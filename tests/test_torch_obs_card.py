"""The on-demand trace on the card (marked ``gpu``, skipped without one; no
JAX import, so it runs where JAX is absent): ``obs/trace.TraceOnDemand``,
started and stopped at this thread's call boundaries while it runs graphed
fused calls (``runtime/graphed_call.GraphedCall``, the dedup ring,
sample-ahead), records the calls' kernels, and its summary counts one
sampler kernel per captured call: as many as the wrapper counted over the
window, capture after capture in one process."""

from __future__ import annotations

import json
import time

import numpy as np
import pytest
import torch

from ape_x_dqn_tpu_torch.learner import train_step as ttrain
from ape_x_dqn_tpu_torch.models import dueling as tdueling
from ape_x_dqn_tpu_torch.obs.trace import SAMPLER_KERNEL, TraceOnDemand, summarize
from ape_x_dqn_tpu_torch.ops import sampling
from ape_x_dqn_tpu_torch.replay import device_dedup as tdd
from ape_x_dqn_tpu_torch.runtime import graphed_call
from ape_x_dqn_tpu_torch.utils.profiling import EDGE_MARGIN_S, LEAD_KERNELS, trace

K = 16
CAPTURES = 30


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _graphed_dedup(dev):
    """A graphed sample-ahead call over a filled dedup ring of 1024 slots."""
    torch.manual_seed(0)
    net = tdueling.build_network("conv", 3, (36, 36, 1), channels=(8, 8, 8), hidden=32)
    opt = ttrain.make_optimizer("rmsprop")
    state = ttrain.init_train_state(net, opt, device=dev)
    ring = tdd.init_dedup_device_replay(1024, (36, 36, 1), frame_capacity=1280, device=dev)
    r = np.random.default_rng(1)
    M = 512
    tdd.dedup_device_add_frames(ring, torch.from_numpy(
        r.integers(0, 256, (M + 1, 36, 36, 1), dtype=np.uint8)).to(dev))
    seq = torch.arange(M, dtype=torch.int32, device=dev)
    tdd.dedup_device_add_transitions(
        ring, seq, seq + 1, torch.from_numpy(r.integers(0, 3, M).astype(np.int32)).to(dev),
        torch.from_numpy(r.normal(size=M).astype(np.float32)).to(dev),
        torch.full((M,), 0.97, device=dev),
        torch.from_numpy((r.random(M) + 0.05).astype(np.float32)).to(dev))
    step = ttrain.build_train_step(net, opt, sync_in_step=False)
    call = graphed_call.GraphedCall(step, steps_per_call=K, batch_size=32,
                                    priority_exponent=0.6, target_sync_freq=K,
                                    sample_ahead=True, sample_many_fn=tdd.dedup_sample_many)
    call.bind(state, ring)
    return call, state, ring


def _capture(call, state, ring, step: int, tmp_path):
    """One 3-call capture driven from this thread's call boundaries; the
    finished record and the step reached."""
    tracer = TraceOnDemand(steps=3 * K, out_dir=str(tmp_path),
                           counters_fn=lambda: {"sampler_launches":
                                                sampling.sample_indices.launches})
    assert tracer.trigger()["state"] == "capturing"
    deadline = time.monotonic() + 120.0
    while tracer.status()["state"] == "capturing" and time.monotonic() < deadline:
        call(state, ring, 0.4)
        step += K
        tracer.tick(step)   # the learner's boundary: the capture starts and stops here
    torch.cuda.synchronize()
    return tracer.status(), step


def _check_exact(rec):
    assert rec["state"] == "done", rec
    s = rec["summary"]
    assert s["device_events"] > 0 and 0.0 <= s["idle_share"] < 1.0
    # Exactly the 3 calls of the window: one sampler launch each, inside its
    # prologue's graph replay, and K + 2 replays per call; the device was
    # synchronized before the start, so no earlier call's kernel is in it.
    assert s["sampler_kernels_launched_in_window"] == rec["counters"]["sampler_launches"] == 3
    assert s["sampler_kernels"] == 3
    assert s["graph_replays"] == 3 * (K + 2)
    # The window's first launch came EDGE_MARGIN_S after the start: more
    # than the card's clock runs ahead of the host's.
    assert s["device_clock_lead_ms"] < EDGE_MARGIN_S * 1e3
    assert any(SAMPLER_KERNEL in op["name"] for op in s["top_device_ms"]) \
        or len(s["top_device_ms"]) == 20


@pytest.mark.gpu
def test_trace_summary_counts_the_sampler_kernels_of_graphed_calls_on_card(
        cuda_device, tmp_path):
    call, state, ring = _graphed_dedup(cuda_device)
    rec, _ = _capture(call, state, ring, 0, tmp_path)
    _check_exact(rec)


@pytest.mark.gpu
def test_repeated_captures_each_count_exactly_on_card(cuda_device, tmp_path):
    """Capture after capture in one process, graphed calls running between
    them (CUPTI set up once and kept): every capture finishes and counts
    exactly."""
    call, state, ring = _graphed_dedup(cuda_device)
    step = 0
    for i in range(CAPTURES):
        rec, step = _capture(call, state, ring, step, tmp_path / str(i))
        _check_exact(rec)
        for _ in range(2):
            call(state, ring, 0.4)
            step += K


def _lost_launches(path: str) -> list:
    """Kernel launches (graph replays included) of the Chrome trace at
    ``path`` with no device record, in launch order, and all launches."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    recorded = {e["args"]["correlation"] for e in events if e.get("cat") == "kernel"}
    launches = sorted((e["ts"], e["args"]["correlation"]) for e in events
                      if e.get("cat") in ("cuda_runtime", "cuda_driver")
                      and e.get("name", "").startswith(("cudaLaunchKernel", "cuLaunchKernel",
                                                        "cudaGraphLaunch")))
    return [i for i, (_, c) in enumerate(launches) if c not in recorded], launches


@pytest.mark.gpu
def test_a_large_window_keeps_its_kernels_on_card(cuda_device, tmp_path):
    """2048 replays of a 436-kernel graph, as many records as a 2048-step
    call of config3's learner, traced twice in one process through
    ``utils/profiling``: each trace holds all of the window's replays and at
    least 99.99 % of its kernels."""
    from ape_x_dqn_tpu_torch.utils.profiling import export_trace, start_trace, stop_trace

    x = torch.zeros(1024, device=cuda_device)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        x.add_(1)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(436):
            x.add_(1)
    for i in range(2):
        prof = start_trace()
        for _ in range(2048):
            graph.replay()
        assert stop_trace(prof)
        s = summarize(export_trace(prof, str(tmp_path / str(i))))
        assert s["graph_replays"] == 2048
        assert 0.9999 * 436 * 2048 <= s["device_events"] - LEAD_KERNELS <= 436 * 2048


@pytest.mark.gpu
def test_profiling_trace_records_the_card(cuda_device, tmp_path):
    """Short traces, one after another, after a large one (the test above):
    every launch of the body has its kernels in the trace, the first and
    the last ones too; only the start's throwaway kernels may go missing."""
    a = torch.randn(512, 512, device=cuda_device)
    for i in range(5):
        with trace(str(tmp_path / str(i))) as prof:
            for _ in range(4):
                a = a @ a / 512
        assert prof is not None
        s = summarize(str(tmp_path / str(i) / "trace.json"))
        assert s["device_events"] >= 8 and s["device_busy_ms"] > 0, s
        lost, launches = _lost_launches(str(tmp_path / str(i) / "trace.json"))
        assert len(launches) >= LEAD_KERNELS + 8
        assert all(j < LEAD_KERNELS for j in lost), (lost, len(launches))
