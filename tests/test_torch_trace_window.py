"""The on-demand trace window of a fused learner: it starts and stops between
the graph replays of a call, so it holds the steps it was asked for.

``runtime/graphed_call.GraphedCall`` calls ``on_replay(step)`` before each
replay and after the last (on the CPU ``replay/device.run_eager`` calls it
between the body's pieces), with the call's first step plus the steps run;
the runtime passes ``obs/trace.TraceOnDemand.tick``.

* On the CPU, a capture armed before a call starts at its first boundary
  and stops ``n`` steps later inside the call; one armed mid-call starts at
  the next boundary; one that outlasts the call stops in the next.
* The graph runner adds a graph's captured sampler launches right after
  each of its replays and counts the replays, so the counts read at any
  boundary are exact (fake graphs stand in for CUDA graphs).
* The fused loops of ``AsyncPipeline`` (strict and overlapped) pass the
  hook: a window of 8 steps inside a 32-step call traces 8, and the
  record's counters hold the runner's replays and the sampler's launches.
* The trace summary names the device record that leads its launch most,
  and the launch it was matched to.
"""

from __future__ import annotations

import io
import types

import numpy as np
import pytest
import torch

from ape_x_dqn_tpu_torch import config as tconfig
from ape_x_dqn_tpu_torch.learner import train_step as ttrain
from ape_x_dqn_tpu_torch.models import dueling as tdueling
from ape_x_dqn_tpu_torch.obs.trace import TraceOnDemand, summarize_events
from ape_x_dqn_tpu_torch.ops import sampling
from ape_x_dqn_tpu_torch.replay import device as tdev
from ape_x_dqn_tpu_torch.runtime import graphed_call
from ape_x_dqn_tpu_torch.types import NStepTransition

OBS = (6,)
K, B = 16, 8


def _fused_call(sample_ahead: bool):
    """A CPU fused call (K steps, mlp) over a ring of 400 transitions."""
    torch.manual_seed(0)
    net = tdueling.build_network("mlp", 3, OBS, hidden_sizes=(16,))
    opt = ttrain.make_optimizer("adam", learning_rate=1e-3)
    state = ttrain.init_train_state(net, opt, device="cpu")
    ring = tdev.init_device_replay(512, OBS, device="cpu")
    r = np.random.default_rng(3)
    n = 400
    tdev.device_replay_add(ring, NStepTransition(
        obs=torch.from_numpy(r.integers(0, 255, (n, *OBS), dtype=np.uint8)),
        action=torch.from_numpy(r.integers(0, 3, n).astype(np.int32)),
        reward=torch.from_numpy(r.normal(size=n).astype(np.float32)),
        discount=torch.full((n,), 0.97),
        next_obs=torch.from_numpy(r.integers(0, 255, (n, *OBS), dtype=np.uint8))),
        torch.from_numpy((r.random(n) + 0.05).astype(np.float32)), 0.6)
    step_fn = ttrain.build_train_step(net, opt, sync_in_step=False)
    call = tdev.build_fused_learn_step(step_fn, B, steps_per_call=K, include_ingest=False,
                                       target_sync_freq=None, sample_ahead=sample_ahead)
    return call, state, ring


@pytest.mark.parametrize("sample_ahead", [False, True])
def test_cpu_window_stops_inside_the_call(tmp_path, sample_ahead):
    call, state, ring = _fused_call(sample_ahead)
    ticks = []

    def tick(step):
        ticks.append(step)
        tracer.tick(step)

    # Armed before the call: it starts at the call's first boundary and
    # stops 5 steps later, inside the call.
    tracer = TraceOnDemand(steps=5, out_dir=str(tmp_path / "a"))
    tracer.trigger()
    call(state, ring, 0.4, on_replay=tick)
    assert state.step == K
    assert ticks[0] == 0 and ticks[-1] == K and ticks == sorted(ticks)
    assert len(ticks) == K + 3     # before each piece (prologue, K steps, epilogue), after
    rec = _finished(tracer)
    assert rec["steps_traced"] == 5

    # Armed mid-call (at step K + 6): it starts at that boundary and stops
    # at step K + 10, still inside the second call.
    tracer = TraceOnDemand(steps=4, out_dir=str(tmp_path / "b"))

    def arm_at(step):
        if step == K + 6 and tracer.status()["state"] == "idle":
            tracer.trigger()
        tracer.tick(step)

    call(state, ring, 0.4, on_replay=arm_at)
    rec = _finished(tracer)
    assert rec["steps_traced"] == 4

    # A window longer than what is left of the call stops in the next one.
    tracer = TraceOnDemand(steps=10, out_dir=str(tmp_path / "c"))

    def arm_late(step):
        if step == 3 * K - 2 and tracer.status()["state"] == "idle":
            tracer.trigger()
        tracer.tick(step)

    call(state, ring, 0.4, on_replay=arm_late)
    assert tracer.status()["state"] == "capturing"
    call(state, ring, 0.4, on_replay=arm_late)
    rec = _finished(tracer)
    assert rec["steps_traced"] == 10 and state.step == 4 * K


def _finished(tracer, timeout_s: float = 60.0) -> dict:
    import time

    deadline = time.monotonic() + timeout_s
    while tracer.status()["state"] == "capturing" and time.monotonic() < deadline:
        time.sleep(0.01)
    rec = tracer.status()
    assert rec["state"] == "done", rec
    return rec


class _FakeGraph:
    def __init__(self, name: str, log: list):
        self.name, self.log = name, log

    def replay(self):
        self.log.append(self.name)


def test_sampler_launches_are_counted_per_replay(monkeypatch):
    """Fake graphs in the runner (no pacing): at every boundary the
    sampler's count and the runner's replays cover exactly the replays
    issued, so a window that ends inside a call counts its own."""
    monkeypatch.setattr(graphed_call, "MAX_REPLAYS_AHEAD", 0)
    call = graphed_call.GraphedCall(types.SimpleNamespace(update=None), steps_per_call=4,
                                    batch_size=B, priority_exponent=0.6,
                                    target_sync_freq=None, sample_ahead=True)
    log: list = []
    call._graphs = [(_FakeGraph("prologue", log), 1, 0, 1), (_FakeGraph("step", log), 0, 1, 4),
                    (_FakeGraph("epilogue", log), 0, 0, 1)]
    seen = []
    launches0 = sampling.sample_indices.launches
    monkeypatch.setattr(sampling.sample_indices, "launches", launches0)
    call._replay(torch.device("cpu"), 100, lambda step: seen.append(
        (step, sampling.sample_indices.launches - launches0, call.replays, len(log))))
    assert log == ["prologue"] + ["step"] * 4 + ["epilogue"]
    assert seen == [(100, 0, 0, 0), (100, 1, 1, 1), (101, 1, 2, 2), (102, 1, 3, 3),
                    (103, 1, 4, 4), (104, 1, 5, 5), (104, 1, 6, 6)]
    # A second call: the counts go on from where the first left them.
    call._replay(torch.device("cpu"), 104, None)
    assert sampling.sample_indices.launches - launches0 == 2 and call.replays == 12


def _fused_cfg(**over):
    cfg = tconfig.ApexConfig()
    cfg.network = "mlp"
    cfg.env.name = "chain:6"
    cfg.actor.num_actors = 4
    cfg.actor.flush_every = 8
    cfg.learner.device_replay = True
    cfg.learner.steps_per_call = 32
    cfg.learner.min_replay_mem_size = 256
    cfg.learner.optimizer = "adam"
    cfg.learner.learning_rate = 1e-3
    cfg.replay.capacity = 4096
    cfg.obs.trace_steps = 8
    for k, v in over.items():
        section, field = k.split("__")
        setattr(getattr(cfg, section), field, v)
    return cfg.validate()


@pytest.mark.parametrize("pipelined", [False, True])
def test_fused_runtime_traces_the_window_inside_a_call(tmp_path, pipelined):
    """The runtime's fused loops pass the tracer's tick into the call: a
    capture armed before the run starts at the first call's first
    boundary and stops after 8 of its 32 steps."""
    from ape_x_dqn_tpu_torch.runtime.async_pipeline import AsyncPipeline
    from ape_x_dqn_tpu_torch.utils.metrics import MetricLogger

    over = {"obs__trace_dir": str(tmp_path)}
    if pipelined:
        over.update(learner__pipeline_depth=2, learner__sync_every=64)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        pipe = AsyncPipeline(_fused_cfg(**over), logger=MetricLogger(stream=io.StringIO()),
                             log_every=10_000, device="cpu")
        assert pipe._overlapped == pipelined
        assert pipe.trace_on_demand.trigger()["state"] == "capturing"
        final = pipe.run(learner_steps=64)
    finally:
        torch.set_num_threads(threads)
    assert final["step"] == 64
    rec = _finished(pipe.trace_on_demand)
    assert rec["steps_traced"] == 8
    # The fused path's counters: the runner's replays (none on the CPU) and
    # the sampler's launches (its plain version on the CPU); no step count
    # that moves only after a call.
    assert rec["counters"] == {"sampler_launches": 0, "graph_replays": 0}


def _kernel(name, ts, corr, stream=7):
    return {"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": 2.0,
            "args": {"correlation": corr, "stream": stream}}


def _launch(name, ts, corr, tid=11):
    return {"ph": "X", "cat": "cuda_runtime", "name": name, "ts": ts, "dur": 3.0, "tid": tid,
            "args": {"correlation": corr}}


def test_trace_summary_names_the_record_that_leads_its_launch():
    events = [
        _launch("cudaGraphLaunch", 100.0, 1),
        _kernel("gemm", 110.0, 1),
        _launch("cudaLaunchKernel", 200.0, 2, tid=12),
        _kernel("fill", 150.0, 2, stream=9),        # 50 µs before its launch
        _kernel("fill", 190.0, 2, stream=9),        # the same launch, later
        _launch("cudaGraphLaunch", 300.0, 3),
        _kernel("copy", 299.0, 3),                  # 1 µs before its launch
        _kernel("orphan", 10.0, 4),                 # its launch is not in the trace
    ]
    s = summarize_events(events)
    assert s["device_clock_lead_ms"] == pytest.approx(0.05)
    assert s["device_records_before_launch"] == 2
    lead = s["device_clock_lead"]
    assert lead == {"ms": pytest.approx(0.05), "name": "fill", "cat": "kernel", "stream": 9,
                    "correlation": 2, "ts_us": 150.0, "dur_us": 2.0,
                    "launch": {"name": "cudaLaunchKernel", "tid": 12, "ts_us": 200.0,
                               "dur_us": 3.0}}
    assert summarize_events([])["device_clock_lead"] is None
