"""Where the fused learner's time goes on the card, graphed against eager.

    python -m ape_x_dqn_tpu_torch.profile_fused [--layout double|dedup] [--calls N]
        [--sample-ahead] [--profile-steps K] [--steps-per-graph G]

Builds a full device ring on the card from a seed (random 84×84×1 frames
written on the device, every slot live) and the conv dueling network at
full width, B = 32, and runs the fused call alone (no actors) two ways in
one process, on the same ring and train state:
  * ``graphed`` — ``runtime/graphed_call.GraphedCall``, the learners' path:
    CUDA-graph replays;
  * ``eager``   — the same ``FusedBody`` run step by step
    (``replay/device.fused_scan_body``), the path before graphs.

Layouts:
  * ``double`` (default): the double-store ring of 100 000 slots, K = 128,
    strict sampling (``--sample-ahead`` for sample-ahead), RMSProp.
  * ``dedup``: config3's learner — the frame-dedup ring at 2 000 000 slots
    (frame ratio 1.25), sample-ahead K = 2048, bf16 ν and target.

Prints JSON lines:
  * ``steps``   — per mode, learner steps/s and ms/step over ``--calls``
    calls of K steps, host clock around work that ends in a device
    synchronise;
  * ``profile`` — per mode, one call of ``--profile-steps`` steps (default:
    K, or 256 for ``dedup``: the profiler cannot hold the ~10^6 events of an
    eager 2048-step call) under ``torch.profiler``: device-busy ms (the
    union of kernel intervals) against the call's wall time, the idle
    share, the sampler kernels in the trace, and the top operators by
    device time and by host time.
The first line is the card's name and power limit (``nvidia-smi``).
``--steps-per-graph`` sets the steps captured in one graph (G, the module
constant ``graphed_call.STEPS_PER_GRAPH``) for this run.  Needs a CUDA
device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch

from ape_x_dqn_tpu_torch.obs.trace import SAMPLER_KERNEL, union_of_spans


def _busy_ms(events) -> float:
    """Union of device kernel intervals, in ms."""
    return union_of_spans(
        (e.time_range.start, e.time_range.end) for e in events
        if e.device_type == torch.autograd.DeviceType.CUDA
    ) / 1e3  # µs → ms


def profile_call(fn) -> dict:
    """One call of ``fn`` (which ends in a device read) under the profiler:
    wall ms, device-busy ms, idle share, sampler kernels, top operators.
    The profiler starts and stops through ``utils/profiling`` (lead kernels
    and idle edges: a trace after an earlier one in the process otherwise
    loses its first device records); the lead kernels, which run before the
    call, are left out of the busy time."""
    from ape_x_dqn_tpu_torch.utils.profiling import LEAD_KERNELS, start_trace, stop_trace

    prof = start_trace()
    if prof is None:
        raise RuntimeError("torch.profiler did not start")
    try:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        call_ms = (time.perf_counter() - t0) * 1e3
    finally:
        if not stop_trace(prof):
            raise RuntimeError("torch.profiler did not stop")
    events = prof.events()
    device = sorted((e for e in events if e.device_type == torch.autograd.DeviceType.CUDA),
                    key=lambda e: e.time_range.start)
    busy = _busy_ms(device[LEAD_KERNELS:])
    ka = prof.key_averages()

    def dev_us(e):
        return getattr(e, "device_time_total", getattr(e, "cuda_time_total", 0.0))

    return {
        "call_ms": call_ms, "device_busy_ms": busy, "device_idle_share": 1.0 - busy / call_ms,
        "sampler_kernels": sum(1 for e in events
                               if e.device_type == torch.autograd.DeviceType.CUDA
                               and SAMPLER_KERNEL in e.name),
        "top_device_ms": [(e.key, dev_us(e) / 1e3, e.count)
                          for e in sorted(ka, key=dev_us, reverse=True)[:12]],
        "top_host_self_ms": [(e.key, e.self_cpu_time_total / 1e3, e.count)
                             for e in sorted(ka, key=lambda e: e.self_cpu_time_total,
                                             reverse=True)[:12]],
    }


def _fill_double(ring, gen):
    C = ring.capacity
    ring.obs.random_(0, 256, generator=gen)
    ring.next_obs.random_(0, 256, generator=gen)
    ring.action.random_(0, 3, generator=gen)
    ring.reward.normal_(generator=gen)
    ring.discount.fill_(0.97)
    ring.mass.copy_((torch.rand(C, generator=gen, device=ring.mass.device) + 0.05) ** 0.6)
    ring.count = C


def _fill_dedup(ring, gen):
    """Every slot live: obs_ref = slot, next_ref = slot + 3 (n = 3), all
    referenced frames written (fcount = Cf ≥ C + 3)."""
    C, dev = ring.capacity, ring.mass.device
    ring.frames.random_(0, 256, generator=gen)
    ring.obs_ref.copy_(torch.arange(C, dtype=torch.int32, device=dev))
    ring.next_ref.copy_(ring.obs_ref + 3)
    ring.action.random_(0, 3, generator=gen)
    ring.reward.normal_(generator=gen)
    ring.discount.fill_(0.97)
    ring.mass.copy_((torch.rand(C, generator=gen, device=dev) + 0.05) ** 0.6)
    ring.count = C
    ring.fcount = ring.frame_capacity


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="ape_x_dqn_tpu_torch.profile_fused")
    p.add_argument("--layout", choices=("double", "dedup"), default="double")
    p.add_argument("--calls", type=int, default=None,
                   help="timed calls per mode (default 4, dedup 1)")
    p.add_argument("--sample-ahead", action="store_true",
                   help="double layout: sample-ahead instead of strict")
    p.add_argument("--profile-steps", type=int, default=None)
    p.add_argument("--steps-per-graph", type=int, default=None)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_fused needs a CUDA device")
    from ape_x_dqn_tpu_torch.learner.train_step import (
        build_train_step,
        init_train_state,
        make_optimizer,
    )
    from ape_x_dqn_tpu_torch.models.dueling import build_network
    from ape_x_dqn_tpu_torch.replay.device import fused_scan_body, init_device_replay
    from ape_x_dqn_tpu_torch.replay.device_dedup import (
        dedup_sample_many,
        init_dedup_device_replay,
    )
    from ape_x_dqn_tpu_torch.runtime import graphed_call

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    if args.steps_per_graph:
        graphed_call.STEPS_PER_GRAPH = args.steps_per_graph
    dedup = args.layout == "dedup"
    obs_shape, A, B = (84, 84, 1), 3, 32
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    torch.manual_seed(0)
    net = build_network("conv", A, obs_shape)
    if dedup:
        C, K, sample_ahead, default_profile, default_calls = 2_000_000, 2048, True, 256, 1
        opt = make_optimizer("rmsprop", second_moment_dtype=torch.bfloat16)
        state = init_train_state(net, opt, device=dev, target_dtype=torch.bfloat16)
        ring = init_dedup_device_replay(C, obs_shape, frame_ratio=1.25, device=dev)
        _fill_dedup(ring, gen)
        sample_many_fn = dedup_sample_many
    else:
        C, K, sample_ahead, default_profile, default_calls = (100_000, 128, args.sample_ahead,
                                                              128, 4)
        opt = make_optimizer("rmsprop")
        state = init_train_state(net, opt, device=dev)
        ring = init_device_replay(C, obs_shape, device=dev)
        _fill_double(ring, gen)
        sample_many_fn = None
    calls = args.calls or default_calls
    profile_steps = args.profile_steps or default_profile
    step = build_train_step(net, opt, sync_in_step=False)
    knobs = dict(batch_size=B, priority_exponent=0.6, sample_ahead=sample_ahead,
                 sample_many_fn=sample_many_fn)
    graphed = {}

    def run(mode, steps):
        if mode == "eager":
            fused_scan_body(step, state, ring, 0.4, steps_per_call=steps, generator=gen,
                            target_sync_freq=2048, **knobs)
            return
        graphed[steps](state, ring, 0.4, generator=gen)

    head = {"layout": args.layout, "device": torch.cuda.get_device_name(0), "card": smi,
            "C": C, "K": K, "B": B, "sample_ahead": sample_ahead,
            "steps_per_graph": graphed_call.STEPS_PER_GRAPH}
    for mode in ("graphed", "eager"):
        t0 = time.perf_counter()
        if mode == "graphed":   # warm-up and capture of both call lengths
            for steps in {K, profile_steps}:
                graphed[steps] = graphed_call.GraphedCall(
                    step, steps_per_call=steps, target_sync_freq=2048, **knobs)
                graphed[steps].bind(state, ring)
        run(mode, profile_steps)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        for _ in range(calls):
            run(mode, K)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        print(json.dumps({"phase": "steps", **head, "mode": mode, "calls": calls,
                          "steps_per_s": calls * K / wall,
                          "ms_per_step": wall / (calls * K) * 1e3,
                          "first_call_s": first_s}), flush=True)
        prof = profile_call(lambda: run(mode, profile_steps))
        print(json.dumps({"phase": "profile", **head, "mode": mode,
                          "profile_steps": profile_steps,
                          "ms_per_step": prof["call_ms"] / profile_steps, **prof}),
              flush=True)
    print(json.dumps({"phase": "memory", **head,
                      "peak_mem_bytes": torch.cuda.max_memory_allocated()}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
