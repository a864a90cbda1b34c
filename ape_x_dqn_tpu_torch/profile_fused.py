"""Where the fused learner's time goes on the card.

    python -m ape_x_dqn_tpu_torch.profile_fused [--calls N] [--sample-ahead]

Fills a device ring of 100 000 slots with random 84×84×1 frames and runs
the fused learner alone (no actors) at the full width of the conv dueling
network, B = 32, K = 128 — the shapes ``chip_smoke.py`` drives.  Prints
JSON lines:
  * ``steps``   — learner steps/s and ms/step over ``--calls`` fused calls,
    host clock around work that ends in a device synchronise;
  * ``profile`` — one fused call under ``torch.profiler``: device-busy
    milliseconds (the union of kernel intervals) against the wall time of
    the call, the idle share, and the top operators by device time and by
    host time.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch


def _busy_ms(events) -> float:
    """Union of device kernel intervals, in ms."""
    spans = sorted(
        (e.time_range.start, e.time_range.end) for e in events
        if e.device_type == torch.autograd.DeviceType.CUDA
    )
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy / 1e3  # µs → ms


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="ape_x_dqn_tpu_torch.profile_fused")
    p.add_argument("--calls", type=int, default=4)
    p.add_argument("--sample-ahead", action="store_true")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_fused needs a CUDA device")
    from ape_x_dqn_tpu_torch.learner.train_step import init_train_state, make_optimizer
    from ape_x_dqn_tpu_torch.models.dueling import build_network
    from ape_x_dqn_tpu_torch.runtime.fused_learner import FusedDeviceLearner
    from ape_x_dqn_tpu_torch.types import NStepTransition

    obs_shape, A, C, B, K = (84, 84, 1), 3, 100_000, 32, 128
    torch.manual_seed(0)
    net = build_network("conv", A, obs_shape)
    opt = make_optimizer("rmsprop")
    learner = FusedDeviceLearner(
        net, opt, init_train_state(net, opt, device="cuda"), obs_shape,
        capacity=C, batch_size=B, steps_per_call=K, ingest_block=4096,
        target_sync_freq=2432, sample_ahead=args.sample_ahead, device="cuda",
    )
    r = np.random.default_rng(0)
    M = 4096
    for _ in range(C // M):
        learner.add_block(
            (r.random(M) + 0.05).astype(np.float32),
            NStepTransition(
                obs=r.integers(0, 256, (M, *obs_shape), dtype=np.uint8),
                action=r.integers(0, A, M).astype(np.int32),
                reward=r.normal(size=M).astype(np.float32),
                discount=np.full(M, 0.97, np.float32),
                next_obs=r.integers(0, 256, (M, *obs_shape), dtype=np.uint8),
            ),
        )
    learner.train(0.4)  # warm-up: cuDNN plans, library load, allocator
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(args.calls):
        m = learner.train(0.4)
    float(m.loss[-1])
    wall = time.perf_counter() - t0
    steps = args.calls * K
    dev = torch.cuda.get_device_name(0)
    print(json.dumps({"phase": "steps", "device": dev, "sample_ahead": args.sample_ahead,
                      "steps_per_s": steps / wall, "ms_per_step": wall / steps * 1e3}),
          flush=True)

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        m = learner.train(0.4)
        float(m.loss[-1])
        call_ms = (time.perf_counter() - t0) * 1e3
    ka = prof.key_averages()

    def dev_us(e):
        return getattr(e, "device_time_total", getattr(e, "cuda_time_total", 0.0))

    top_dev = sorted(ka, key=dev_us, reverse=True)[:12]
    top_cpu = sorted(ka, key=lambda e: e.self_cpu_time_total, reverse=True)[:12]
    busy = _busy_ms(prof.events())
    print(json.dumps({
        "phase": "profile", "device": dev, "sample_ahead": args.sample_ahead,
        "call_ms": call_ms, "device_busy_ms": busy,
        "device_idle_share": 1.0 - busy / call_ms,
        "top_device_ms": [(e.key, dev_us(e) / 1e3, e.count) for e in top_dev],
        "top_host_self_ms": [(e.key, e.self_cpu_time_total / 1e3, e.count) for e in top_cpu],
    }), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
