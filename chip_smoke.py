#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (an H100).

    python3 chip_smoke.py

Phases, each printing one JSON line:
  1. device   — the card's name and count, and nvidia-smi's name and
                power limit;
  2. build    — compile the sampling kernel (``ops/csrc/sampling.cu``) from
                the checkout with nvcc, timed;
  3. kernel   — hold the kernel against its plain PyTorch version at
                C = 100 000 and 2 000 000, B = 32 and 4096: identical
                indices on integer-valued priorities (exact in float32),
                every index inside its inverse-CDF bracket (float64, within
                1e-5·total) on real-valued ones, zero-mass blocks and a C
                that is not a multiple of 4; identical indices from two
                calls on the same real-valued priorities (determinism);
                exactly one device kernel and no memset per call (profiler);
                a call captured in a CUDA graph, replayed after the
                priorities changed in place.  Device times of the kernel and
                the plain version (``bench_sampler``: warm = CUDA-graph
                replay, cold = profiler spans after an L2 flush) and the
                host time of one wrapper call;
  4. parity   — one small fused learner run twice, on the card and on the
                CPU, with the same weights, chunks and uniforms (float32
                compute, TF32 off): the parameter updates must agree;
  5. train    — the main path through the user's entry point,
                ``ape_x_dqn_tpu_torch.train.main``, at the full width of the
                conv dueling network (64/64/64, hidden 512) on 84×84×1
                frames, device replay of 100 000 slots, B = 32, K = 128,
                8 actors: the loss must be finite, the steps reached, and
                every sample drawn by the kernel (launch count == steps);
  6. kernels  — one JSON object per ported kernel with its launches on the
                main path, error, times and bound.
The line before the last is nvidia-smi's "name, power limit"; the last is
``{"ok": true, "device": {...}}``.  Exits non-zero, printing no result,
when there is no CUDA device, the kernel does not build, or any check fails.
"""

from __future__ import annotations

import contextlib
import io
import json
import subprocess
import sys
import time

import numpy as np

SEED = 0


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check_brackets(p, t, idx) -> float:
    """Every idx must satisfy cdf[i-1] <= t < cdf[i] in float64, within
    1e-5·total.  Returns the worst violation as a fraction of the total."""
    p64 = p.double().cpu().numpy()
    cdf = np.cumsum(p64)
    total = cdf[-1]
    i = idx.long().cpu().numpy()
    tt = t.double().cpu().numpy()
    lo = np.where(i > 0, cdf[np.maximum(i - 1, 0)], 0.0)
    hi = cdf[i]
    worst = max(float(np.max(lo - tt, initial=0.0)),
                float(np.max(tt - hi, initial=0.0))) / total
    if worst > 1e-5:
        raise AssertionError(f"kernel index outside its inverse-CDF bracket by "
                             f"{worst:.3g}·total")
    return worst


def phase_kernel(sampling):
    import torch

    from ape_x_dqn_tpu_torch import bench_sampler as bench

    rng = np.random.default_rng(SEED)
    dev = torch.device("cuda")
    num_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    flush = torch.empty(bench.FLUSH_BYTES, dtype=torch.uint8, device=dev)
    rows = []
    for C in (100_000, 2_000_000):
        # Integer priorities whose total stays below 2^24: every prefix sum
        # is exact in float32, in any order, so indices must be identical.
        hi = max(2, 2**24 // C)
        p_int = torch.as_tensor(rng.integers(0, hi, C).astype(np.float32), device=dev)
        p_real = torch.as_tensor(rng.random(C, dtype=np.float32), device=dev)
        for B in (32, 4096):
            t_int = bench.stratified_targets(p_int, B, rng)
            k = sampling.sample_indices(p_int, t_int)
            ref = sampling.sample_indices_reference(p_int, t_int)
            torch.cuda.synchronize()
            if not torch.equal(k, ref):
                bad = int((k != ref).sum())
                raise AssertionError(f"C={C} B={B}: {bad} indices differ on "
                                     "integer priorities")
            t_real = bench.stratified_targets(p_real, B, rng)
            k_real = sampling.sample_indices(p_real, t_real)
            ref_real = sampling.sample_indices_reference(p_real, t_real)
            worst = check_brackets(p_real, t_real, k_real)
            if not torch.equal(k_real, sampling.sample_indices(p_real, t_real)):
                raise AssertionError(f"C={C} B={B}: two calls on the same "
                                     "priorities gave different indices")
            calls = bench.device_calls(
                lambda: sampling.sample_indices(p_real, t_real), 3, flush)
            if any(len(c) != 1 for c in calls):
                raise AssertionError(f"C={C} B={B}: device activities per call "
                                     f"{[[a[0] for a in c] for c in calls]}, "
                                     "want one kernel")

            def kernel():
                return sampling.sample_indices(p_real, t_real)

            def plain():
                return sampling.sample_indices_reference(p_real, t_real)

            timed = bench.measure(kernel, C, B, 50, flush)
            plain_t = bench.measure(plain, C, B, 50, flush)
            rows.append({
                "C": C, "B": B, "grid": list(sampling.plan(C, num_sms)),
                "ms": timed["cold_ms"], **timed,
                "plain_ms": plain_t["cold_ms"], "plain_warm_ms": plain_t["warm_ms"],
                "plain_host_us": plain_t["host_us"],
                "bound_ms": bench.bound_ms(C, B),
                "max_abs_err": int((k - ref).abs().max()),
                "bracket_violation_of_total": worst,
                "real_idx_max_abs_diff_vs_plain":
                    int((k_real.long() - ref_real.long()).abs().max()),
                "kernel_activity": calls[0][0][0],
            })
            emit({"phase": "kernel", **rows[-1]})
    # Zero-mass blocks, a C that is not a multiple of 4, targets at and
    # past the total.
    C = 100_003
    p = np.zeros(C, np.float32)
    live = rng.choice(C, 64, replace=False)
    p[live] = rng.integers(1, 50, 64)
    p[C - 1] = 3.0
    p = torch.as_tensor(p, device=dev)
    total = float(p.sum())
    t = torch.as_tensor(np.concatenate([
        np.sort(rng.random(253)) * total, [0.0, total, 1.5 * total]
    ]).astype(np.float32), device=dev)
    k = sampling.sample_indices(p, t)
    ref = sampling.sample_indices_reference(p, t)
    if not torch.equal(k, ref):
        raise AssertionError("zero-mass / ragged case differs from the plain version")
    if int(k[-1]) != C - 1:
        raise AssertionError("a target past the total must resolve to the last leaf")
    emit({"phase": "kernel", "case": "zero-mass blocks, C=100003", "identical": True})
    # A call captured in a CUDA graph, replayed after p changed in place.
    C, B = 2_000_000, 4096
    p = torch.as_tensor(rng.integers(0, 8, C).astype(np.float32), device=dev)
    t = bench.stratified_targets(p, B, rng)
    sampling.sample_indices(p, t)  # set-up outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = sampling.sample_indices(p, t)
    p.copy_(torch.as_tensor(rng.integers(0, 8, C).astype(np.float32), device=dev))
    t.copy_(bench.stratified_targets(p, B, rng))
    graph.replay()
    torch.cuda.synchronize()
    if not torch.equal(captured, sampling.sample_indices_reference(p, t)):
        raise AssertionError("graph replay after an in-place change of p differs "
                             "from the plain version")
    emit({"phase": "kernel", "case": "CUDA graph replay, p changed in place",
          "identical": True})
    return rows


def phase_parity():
    """The same small fused learner on the card and on the CPU."""
    import torch

    from ape_x_dqn_tpu_torch.learner.train_step import init_train_state, make_optimizer
    from ape_x_dqn_tpu_torch.models.dueling import build_network
    from ape_x_dqn_tpu_torch.runtime.fused_learner import FusedDeviceLearner
    from ape_x_dqn_tpu_torch.types import NStepTransition

    rng = np.random.default_rng(SEED)
    obs_shape, A, M, K, B = (36, 36, 1), 3, 512, 4, 8
    chunk = NStepTransition(
        obs=rng.integers(0, 256, (M, *obs_shape), dtype=np.uint8),
        action=rng.integers(0, A, M).astype(np.int32),
        reward=rng.normal(size=M).astype(np.float32),
        discount=np.full(M, 0.97, np.float32),
        next_obs=rng.integers(0, 256, (M, *obs_shape), dtype=np.uint8),
    )
    prio = (rng.random(M) + 0.1).astype(np.float32)
    u = rng.random((2, K, B), dtype=np.float32)
    torch.manual_seed(SEED)
    net = build_network("conv", A, obs_shape, channels=(8, 8, 8), hidden=32,
                        compute_dtype=torch.float32)
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        out = {}
        for dev in ("cpu", "cuda"):
            opt = make_optimizer("rmsprop")
            state = init_train_state(net, opt, seed=SEED, device=dev)
            learner = FusedDeviceLearner(net, opt, state, obs_shape, capacity=1000,
                                         batch_size=B, steps_per_call=K,
                                         ingest_block=128, target_sync_freq=K,
                                         device=dev)
            learner.add_chunk(prio, chunk)
            learner.ingest_staged(drain=True)
            for call in range(2):
                learner.train(0.4, u=torch.as_tensor(u[call]))
            out[dev] = ({k: v.cpu() for k, v in learner.state.params.items()},
                        learner.replay.mass.cpu())
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    init = {k: v.cpu() for k, v in net.state_dict().items()}
    worst = 0.0
    for k in init:
        d_cpu = out["cpu"][0][k] - init[k]
        d_gpu = out["cuda"][0][k] - init[k]
        scale = float(d_cpu.abs().max()) + 1e-12
        worst = max(worst, float((d_cpu - d_gpu).abs().max()) / scale)
    mass_err = float((out["cpu"][1] - out["cuda"][1]).abs().max())
    # Conv and matmul sums run in other orders on the card; RMSProp's
    # normalised update keeps the relative error of each update near the
    # gradients' (~1e-6); 1e-3 of the largest update leaves room for that.
    if worst > 1e-3 or mass_err > 1e-4:
        raise AssertionError(f"card vs CPU fused learner: update error {worst:.3g} "
                             f"of the largest update, mass error {mass_err:.3g}")
    emit({"phase": "parity", "param_update_err_rel": worst, "mass_max_abs_err": mass_err,
          "tolerance": {"param_update_err_rel": 1e-3, "mass_max_abs_err": 1e-4}})


def phase_train(sampling, card: str, steps: int = 512):
    import torch

    from ape_x_dqn_tpu_torch import train

    argv = [
        "--device", "cuda", "--steps", str(steps), "--log-every", "128",
        "--set", "learner.device_replay=true",
        "--set", "network=conv",
        "--set", "env.name=catch:84",
        "--set", "replay.capacity=100000",
        "--set", "learner.replay_sample_size=32",
        "--set", "learner.steps_per_call=128",
        "--set", "learner.ingest_block=256",
        "--set", "learner.min_replay_mem_size=2048",
        "--set", "actor.num_actors=8",
        "--set", f"seed={SEED}",
    ]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    sampling.sample_indices.launches = 0
    out = io.StringIO()
    t0 = time.monotonic()
    with contextlib.redirect_stdout(out):
        rc = train.main(argv)
    wall = time.monotonic() - t0
    launches = sampling.sample_indices.launches
    records = [json.loads(line) for line in out.getvalue().splitlines()
               if line.startswith("{")]
    final = records[-1]
    if rc != 0 or not final.get("final"):
        raise AssertionError(f"train.main returned {rc} without a final record")
    if final["step"] < steps:
        raise AssertionError(f"reached {final['step']} of {steps} learner steps")
    loss = final.get("learner/loss")
    if loss is None or not np.isfinite(loss):
        raise AssertionError(f"loss not finite: {loss}")
    if launches != final["step"]:
        raise AssertionError(f"{launches} sampler kernel launches for "
                             f"{final['step']} strict learner steps")
    result = {
        "phase": "train", "card": card, "learner_steps": final["step"], "loss": loss,
        "sampler_launches": launches,
        "learner_steps_per_s": final["step"] / final["train_s"],
        "train_s": final["train_s"], "wall_s": wall,
        "actor_steps": final["actor_steps"], "replay_size": final["replay_size"],
        "peak_mem_bytes": torch.cuda.max_memory_allocated(),
    }
    emit(result)
    return result


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from ape_x_dqn_tpu_torch.ops import sampling

    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    emit({"phase": "device", "kind": name, "count": count, "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    t0 = time.monotonic()
    lib, log = sampling.build_library()
    emit({"phase": "build", "library": lib.name, "seconds": time.monotonic() - t0,
          "ptxas": [ln.strip() for ln in log.splitlines()
                    if "registers" in ln or "Compiling entry" in ln]})

    rows = phase_kernel(sampling)
    phase_parity()
    trained = phase_train(sampling, card=smi)

    main_row = next(r for r in rows if r["C"] == 100_000 and r["B"] == 32)
    emit({"kernels": [{
        "name": "sampling",
        "route": "cuda",
        "source": "ape_x_dqn_tpu_torch/ops/csrc/sampling.cu",
        "replaces": "ape_x_dqn_tpu/ops/pallas/sampling.py:118",
        "launches": trained["sampler_launches"],
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": main_row["cold_ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
        "cold_ms": main_row["cold_ms"],
        "warm_ms": main_row["warm_ms"],
        "roofline_share": main_row["roofline_share"],
        "grid": main_row["grid"],
        "at": {"C": 100_000, "B": 32},
        "shapes": rows,
    }]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}})
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
