"""Device time of the sampling kernel on the card, warm and cold.

    python -m ape_x_dqn_tpu_torch.bench_sampler [--parent DIR] [--iters N] [--phases]

Times ``ops.sampling.sample_indices`` and its plain version at the main
path's shapes, C in {100 000, 2 000 000} x B in {32, 4096}, on real-valued
priorities made from a seed.  Three readings per function and shape:

* ``warm_ms``: a CUDA graph of ``iters`` calls on the same priorities,
  replayed between two CUDA events.  Graph replay leaves no host gaps, so
  this is device time, with the priorities warm in the 50 MB L2.
* ``cold_ms``: ``torch.profiler`` over ``iters`` calls, each after a 256 MiB
  read-and-write that evicts L2.  Per call, the span from the start of its
  first device activity to the end of its last; the flush is not counted.
* ``host_us``: host time of one call, ``perf_counter`` over ``iters`` calls
  with no synchronise (the enqueue cost a host-bound caller pays).

``--phases`` also builds the kernel with its phase stamps
(``-DAPEX_SAMPLER_PHASES``) and prints, per shape and cold, when the
slowest block finished each phase (stage, scan, grid barrier, offsets,
resolve), in µs from the first block's start, averaged over ``iters`` calls.

``--parent DIR`` names an unpacked earlier checkout (``git archive``): its
``sample_indices`` is timed beside this one in turns (parent, this, this,
parent), on the same inputs.  Prints one JSON line per reading and a summary
line.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (NVIDIA data sheet)
SHAPES = ((100_000, 32), (100_000, 4096), (2_000_000, 32), (2_000_000, 4096))
FLUSH_BYTES = 256 << 20  # > 5x the 50 MB L2
_FLUSH_OP = "bitwise_not"  # the flush's kernel name; no sampler uses it


def bound_ms(C: int, B: int) -> float:
    """Least time for the bytes the function must move: p and the targets
    read once, the indices written once."""
    return (4 * C + 8 * B) / HBM_BYTES_PER_S * 1e3


def stratified_targets(p: torch.Tensor, B: int, rng) -> torch.Tensor:
    """Targets as the device replay draws them: (b + u)·total/B, clamped."""
    total = torch.sum(p)
    u = torch.as_tensor(rng.random(B, dtype=np.float32), device=p.device)
    t = (torch.arange(B, device=p.device, dtype=torch.float32) + u) * (total / B)
    return torch.minimum(t, total * (1.0 - 1e-7)).contiguous()


def warm_ms(fn, iters: int = 100) -> float:
    """Device ms per call: a CUDA graph of ``iters`` calls, replayed."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):  # lazy set-up and allocations before capture
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def device_calls(fn, iters: int, flush: torch.Tensor | None) -> list[list]:
    """Profiles ``iters`` calls, each after an L2 flush, and returns each
    call's device activities as (name, start_us, end_us), flush left out."""
    if flush is None:
        flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(iters):
            torch.bitwise_not(flush, out=flush)
            fn()
        torch.cuda.synchronize()
    dev = sorted(
        ((e.name, e.time_range.start, e.time_range.end) for e in prof.events()
         if e.device_type == torch.autograd.DeviceType.CUDA),
        key=lambda a: a[1],
    )
    calls: list[list] = []
    for act in dev:
        if _FLUSH_OP in act[0]:
            calls.append([])
        elif calls:
            calls[-1].append(act)
    calls = [c for c in calls if c]
    if len(calls) != iters:
        raise RuntimeError(f"profiler saw device work for {len(calls)} of {iters} "
                           "calls: no device trace to time from")
    return calls


def cold_ms(fn, iters: int = 50, flush: torch.Tensor | None = None) -> float:
    """Device ms per call with L2 flushed before each call (profiler spans)."""
    calls = device_calls(fn, iters, flush)
    return sum(c[-1][2] - c[0][1] for c in calls) / len(calls) / 1e3


def host_us(fn, iters: int = 200) -> float:
    """Host µs per call, no synchronise inside the loop."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / iters * 1e6


def measure(fn, C: int, B: int, iters: int, flush) -> dict:
    cold = cold_ms(fn, iters, flush)
    return {"warm_ms": warm_ms(fn, 2 * iters), "cold_ms": cold,
            "roofline_share": bound_ms(C, B) / cold, "host_us": host_us(fn)}


PHASES = ("stage", "scan", "barrier", "offsets", "resolve")


def phase_us(p: torch.Tensor, t: torch.Tensor, iters: int, flush) -> dict:
    """When the slowest block finished each phase, µs after the first block
    started, for cold calls of the kernel built with its phase stamps."""
    from ape_x_dqn_tpu_torch.ops import sampling

    lib = sampling._library(("-DAPEX_SAMPLER_PHASES",))
    lib.apex_sample_phases.argtypes = [ctypes.c_void_p]
    num_sms = ctypes.c_int(0)
    if lib.apex_sample_setup(ctypes.byref(num_sms)) != 0:
        raise RuntimeError("phase build: setup failed")
    grid, slice_, tile = sampling.plan(p.shape[0], num_sms.value)
    scratch = torch.empty(grid, device="cuda")
    out = torch.empty(t.shape[0], dtype=torch.int32, device="cuda")
    stamps = np.zeros((sampling.MAX_GRID, len(PHASES) + 1), np.uint64)
    ends = []
    for _ in range(iters):
        torch.bitwise_not(flush, out=flush)
        err = lib.apex_sample_indices(p.data_ptr(), p.shape[0], t.data_ptr(),
                                      t.shape[0], grid, slice_, tile,
                                      scratch.data_ptr(), out.data_ptr(),
                                      torch.cuda.current_stream().cuda_stream)
        torch.cuda.synchronize()
        if err != 0 or lib.apex_sample_phases(stamps.ctypes.data) != 0:
            raise RuntimeError("phase build: launch or read-back failed")
        ns = stamps[:grid].astype(np.int64)
        ends.append((ns[:, 1:].max(axis=0) - ns[:, 0].min()) / 1e3)
    return dict(zip(PHASES, np.mean(ends, axis=0).tolist()))


def _load_parent(root: Path):
    path = root / "ape_x_dqn_tpu_torch" / "ops" / "sampling.py"
    spec = importlib.util.spec_from_file_location("parent_sampling", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="ape_x_dqn_tpu_torch.bench_sampler")
    ap.add_argument("--parent", type=Path, default=None,
                    help="unpacked earlier checkout to time beside this one")
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--phases", action="store_true",
                    help="also time the kernel's phases (stamped build)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_sampler needs a CUDA device")
    from ape_x_dqn_tpu_torch.ops import sampling

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    versions = {"this": sampling}
    if args.parent is not None:
        versions["parent"] = _load_parent(args.parent)
    order = ["parent", "this", "this", "parent"] if args.parent else ["this", "this"]
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    rng = np.random.default_rng(0)
    summary = []
    for C, B in SHAPES:
        p = torch.as_tensor(rng.random(C, dtype=np.float32), device="cuda")
        t = stratified_targets(p, B, rng)
        want = sampling.sample_indices_reference(p, t)
        for name, mod in versions.items():  # every version agrees before timing
            got = mod.sample_indices(p, t)
            if int((got.long() - want.long()).abs().max()) > 8:
                raise AssertionError(f"{name} disagrees with the plain version "
                                     f"at C={C} B={B}")
        row = {"C": C, "B": B, "card": smi, "bound_ms": bound_ms(C, B)}
        for turn, name in enumerate(order):
            mod = versions[name]
            r = measure(lambda: mod.sample_indices(p, t), C, B, args.iters, flush)
            print(json.dumps({"turn": turn, "version": name, **row, **r}), flush=True)
            row.setdefault(name, []).append(r)
        plain = measure(lambda: sampling.sample_indices_reference(p, t), C, B,
                        args.iters, flush)
        print(json.dumps({"version": "plain", **row, **plain}), flush=True)
        row["plain"] = plain
        if args.phases:
            row["phase_end_us"] = phase_us(p, t, args.iters, flush)
            print(json.dumps({"version": "this, phase ends (µs, cold)", "C": C, "B": B,
                              **row["phase_end_us"]}), flush=True)
        summary.append(row)
    print(json.dumps({"summary": [
        {k: (v if not isinstance(v, list) else
             {m: float(np.mean([x[m] for x in v])) for m in v[0]})
         for k, v in row.items()} for row in summary]}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
