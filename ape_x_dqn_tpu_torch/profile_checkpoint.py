"""What a checkpoint costs the learner on the card: the device dedup ring.

    python -m ape_x_dqn_tpu_torch.profile_checkpoint [--capacity C]
        [--interval ROWS] [--deltas N] [--workdir DIR] [--keep]

The port's twin of the JAX package's checkpoint-stall bench
(``bench.py:837``, ``_checkpoint_stall_bench``), measured where the port
keeps config3's replay: the frame-dedup ring of 2 000 000 slots on the
card (frame ratio 1.25: 17.64 GB of frames), with config3's learner
(sample-ahead K = 2048, bf16 ν and target, the conv network at full
width).  The ring is filled to half its slots through the learner's own
ingest (``add_chunk`` → ``ingest_staged``), then:

  * ``full_sync`` — one synchronous save of the train state and the ring
    as ``replay.npz`` (``utils/checkpoint.save_checkpoint(replay=...)``):
    the learner-visible stall, the bytes, and the seconds a fresh learner
    takes to restore it;
  * ``incremental`` — ``utils/checkpoint_inc.IncrementalCheckpointer``:
    the stall of the base's ``save()`` (the ring's copy to the host), then
    ``--deltas`` deltas, each after ``--interval`` ingested rows and one
    fused call: each ``save()``'s stall (the span gathers issued on the
    learner's stream and the hand-off; the copy to the host and the write
    are the writer thread's), each delta's bytes, and one delta at half
    the interval (bytes follow the interval, not the capacity); then the
    seconds a fresh learner takes to restore the chain, and a check that
    its ring equals the saved one on the card.

The disk (``--workdir``, default ``build/profile_checkpoint`` in the
checkout) and the host RAM are read first.  Where they cannot hold one
leg (the frames once on disk; about twice on the host), the capacity is
cut to what fits and the cut is printed: a cut, never a skip.  The first
line is the card's name and power limit (``nvidia-smi``), then one JSON
line per measurement.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import time

import numpy as np
import torch

OBS = (84, 84, 1)
FRAME_RATIO = 1.25
K = 2048


def _emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def _mem_available() -> int:
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) * 1024
    raise RuntimeError("no MemAvailable in /proc/meminfo")


def fit_capacity(want: int, disk_free: int, ram_free: int) -> tuple:
    """(capacity, cut reason or None): one leg's frames on disk (10 %
    slack, 1 GB spare), about 2.3 copies of them in host RAM (the host
    snapshot and its read-back; 4 GB spare)."""
    per_slot = FRAME_RATIO * int(np.prod(OBS))
    by_disk = int((disk_free * 0.9 - 1e9) / (per_slot * 1.1))
    by_ram = int((ram_free * 0.9 - 4e9) / (per_slot * 2.3))
    cap = min(want, by_disk, by_ram)
    if cap >= want:
        return want, None
    cap = max(cap // K * K, 2 * K)
    why = "disk" if by_disk <= by_ram else "ram"
    return cap, f"{why}: {disk_free} B free on disk, {ram_free} B available RAM"


def _config(capacity: int):
    from ape_x_dqn_tpu_torch.config import ApexConfig

    cfg = ApexConfig()
    cfg.network = "conv"
    cfg.env.name = "catch:84"
    cfg.replay.capacity = capacity
    cfg.replay.dedup = True
    cfg.replay.frame_ratio = FRAME_RATIO
    cfg.learner.device_replay = True
    cfg.learner.sample_ahead = True
    cfg.learner.steps_per_call = K
    cfg.learner.ingest_block = K
    cfg.learner.min_replay_mem_size = K
    cfg.learner.second_moment_dtype = "bfloat16"
    cfg.learner.target_dtype = "bfloat16"
    return cfg.validate()


def _learner(capacity: int):
    from ape_x_dqn_tpu_torch.runtime.components import build_components

    comps = build_components(_config(capacity), device="cuda")
    return comps.make_fused_learner()


class _Feeder:
    """Chunks of M transitions over M + 1 fresh frames (one source, no
    carries), the same seeded arrays every time."""

    def __init__(self, M: int = 4096, seed: int = 0):
        from ape_x_dqn_tpu_torch.types import DedupChunk

        r = np.random.default_rng(seed)
        self._chunk = DedupChunk(
            frames=r.integers(0, 255, (M + 1, *OBS), dtype=np.uint8),
            obs_ref=np.arange(M, dtype=np.int32),
            next_ref=np.arange(1, M + 1, dtype=np.int32),
            action=r.integers(0, 3, M).astype(np.int32),
            reward=r.normal(size=M).astype(np.float32),
            discount=np.full(M, 0.97, np.float32), source=1, chunk_seq=0,
            prev_frames=M + 1)
        self._prio = (np.abs(r.normal(size=M)) + 0.1).astype(np.float32)
        self._seq = 0
        self.M = M

    def __call__(self, learner, rows: int) -> None:
        for _ in range(max(1, rows // self.M)):
            learner.add_chunk(self._prio, self._chunk._replace(chunk_seq=self._seq))
            self._seq += 1
            learner.ingest_staged()
        learner.ingest_staged(drain=True)


def _ms(t0: float) -> float:
    return (time.perf_counter() - t0) * 1e3


def _dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(path) for f in files)


def run(capacity: int, interval: int, deltas: int, workdir: str, keep: bool) -> dict:
    from ape_x_dqn_tpu_torch.utils.checkpoint import restore_checkpoint, save_checkpoint
    from ape_x_dqn_tpu_torch.utils.checkpoint_inc import (
        IncrementalCheckpointer,
        load_incremental_replay,
    )

    os.makedirs(workdir, exist_ok=True)
    disk, ram = shutil.disk_usage(workdir).free, _mem_available()
    cap, cut = fit_capacity(capacity, disk, ram)
    _emit({"phase": "resources", "workdir": os.path.abspath(workdir), "disk_free_bytes": disk,
           "ram_available_bytes": ram, "capacity_wanted": capacity, "capacity": cap,
           "cut": cut})
    root = os.path.join(workdir, f"run_{os.getpid()}")
    feed = _Feeder()
    t0 = time.perf_counter()
    a = _learner(cap)
    feed(a, cap // 2)
    a.train(0.4)
    torch.cuda.synchronize()
    ring = a.replay
    _emit({"phase": "fill", "capacity": ring.capacity, "frame_capacity": ring.frame_capacity,
           "frames_bytes": ring.nbytes()["frames"], "occupancy": a.size,
           "seconds": (time.perf_counter() - t0)})
    out = {"capacity": cap, "cut": cut, "occupancy": a.size,
           "frames_bytes": ring.nbytes()["frames"], "interval_rows": interval}
    try:
        # -- the synchronous full save ------------------------------------
        full = os.path.join(root, "full")
        t0 = time.perf_counter()
        save_checkpoint(full, a.state, replay=a, generator=a.generator)
        full_ms = _ms(t0)
        full_bytes = _dir_bytes(full)
        b = _learner(cap)
        t0 = time.perf_counter()
        restore_checkpoint(full, b.state, replay=b, generator=b.generator)
        torch.cuda.synchronize()
        npz_restore_s = time.perf_counter() - t0
        shutil.rmtree(full)   # one leg on disk at a time
        out["full_sync"] = {"stall_ms": full_ms, "bytes": full_bytes,
                            "restore_s": npz_restore_s}
        _emit({"phase": "full_sync", **out["full_sync"]})

        # -- the incremental chain ----------------------------------------
        ck = IncrementalCheckpointer(root, a, base_every=64)
        t0 = time.perf_counter()
        assert ck.save(a.step)
        base_ms = _ms(t0)
        t0 = time.perf_counter()
        assert ck.flush(3600.0)
        base_write_s = time.perf_counter() - t0
        base_bytes = ck.stats()["last_chunk_bytes"]
        stalls, sizes = [], []
        for k in range(deltas + 1):
            rows = interval if k < deltas else interval // 2
            feed(a, rows)
            a.train(0.4)
            t0 = time.perf_counter()
            assert ck.save(a.step)
            stalls.append(_ms(t0))
            assert ck.flush(600.0)   # outside the stall: the writer's time
            sizes.append(ck.stats()["last_chunk_bytes"])
        ck.close()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step = load_incremental_replay(root, b)
        torch.cuda.synchronize()
        chain_restore_s = time.perf_counter() - t0
        same = (step == a.step and b.size == a.size
                and b.stager.shipped_f == a.stager.shipped_f
                and all(torch.equal(getattr(a.replay, f), getattr(b.replay, f))
                        for f in ("frames", "obs_ref", "next_ref", "action", "reward",
                                  "discount", "mass")))
        if not same:
            raise AssertionError("the chain's restore differs from the saved ring")
        out["incremental"] = {
            "base_stall_ms": base_ms, "base_write_s": base_write_s, "base_bytes": base_bytes,
            "delta_stall_ms": stalls[:-1], "delta_bytes": sizes[:-1],
            "half_interval_stall_ms": stalls[-1], "half_interval_bytes": sizes[-1],
            "restore_s": chain_restore_s, "restored_equal": same,
        }
        _emit({"phase": "incremental", **out["incremental"]})
        mean_stall = sum(stalls[:-1]) / max(len(stalls) - 1, 1)
        out["stall_reduction_x"] = full_ms / max(mean_stall, 1e-3)
        out["delta_vs_full_bytes_x"] = full_bytes / max(sum(sizes[:-1]) / max(deltas, 1), 1)
    finally:
        if not keep:
            shutil.rmtree(root, ignore_errors=True)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="ape_x_dqn_tpu_torch.profile_checkpoint",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--capacity", type=int, default=2_000_000)
    p.add_argument("--interval", type=int, default=65_536,
                   help="rows ingested between two deltas")
    p.add_argument("--deltas", type=int, default=3)
    p.add_argument("--workdir", default=os.path.join("build", "profile_checkpoint"))
    p.add_argument("--keep", action="store_true", help="keep the checkpoint files")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("profile_checkpoint measures the card: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    result = run(args.capacity, args.interval, args.deltas, args.workdir, args.keep)
    _emit({"phase": "summary", "card": smi, **result})
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
