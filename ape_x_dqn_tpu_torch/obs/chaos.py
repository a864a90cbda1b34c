"""Deterministic, seed-driven fault injection — the chaos half of the
fault-tolerance contract.

The port's copy of ``ape_x_dqn_tpu/obs/chaos.py``: the same injectors and
the same seeded streams (schedule, victims, jitter: ``random.Random``
seeded as there), so a chaos run of the port draws the JAX package's fault
sequence for the same config and seed.  Its targets are the port's: the
process pool of ``runtime/process_actors``, ``runtime/shm_ring`` rings and
``utils/checkpoint_inc`` chunks, and the ``replay/service.py`` fleet that
``attach(replay_fleet=...)`` names (``kill_shard``: the same seeded victim
as the JAX package; without a fleet it records "no replay fleet
attached").

The supervision tier (runtime/supervisor.py) claims the fleet survives
any single component dying; this module is how that claim gets TESTED
instead of asserted.  Every fault the production postmortems have actually
seen has an injector here:

  * **SIGKILL / SIGSTOP a worker** — the process-actor death shapes the
    salvage + respawn discipline exists for.
  * **Torn shm-ring record** — an uncommitted record scribbled at a dead
    worker's write cursor: the deterministic twin of "killed mid-write"
    (the real kill only tears a record if it lands inside the microseconds
    of a ring write; the injector makes the torn-tail path run every time).
    Only ever applied to a ring whose writer is already dead — scribbling
    under a live writer would corrupt the SPSC discipline itself.
  * **Corrupted APXC chunk** — one byte flipped (or the file truncated) in
    a committed checkpoint chunk: the restore fallback's trigger.
  * **Stuck stager / slow env / /dev/shm pressure** — liveness and
    capacity faults: a gate the ingest stager polls, a latency wrapper
    around worker envs, a transient shared-memory allocation.

``ChaosMonkey`` sequences these on a schedule derived entirely from
``chaos.seed`` (config.ChaosConfig): same seed, same fault times, same
victims — a failing chaos soak reproduces.  All injectors are also usable
directly.

Import-light by contract (stdlib + numpy + shm_ring, never torch): the
latency wrapper runs inside worker children, and the monkey's thread never
touches the card.
"""

from __future__ import annotations

import os
import random
import signal
import threading
import time
from typing import List, Optional

# ---------------------------------------------------------------------------
# One-shot injectors
# ---------------------------------------------------------------------------


def inject_torn_record(ring, garbage_bytes: int = 64,
                       rng: Optional[random.Random] = None) -> dict:
    """Scribble one STARTED-but-never-committed record at ``ring``'s write
    cursor — what a SIGKILL lands mid-``ShmRing.write`` leaves behind.

    Bumps the writer's ``started`` counter and writes a garbage header +
    payload with a non-matching commit word, so the reader's seq check
    rejects it forever and ``torn_tail()`` reports True at salvage.  The
    caller must guarantee the writer is DEAD (this writes into the ring's
    free region from outside the single-writer discipline).
    """
    from ape_x_dqn_tpu_torch.runtime.shm_ring import _OFF_STARTED, _REC

    rng = rng or random.Random(0)
    started = ring._get(_OFF_STARTED)
    ring._set(_OFF_STARTED, started + 1)
    widx = ring.committed_bytes
    free = ring.capacity - (widx - ring._reader_cursor())
    n = max(0, min(int(garbage_bytes), free - _REC.size))
    if free >= _REC.size:
        # A plausible half-written frame: valid-looking length, garbage
        # crc, and a STALE seq (0 can never be the next expected record).
        ring._copy_in(widx, _REC.pack(n, rng.getrandbits(32), 0))
        if n:
            ring._copy_in(
                widx + _REC.size, bytes(rng.getrandbits(8) for _ in range(n))
            )
    return {"fault": "torn_record", "ring": ring.name,
            "started": started + 1, "garbage_bytes": n}


def corrupt_chunk(path: str, mode: str = "bitflip",
                  rng: Optional[random.Random] = None) -> dict:
    """Damage one committed chunk file in a detectable way.

    ``bitflip`` flips a single payload bit (CRC mismatch), ``truncate``
    cuts the file to header-only (truncated payload), ``zero`` empties it
    (truncated header).  All three must surface as ``ChunkCorrupt`` at
    read time — tests/test_torch_chaos.py pins that.
    """
    rng = rng or random.Random(0)
    size = os.path.getsize(path)
    if mode == "bitflip":
        # Past the 20-byte APXC header so the flip lands in the payload.
        off = 20 + rng.randrange(max(1, size - 20)) if size > 20 else 0
        with open(path, "r+b") as f:
            f.seek(off)
            byte = f.read(1)
            f.seek(off)
            f.write(bytes([byte[0] ^ (1 << rng.randrange(8))]))
    elif mode == "truncate":
        with open(path, "r+b") as f:
            f.truncate(min(size, 20))
    elif mode == "zero":
        with open(path, "r+b") as f:
            f.truncate(0)
    else:
        raise ValueError(f"unknown corruption mode: {mode}")
    return {"fault": "corrupt_chunk", "path": path, "mode": mode,
            "orig_bytes": size}


def pick_chunk(inc_dir: str, rng: Optional[random.Random] = None,
               prefer: str = "any") -> Optional[str]:
    """A committed chunk file under one ``replay_inc*`` dir (seeded
    choice).  ``prefer`` narrows to ``"base"`` (``chunk_<G>_0``) or
    ``"delta"`` chunks of the manifest's live generation."""
    import json

    rng = rng or random.Random(0)
    manifest_path = os.path.join(inc_dir, "MANIFEST.json")
    if not os.path.exists(manifest_path):
        return None
    try:
        with open(manifest_path) as f:
            chunks = json.load(f)["chunks"]
    except (ValueError, KeyError, OSError):
        return None
    if prefer == "base":
        chunks = chunks[:1]
    elif prefer == "delta":
        chunks = chunks[1:]
    chunks = [c for c in chunks
              if os.path.exists(os.path.join(inc_dir, c))]
    if not chunks:
        return None
    return os.path.join(inc_dir, rng.choice(chunks))


class RpcChaos:
    """Seeded fault injection for the replay-service RPC plane
    (replay/service.py — config ``chaos.rpc_delay_ms`` /
    ``chaos.rpc_drop_rate``).

    Installed shard-side: ``delay_s()`` is consulted before every request
    executes (mean ``delay_ms`` with ±50% seeded jitter — sleeping the
    shard's pump thread IS the fault: every queued request behind it
    waits too, the slow-replay shape the client's deadline exists for);
    ``drop()`` decides whether a well-framed request is silently
    discarded (no reply — the lost-reply shape that forces the client's
    whole-request retry and proves the at-most-once add dedup).  Both
    streams are pure functions of the seed, so a failing run reproduces.
    """

    def __init__(self, delay_ms: float = 0.0, drop_rate: float = 0.0,
                 seed: int = 0):
        self.delay_ms = float(delay_ms)
        self.drop_rate = float(drop_rate)
        self._rng = random.Random(seed ^ 0x69C)
        self.delays = 0
        self.drops = 0

    def delay_s(self) -> float:
        if self.delay_ms <= 0:
            return 0.0
        self.delays += 1
        return self.delay_ms * (0.5 + self._rng.random()) / 1e3

    def drop(self) -> bool:
        if self.drop_rate <= 0:
            return False
        hit = self._rng.random() < self.drop_rate
        self.drops += int(hit)
        return hit


class SlowEnv:
    """Env wrapper injecting seeded per-step latency (the slow-emulator
    scenario).  Delegates everything else to the wrapped env."""

    def __init__(self, env, latency_s: float, seed: int = 0):
        self._env = env
        self._latency_s = float(latency_s)
        self._rng = random.Random(seed)

    def __getattr__(self, name):
        return getattr(self._env, name)

    def reset(self, *a, **kw):
        return self._env.reset(*a, **kw)

    def step(self, *a, **kw):
        # Mean latency_s with +/-50% seeded jitter: slow, not metronomic.
        time.sleep(self._latency_s * (0.5 + self._rng.random()))
        return self._env.step(*a, **kw)


class ShmFiller:
    """Transient /dev/shm pressure: allocate a shared-memory segment of
    ``nbytes`` and hold it until ``release()``.  Allocation failure is the
    fault succeeding differently (the filesystem is ALREADY exhausted) —
    reported, never raised."""

    def __init__(self):
        self._seg = None
        # The monkey's thread, ``stop`` and a caller's ``execute`` may fill
        # and release at once: a fill read back a segment another thread
        # had just released (AttributeError on None; the JAX copy can also
        # unlink None there).
        self._lock = threading.Lock()

    def fill(self, nbytes: int) -> dict:
        with self._lock:
            self._release_locked()
            try:
                from ape_x_dqn_tpu_torch.runtime.shm_ring import create_shared_memory

                seg = create_shared_memory("chaosfill", max(1, int(nbytes)))
                self._seg = seg
                # Touch the pages so tmpfs actually commits them.
                seg.buf[::4096] = b"\xff" * len(seg.buf[::4096])
                return {"fault": "shm_fill", "bytes": int(nbytes), "name": seg.name}
            except OSError as e:
                return {"fault": "shm_fill", "bytes": int(nbytes),
                        "failed": f"{type(e).__name__}: {e}"}

    def release(self) -> None:
        with self._lock:
            self._release_locked()

    def _release_locked(self) -> None:
        seg, self._seg = self._seg, None
        if seg is not None:
            try:
                seg.close()
                seg.unlink()
            except (OSError, FileNotFoundError):
                pass


# ---------------------------------------------------------------------------
# The scheduled monkey
# ---------------------------------------------------------------------------


class ChaosMonkey:
    """Seed-driven fault scheduler over one training run.

    Each enabled fault kind fires on its own cadence
    (``interval * (0.5 + u)`` between events, ``u`` from the seeded rng),
    merged into one deterministic timeline.  Victims (which worker, which
    chunk, which byte) come from the same rng, so the whole fault sequence
    is a pure function of ``(config, seed)``.

    Targets are late-bound: ``attach(pool=..., ckpt_dirs=...,
    stager_gate=...)`` — the tools construct the monkey before the
    pipeline exists.  Every executed fault lands in ``self.log`` (a
    bounded list of dicts), on the optional metrics registry
    (``chaos/<kind>`` counters), and through the optional ``emit``
    callback (the JSONL stream).
    """

    KINDS = ("kill", "sigstop", "torn_record", "corrupt_chunk",
             "stuck_stager", "shm_fill", "kill_shard")

    def __init__(self, cfg, registry=None, emit=None,
                 horizon_s: float = 3600.0):
        self.cfg = cfg
        self._emit = emit
        self.log: List[dict] = []
        self._counters = {}
        if registry is not None:
            for kind in self.KINDS:
                self._counters[kind] = registry.counter(
                    f"chaos/{kind}", help=f"injected {kind} faults"
                )
            registry.register_provider("chaos", self.state)
        self._rng = random.Random(int(cfg.seed) ^ 0xC4405)
        self.schedule = self._build_schedule(float(horizon_s))
        self._pool = None
        self._replay_fleet = None   # ReplayServiceFleet (kill_shard kind)
        self._ckpt_dirs: List[str] = []
        self._stager_stall = threading.Event()
        self._filler = ShmFiller()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._t0: Optional[float] = None

    # -- schedule (pure function of config + seed) -------------------------

    def _build_schedule(self, horizon_s: float) -> List[tuple]:
        intervals = {
            "kill": self.cfg.kill_interval_s,
            "sigstop": self.cfg.sigstop_interval_s,
            "torn_record": self.cfg.torn_record_interval_s,
            "corrupt_chunk": self.cfg.corrupt_chunk_interval_s,
            "stuck_stager": self.cfg.stuck_stager_interval_s,
            "shm_fill": self.cfg.shm_fill_interval_s,
            "kill_shard": getattr(self.cfg, "kill_shard_interval_s", 0.0),
        }
        events: List[tuple] = []
        for kind in self.KINDS:  # fixed order: determinism
            mean = float(intervals[kind])
            if mean <= 0:
                continue
            t = 0.0
            while True:
                t += mean * (0.5 + self._rng.random())
                if t > horizon_s:
                    break
                events.append((round(t, 4), kind))
        events.sort()
        return events

    # -- wiring ------------------------------------------------------------

    def attach(self, pool=None, ckpt_dirs=None,
               replay_fleet=None) -> "ChaosMonkey":
        self._pool = pool if pool is not None else self._pool
        if ckpt_dirs:
            self._ckpt_dirs = list(ckpt_dirs)
        if replay_fleet is not None:
            self._replay_fleet = replay_fleet
        return self

    def stager_stalled(self) -> bool:
        """Polled by the ingest stager's loop (the stuck-stager gate)."""
        return self._stager_stall.is_set()

    def state(self) -> dict:
        by_kind = {}
        for rec in self.log:
            by_kind[rec["fault"]] = by_kind.get(rec["fault"], 0) + 1
        return {
            "scheduled": len(self.schedule),
            "executed": len(self.log),
            "by_kind": by_kind,
            "stager_stalled": self._stager_stall.is_set(),
        }

    def counts(self) -> dict:
        return dict(self.state()["by_kind"])

    # -- execution ---------------------------------------------------------

    def start(self) -> "ChaosMonkey":
        if self._thread is None:
            self._t0 = time.monotonic()
            self._thread = threading.Thread(
                target=self._loop, name="chaos-monkey", daemon=True
            )
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        self._stager_stall.clear()
        self._filler.release()
        if self._thread is not None:
            self._thread.join(timeout=10.0)

    def _loop(self) -> None:
        for t, kind in self.schedule:
            while not self._stop.is_set():
                delay = self._t0 + t - time.monotonic()
                if delay <= 0:
                    break
                time.sleep(min(delay, 0.1))
            if self._stop.is_set():
                return
            self.execute(kind)

    def _record(self, rec: dict) -> dict:
        rec = {"t": round(time.monotonic() - (self._t0 or 0.0), 3), **rec}
        self.log.append(rec)
        if len(self.log) > 4096:
            del self.log[:1024]
        c = self._counters.get(rec.get("fault"))
        if c is not None:
            c.inc()
        if self._emit is not None:
            try:
                self._emit("chaos_fault", **rec)
            except Exception:  # noqa: BLE001 — telemetry never blocks chaos
                pass
        return rec

    def _live_workers(self) -> List[tuple]:
        if self._pool is None:
            return []
        out = []
        for wid, p in enumerate(self._pool._procs):
            if p is not None and p.is_alive() and p.pid:
                out.append((wid, p))
        return out

    # Public so callers (soak scripts, chip_smoke.py) can force individual
    # faults on top of — or instead of — the schedule.
    def execute(self, kind: str) -> Optional[dict]:
        try:
            if kind == "kill":
                return self._do_kill(torn=False)
            if kind == "torn_record":
                return self._do_kill(torn=True)
            if kind == "sigstop":
                return self._do_sigstop()
            if kind == "corrupt_chunk":
                return self._do_corrupt_chunk()
            if kind == "stuck_stager":
                return self._do_stuck_stager()
            if kind == "shm_fill":
                return self._do_shm_fill()
            if kind == "kill_shard":
                return self._do_kill_shard()
        except Exception as e:  # noqa: BLE001 — a failed injection is data
            return self._record(
                {"fault": kind, "failed": f"{type(e).__name__}: {e}"}
            )
        return None

    def _do_kill(self, torn: bool) -> Optional[dict]:
        victims = self._live_workers()
        if not victims:
            return self._record({"fault": "torn_record" if torn else "kill",
                                 "skipped": "no live workers"})
        wid, proc = victims[self._rng.randrange(len(victims))]
        ring = self._pool._rings.get(wid)  # THIS incarnation's ring
        os.kill(proc.pid, signal.SIGKILL)
        proc.join(timeout=10.0)  # the ring writer must be gone before we
        rec = {"fault": "kill", "worker": wid, "pid": proc.pid}
        if torn:
            # ... scribble its torn tail (dead-writer precondition) — but
            # only if the supervisor has not already salvaged + respawned:
            # the replacement ring has a LIVE writer, off limits.
            if ring is not None and self._pool._rings.get(wid) is ring:
                rec = {**inject_torn_record(ring, rng=self._rng),
                       "worker": wid, "pid": proc.pid}
            else:
                rec["torn_skipped"] = "incarnation already retired"
        return self._record(rec)

    def _do_sigstop(self) -> Optional[dict]:
        victims = self._live_workers()
        if not victims:
            return self._record({"fault": "sigstop",
                                 "skipped": "no live workers"})
        wid, proc = victims[self._rng.randrange(len(victims))]
        hold = float(self.cfg.sigstop_hold_s)
        try:
            os.kill(proc.pid, signal.SIGSTOP)
            self._stop.wait(hold)
        finally:
            try:
                os.kill(proc.pid, signal.SIGCONT)
            except ProcessLookupError:
                pass  # reaped while stopped (supervisor saw it dead)
        return self._record({"fault": "sigstop", "worker": wid,
                             "pid": proc.pid, "hold_s": hold})

    def _do_corrupt_chunk(self) -> Optional[dict]:
        for root in self._ckpt_dirs:
            for name in sorted(os.listdir(root)) if os.path.isdir(root) else []:
                if not name.startswith("replay_inc"):
                    continue
                path = pick_chunk(os.path.join(root, name), rng=self._rng)
                if path is not None:
                    return self._record(corrupt_chunk(path, rng=self._rng))
        return self._record({"fault": "corrupt_chunk",
                             "skipped": "no committed chunks"})

    def _do_stuck_stager(self) -> dict:
        hold = float(self.cfg.stuck_stager_hold_s)
        self._stager_stall.set()
        self._stop.wait(hold)
        self._stager_stall.clear()
        return self._record({"fault": "stuck_stager", "hold_s": hold})

    def _do_kill_shard(self) -> Optional[dict]:
        """SIGKILL one live replay-service shard (seeded victim) — the
        mid-run shard-death drill the fleet's respawn + checkpoint-chain
        recovery exists for (replay/service.py)."""
        fleet = self._replay_fleet
        if fleet is None:
            return self._record({"fault": "kill_shard",
                                 "skipped": "no replay fleet attached"})
        return self._record(fleet.kill_random(rng=self._rng))

    def _do_shm_fill(self) -> dict:
        rec = self._filler.fill(int(self.cfg.shm_fill_bytes))
        self._stop.wait(float(self.cfg.shm_fill_hold_s))
        self._filler.release()
        return self._record({**rec, "hold_s": float(self.cfg.shm_fill_hold_s)})
