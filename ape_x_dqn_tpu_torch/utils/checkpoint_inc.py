"""Incremental async replay checkpoints: the replay leg off the learner's
critical path.

Port of ``ape_x_dqn_tpu/utils/checkpoint_inc.py``; chunks and manifests are
written byte for byte as the JAX package writes them, so either package
restores the other's chain.  ``utils/checkpoint.save_checkpoint`` writes
the whole replay inline on the learner thread (17.64 GB for the 2M-slot
dedup ring); this module writes it as a chain instead:

  * **Dirty-span deltas.**  The rings write sequentially at cursors, so
    between saves only the span written since the last one changed, plus
    the restamped priorities.  The replay's protocol is
    ``delta_state_dict(force_base=False)`` (a base snapshot or a chained
    delta, both flat str→array dicts) and ``apply_delta_state_dict``.
    Every dict carries ``chain_mark`` (counters after) and a delta
    ``chain_prev`` (counters before), so a break in the chain raises.
  * **CRC-framed chunk files.**  Each base or delta is one
    ``chunk_<G>_<k>.ckpt``: ``APXC`` | u32 version | u32 flags | u64
    payload_len | u32 crc32, over an APXT array dict (the shm_ring codec).
    A torn or corrupted chunk fails its CRC and is never half-applied.
  * **Manifest last.**  ``MANIFEST.json`` is rewritten with fsync and
    ``os.replace`` after every chunk of the save is durable, and archived
    per generation for the restore's fallback walk.
  * **Async writer.**  ``save()`` on the learner thread only takes the
    snapshot; a writer thread materializes it, compresses, writes, fsyncs
    and commits.  A device snapshot (a dict with a ``ready`` CUDA event,
    as ``FusedDedupLearner.delta_state_dict`` returns) holds fresh device
    tensors gathered on the learner's stream: the writer waits on the
    event and copies them to the host on a stream of its own, so nothing
    on the learner thread waits for the device.  Backpressure: a save
    while one is in flight is refused (``inflight_skips``); the next delta
    covers the wider span.

Layout under ``<root>/replay_inc<suffix>/``:
    chunk_<G>_0.ckpt      — generation G's full base snapshot
    chunk_<G>_<k>.ckpt    — k-th delta after base G (k >= 1)
    MANIFEST.json         — atomic commit marker, written LAST

A tiered replay's base (``replay/tiered.py``) embeds its hot frames and
references every cold span by (offset, length, crc) into the spill file
(``tier_cold_*`` arrays) instead of reading the cold tier back in; the
restore verifies each referenced record, and a torn or drifted one is a
typed ``ColdSpanCorrupt`` (a ``ChunkCorrupt``), which the fallback walk
treats like a torn chunk.  The manifest carries ``cold_ref_bytes`` and the
``spill_file``.  Replays without the delta protocol write a full base at
every save, still off the learner thread.
"""

from __future__ import annotations

import json
import os
import struct
import threading
import time
import zlib
from typing import Optional

import numpy as np

# Stdlib + numpy + the shm_ring codecs: reading a chunk file imports no
# torch (torch is imported only to materialize a device snapshot).
from ape_x_dqn_tpu_torch.runtime.shm_ring import pack_array_parts, unpack_arrays

_CHUNK_MAGIC = b"APXC"
_CHUNK_VERSION = 1
_FLAG_ZLIB = 1
# magic 4s | u32 version | u32 flags | u64 payload_len | u32 crc32(payload)
_CHUNK_HDR = struct.Struct("<4sIIQI")

_MANIFEST = "MANIFEST.json"


class ChunkCorrupt(ValueError):
    """A chunk file failed its CRC / framing / decode check (torn,
    truncated, or bit-rotted).

    Typed so callers can ACT on it — the restore fallback walks back a
    generation, the supervisor counts it — instead of pattern-matching a
    raw ``struct.error``/``zlib.error`` message.  Carries the chunk
    ``path`` and, when the filename encodes one, the ``generation`` and
    chain ``index`` of the bad chunk.
    """

    def __init__(self, message: str, path: Optional[str] = None,
                 generation: Optional[int] = None,
                 index: Optional[int] = None):
        super().__init__(message)
        self.path = path
        if path is not None and (generation is None or index is None):
            g, k = _parse_chunk_name(os.path.basename(path))
            generation = generation if generation is not None else g
            index = index if index is not None else k
        self.generation = generation
        self.index = index


def inc_dir(root: str, suffix: str = "") -> str:
    return os.path.join(os.path.abspath(root), f"replay_inc{suffix}")


def _chunk_name(gen: int, idx: int) -> str:
    return f"chunk_{gen}_{idx}.ckpt"


def _parse_chunk_name(name: str):
    """(generation, index) from a ``chunk_<G>_<k>.ckpt`` basename, or
    (None, None) for anything else."""
    parts = name.split("_")
    if len(parts) == 3 and parts[0] == "chunk" and parts[2].endswith(".ckpt"):
        try:
            return int(parts[1]), int(parts[2][:-len(".ckpt")])
        except ValueError:
            pass
    return None, None


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _byte_view(part) -> memoryview:
    """A flat byte view of one packed part.  A zero-size array (an empty
    delta's index column) has no byte view to cast: it is ``b""``."""
    if isinstance(part, (bytes, bytearray)):
        return memoryview(part)
    arr = np.ascontiguousarray(part)
    return memoryview(arr).cast("B") if arr.size else memoryview(b"")


def write_chunk(path: str, arrays: dict, compress: bool = False) -> int:
    """Serialize a flat str→array dict as one CRC-framed chunk file
    (tmp + fsync + rename — a kill mid-write never leaves a torn file at
    the committed name).  Returns bytes written.  Uncompressed, the parts
    are checksummed and written in place, never joined: a base of the 2M
    dedup ring is 17.64 GB, and a joined copy would double its RAM."""
    parts = [_byte_view(p)
             for p in pack_array_parts({k: np.asarray(v) for k, v in arrays.items()})]
    flags = 0
    if compress:
        parts = [memoryview(zlib.compress(b"".join(parts), 1))]
        flags |= _FLAG_ZLIB
    crc = 0
    for p in parts:
        crc = zlib.crc32(p, crc)
    plen = sum(p.nbytes for p in parts)
    header = _CHUNK_HDR.pack(_CHUNK_MAGIC, _CHUNK_VERSION, flags, plen, crc)
    tmp = f"{path}.tmp"
    with open(tmp, "wb") as f:
        f.write(header)
        for p in parts:
            f.write(p)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return _CHUNK_HDR.size + plen


def read_chunk(path: str) -> dict:
    """Decode one chunk file back to its array dict; ``ChunkCorrupt`` (with
    the path + parsed generation attached) on a zero-length or header-only
    file, a truncated payload, a CRC mismatch, or any decode failure past
    the CRC — a corrupted chunk must surface as ONE typed error, never a
    raw struct/zlib/json traceback the caller cannot classify."""
    with open(path, "rb") as f:
        data = f.read()
    if len(data) < _CHUNK_HDR.size:
        raise ChunkCorrupt(
            f"{path}: truncated header ({len(data)} < {_CHUNK_HDR.size} "
            "bytes)", path=path,
        )
    magic, version, flags, plen, crc = _CHUNK_HDR.unpack_from(data, 0)
    if magic != _CHUNK_MAGIC:
        raise ChunkCorrupt(f"{path}: bad magic {magic!r}", path=path)
    if version != _CHUNK_VERSION:
        raise ChunkCorrupt(
            f"{path}: unsupported chunk version {version}", path=path
        )
    payload = memoryview(data)[_CHUNK_HDR.size:]   # no copy
    if len(payload) != plen:
        raise ChunkCorrupt(
            f"{path}: truncated payload ({len(payload)} != {plen} bytes)",
            path=path,
        )
    if zlib.crc32(payload) != crc:
        raise ChunkCorrupt(
            f"{path}: crc mismatch (torn or corrupted chunk)", path=path
        )
    try:
        if flags & _FLAG_ZLIB:
            payload = zlib.decompress(payload)
        return {k: np.array(v) for k, v in unpack_arrays(payload).items()}
    except ChunkCorrupt:
        raise
    except Exception as e:  # noqa: BLE001 — decode failure IS corruption
        raise ChunkCorrupt(
            f"{path}: undecodable payload past CRC "
            f"({type(e).__name__}: {e})", path=path,
        ) from e


def read_manifest(directory: str) -> Optional[dict]:
    path = os.path.join(directory, _MANIFEST)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def _archived_manifest_name(gen: int) -> str:
    return f"MANIFEST.gen{gen}.json"


def read_archived_manifest(directory: str, gen: int) -> Optional[dict]:
    """The per-generation manifest archive (written alongside every commit)
    — what the restore fallback walks when the live generation is bad."""
    path = os.path.join(directory, _archived_manifest_name(gen))
    if not os.path.exists(path):
        return None
    try:
        with open(path) as f:
            return json.load(f)
    except (ValueError, OSError):
        return None  # a torn archive is just a missing fallback rung


def _write_manifest(directory: str, manifest: dict) -> None:
    """fsync + os.replace: the atomic commit marker, written LAST.  The
    same record is also archived per generation (``MANIFEST.gen<G>.json``)
    so a later generation's corruption can walk back to this one."""
    path = os.path.join(directory, _MANIFEST)
    for target in (
        os.path.join(directory,
                     _archived_manifest_name(int(manifest["generation"]))),
        path,
    ):
        tmp = f"{target}.tmp"
        with open(tmp, "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, target)
    _fsync_dir(directory)


# Fallback restores recorded by load_incremental_replay (module-level so
# restores that happen before the supervisor exists — build_components —
# still reach its fallback_restores counter; the supervisor drains this
# at construction).
FALLBACK_EVENTS: list = []


def consume_fallback_events() -> list:
    """Drain-and-return the recorded degraded-restore events."""
    out, FALLBACK_EVENTS[:] = list(FALLBACK_EVENTS), []
    return out


def _note_fallback(on_event, **fields) -> dict:
    event = {"event": "degraded_restore", **fields}
    FALLBACK_EVENTS.append(event)
    try:
        from ape_x_dqn_tpu_torch.utils.metrics import emit_event

        emit_event("degraded_restore", **fields)
    except Exception:  # noqa: BLE001 — restore must not die on telemetry
        pass
    if on_event is not None:
        try:
            on_event(event)
        except Exception:  # noqa: BLE001 — a sick observer must not stop the restore
            pass
    return event


def _apply_chain(directory: str, replay, chunks: list) -> None:
    """Base + deltas in chain order; every failure is a typed
    ``ChunkCorrupt`` carrying the offending path (a manifest-referenced
    file that has gone missing counts — the chain is broken either way)."""
    head = os.path.join(directory, chunks[0])
    try:
        base = read_chunk(head)
    except FileNotFoundError as e:
        raise ChunkCorrupt(f"{head}: referenced chunk missing",
                           path=head) from e
    if "delta" in base:
        raise ChunkCorrupt(
            f"{chunks[0]}: generation head is a delta, not a base",
            path=head,
        )
    replay.load_state_dict(base)
    for name in chunks[1:]:
        path = os.path.join(directory, name)
        try:
            delta = read_chunk(path)
        except FileNotFoundError as e:
            raise ChunkCorrupt(f"{path}: referenced chunk missing",
                               path=path) from e
        replay.apply_delta_state_dict(delta)


def load_incremental_replay(root: str, replay, suffix: str = "",
                            fallback: bool = False,
                            on_event=None) -> Optional[int]:
    """Restore ``replay`` from the newest committed manifest under
    ``<root>/replay_inc<suffix>/``: base first, then every delta in chain
    order.  Returns the manifest's training step, or None when no committed
    chain exists.  A chunk the manifest references but that fails its CRC
    raises ``ChunkCorrupt`` (real corruption — never silently skipped);
    files beyond the manifest (an uncommitted tail from a killed writer)
    are ignored.

    ``fallback=True`` is the SUPERVISED restore: on a corrupt chunk it
    walks back — first to the live generation's longest good prefix (exact
    recovery to that delta's committed step, via the manifest's per-chunk
    ``chunk_steps``), then to prior generations' archived manifests — and
    records a structured ``degraded_restore`` event (JSONL +
    ``FALLBACK_EVENTS`` for the supervisor's counter) instead of crashing
    the resume.  Only when no committed rung restores does the original
    ``ChunkCorrupt`` surface.  Restores are never silently wrong: every
    accepted rung replayed through the same CRC-checked chain apply.
    """
    directory = inc_dir(root, suffix)
    manifest = read_manifest(directory)
    if manifest is None:
        return None
    chunks = manifest["chunks"]
    if not chunks:
        return None
    try:
        _apply_chain(directory, replay, chunks)
        return int(manifest.get("step", 0))
    except ChunkCorrupt as err:
        if not fallback:
            raise
        return _fallback_restore(directory, replay, manifest, err, on_event)


def _fallback_restore(directory: str, replay, manifest: dict,
                      err: ChunkCorrupt, on_event) -> int:
    chunks = list(manifest["chunks"])
    steps = manifest.get("chunk_steps")
    # Position of the bad chunk in the live chain (by path, the reliable
    # key — err.index is the filename's chain slot, identical for intact
    # names but absent on weird paths).
    bad_pos = None
    if err.path is not None:
        base_name = os.path.basename(err.path)
        if base_name in chunks:
            bad_pos = chunks.index(base_name)
    # Rung 1: the live generation's longest good prefix — only when the
    # manifest records per-chunk steps (otherwise the restored step would
    # be a guess, and a wrong step is a wrong-data load by another name).
    if bad_pos and steps and len(steps) == len(chunks):
        try:
            _apply_chain(directory, replay, chunks[:bad_pos])
            step = int(steps[bad_pos - 1])
            _note_fallback(
                on_event, fallback="partial_chain",
                directory=directory,
                generation=int(manifest["generation"]),
                chunks_dropped=len(chunks) - bad_pos,
                step=step, error=str(err),
            )
            return step
        except ChunkCorrupt as e2:
            err = e2
    # Rung 2: walk prior generations' archived manifests (pruning retains
    # one full prior generation for exactly this).
    gen = int(manifest["generation"]) - 1
    while gen >= 0:
        archived = read_archived_manifest(directory, gen)
        if archived is None or not archived.get("chunks"):
            break
        try:
            _apply_chain(directory, replay, archived["chunks"])
            step = int(archived.get("step", 0))
            _note_fallback(
                on_event, fallback="previous_generation",
                directory=directory, generation=gen,
                step=step, error=str(err),
            )
            return step
        except ChunkCorrupt:
            gen -= 1
    raise err


class IncrementalCheckpointer:
    """Owns one replay object's incremental checkpoint chain.

    ``save(step)`` runs on the learner thread: it takes the replay's
    base/delta snapshot (the bounded part) and hands it to the writer
    thread; serialization, compression, IO and the manifest commit happen
    there.  Returns False — and counts an ``inflight_skip`` — when the
    previous save is still being written (backpressure; the next delta
    covers the wider span).  ``sync=True`` writes inline on the caller
    (deterministic tests, final-save-at-exit callers).
    """

    def __init__(self, root: str, replay, suffix: str = "",
                 base_every: int = 16, compress: bool = False,
                 sync: bool = False, keep_generations: int = 2):
        self._dir = inc_dir(root, suffix)
        os.makedirs(self._dir, exist_ok=True)
        self._replay = replay
        self._base_every = max(1, int(base_every))
        self._compress = bool(compress)
        self._sync = bool(sync)
        # Generations retained on disk (current + fallback rungs): the
        # restore fallback can only walk back to a generation whose files
        # survived pruning.  2 = current + one committed predecessor.
        self._keep_generations = max(1, int(keep_generations))
        # Chain continuation: adopt the committed manifest's position.  The
        # first save() chains onto it only if the replay's own counters
        # still match its chain_mark (i.e. the replay was restored from
        # this very chain); any mismatch forces a fresh-generation base.
        self._manifest = read_manifest(self._dir)
        self.error: Optional[BaseException] = None
        # Stats (learner-thread reads; writer-thread increments are
        # int-assignments under the cv).
        self._stall_ms_total = 0.0
        self._last_stall_ms = 0.0
        self._saves = 0
        self._bases = 0
        self._deltas = 0
        self._inflight_skips = 0
        self._bytes_written = 0
        self._last_chunk_bytes = 0
        self._write_ms_total = 0.0
        self._job = None  # (arrays, step, is_base) awaiting the writer
        self._busy = False
        self._stop = False
        self._cv = threading.Condition()
        self._copy_stream = None  # the writer's stream for device snapshots
        self._thread = None
        if not self._sync:
            self._thread = threading.Thread(
                target=self._loop, name="ckpt-writer", daemon=True
            )
            self._thread.start()

    # -- learner side ------------------------------------------------------

    def save(self, step: int, force_base: bool = False) -> bool:
        """Snapshot + enqueue one base/delta.  Learner-visible stall is
        exactly the time spent in this call."""
        if self.error is not None:
            raise RuntimeError("checkpoint writer failed") from self.error
        t0 = time.perf_counter()
        with self._cv:
            if self._busy or self._job is not None:
                self._inflight_skips += 1
                return False
        # base_every counts DELTAS between full bases (a generation holds
        # 1 base + base_every deltas before the next base bounds the chain).
        base_due = (
            force_base
            or self._manifest is None
            or len(self._manifest["chunks"]) > self._base_every
        )
        arrays = self._snapshot(base_due)
        is_base = "delta" not in arrays
        if not is_base and not self._chains_onto_manifest(arrays):
            # The live replay does not continue the committed chain (a
            # fresh run over a stale dir) — restart with a base.
            arrays = self._snapshot(True)
            is_base = True
        if self._sync:
            self._write(arrays, int(step), is_base)
            if self.error is not None:
                raise RuntimeError("checkpoint writer failed") from self.error
        else:
            with self._cv:
                self._job = (arrays, int(step), is_base)
                self._cv.notify()
        stall = (time.perf_counter() - t0) * 1e3
        self._last_stall_ms = stall
        self._stall_ms_total += stall
        self._saves += 1
        return True

    def _snapshot(self, force_base: bool) -> dict:
        if hasattr(self._replay, "delta_state_dict"):
            return self._replay.delta_state_dict(force_base=force_base)
        # Degraded path (no delta protocol): full snapshot every save —
        # still async on the IO side.
        return dict(self._replay.state_dict())

    def _chains_onto_manifest(self, delta: dict) -> bool:
        if self._manifest is None:
            return False
        mark = self._manifest.get("chain_mark")
        if mark is None:
            return False
        prev = np.asarray(delta["chain_prev"]).reshape(-1)
        return prev.tolist() == list(mark)

    def flush(self, timeout: float = 600.0) -> bool:
        """Block until the writer has drained; False on timeout (the caller
        must surface it — an unwritten final save is silent data loss)."""
        if self._sync:
            return True
        deadline = time.monotonic() + timeout
        with self._cv:
            while (self._job is not None or self._busy) \
                    and time.monotonic() < deadline:
                self._cv.wait(timeout=0.1)
            done = self._job is None and not self._busy
        if self.error is not None:
            raise RuntimeError("checkpoint writer failed") from self.error
        return done

    def close(self, timeout: float = 600.0) -> None:
        if self._sync:
            return
        self.flush(timeout)
        with self._cv:
            self._stop = True
            self._cv.notify()
        self._thread.join(timeout=30.0)

    def stats(self) -> dict:
        return {
            "saves": self._saves,
            "bases": self._bases,
            "deltas": self._deltas,
            "inflight_skips": self._inflight_skips,
            "bytes_written": self._bytes_written,
            "last_chunk_bytes": self._last_chunk_bytes,
            "last_stall_ms": round(self._last_stall_ms, 3),
            "stall_ms_total": round(self._stall_ms_total, 3),
            "write_ms_total": round(self._write_ms_total, 3),
        }

    # -- writer side -------------------------------------------------------

    def _loop(self) -> None:
        while True:
            with self._cv:
                while self._job is None and not self._stop:
                    self._cv.wait()
                if self._job is None and self._stop:
                    return
                job, self._job = self._job, None
                self._busy = True
            try:
                self._write(*job)
            except BaseException as e:  # noqa: BLE001 — surfaced at next save
                self.error = e
            finally:
                with self._cv:
                    self._busy = False
                    self._cv.notify_all()

    def _write(self, arrays: dict, step: int, is_base: bool) -> None:
        t0 = time.perf_counter()
        # Materialize HERE: a device snapshot's copy to the host is the
        # expensive transfer the learner thread skipped.
        arrays = self._materialize(arrays)
        if is_base:
            gen = (0 if self._manifest is None
                   else int(self._manifest["generation"]) + 1)
            idx, chunks, chunk_steps = 0, [], []
        else:
            gen = int(self._manifest["generation"])
            chunks = list(self._manifest["chunks"])
            idx = len(chunks)
            prev_steps = self._manifest.get("chunk_steps")
            # Per-chunk steps power exact partial-chain fallback; a legacy
            # manifest without them just loses that rung (never guessed).
            chunk_steps = (
                list(prev_steps)
                if prev_steps is not None and len(prev_steps) == idx
                else None
            )
        name = _chunk_name(gen, idx)
        nbytes = write_chunk(os.path.join(self._dir, name), arrays,
                             compress=self._compress)
        chunks.append(name)
        if chunk_steps is not None:
            chunk_steps.append(int(step))
        mark = arrays.get("chain_mark")  # absent on replays without deltas
        manifest = {
            "version": 1,
            "generation": gen,
            "chunks": chunks,
            "chunk_steps": chunk_steps,
            "step": int(step),
            "chain_mark": (np.asarray(mark).reshape(-1).tolist()
                           if mark is not None else None),
            "bytes": nbytes,
        }
        if "tier_cold_lens" in arrays:
            # Tiered base: how much replay data lives only as cold-span refs
            # (the restore needs the spill file for it).
            hot = arrays.get("tier_hot_frames")
            frame_bytes = (int(np.prod(hot.shape[1:])) * hot.dtype.itemsize
                           if hot is not None and hot.ndim > 1 else 0)
            cold_frames = int(np.asarray(arrays["tier_cold_lens"]).sum())
            manifest["cold_ref_bytes"] = cold_frames * frame_bytes
            manifest["spill_file"] = bytes(np.asarray(
                arrays["tier_spill_path"], np.uint8)).decode()
        elif not is_base and self._manifest is not None \
                and "cold_ref_bytes" in self._manifest:
            # A delta rewrites the manifest; the generation's base still
            # references its cold spans, so the accounting carries.
            manifest["cold_ref_bytes"] = self._manifest["cold_ref_bytes"]
            manifest["spill_file"] = self._manifest.get("spill_file")
        _write_manifest(self._dir, manifest)  # the commit
        self._manifest = manifest
        if is_base:
            self._prune(gen)
            self._bases += 1
        else:
            self._deltas += 1
        self._bytes_written += nbytes
        self._last_chunk_bytes = nbytes
        self._write_ms_total += (time.perf_counter() - t0) * 1e3


    def _materialize(self, arrays: dict) -> dict:
        """Host numpy for every leaf.  A device snapshot's ``ready`` event
        marks its gathers done on the learner's stream; the copies then run
        on this thread's own stream (a pool stream does not wait for the
        learner's later work on the default stream)."""
        ready = getattr(arrays, "ready", None)
        if ready is not None:
            ready.synchronize()
        out = {}
        for k, v in arrays.items():
            if type(v).__module__.startswith("torch"):
                import torch

                if v.device.type == "cuda":
                    if self._copy_stream is None:
                        self._copy_stream = torch.cuda.Stream(v.device)
                    with torch.cuda.stream(self._copy_stream):
                        v = v.to("cpu")
                v = v.detach().numpy()
            out[k] = np.asarray(v)
        return out

    def _prune(self, live_gen: int) -> None:
        """Once the manifest names generation ``live_gen``, generations
        older than the retention horizon are removed — chunks AND archived
        manifests.  The newest ``keep_generations - 1`` predecessors stay
        on disk as the restore fallback's walk-back rungs."""
        horizon = live_gen - (self._keep_generations - 1)
        for name in os.listdir(self._dir):
            gen = None
            if name.startswith("chunk_"):
                try:
                    gen = int(name.split("_")[1])
                except (IndexError, ValueError):
                    continue
            elif name.startswith("MANIFEST.gen") and name.endswith(".json"):
                try:
                    gen = int(name[len("MANIFEST.gen"):-len(".json")])
                except ValueError:
                    continue
            if gen is not None and gen < horizon:
                try:
                    os.unlink(os.path.join(self._dir, name))
                except OSError:
                    pass
