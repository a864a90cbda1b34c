"""The flight-data recorder: a run's fleet timeline on disk (port of
``ape_x_dqn_tpu/obs/timeline.py``; the files are the JAX package's, byte
for byte, and each package reads the other's).

The rollup of :class:`~ape_x_dqn_tpu_torch.obs.fleet.FleetAggregator`
serves only its newest sweep, and the SLO engine's windows live in its
memory.  This store keeps the sweeps: a bounded ring of snapshots on disk
that the aggregator appends one compacted record to per sweep, with
windowed queries that re-aggregate any span exactly as the live rollup
does.

Disk format:

  * **Records**: each sweep is one CRC-framed record::

        4s TIMELINE_MAGIC "APXL" | u32 version | u32 flags
        | u64 payload_len | u32 crc32(payload)      + payload

    the ``utils/checkpoint_inc`` header layout over a JSON payload
    (flags bit 0: zlib).  A torn or corrupt tail (a SIGKILL mid-append)
    fails its CRC and is dropped at the frame boundary, never half
    parsed.
  * **Segments and generations**: records append to the active
    ``tl_<G>.seg``; at ``segment_bytes`` the segment is fsynced and
    committed into ``MANIFEST.json`` (tmp, fsync, ``os.replace``: the
    manifest last), and a new generation opens.  Past ``max_bytes`` the
    oldest generations are pruned.  A reopened store adopts the previous
    incarnation's uncommitted tail (CRC-checked), commits it, and starts
    its own generation.

Delta compaction: cumulative histograms are stored as per-sweep bucket
deltas (clamped at zero, ``_BucketWindow.feed``'s arithmetic) and
cumulative counters as per-sweep deltas; a windowed query sums the deltas
with ``merge_bucket_dicts`` and takes percentiles with
``bucket_percentile``, the two functions the live window uses, so a
window read from disk equals the live one by construction.

Each record also carries every SLO rule's (value, violated, state), so
:meth:`TimelineStore.rebuild_slo` refills a restarted engine's windows
and states instead of opening a blind window that clears a live breach.

Import-light, like ``obs/fleet.py``: stdlib at module scope.
"""

from __future__ import annotations

import json
import os
import struct
import threading
import time
import zlib
from collections import deque
from typing import Dict, Iterable, List, Optional, Tuple

from ape_x_dqn_tpu_torch.runtime.net import TIMELINE_MAGIC
from ape_x_dqn_tpu_torch.utils.metrics import bucket_percentile, merge_bucket_dicts

# Record framing: the utils/checkpoint_inc header layout (magic |
# version | flags | payload_len | crc32) over a JSON payload.
_REC_HDR = struct.Struct("<4sIIQI")
_REC_VERSION = 1
_FLAG_ZLIB = 1
_COMPRESS_MIN = 512        # don't zlib tiny payloads
_MANIFEST = "MANIFEST.json"

#: rollup cumulative-histogram sources → timeline hist keys (seconds
#: edges, the merge_bucket_dicts vocabulary).
_HIST_KEYS = ("age_s", "serving_s", "replay_op_s")
#: rollup cumulative-counter sources → timeline counter keys.
_COUNTER_KEYS = ("serving_replies", "replay_added", "scrapes",
                 "scrape_failures")


class TimelineCorrupt(ValueError):
    """A timeline segment failed framing/CRC/decode verification."""


def _fsync_dir(path: str) -> None:
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _frame(record: dict, compress: bool) -> bytes:
    payload = json.dumps(record, separators=(",", ":")).encode("utf-8")
    flags = 0
    if compress and len(payload) >= _COMPRESS_MIN:
        payload = zlib.compress(payload, 1)
        flags |= _FLAG_ZLIB
    hdr = _REC_HDR.pack(TIMELINE_MAGIC, _REC_VERSION, flags, len(payload),
                        zlib.crc32(payload) & 0xFFFFFFFF)
    return hdr + payload


def read_segment(path: str) -> Tuple[List[dict], int]:
    """Decode one segment file: (records, torn).  ``torn`` is 1 when the
    file ends in bytes that fail framing or CRC — a SIGKILL mid-append
    leaves exactly one torn tail; like the net planes, a byte stream
    cannot resync past a corrupt header, so decoding stops there and the
    damage is bounded at the frame boundary."""
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError:
        return [], 0
    out: List[dict] = []
    off = 0
    n = len(data)
    while off < n:
        if off + _REC_HDR.size > n:
            return out, 1
        magic, version, flags, plen, crc = _REC_HDR.unpack_from(data, off)
        if magic != TIMELINE_MAGIC or version != _REC_VERSION \
                or off + _REC_HDR.size + plen > n:
            return out, 1
        payload = data[off + _REC_HDR.size: off + _REC_HDR.size + plen]
        if zlib.crc32(payload) & 0xFFFFFFFF != crc:
            return out, 1
        try:
            if flags & _FLAG_ZLIB:
                payload = zlib.decompress(payload)
            rec = json.loads(payload.decode("utf-8"))
        except (ValueError, zlib.error):
            return out, 1
        if isinstance(rec, dict):
            out.append(rec)
        off += _REC_HDR.size + plen
    return out, 0


def read_timeline(dir_path: str) -> dict:
    """Read-only load of a run's whole timeline (the ``obs_top
    --timeline`` / ``obs_diff`` entry point): records in append order
    across every generation — committed segments in manifest order,
    then any uncommitted tail segments — plus torn/segment counts."""
    records: List[dict] = []
    torn = 0
    seen: set = set()
    manifest_segments: List[dict] = []
    try:
        with open(os.path.join(dir_path, _MANIFEST), encoding="utf-8") as f:
            manifest_segments = list(json.load(f).get("segments") or [])
    except (OSError, ValueError):
        pass
    paths: List[str] = []
    for seg in manifest_segments:
        name = seg.get("file")
        if name:
            paths.append(os.path.join(dir_path, name))
            seen.add(name)
    try:
        extra = sorted(
            name for name in os.listdir(dir_path)
            if name.startswith("tl_") and name.endswith(".seg")
            and name not in seen
        )
    except OSError:
        extra = []
    paths.extend(os.path.join(dir_path, name) for name in extra)
    for path in paths:
        recs, t = read_segment(path)
        records.extend(recs)
        torn += t
    records.sort(key=lambda r: r.get("t", 0.0))
    return {"records": records, "torn": torn, "segments": len(paths)}


def _delta_map(prev: dict, cur: dict) -> dict:
    """Per-key ``max(0, cur - prev)`` — the _BucketWindow clamp: an
    endpoint respawn that reset its cumulative counters loses at most
    its own window contribution, never corrupts the sum."""
    return {
        k: max(0, int(v) - int(prev.get(k, 0)))
        for k, v in (cur or {}).items()
    }


class TimelineStore:
    """Bounded on-disk snapshot ring + windowed queries.  See the module
    docstring for the format; construction opens (or adopts) the store
    under ``dir_path`` and starts a fresh generation."""

    def __init__(self, dir_path: str, *, max_bytes: int = 16 << 20,
                 segment_bytes: int = 1 << 20, tail_keep_s: float = 600.0,
                 compress: bool = True):
        if segment_bytes <= 0 or max_bytes < segment_bytes:
            raise ValueError(
                "timeline needs 0 < segment_bytes <= max_bytes"
            )
        self.dir = str(dir_path)
        self._max_bytes = int(max_bytes)
        self._segment_bytes = int(segment_bytes)
        self._tail_keep_s = float(tail_keep_s)
        self._compress = bool(compress)
        self._lock = threading.Lock()
        self._segments: List[dict] = []   # committed: {gen,file,records,t0,t1,bytes}
        self._f = None
        self._gen = 0
        self._active_bytes = 0
        self._active_records = 0
        self._active_t0: Optional[float] = None
        self._active_t1: Optional[float] = None
        # In-memory tail: (t, record) within tail_keep_s of the newest —
        # where windowed queries and the SLO rebuild read from without
        # touching disk on the sweep path.
        self._tail: deque = deque()
        self._t_first: Optional[float] = None
        # Delta-compaction state (cumulative marks from the last sweep).
        self._prev_hist: Dict[str, dict] = {}
        self._prev_counters: Dict[str, int] = {}
        # Counters (the `timeline` /varz section).
        self.appends = 0
        self.rotations = 0
        self.prunes = 0
        self.torn_records = 0
        self.adopted_records = 0
        self.rebuilds = 0
        self._open()

    # -- open / adopt ------------------------------------------------------

    def _open(self) -> None:
        os.makedirs(self.dir, exist_ok=True)
        try:
            with open(os.path.join(self.dir, _MANIFEST),
                      encoding="utf-8") as f:
                self._segments = list(json.load(f).get("segments") or [])
        except (OSError, ValueError):
            self._segments = []
        committed = {s.get("file") for s in self._segments}
        max_gen = max([int(s.get("gen", 0)) for s in self._segments] or [0])
        # Adopt a dead incarnation's uncommitted tail segments: verify
        # (CRC, torn tail dropped) and commit them, so a respawn loses at
        # most the single torn record, never the window.
        try:
            orphans = sorted(
                name for name in os.listdir(self.dir)
                if name.startswith("tl_") and name.endswith(".seg")
                and name not in committed
            )
        except OSError:
            orphans = []
        adopted: set = set()
        for name in orphans:
            path = os.path.join(self.dir, name)
            recs, torn = read_segment(path)
            self.torn_records += torn
            adopted.add(name)
            try:
                gen = int(name[3:-4])
            except ValueError:
                gen = max_gen + 1
            max_gen = max(max_gen, gen)
            if not recs:
                try:
                    os.unlink(path)
                except OSError:
                    pass
                continue
            self.adopted_records += len(recs)
            self._segments.append({
                "gen": gen, "file": name, "records": len(recs),
                "t0": recs[0].get("t"), "t1": recs[-1].get("t"),
                "bytes": os.path.getsize(path),
            })
        self._segments.sort(key=lambda s: int(s.get("gen", 0)))
        if orphans:
            self._commit_manifest()
        # Seed the in-memory tail from the committed history so queries
        # and the SLO rebuild see the pre-respawn window immediately.
        records: List[dict] = []
        for seg in self._segments:
            recs, torn = read_segment(os.path.join(self.dir, seg["file"]))
            if seg["file"] not in adopted:
                # An adopted segment's torn tail was counted above; the
                # JAX store counts it a second time here.
                self.torn_records += torn
            records.extend(recs)
        records.sort(key=lambda r: r.get("t", 0.0))
        if records:
            self._t_first = float(records[0].get("t", 0.0))
            newest = float(records[-1].get("t", 0.0))
            for rec in records:
                t = float(rec.get("t", 0.0))
                if t >= newest - self._tail_keep_s:
                    self._tail.append((t, rec))
            # Resume delta marks from the newest record's cumulative
            # echo so the first post-respawn delta is vs the last
            # PERSISTED sweep, not vs zero (which would double-count the
            # whole run into one delta).
            cum = records[-1].get("cum") or {}
            self._prev_hist = {k: dict(v) for k, v in
                               (cum.get("hist") or {}).items()}
            self._prev_counters = dict(cum.get("counters") or {})
        self._gen = max_gen + 1
        self._f = open(self._active_path(), "ab")
        self._prune_locked()

    def _active_path(self) -> str:
        return os.path.join(self.dir, f"tl_{self._gen:08d}.seg")

    # -- append ------------------------------------------------------------

    def append_sweep(self, rollup: dict, slo_status: Optional[dict] = None,
                     now: Optional[float] = None) -> dict:
        """Compact one rollup sweep into a delta record and append it.
        Returns the record (tests assert on it).  Never raises on the
        sweep path — an IO fault marks the store degraded in ``stats``."""
        now = time.monotonic() if now is None else float(now)
        age = rollup.get("age_of_experience") or {}
        srv = rollup.get("serving") or {}
        rep = rollup.get("replay") or {}
        cum_hist = {
            "age_s": age.get("buckets_s") or {},
            "serving_s": srv.get("latency_buckets") or {},
            "replay_op_s": rep.get("op_buckets") or {},
        }
        cum_counters = {
            "serving_replies": int(srv.get("count") or 0),
            "replay_added": int(rep.get("total_added") or 0),
            "scrapes": int(rollup.get("scrapes") or 0),
            "scrape_failures": int(rollup.get("scrape_failures") or 0),
        }
        rec: dict = {
            "v": 1,
            "t": round(now, 6),
            "wall": round(time.time(), 3),
            "gauges": {
                "alive": rollup.get("alive"),
                "expected": rollup.get("expected"),
                "serving_replicas": srv.get("replicas"),
                "serving_qps": srv.get("qps"),
                "serving_p99_ms": (srv.get("window") or {}).get("p99_ms")
                if (srv.get("window") or {}).get("count")
                else srv.get("p99_ms"),
                "age_p95_s": (age.get("window") or {}).get("p95_s")
                if (age.get("window") or {}).get("count")
                else age.get("p95_s"),
                "shards_alive": rep.get("shards_alive"),
                "replay_add_qps": rep.get("add_qps"),
                "replay_occupancy": rep.get("occupancy"),
                "ring_occupancy_max": rollup.get("ring_occupancy_max"),
            },
            "hist": {
                key: _delta_map(self._prev_hist.get(key, {}), cum)
                for key, cum in cum_hist.items()
            },
            "counters": _delta_map(self._prev_counters, cum_counters),
            # Cumulative echo: how a reopened store resumes delta marks
            # against the last persisted sweep instead of zero.
            "cum": {"hist": cum_hist, "counters": cum_counters},
        }
        exemplars = {}
        for src_key, out_key in (("exemplars", "serving"),
                                 ("op_exemplars", "replay_op"),
                                 ("rtt_exemplars", "inference_rtt")):
            holder = srv if out_key == "serving" else (
                rep if out_key == "replay_op"
                else rollup.get("inference") or {})
            ex = holder.get(src_key)
            if ex:
                exemplars[out_key] = dict(ex)
        if exemplars:
            rec["exemplars"] = exemplars
        if slo_status:
            slo_rec: dict = {}
            for name, r in (slo_status.get("rules") or {}).items():
                value = r.get("value")
                violated = None
                if value is not None:
                    violated = (value > r.get("bound", 0.0)
                                if r.get("kind") == "upper"
                                else value < r.get("bound", 0.0))
                slo_rec[name] = {"v": value,
                                 "x": int(bool(violated))
                                 if violated is not None else None,
                                 "s": r.get("state", "ok")}
            rec["slo"] = slo_rec
        self._prev_hist = {k: dict(v) for k, v in cum_hist.items()}
        self._prev_counters = dict(cum_counters)
        self._append(rec, now)
        return rec

    def _append(self, rec: dict, now: float) -> None:
        frame = _frame(rec, self._compress)
        with self._lock:
            try:
                self._f.write(frame)
                self._f.flush()
            except (OSError, ValueError):
                return
            self.appends += 1
            self._active_bytes += len(frame)
            self._active_records += 1
            self._active_t1 = now
            if self._active_t0 is None:
                self._active_t0 = now
            if self._t_first is None:
                self._t_first = now
            self._tail.append((now, rec))
            cutoff = now - self._tail_keep_s
            while self._tail and self._tail[0][0] < cutoff:
                self._tail.popleft()
            if self._active_bytes >= self._segment_bytes:
                self._rotate_locked()

    def _rotate_locked(self) -> None:
        """Commit the active segment (fsync, then manifest tmp+rename —
        the manifest-last ordering) and open the next generation."""
        try:
            self._f.flush()
            os.fsync(self._f.fileno())
            self._f.close()
        except (OSError, ValueError):
            pass
        self._segments.append({
            "gen": self._gen,
            "file": os.path.basename(self._active_path()),
            "records": self._active_records,
            "t0": self._active_t0, "t1": self._active_t1,
            "bytes": self._active_bytes,
        })
        self.rotations += 1
        self._prune_locked()
        self._commit_manifest()
        self._gen += 1
        self._active_bytes = 0
        self._active_records = 0
        self._active_t0 = self._active_t1 = None
        self._f = open(self._active_path(), "ab")

    def _prune_locked(self) -> None:
        total = sum(int(s.get("bytes") or 0) for s in self._segments)
        while len(self._segments) > 1 and total > self._max_bytes:
            old = self._segments.pop(0)
            total -= int(old.get("bytes") or 0)
            self.prunes += 1
            try:
                os.unlink(os.path.join(self.dir, old["file"]))
            except OSError:
                pass

    def _commit_manifest(self) -> None:
        doc = {"version": 1, "segments": self._segments}
        tmp = os.path.join(self.dir, _MANIFEST + ".tmp")
        try:
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(doc, f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, os.path.join(self.dir, _MANIFEST))
            _fsync_dir(self.dir)
        except OSError:
            pass

    # -- windowed queries --------------------------------------------------

    def records(self, t0: Optional[float] = None,
                t1: Optional[float] = None) -> List[dict]:
        """Records with ``t0 <= t <= t1`` (None = unbounded).  Served
        from the in-memory tail when it covers the span; otherwise the
        committed segments are re-read — the disk IS the source of
        truth, the tail only an accelerator."""
        with self._lock:
            tail = list(self._tail)
        lo = -float("inf") if t0 is None else float(t0)
        hi = float("inf") if t1 is None else float(t1)
        if tail and (self._t_first is None or tail[0][0] <= lo
                     or tail[0][0] <= (self._t_first or 0.0)):
            return [rec for t, rec in tail if lo <= t <= hi]
        doc = read_timeline(self.dir)
        return [rec for rec in doc["records"]
                if lo <= float(rec.get("t", 0.0)) <= hi]

    def merged_buckets(self, key: str, t0: Optional[float] = None,
                       t1: Optional[float] = None) -> dict:
        out: dict = {}
        for rec in self.records(t0, t1):
            d = (rec.get("hist") or {}).get(key)
            if d:
                out = merge_bucket_dicts(out, d)
        return out

    def percentile(self, key: str, q: float, t0: Optional[float] = None,
                   t1: Optional[float] = None) -> Optional[float]:
        """Percentile of ``key``'s distribution over [t0, t1], re-derived
        from the stored per-sweep bucket deltas — bit-consistent with the
        live rollup window by construction (same deltas, same
        ``merge_bucket_dicts`` + ``bucket_percentile``)."""
        merged = self.merged_buckets(key, t0, t1)
        if not any(merged.values()):
            return None
        return bucket_percentile(merged, q)

    def rate(self, key: str, window_s: float,
             now: Optional[float] = None) -> Optional[float]:
        """Windowed rate of a cumulative counter (events/s over the
        trailing ``window_s``) — the smoothed twin of the rollup's
        instantaneous scrape-to-scrape QPS, and what the autopilot's
        idle rules read so one quiet sweep cannot read as idleness.
        None before the store has any coverage."""
        now = time.monotonic() if now is None else float(now)
        t0 = now - float(window_s)
        total = 0
        seen = False
        for rec in self.records(t0, now):
            seen = True
            total += int((rec.get("counters") or {}).get(key, 0))
        if not seen:
            return None
        span = float(window_s)
        if self._t_first is not None:
            span = min(span, max(now - self._t_first, 0.0))
        if span <= 0.0:
            return None
        return total / span

    def series(self, gauge: str, t0: Optional[float] = None,
               t1: Optional[float] = None) -> List[Tuple[float, float]]:
        """(t, value) points of one gauge — what ``obs_top --timeline``
        renders as a sparkline."""
        out: List[Tuple[float, float]] = []
        for rec in self.records(t0, t1):
            v = (rec.get("gauges") or {}).get(gauge)
            if v is not None:
                out.append((float(rec.get("t", 0.0)), float(v)))
        return out

    def exemplar(self, key: str, edge: Optional[str] = None,
                 t0: Optional[float] = None,
                 t1: Optional[float] = None) -> Optional[int]:
        """Newest stored exemplar trace id for ``key`` (``serving`` /
        ``replay_op`` / ``inference_rtt``); ``edge`` narrows to one
        bucket (e.g. the bucket a p99 resolves to)."""
        for rec in reversed(self.records(t0, t1)):
            ex = (rec.get("exemplars") or {}).get(key)
            if not ex:
                continue
            if edge is None:
                return int(next(reversed(list(ex.values()))))
            if edge in ex:
                return int(ex[edge])
        return None

    # -- SLO rebuild -------------------------------------------------------

    def rebuild_slo(self, engine, now: Optional[float] = None) -> int:
        """Refill a (fresh) SLO engine's burn windows and rule states
        from the timeline tail — the aggregator-respawn story: without
        this a restarted engine opens a blind window in state ``ok`` and
        a live breach silently clears.  Rules are matched by name;
        returns how many got samples.  No events are emitted — the
        rebuild restores state, transitions stay the evaluator's job."""
        now = time.monotonic() if now is None else float(now)
        recs = self.records(now - float(engine.window_s), now)
        newest_state: Dict[str, str] = {}
        newest_value: Dict[str, float] = {}
        filled = 0
        for rule in engine.rules:
            window: List[Tuple[float, bool]] = []
            for rec in recs:
                ent = (rec.get("slo") or {}).get(rule.name)
                if not ent:
                    continue
                newest_state[rule.name] = ent.get("s", "ok")
                if ent.get("v") is not None:
                    newest_value[rule.name] = float(ent["v"])
                    window.append((float(rec.get("t", 0.0)),
                                   bool(ent.get("x"))))
            if not window and rule.name not in newest_state:
                continue
            rule._window.clear()
            rule._window.extend(window)
            if rule.name in newest_state:
                rule.state = newest_state[rule.name]
            if rule.name in newest_value:
                rule.last_value = newest_value[rule.name]
            filled += 1
        if filled:
            self.rebuilds += 1
        return filled

    # -- observability / lifecycle ----------------------------------------

    def stats(self) -> dict:
        """The ``timeline`` /varz section (docs/METRICS.md "Timeline
        schema")."""
        with self._lock:
            segments = list(self._segments)
            tail_n = len(self._tail)
            t_last = self._tail[-1][0] if self._tail else None
            active_bytes = self._active_bytes
            active_records = self._active_records
        committed_bytes = sum(int(s.get("bytes") or 0) for s in segments)
        return {
            "dir": self.dir,
            "gen": self._gen,
            "segments": len(segments),
            "records": sum(int(s.get("records") or 0) for s in segments)
            + active_records,
            "bytes": committed_bytes + active_bytes,
            "max_bytes": self._max_bytes,
            "appends": self.appends,
            "rotations": self.rotations,
            "prunes": self.prunes,
            "torn_records": self.torn_records,
            "adopted_records": self.adopted_records,
            "rebuilds": self.rebuilds,
            "tail_records": tail_n,
            "t_first": self._t_first,
            "t_last": t_last,
        }

    def close(self) -> None:
        """Commit the active segment — a clean shutdown leaves no
        uncommitted tail for the next incarnation to adopt."""
        with self._lock:
            if self._f is None:
                return
            if self._active_records:
                self._rotate_locked()
            try:
                self._f.close()
            except (OSError, ValueError):
                pass
            try:
                if self._active_records == 0:
                    os.unlink(self._active_path())
            except OSError:
                pass
            self._f = None
