"""Flight recorder: a bounded ring of recent events, dumped to a post-mortem
file when the process dies with a word, and salvageable from shared memory
when it dies without one.

Port of ``ape_x_dqn_tpu/obs/recorder.py`` (``FlightRecorder`` :35,
``write_postmortem`` :129):

  * ``record(kind, ...)`` appends to a deque of ``obs.recorder_depth``
    events (per quantum or per emit, never per step);
  * with a ``shm_sink`` (a worker's ``WorkerStatsBlock``) every event also
    lands in the block's event ring, which the parent reads after a
    SIGKILL;
  * ``dump()`` writes one JSON file under the post-mortem dir (tmp, fsync,
    rename: no torn file), with the snapshot providers' state at dump
    time; ``install_sigterm`` dumps on SIGTERM and then runs the previous
    handler, on the main thread only, and ``restore_sigterm`` puts that
    handler back when the run ends.

Standard library only: a worker builds one before it imports torch.
"""

from __future__ import annotations

import json
import os
import signal
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional


class FlightRecorder:
    def __init__(self, name: str = "proc", depth: int = 256, shm_sink=None):
        self.name = name
        self._events: deque = deque(maxlen=int(depth))
        self._sink = shm_sink
        self._lock = threading.Lock()
        self._snapshot_fns: Dict[str, Callable[[], dict]] = {}
        self._sigterm = None   # (our handler, the one it chains to)
        self.dumped: List[str] = []

    def add_snapshot_provider(self, name: str, fn: Callable[[], dict]) -> None:
        """State captured at dump time (the registry's snapshot, ...)."""
        self._snapshot_fns[name] = fn

    def record(self, kind: str, **fields) -> dict:
        rec = {"t": round(time.monotonic(), 4), "kind": kind, **fields}
        with self._lock:
            self._events.append(rec)
        if self._sink is not None:
            try:
                self._sink.record_event(rec)
            except Exception:  # noqa: BLE001 — recording must never kill the caller
                pass
        return rec

    def events(self) -> List[dict]:
        with self._lock:
            return list(self._events)

    def dump(self, out_dir: str, reason: str, extra: Optional[dict] = None) -> Optional[str]:
        """Write one post-mortem JSON under ``out_dir`` and return its path
        (None when ``out_dir`` is empty).  Never raises: it runs on failure
        paths, where a second exception would hide the first."""
        if not out_dir:
            return None
        try:
            os.makedirs(out_dir, exist_ok=True)
            snapshots: dict = {}
            for name, fn in self._snapshot_fns.items():
                try:
                    snapshots[name] = fn()
                except Exception as e:  # noqa: BLE001 — recorded in the dump
                    snapshots[name] = {"error": f"{type(e).__name__}: {e}"}
            record = {
                "name": self.name,
                "reason": reason,
                "pid": os.getpid(),
                "wall_time": time.time(),
                "t_mono": time.monotonic(),
                "events": self.events(),
                "snapshots": snapshots,
                "extra": extra or {},
            }
            fname = f"{self.name}-pid{os.getpid()}-{reason}-{int(time.time() * 1e3)}.json"
            path = os.path.join(out_dir, fname)
            _write_atomic(path, record)
            self.dumped.append(path)
            return path
        except Exception:  # noqa: BLE001 — see the docstring
            return None

    def install_sigterm(self, out_dir: str) -> bool:
        """Dump on SIGTERM, then run the previous handler (or die of the
        default action).  Signal handlers live on the main thread only:
        elsewhere this returns False and installs nothing."""
        if threading.current_thread() is not threading.main_thread():
            return False
        prev = signal.getsignal(signal.SIGTERM)

        def _handler(signum, frame):
            self.dump(out_dir, "sigterm")
            if callable(prev):
                prev(signum, frame)
            else:
                signal.signal(signal.SIGTERM, signal.SIG_DFL)
                os.kill(os.getpid(), signal.SIGTERM)

        signal.signal(signal.SIGTERM, _handler)
        self._sigterm = (_handler, prev)
        return True

    def restore_sigterm(self) -> bool:
        """Put back the handler ``install_sigterm`` chained to, if this
        recorder's is still the one installed (a run that ends must not
        keep itself reachable from the signal table); False otherwise."""
        installed = self._sigterm
        if (installed is None or threading.current_thread() is not threading.main_thread()
                or signal.getsignal(signal.SIGTERM) is not installed[0]):
            return False
        signal.signal(signal.SIGTERM, installed[1])
        self._sigterm = None
        return True


def _write_atomic(path: str, record: dict) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(record, f, indent=1, default=str)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def write_postmortem(out_dir: str, name: str, reason: str, record: dict) -> Optional[str]:
    """One post-mortem file for a record assembled elsewhere (the parent
    writing a dead worker's salvaged stats block): the same atomic write,
    never raises; None when ``out_dir`` is empty or the write failed."""
    if not out_dir:
        return None
    try:
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(out_dir, f"{name}-{reason}-{int(time.time() * 1e3)}.json")
        _write_atomic(path, {"name": name, "reason": reason, "wall_time": time.time(),
                             **record})
        return path
    except Exception:  # noqa: BLE001 — a salvage must not kill the parent
        return None
