"""Versioned parameter store — the learner→actor broadcast channel.

Port of ``ape_x_dqn_tpu/runtime/param_store.py``: an atomic versioned
snapshot in host memory.  The learner publishes at a capped rate (one
device→host copy per publish); readers poll ``get(have_version)`` and pay
only when the version moved.  Snapshots are host copies, never views of
the learner's tensors, which it updates in place.
"""

from __future__ import annotations

import threading
from typing import Any, Optional, Tuple

from ape_x_dqn_tpu_torch.actors.pool import host_params


class ParamStore:
    """Thread-safe versioned parameter snapshots (CPU tensor dicts)."""

    def __init__(self, params: Optional[dict] = None):
        self._lock = threading.Lock()
        self._params = host_params(params) if params is not None else None
        # Initial params (if any) are version 0; each publish bumps by 1.
        self._version = 0

    @property
    def version(self) -> int:
        with self._lock:
            return self._version

    def publish(self, params: dict) -> int:
        """Snapshot device params to host and bump the version."""
        host = host_params(params)
        with self._lock:
            self._params = host
            self._version += 1
            return self._version

    def get(self, have_version: int = -1) -> Optional[Tuple[Any, int]]:
        """Return (params, version) if newer than ``have_version`` else None."""
        with self._lock:
            if self._params is None or self._version <= have_version:
                return None
            return self._params, self._version
