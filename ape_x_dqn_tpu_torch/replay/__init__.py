"""Replay (port of ``ape_x_dqn_tpu/replay``): the host prioritized replay
over its sum-tree (``buffer.py``, ``sum_tree.py``, ``native.py``), the host
frame-dedup replay (``dedup.py``) and its C++ core (``native_dedup.py``),
the tiered frame store (``tiered.py``), the device-resident ring
(``device.py``) and its frame-dedup twin (``device_dedup.py``).

Lazy (PEP 562), as the JAX package's: ``tiered.py`` loads no torch, and
importing it runs this file first, so the names below resolve on first
attribute access instead of importing ``buffer`` (and torch) here.
"""

from __future__ import annotations

import importlib

_LAZY = {
    "PrioritizedReplay": "ape_x_dqn_tpu_torch.replay.buffer",
    "DedupReplay": "ape_x_dqn_tpu_torch.replay.dedup",
    "SumTree": "ape_x_dqn_tpu_torch.replay.sum_tree",
}

__all__ = sorted(_LAZY)


def __getattr__(name):
    target = _LAZY.get(name)
    if target is not None:
        return getattr(importlib.import_module(target), name)
    try:
        return importlib.import_module(f"{__name__}.{name}")
    except ModuleNotFoundError:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}") from None


def __dir__():
    return sorted(set(globals()) | set(_LAZY))
