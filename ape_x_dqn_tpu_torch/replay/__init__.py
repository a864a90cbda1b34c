"""Replay (port of ``ape_x_dqn_tpu/replay``): the host prioritized replay
over its sum-tree (``buffer.py``, ``sum_tree.py``, ``native.py``), the
device-resident ring (``device.py``), its frame-dedup twin
(``device_dedup.py``) and the dedup carry resolver (``dedup.py``)."""

from ape_x_dqn_tpu_torch.replay.buffer import PrioritizedReplay
from ape_x_dqn_tpu_torch.replay.sum_tree import SumTree

__all__ = ["PrioritizedReplay", "SumTree"]
