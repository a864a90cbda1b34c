"""Batched sum-tree for proportional prioritized sampling.

The port's own copy of ``ape_x_dqn_tpu/replay/sum_tree.py``, kept numpy
float64 exactly as the JAX package has it: it is the plain version of the
host replay's tree and the tests' oracle for the native twin
(``_native/sum_tree.cc`` via ``native.py``).

Layout: a flat array of ``2 * capacity`` float64 nodes (capacity rounded up to
a power of two).  Leaf ``i`` lives at ``capacity + i``; node ``k``'s children
are ``2k`` and ``2k+1``; ``tree[1]`` is the total mass.  Every operation is a
handful of vectorized numpy passes over tree levels for a whole batch.
The same seed draws the same slots in both packages only while the masses
stay float64 and the sums run in this order, so the host tree never moves to
torch.
"""

from __future__ import annotations

import numpy as np


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


def stratified_targets(
    total: float, batch_size: int, rng: np.random.Generator
) -> np.ndarray:
    """One uniform draw per equal-mass stratum of [0, total), clamped below
    total against round-off.  Shared by the numpy and native trees so their
    stratified sampling stays bit-for-bit comparable."""
    if total <= 0:
        raise ValueError("cannot sample from an empty sum-tree")
    bounds = total / batch_size
    targets = (np.arange(batch_size) + rng.random(batch_size)) * bounds
    np.clip(targets, 0.0, np.nextafter(total, 0.0), out=targets)
    return targets


class SumTree:
    """Vectorized sum-tree over ``capacity`` slots.

    All methods accept/return numpy arrays and are O(B + log C) vectorized
    passes for a batch of B operations (each pass touches one tree level).
    Not thread-safe — callers (the replay buffer) hold the lock.
    """

    def __init__(self, capacity: int):
        if capacity <= 0:
            raise ValueError("capacity must be positive")
        self.capacity = int(capacity)
        self._leaf_base = _next_pow2(self.capacity)
        self._tree = np.zeros(2 * self._leaf_base, dtype=np.float64)
        self._depth = int(np.log2(self._leaf_base))

    @property
    def total(self) -> float:
        return float(self._tree[1])

    def get(self, indices: np.ndarray) -> np.ndarray:
        """Priorities at ``indices`` (int array) -> float64 array."""
        indices = np.asarray(indices, dtype=np.int64)
        return self._tree[self._leaf_base + indices]

    def max_priority(self) -> float:
        leaves = self._tree[self._leaf_base : self._leaf_base + self.capacity]
        return float(leaves.max()) if leaves.size else 0.0

    def set(self, indices: np.ndarray, priorities: np.ndarray) -> None:
        """Batched priority write + upward propagation.

        Duplicate indices are allowed; the *last* write wins.  Propagation
        recomputes parent = left + right along the affected paths, so
        duplicates cannot double-count.
        """
        indices = np.asarray(indices, dtype=np.int64)
        priorities = np.asarray(priorities, dtype=np.float64)
        if indices.size == 0:
            return
        if np.any((indices < 0) | (indices >= self.capacity)):
            raise IndexError("sum-tree index out of range")
        if np.any(priorities < 0) or not np.all(np.isfinite(priorities)):
            raise ValueError("priorities must be finite and non-negative")
        nodes = self._leaf_base + indices
        # Last-write-wins for duplicate indices: numpy fancy assignment already
        # applies writes in order, so later duplicates overwrite earlier ones.
        self._tree[nodes] = priorities
        # Propagate: at each level, recompute each affected parent from both
        # children (immune to duplicate-index double counting).
        parents = np.unique(nodes >> 1)
        while parents[0] >= 1:
            left = self._tree[2 * parents]
            right = self._tree[2 * parents + 1]
            self._tree[parents] = left + right
            if parents[0] == 1:
                break
            parents = np.unique(parents >> 1)

    def sample(self, targets: np.ndarray) -> np.ndarray:
        """Inverse-CDF lookup: for each target mass in [0, total), descend to
        the leaf whose prefix-sum interval contains it.  Fully vectorized —
        one comparison per tree level for the whole batch.
        """
        targets = np.asarray(targets, dtype=np.float64).copy()
        nodes = np.ones(targets.shape, dtype=np.int64)
        for _ in range(self._depth):
            left = 2 * nodes
            left_mass = self._tree[left]
            go_right = targets >= left_mass
            targets = np.where(go_right, targets - left_mass, targets)
            nodes = np.where(go_right, left + 1, left)
        leaf = nodes - self._leaf_base
        # Float round-off can land exactly on a zero-mass leaf edge; clamp to
        # the populated region.
        return np.clip(leaf, 0, self.capacity - 1)

    def sample_stratified(self, batch_size: int, rng: np.random.Generator) -> np.ndarray:
        """Stratified proportional sample: one draw per equal-mass stratum
        (lower variance than i.i.d. draws; standard PER practice)."""
        return self.sample(stratified_targets(self.total, batch_size, rng))
