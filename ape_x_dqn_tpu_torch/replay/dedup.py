"""Carry-ref resolution for frame-dedup chunks.

Port of ``CarryResolver`` in ``ape_x_dqn_tpu/replay/dedup.py`` (:48-104):
the per-source bookkeeping every dedup consumer shares.  A chunk's refs are
relative to its own first frame (negative refs reach into the source's
previous chunk, ``types.DedupChunk``); the resolver maps them to absolute
int64 frame sequence numbers given the consumer's frame counter, and drops
only the carried rows when a source's stream has a gap.

The host ``DedupReplay`` of that module (and its C++ core) is not part of
the port yet (ROADMAP item 4); the device dedup ring (``device_dedup.py``,
driven by ``runtime/fused_dedup.py``) is.
"""

from __future__ import annotations

import numpy as np

from ape_x_dqn_tpu_torch.types import DedupChunk


class CarryResolver:
    """Per-source (chunk_seq, frame base, U) records; ``resolve`` turns a
    chunk's relative refs into absolute frame seqs.  Past ``max_sources``
    records the oldest half (by frame base) is evicted."""

    def __init__(self, max_sources: int = 4096):
        self.sources: dict = {}   # source -> (chunk_seq, frame_base, U)
        self.dropped_carry = 0
        self._max_sources = int(max_sources)

    def resolve(self, chunk: DedupChunk, base: int):
        """``(obs_seq int64 [M], next_seq int64 [M], keep bool [M])``.
        ``base`` is the consumer's frame count where this chunk's frames
        will land.  Updates the source's record."""
        prev = self.sources.get(chunk.source)
        contiguous = (
            prev is not None
            and chunk.chunk_seq == prev[0] + 1
            and chunk.prev_frames == prev[2]
        )
        obs_ref = np.asarray(chunk.obs_ref)
        obs_seq = base + obs_ref.astype(np.int64)
        next_seq = base + np.asarray(chunk.next_ref, np.int64)
        neg = obs_ref < 0
        keep = np.ones(len(obs_seq), bool)
        if neg.any():
            if contiguous:
                obs_seq[neg] = prev[1] + prev[2] + obs_ref[neg]
            else:
                keep = ~neg
                self.dropped_carry += int(neg.sum())
        self.sources[chunk.source] = (chunk.chunk_seq, base, chunk.frames.shape[0])
        if len(self.sources) > self._max_sources:
            oldest = sorted(self.sources, key=lambda s: self.sources[s][1])
            for key in oldest[: len(self.sources) // 2]:
                del self.sources[key]
        return obs_seq, next_seq, keep

    def state_arrays(self):
        """(source ids int64 [S], records int64 [S, 3]) — the snapshot form
        (JAX :92-104)."""
        src = self.sources
        return (np.array(list(src.keys()), np.int64),
                np.array([list(v) for v in src.values()], np.int64).reshape(len(src), 3))

    def load_state_arrays(self, ids, rows) -> None:
        self.sources = {int(s): tuple(int(x) for x in row) for s, row in zip(ids, rows)}
