"""Host driver for the device-resident fused learner.

Port of ``ape_x_dqn_tpu/runtime/fused_learner.FusedDeviceLearner``,
single-device branch (:68-103 of the JAX module).  The replay ring and the
train state live on the device; each ``train()`` call runs K ×
[prioritized sample → double-Q train → priority restamp] as a plain Python
loop that never synchronises with the device.

Thread discipline: ``add_chunk`` (actor threads) only appends numpy to a
host staging list under a lock; ``prepare_staged`` (any thread) carves
staged rows into fixed ``ingest_block`` blocks; device work — ``add_block``
and ``train`` — happens on the one thread that calls ``train()``.

Sampling stream: the learner owns a ``torch.Generator`` on the device,
seeded from the train state's seed with the JAX learner's salt (0x5EED);
``train(beta, u=...)`` takes the K×B uniforms instead, which is how tests
feed it JAX's draws.
"""

from __future__ import annotations

import threading
from typing import Optional

import numpy as np
import torch

from ape_x_dqn_tpu_torch.learner.train_step import build_train_step
from ape_x_dqn_tpu_torch.replay.device import (
    build_fused_learn_step,
    device_replay_add,
    init_device_replay,
)
from ape_x_dqn_tpu_torch.types import NStepTransition, TrainState


class FusedDeviceLearner:
    """Owns the device replay + train state; drives fused K-step calls."""

    def __init__(
        self,
        network,
        optimizer,
        state: TrainState,
        obs_shape,
        capacity: int,
        batch_size: int = 32,
        steps_per_call: int = 128,
        ingest_block: int = 256,
        priority_exponent: float = 0.6,
        target_sync_freq: int = 2500,
        loss_kind: str = "huber",
        sample_ahead: bool = False,
        device: str | torch.device = "cuda",
    ):
        self._capacity = int(capacity)
        self.steps_per_call = int(steps_per_call)
        self._ingest_block = int(ingest_block)
        self._priority_exponent = float(priority_exponent)
        self.device = torch.device(device)
        self._state = state
        self._replay = init_device_replay(capacity, obs_shape, self.device)
        step_fn = build_train_step(network, optimizer, loss_kind=loss_kind,
                                   sync_in_step=False)
        fused_args = dict(
            batch_size=batch_size,
            steps_per_call=self.steps_per_call,
            priority_exponent=priority_exponent,
            target_sync_freq=target_sync_freq,
            sample_ahead=sample_ahead,
        )
        self._fused = build_fused_learn_step(step_fn, include_ingest=False,
                                             **fused_args)
        self._fused_ingest = build_fused_learn_step(step_fn, include_ingest=True,
                                                    **fused_args)
        self._generator = torch.Generator(device=self.device)
        self._generator.manual_seed((int(state.seed) ^ 0x5EED) & (2**63 - 1))
        self._lock = threading.Lock()
        self._staged: list = []
        self._staged_rows = 0
        self._prepared: list = []
        self._prepared_rows = 0
        self._size = 0          # host count of transitions ingested

    # ---------------------------------------------------------------- sinks

    def add_chunk(self, priorities: np.ndarray, transitions: NStepTransition):
        """Actor-thread sink: stage a numpy chunk (no device work here)."""
        with self._lock:
            self._staged.append((np.asarray(priorities, np.float32), transitions))
            self._staged_rows += len(priorities)

    @property
    def size(self) -> int:
        """Transitions visible to sampling (capacity-clamped)."""
        return min(self._size, self._capacity)

    @property
    def staged_rows(self) -> int:
        with self._lock:
            return self._staged_rows + self._prepared_rows

    @property
    def state(self) -> TrainState:
        return self._state

    @property
    def replay(self):
        return self._replay

    @property
    def step(self) -> int:
        return self._state.step

    def params_for_publish(self):
        return self._state.params

    # ------------------------------------------------------------- learner

    def prepare_staged(self, drain: bool = False) -> int:
        """Carve staged rows into fixed ``ingest_block`` blocks on the
        prepared queue (host CPU only, any thread).  ``drain=True`` also
        carves the partial tail into power-of-2 sub-blocks, so nothing is
        padded.  Returns rows prepared."""
        with self._lock:
            staged, self._staged = self._staged, []
            self._staged_rows = 0
        if not staged:
            return 0
        cat = _concat_chunks([t for _, t in staged])
        prio = np.concatenate([p for p, _ in staged])
        m = self._ingest_block
        blocks: list = []
        off = 0
        for _ in range(len(prio) // m):
            sl = slice(off, off + m)
            blocks.append((prio[sl], cat.map(lambda a: a[sl])))
            off += m
        rem = len(prio) - off
        while rem and drain:
            sub = 1 << (rem.bit_length() - 1)  # largest 2^k <= rem
            sl = slice(off, off + sub)
            blocks.append((prio[sl], cat.map(lambda a: a[sl])))
            off += sub
            rem -= sub
        with self._lock:
            self._prepared.extend(blocks)
            self._prepared_rows += off
            if rem:
                # The partial tail goes back to the front of staging.
                tail = slice(len(prio) - rem, None)
                self._staged.insert(0, (prio[tail], cat.map(lambda a: a[tail])))
                self._staged_rows += rem
        return off

    def pop_prepared(self) -> list:
        """Take every prepared block, in ring order."""
        with self._lock:
            blocks, self._prepared = self._prepared, []
            self._prepared_rows = 0
        return blocks

    def _to_device(self, priorities, transitions):
        dev = self.device
        return (transitions.map(lambda a: torch.as_tensor(np.asarray(a)).to(dev)),
                torch.as_tensor(np.asarray(priorities, np.float32)).to(dev))

    def add_block(self, priorities: np.ndarray, transitions) -> int:
        """Move one prepared block to the device ring (learner thread)."""
        trans, prio = self._to_device(priorities, transitions)
        device_replay_add(self._replay, trans, prio, self._priority_exponent)
        self._size += len(priorities)
        return len(priorities)

    def ingest_staged(self, drain: bool = False) -> int:
        """Assemble and add staged rows inline (learner thread).  Returns
        rows ingested."""
        self.prepare_staged(drain=drain)
        return sum(self.add_block(p, t) for p, t in self.pop_prepared())

    def train(self, beta: float, u: Optional[torch.Tensor] = None):
        """One fused call: K steps of sample/train/restamp.  Returns the
        stacked metrics, still on the device (read them lazily)."""
        self._state, self._replay, metrics = self._fused(
            self._state, self._replay, beta, u=u, generator=self._generator
        )
        return metrics

    def train_with_ingest(self, beta: float, priorities: np.ndarray,
                          transitions, u: Optional[torch.Tensor] = None):
        """Ingest one full ``ingest_block`` then run the K-step call; the
        same result as ``add_block`` followed by ``train``."""
        if len(priorities) != self._ingest_block:
            raise ValueError(
                f"train_with_ingest requires a full ingest_block "
                f"({self._ingest_block} rows), got {len(priorities)}"
            )
        trans, prio = self._to_device(priorities, transitions)
        self._state, self._replay, metrics = self._fused_ingest(
            self._state, self._replay, trans, prio, beta,
            u=u, generator=self._generator,
        )
        self._size += self._ingest_block
        return metrics


def _concat_chunks(chunks) -> NStepTransition:
    if len(chunks) == 1:
        return chunks[0].map(np.asarray)
    return NStepTransition(*(
        np.concatenate([np.asarray(getattr(c, f)) for c in chunks])
        for f in ("obs", "action", "reward", "discount", "next_obs")
    ))
