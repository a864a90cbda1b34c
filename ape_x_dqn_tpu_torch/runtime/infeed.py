"""Device infeed: prefetch host replay samples onto the device behind the step.

Port of ``PrefetchQueue`` (``ape_x_dqn_tpu/runtime/infeed.py:28-101``): a
feeder thread samples from the host replay and places each batch on the
device into a small bounded queue while the learner's previous step runs.
Depth 2 is double buffering: one batch in use, one staged; deeper queues
only add priority staleness.

JAX's ``device_put`` is asynchronous and orders itself; here the placement
is spelled out (``DevicePlacer``):

1. the host batch is copied into pinned staging (``pin_memory``);
2. each field is copied to the device with ``non_blocking=True`` on a
   dedicated copy stream;
3. an event recorded on the copy stream after the copies travels with the
   batch; ``Placed.wait()``, called by the learner, makes the learner's
   stream wait for it and marks each tensor used on that stream.

Two hazards this handles: a pinned buffer must not be reused before its
copy finishes (PyTorch's pinned-memory cache records the copy on the copy
stream and holds the block until it completes; each batch gets fresh
staging), and a tensor allocated on the copy stream but freed after use on
the learner's stream needs ``record_stream``, or the caching allocator
hands its memory out before the learner is done with it.

``DispatchPipeline`` (the overlapped fused path) is not part of the port yet.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ape_x_dqn_tpu_torch.types import NStepTransition, PrioritizedBatch


def _map_batch(host_batch: PrioritizedBatch, fn) -> PrioritizedBatch:
    return PrioritizedBatch(
        transition=host_batch.transition.map(fn),
        indices=fn(host_batch.indices),
        is_weights=fn(host_batch.is_weights),
    )


def _tensors(batch: PrioritizedBatch):
    t = batch.transition
    return [*(getattr(t, f.name) for f in dataclasses.fields(NStepTransition)),
            batch.indices, batch.is_weights]


def batch_to_device(host_batch: PrioritizedBatch,
                    device: str | torch.device) -> PrioritizedBatch:
    """Synchronous placement of a numpy batch: a tensor per field on
    ``device`` (on the CPU, views of the numpy arrays)."""
    return _map_batch(
        host_batch,
        lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device),
    )


class Placed(NamedTuple):
    """A sampled batch on the device, with the host indices kept for the
    deferred priority write-back."""

    indices: np.ndarray                 # int32 [B], host
    batch: PrioritizedBatch             # tensors on the device
    ready: Optional[torch.cuda.Event]   # copies done (None on the CPU)

    def wait(self) -> PrioritizedBatch:
        """The batch, once the current stream waits for its copies; each
        tensor is marked as used on that stream for the allocator."""
        if self.ready is not None:
            stream = torch.cuda.current_stream(self.batch.is_weights.device)
            stream.wait_event(self.ready)
            for t in _tensors(self.batch):
                t.record_stream(stream)
        return self.batch


class DevicePlacer:
    """``place_fn`` of the ``PrefetchQueue``: host batch → ``Placed``.

    On a CUDA device the copies run on a stream of their own (see the
    module docstring); on the CPU the batch is wrapped as it is.
    """

    def __init__(self, device: str | torch.device):
        self.device = torch.device(device)
        self._copy_stream = (torch.cuda.Stream(self.device)
                             if self.device.type == "cuda" else None)

    def __call__(self, host_batch: PrioritizedBatch) -> Placed:
        indices = np.asarray(host_batch.indices)
        if self._copy_stream is None:
            return Placed(indices, batch_to_device(host_batch, self.device), None)
        with torch.cuda.stream(self._copy_stream):
            batch = _map_batch(
                host_batch,
                lambda a: torch.from_numpy(np.ascontiguousarray(a))
                .pin_memory().to(self.device, non_blocking=True),
            )
            ready = torch.cuda.Event()
            ready.record(self._copy_stream)
        return Placed(indices, batch, ready)


class PrefetchQueue:
    """Feeder thread: ``sample_fn() -> host batch`` → ``place_fn`` → bounded
    queue.

    Args:
      sample_fn: returns the next host batch (thread-safe; typically closes
        over replay.sample with the β schedule).
      place_fn: host batch → what ``get`` returns (``DevicePlacer``).
      depth: max staged batches (2 = double buffering).
    """

    def __init__(
        self,
        sample_fn: Callable[[], object],
        place_fn: Callable[[object], object],
        depth: int = 2,
    ):
        if depth < 1:
            raise ValueError("depth must be >= 1")
        self._sample_fn = sample_fn
        self._place_fn = place_fn
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._error: Optional[BaseException] = None
        self._thread = threading.Thread(
            target=self._run, name="infeed-prefetch", daemon=True
        )
        self._thread.start()

    def _run(self) -> None:
        try:
            while not self._stop.is_set():
                batch = self._place_fn(self._sample_fn())
                # Bounded put with timeout so stop() is honored promptly.
                while not self._stop.is_set():
                    try:
                        self._q.put(batch, timeout=0.1)
                        break
                    except queue.Full:
                        continue
        except BaseException as e:  # noqa: BLE001 — re-raised in get()
            self._error = e

    def get(self, timeout: float = 30.0):
        """Next staged batch; re-raises feeder errors.

        ``timeout`` is a wall-clock deadline from call entry; each wait is
        capped at 0.2 s so a feeder error surfaces promptly.
        """
        deadline = time.monotonic() + timeout
        while True:
            if self._error is not None:
                raise RuntimeError("infeed feeder failed") from self._error
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise TimeoutError("infeed queue starved") from None
            try:
                return self._q.get(timeout=min(0.2, remaining))
            except queue.Empty:
                continue

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()
