"""Device infeed: host→device placement off the learner's critical path.

Port of ``ape_x_dqn_tpu/runtime/infeed.py``: ``PrefetchQueue`` (:28-101)
and ``DispatchPipeline`` (:104-301).

``PrefetchQueue``: a
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

``HostToDevice`` applies the same discipline to the fused learners' ingest
blocks: the learner's stream waits for the copies on the device, never the
host for the stream.

``DispatchPipeline`` keeps up to ``depth`` fused calls in flight (the
overlapped fused path, ``learner.pipeline_depth`` > 1 or
``learner.sync_every``); see its docstring.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Callable, List, NamedTuple, Optional

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


def _pinned_to(device: torch.device):
    """Fresh pinned staging, then a non-blocking copy (on the current
    stream, which the callers set to their copy stream)."""
    return lambda a: (torch.from_numpy(np.ascontiguousarray(a)).pin_memory()
                      .to(device, non_blocking=True))


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
            batch = _map_batch(host_batch, _pinned_to(self.device))
            ready = torch.cuda.Event()
            ready.record(self._copy_stream)
        return Placed(indices, batch, ready)


class HostToDevice:
    """Ingest placement for the fused learners: numpy arrays → tensors on
    ``device``, without a host synchronisation.

    On a CUDA device each call stages the arrays in fresh pinned memory,
    copies them with ``non_blocking=True`` on a copy stream, and makes the
    caller's current stream wait for an event recorded after the copies;
    each tensor is marked used on that stream (``record_stream``).  Work
    the caller queues next (the ring's scatter) runs after the copies land.
    On the CPU the arrays are wrapped as tensors (``torch.as_tensor``).
    """

    def __init__(self, device: str | torch.device):
        self.device = torch.device(device)
        self._copy_stream = (torch.cuda.Stream(self.device)
                             if self.device.type == "cuda" else None)

    def __call__(self, arrays) -> List[torch.Tensor]:
        if self._copy_stream is None:
            return [torch.as_tensor(np.asarray(a)).to(self.device) for a in arrays]
        stream = torch.cuda.current_stream(self.device)
        with torch.cuda.stream(self._copy_stream):
            out = [_pinned_to(self.device)(np.asarray(a)) for a in arrays]
            ready = torch.cuda.Event()
            ready.record(self._copy_stream)
        stream.wait_event(ready)
        for t in out:
            t.record_stream(stream)
        return out


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


class HostProbe:
    """A fused call's probe: its last loss, copied to the host without a
    synchronisation.

    On a CUDA device the value is copied with ``non_blocking=True`` into
    pinned host memory on the current stream, and an event is recorded
    after the copy: ``is_ready()`` asks the event (``query``, never a
    wait), and reading the probe (``np.asarray``) waits for it.  On the CPU
    the value is ready at once.
    """

    def __init__(self, value: torch.Tensor):
        if value.device.type == "cuda":
            self._host = torch.empty(value.shape, dtype=value.dtype, pin_memory=True)
            self._host.copy_(value, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(value.device))
        else:
            self._host = value
            self._event = None

    def is_ready(self) -> bool:
        return self._event is None or self._event.query()

    def __array__(self, dtype=None, copy=None):
        if self._event is not None:
            self._event.synchronize()
        out = self._host.numpy()
        return out if dtype is None else out.astype(dtype)


def loss_probe(metrics) -> HostProbe:
    """``probe_fn`` of the fused learners' ``DispatchPipeline``."""
    return HostProbe(metrics.loss[-1:])


class DispatchPipeline:
    """Overlapped fused-dispatch window: chain fused calls with no host
    synchronisation between them, retiring each from its probe.

    Port of ``ape_x_dqn_tpu/runtime/infeed.DispatchPipeline`` with the same
    window, poll, deadline and counters.  A blocking read between calls
    empties the card's queue while the host round-trips; this window keeps
    up to ``depth`` calls in flight:

      * ``dispatch(fn, steps)`` runs one fused call, takes its probe
        (``probe_fn(metrics)``; the learners pass ``loss_probe``, whose
        copy to the host starts at once; a probe with
        ``copy_to_host_async`` has it called) and registers it.
      * ``drain_ready()`` retires calls whose probe has already landed
        (``is_ready()``): a free read, not a host sync.
      * when ``depth`` calls are in flight, the host waits for the oldest by
        POLLING its readiness (short sleeps) instead of blocking on it: the
        card still holds ``depth − 1`` queued calls, so the wait idles the
        host, not the card.  Only a blown poll deadline degrades to a
        blocking read, counted in ``host_syncs``.  At ``depth`` 1 the wait
        is a blocking read (strict: one counted sync per call that had not
        finished).
      * ``sync()`` is the full drain (``learner.sync_every`` cadence, emit
        and exit): one counted sync event however many calls it retires,
        and free if all had landed.

    Overlap accounting: the card sat idle between two calls iff the newest
    in-flight call had finished before the next one was dispatched;
    ``dispatch`` then records the gap since the card was last seen busy
    (``gap_hist_ms.observe``), else 0 ms.  ``gaps_observed`` counts them.

    Not thread-safe: the learner thread owns it.  ``degrade()`` drops to
    depth 1 (an int store, safe from any thread).
    """

    def __init__(
        self,
        depth: int,
        probe_fn: Callable[[object], object],
        on_retire: Optional[Callable[[object, int], None]] = None,
        sync_counter=None,
        gap_hist_ms=None,
        poll_s: float = 5e-4,
        poll_deadline_s: float = 120.0,
    ):
        if depth < 1:
            raise ValueError("depth must be >= 1")
        self.depth = int(depth)
        self._probe_fn = probe_fn
        self._on_retire = on_retire
        self._sync_counter = sync_counter
        self._gap_hist = gap_hist_ms
        self._poll_s = float(poll_s)
        self._poll_deadline_s = float(poll_deadline_s)
        self._inflight: List[tuple] = []  # (metrics, probe, steps)
        self._last_busy = time.monotonic()
        self._dispatched = 0
        self.host_syncs = 0
        self.gaps_observed = 0
        self.steps_inflight = 0

    def __len__(self) -> int:
        return len(self._inflight)

    @staticmethod
    def _ready(probe) -> bool:
        is_ready = getattr(probe, "is_ready", None)
        if is_ready is None:
            return True  # a host value: nothing to wait for
        return bool(is_ready())

    def _retire(self, entry) -> None:
        metrics, probe, steps = entry
        np.asarray(probe)  # waits only if the copy has not landed
        # The card finished this call at or before now, so a later gap
        # measured from here is a lower bound on its idle time.
        self._last_busy = time.monotonic()
        self.steps_inflight -= steps
        if self._on_retire is not None:
            self._on_retire(metrics, steps)

    def _count_sync(self) -> None:
        self.host_syncs += 1
        if self._sync_counter is not None:
            self._sync_counter.inc()

    def _record_gap(self, gap_s: float) -> None:
        self.gaps_observed += 1
        if self._gap_hist is not None:
            self._gap_hist.observe(gap_s * 1e3)

    def dispatch(self, fn: Callable[[], object], steps: int):
        """Run one fused call via ``fn`` and register it: measure the
        overlap gap, dispatch, take the probe, retire what has landed, and
        if the window is still full wait for the oldest.  Returns ``fn()``'s
        result."""
        now = time.monotonic()
        if self._inflight:
            if self._ready(self._inflight[-1][1]):
                self._record_gap(max(0.0, now - self._last_busy))
            else:
                self._record_gap(0.0)
                self._last_busy = now
        elif self._dispatched:
            self._record_gap(max(0.0, now - self._last_busy))
        metrics = fn()
        self._dispatched += 1
        self._last_busy = time.monotonic()
        probe = self._probe_fn(metrics)
        start_copy = getattr(probe, "copy_to_host_async", None)
        if start_copy is not None:
            start_copy()
        self._inflight.append((metrics, probe, int(steps)))
        self.steps_inflight += int(steps)
        self.drain_ready()
        if len(self._inflight) >= self.depth:
            entry = self._inflight.pop(0)
            if self.depth == 1:
                if not self._ready(entry[1]):
                    self._count_sync()
            elif not self._ready(entry[1]):
                deadline = time.monotonic() + self._poll_deadline_s
                while not self._ready(entry[1]):
                    if time.monotonic() > deadline:
                        self._count_sync()
                        break
                    time.sleep(self._poll_s)
            self._retire(entry)
        return metrics

    def degrade(self) -> None:
        """Drop to strict depth 1."""
        self.depth = 1

    def drain_ready(self) -> int:
        """Retire every in-flight call whose probe already landed; never
        blocks, never counts as a host sync."""
        n = 0
        while self._inflight and self._ready(self._inflight[0][1]):
            self._retire(self._inflight.pop(0))
            n += 1
        return n

    def sync(self) -> int:
        """Full blocking drain: one sync event, free if everything landed."""
        if not self._inflight:
            return 0
        if not all(self._ready(e[1]) for e in self._inflight):
            self._count_sync()
        n = 0
        while self._inflight:
            self._retire(self._inflight.pop(0))
            n += 1
        return n
