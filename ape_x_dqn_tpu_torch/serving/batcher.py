"""Dynamic micro-batcher: coalesce concurrent requests into bucket batches.

Port of ``ape_x_dqn_tpu/serving/batcher.py``; the module runs in numpy on
the host, as the JAX one does, and is held by the same tests.  N
concurrent clients' observations ride ONE forward instead of N.  Three
disciplines make that a service rather than a throughput hack:

  * **Fixed bucket shapes.**  Batches pad up to the next power-of-two
    bucket (1, 2, 4, ..., max_batch), so the forward sees a handful of
    shapes — not one per concurrent-request count.  Padded rows replicate a
    real row and are sliced off before reply; per-row argmax means they
    cannot influence real rows.
  * **Deadline flush.**  A batch launches when it reaches ``max_batch`` OR
    when the oldest member has waited ``max_wait_s`` — p99 queueing latency
    is bounded even at QPS 1 (a lone request never waits for company that
    is not coming).  Under load the deadline is already past when the
    worker frees up, so batches fill from the backlog without any wait.
  * **Admission control.**  The request queue is bounded; a full queue
    rejects with the typed :class:`ServerOverloaded` instead of queueing
    unboundedly — the bounded-queue discipline of the experience
    transport, applied to the request path.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from typing import Callable, List, NamedTuple, Optional, Sequence

import numpy as np

from ape_x_dqn_tpu_torch.utils.metrics import LatencyHistogram, RateCounter
from ape_x_dqn_tpu_torch.utils.profiling import current_timer


class ServingError(Exception):
    """Base class for typed serving-path errors."""


class ServerOverloaded(ServingError):
    """Admission control rejected the request (bounded queue full)."""


class ServerClosed(ServingError):
    """The server is shut down; the request was not (or will not be) served."""


class ServedAction(NamedTuple):
    """One client's reply: greedy action + the evidence behind it."""

    action: int
    q_values: np.ndarray     # float32 [A] — this row's Q(s, .)
    param_version: int       # version of the params that produced it
    latency_s: float         # enqueue -> reply, incl. queueing + compute


class _Request(NamedTuple):
    obs: np.ndarray
    future: Future
    t_enqueue: float


_SENTINEL = None


def bucket_sizes(max_batch: int) -> List[int]:
    """Power-of-two ladder up to (and always including) ``max_batch``."""
    if max_batch < 1:
        raise ValueError("max_batch must be >= 1")
    sizes = []
    b = 1
    while b < max_batch:
        sizes.append(b)
        b *= 2
    sizes.append(max_batch)
    return sizes


def bucket_for(n: int, buckets: Sequence[int]) -> int:
    """Smallest bucket that fits ``n`` requests."""
    for b in buckets:
        if b >= n:
            return b
    raise ValueError(f"batch of {n} exceeds the largest bucket {buckets[-1]}")


class MicroBatcher:
    """Bounded request queue + worker thread running the batched forward.

    ``run_batch(padded_obs) -> (actions, q_values, param_version)`` is the
    compute seam the server supplies: it snapshots params ONCE per call, so
    a param swap can never land mid-batch (version atomicity is per batch
    by construction).
    """

    def __init__(
        self,
        run_batch: Callable,
        max_batch: int = 32,
        max_wait_s: float = 0.005,
        queue_capacity: int = 256,
        name: str = "serve-batcher",
        on_start: Optional[Callable[[], None]] = None,
    ):
        if queue_capacity < 1:
            raise ValueError("queue_capacity must be >= 1")
        self._run_batch = run_batch
        # Runs on the worker thread before its first batch; ``start``
        # returns once it has (and raises what it raised).  The port's
        # PolicyServer warms its buckets here: CUDA's per-thread cuBLAS and
        # cuDNN handles must be created on the thread that serves.
        self._on_start = on_start
        self._started_evt = threading.Event()
        self._start_error: Optional[BaseException] = None
        self.max_batch = int(max_batch)
        self.max_wait_s = float(max_wait_s)
        self.buckets = bucket_sizes(self.max_batch)
        self._q: queue.Queue = queue.Queue(maxsize=int(queue_capacity))
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._loop, name=name, daemon=True
        )
        # Metrics (read by PolicyServer.stats / the JSONL emit loop).
        self.latency = LatencyHistogram()
        self.served = RateCounter()
        self.shed_count = 0
        self.error_count = 0
        self.batch_hist: dict[int, int] = {}   # real batch size -> count
        # Per-param_version latency split (newest few versions): the
        # canary sensor — version atomicity per batch means one lookup
        # covers the whole batch.
        self.by_version: dict[int, dict] = {}
        self.max_versions = 4
        self._started = False
        # Liveness for /healthz (obs.Health age fn): the worker loop
        # stamps this every iteration — including idle ones — so a stale
        # heartbeat means the batcher thread is wedged, not just unloaded.
        self.heartbeat = time.monotonic()

    # -- client side ------------------------------------------------------

    def submit(self, obs: np.ndarray) -> Future:
        """Enqueue one observation; returns a Future of ServedAction.

        Raises :class:`ServerOverloaded` when the bounded queue is full
        (load shed) and :class:`ServerClosed` after shutdown.
        """
        if self._stop.is_set():
            raise ServerClosed("server is shut down")
        req = _Request(np.asarray(obs), Future(), time.monotonic())
        try:
            self._q.put_nowait(req)
        except queue.Full:
            self.shed_count += 1
            raise ServerOverloaded(
                f"request queue at capacity ({self._q.maxsize}); retry later"
            ) from None
        return req.future

    @property
    def queue_depth(self) -> int:
        return self._q.qsize()

    # -- worker side ------------------------------------------------------

    def start(self) -> "MicroBatcher":
        if not self._started:
            self._started = True
            self._thread.start()
            self._started_evt.wait()
            if self._start_error is not None:
                raise self._start_error
        return self

    def _drain_now(self, batch: List[_Request]) -> None:
        """Take whatever is immediately available, up to max_batch."""
        try:
            while len(batch) < self.max_batch:
                r = self._q.get_nowait()
                if r is _SENTINEL:
                    return
                batch.append(r)
        except queue.Empty:
            pass

    def _gather(self, first: _Request) -> List[_Request]:
        """Fill a batch: until max_batch or the FIRST member's deadline.

        Deadline is anchored at the oldest request's enqueue time, not at
        gather start — a request that already queued behind a slow batch
        gets correspondingly less extra wait, keeping the max-wait bound a
        property of the request, not of worker scheduling luck.
        """
        batch = [first]
        deadline = first.t_enqueue + self.max_wait_s
        while len(batch) < self.max_batch:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                self._drain_now(batch)
                break
            try:
                r = self._q.get(timeout=remaining)
            except queue.Empty:
                break
            if r is _SENTINEL:
                break
            batch.append(r)
        return batch

    def _loop(self) -> None:
        try:
            if self._on_start is not None:
                self._on_start()
        except BaseException as e:  # noqa: BLE001 — re-raised by start()
            self._start_error = e
            self._stop.set()
            return
        finally:
            self._started_evt.set()
        while not self._stop.is_set():
            self.heartbeat = time.monotonic()
            try:
                first = self._q.get(timeout=0.05)
            except queue.Empty:
                continue
            if first is _SENTINEL:
                continue
            self._serve_one_batch(self._gather(first))

    def _serve_one_batch(self, batch: List[_Request]) -> None:
        n = len(batch)
        if n == 0:
            return
        bucket = bucket_for(n, self.buckets)
        obs = np.stack([r.obs for r in batch])
        if bucket > n:
            # Replicate the first row — in-distribution values, and row-wise
            # argmax keeps padding inert regardless of content.
            pad = np.broadcast_to(obs[:1], (bucket - n, *obs.shape[1:]))
            obs = np.concatenate([obs, pad], axis=0)
        # Each request's queue wait, enqueue to the start of its batch's
        # forward, into the process's timeline (serve_queue_wait_p95_ms).
        start = time.monotonic()
        current_timer().queue_wait(start, [start - r.t_enqueue for r in batch])
        try:
            actions, q_values, version = self._run_batch(obs)
        except Exception as e:  # noqa: BLE001 — delivered to each waiter
            self.error_count += n
            for r in batch:
                if not r.future.done():
                    r.future.set_exception(e)
            return
        done = time.monotonic()
        self.batch_hist[n] = self.batch_hist.get(n, 0) + 1
        self.served.add(n)
        vrow = self.by_version.get(int(version))
        if vrow is None:
            vrow = self.by_version[int(version)] = {
                "replies": 0, "hist": LatencyHistogram()
            }
            while len(self.by_version) > self.max_versions:
                del self.by_version[min(self.by_version)]
        vrow["replies"] += n
        for i, r in enumerate(batch):
            latency = done - r.t_enqueue
            self.latency.record(latency)
            vrow["hist"].record(latency)
            r.future.set_result(
                ServedAction(
                    int(actions[i]),
                    np.asarray(q_values[i]),
                    int(version),
                    latency,
                )
            )

    def close(self) -> None:
        """Stop the worker; fail queued-but-unserved requests typed."""
        self._stop.set()
        try:
            self._q.put_nowait(_SENTINEL)
        except queue.Full:
            pass
        if self._started:
            self._thread.join(timeout=5.0)
        try:
            while True:
                r = self._q.get_nowait()
                if r is not _SENTINEL and not r.future.done():
                    r.future.set_exception(ServerClosed("server shut down"))
        except queue.Empty:
            pass
