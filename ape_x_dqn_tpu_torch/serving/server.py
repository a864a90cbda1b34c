"""PolicyServer: micro-batcher + greedy forward on the card + hot param reload.

Port of ``ape_x_dqn_tpu/serving/server.py``:

    clients --submit--> MicroBatcher --bucket batch--> greedy_apply(params)
                                          ^
    ParamSource (ParamStore | stub) <--poll-- reload thread

The live triple ``(device_params, version, swap_time)`` (here with the
upload's ready event beside it) is swapped by one reference assignment and
read once per batch, so every reply carries the version that produced it
and a swap never lands mid-batch.

On a card the server shares the device with a learner whose fused calls
run seconds of CUDA-graph replays on its own stream.  So:

  * **Forwards never queue behind the learner.**  The batch worker runs on
    a stream of its own, created with high priority; each batch copies its
    observations in through pinned staging, runs the forward, copies
    actions and q out into pinned host buffers and waits on an event
    recorded on that stream — never on ``torch.cuda.synchronize()``, which
    would wait for the learner's stream too.
  * **Reloads never tear a batch.**  The reload thread copies each new
    version into fresh device tensors on a copy stream of its own (pinned
    staging, then an event) and only then swaps the triple; the batch
    stream waits on that event before its first forward with the new
    params.  Old tensors are never written in place: a batch in flight
    holds them until its event has completed.

Forwards run eagerly; each bucket's host and device time per batch is
kept (``forward_times``).  A failed forward reaches every waiter of the
batch as its exception: nothing is served from the CPU in its place.
The chaos injector's per-batch delay (``apply_delay_ms``, config
``chaos.serving_delay_ms``) sleeps before each batch's forward, the mean
with a seeded ±25 % jitter: the same stream as the JAX package's for the
same ``delay_seed`` (JAX ``serving/server.py:67-75, :174-177``).
"""

from __future__ import annotations

import random
import threading
import time
from typing import Any, Optional

import numpy as np
import torch

from ape_x_dqn_tpu_torch.models.dueling import build_greedy_apply
from ape_x_dqn_tpu_torch.serving.batcher import (
    MicroBatcher,
    ServedAction,
    ServerOverloaded,
)


class PolicyServer:
    """Multi-client greedy-action service over one Q-network.

    Args:
      network: the port's Q-network module (``models/dueling.py``); only
        its structure is used, the params come from ``params`` / the source.
      params: initial params (a name → tensor dict, on any device); None
        pulls the first snapshot from ``param_source`` (blocking up to
        ``source_timeout_s``).
      param_source: optional ``get(have_version) -> (params, version) |
        None`` provider (the runtime's ``ParamStore`` or a test stub),
        polled every ``reload_poll_s`` while running.
      max_batch / max_wait_ms / queue_capacity: the batcher's knobs.
      device: where the forwards run, "cuda" unless the caller asks for
        the CPU; a missing card raises.
    """

    def __init__(
        self,
        network,
        params: Optional[Any] = None,
        *,
        param_source: Optional[Any] = None,
        max_batch: int = 32,
        max_wait_ms: float = 5.0,
        queue_capacity: int = 256,
        reload_poll_s: float = 0.25,
        source_timeout_s: float = 30.0,
        apply_delay_ms: float = 0.0,
        delay_seed: int = 0,
        device: str | torch.device = "cuda",
    ):
        # Chaos (chaos.serving_delay_ms): a seeded per-batch sleep that
        # makes service time sleep-bound.
        self._apply_delay_s = float(apply_delay_ms) / 1e3
        self._delay_rng = (random.Random(0xD31A ^ int(delay_seed))
                           if self._apply_delay_s > 0 else None)
        self.device = torch.device(device)
        self._cuda = self.device.type == "cuda"
        if self._cuda and not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' requested but no CUDA device is "
                               "available (pass device='cpu' to serve on the CPU)")
        self.network = network
        self._apply = build_greedy_apply(network)
        self._source = param_source
        self._reload_poll_s = float(reload_poll_s)
        if self._cuda:
            # Lower number = higher priority: the batch stream's kernels are
            # scheduled ahead of the learner's where both are ready.
            self._stream = torch.cuda.Stream(self.device, priority=-1)
            self._copy_stream = torch.cuda.Stream(self.device)
        self._staging: dict = {}          # reload: name -> pinned host tensor
        self._staged: Optional[torch.cuda.Event] = None
        self._io: dict = {}               # batch: (shape, dtype) -> pinned buffers
        self._times: dict = {}            # bucket -> [batches, host_s, device_ms]
        self._times_lock = threading.Lock()
        version = 0
        if params is None:
            if param_source is None:
                raise ValueError("need params or param_source")
            params, version = self._poll_first(param_source, source_timeout_s)
        # The live triple (+ its upload's ready event): swapped by ONE
        # reference assignment, read by ONE local bind per batch.
        self._live = (*self._upload(params), int(version), time.monotonic())
        self.reload_count = 0
        # Degraded mode: new submissions shed with the typed
        # ServerOverloaded (a staleness policy toggles it).
        self.degraded = False
        self._stop = threading.Event()
        self._warm_shapes: list = []      # warmed on the batch thread at start
        self._batcher = MicroBatcher(
            self._run_batch,
            max_batch=max_batch,
            max_wait_s=max_wait_ms / 1e3,
            queue_capacity=queue_capacity,
            on_start=self._warm_buckets,
        )
        self._reload_thread = (
            threading.Thread(target=self._reload_loop, name="serve-reload", daemon=True)
            if param_source is not None else None
        )
        self._started = False
        self._transport_stats = None

    @staticmethod
    def _poll_first(source, timeout_s: float):
        """First snapshot: ``get_blocking`` when the source has it, else a
        poll loop over the bare protocol."""
        if hasattr(source, "get_blocking"):
            return source.get_blocking(timeout=timeout_s)
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            got = source.get(-1)
            if got is not None:
                return got
            time.sleep(0.02)
        raise TimeoutError("param source published nothing within timeout")

    # -- lifecycle --------------------------------------------------------

    def start(self) -> "PolicyServer":
        if not self._started:
            self._started = True
            self._batcher.start()
            if self._reload_thread is not None:
                self._reload_thread.start()
        return self

    def close(self) -> None:
        self._stop.set()
        self._batcher.close()
        if self._reload_thread is not None and self._reload_thread.is_alive():
            self._reload_thread.join(timeout=5.0)

    def __enter__(self) -> "PolicyServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    def warmup(self, obs_shape) -> None:
        """Run every bucket shape once before opening the doors, so first
        requests pay queueing, not cuDNN's algorithm search, the handles'
        creation and the pinned buffers' allocation.  Called before
        ``start`` (the usual order), the forwards run on the batch thread
        when it starts: CUDA creates cuBLAS and cuDNN handles per thread,
        and creating one synchronizes the whole device, so on the batch
        thread's first request it would wait for every call the learner
        has queued.  After ``start`` they run on the caller's thread."""
        if not self._started:
            self._warm_shapes.append(tuple(obs_shape))
            return
        self._warm(tuple(obs_shape))

    def _warm_buckets(self) -> None:
        for shape in self._warm_shapes:
            self._warm(shape)

    def _warm(self, obs_shape) -> None:
        for b in self._batcher.buckets:
            self._run_batch(np.zeros((b, *obs_shape), np.uint8))
        with self._times_lock:
            self._times.clear()   # forward_times reports served batches only

    # -- request path -----------------------------------------------------

    def submit(self, obs):
        """Non-blocking: Future of ServedAction.  Typed errors on overload,
        the degraded mode included."""
        if self.degraded:
            self._batcher.shed_count += 1
            raise ServerOverloaded(
                f"serving degraded: params stale {self.param_age_s:.1f}s "
                "(source quiet past the configured bound); retry later"
            )
        return self._batcher.submit(obs)

    def act(self, obs, timeout: Optional[float] = 10.0) -> ServedAction:
        """Blocking convenience: one observation -> one ServedAction."""
        return self._batcher.submit(obs).result(timeout=timeout)

    def _run_batch(self, obs):
        params, ready, version, _ = self._live   # one coherent snapshot
        if self._delay_rng is not None:
            # ±25 % seeded jitter, so paced load does not phase-lock.
            time.sleep(self._apply_delay_s * (0.75 + 0.5 * self._delay_rng.random()))
        t0 = time.monotonic()
        if not self._cuda:
            actions, q = self._apply(params, torch.as_tensor(obs))
            self._count(obs.shape[0], time.monotonic() - t0, 0.0)
            return actions.numpy(), q.numpy(), version
        io = self._io.get((obs.shape, obs.dtype))
        if io is None:
            io = self._io[(obs.shape, obs.dtype)] = self._alloc_io(obs)
        pin_obs, pin_a, pin_q, start, done = io
        pin_obs.numpy()[...] = obs
        with torch.cuda.stream(self._stream):
            self._stream.wait_event(ready)       # the params' upload landed
            start.record(self._stream)
            x = pin_obs.to(self.device, non_blocking=True)
            actions, q = self._apply(params, x)
            pin_a.copy_(actions, non_blocking=True)
            pin_q.copy_(q, non_blocking=True)
            done.record(self._stream)
        # This stream's event only: the learner's stream is not waited on.
        done.synchronize()
        self._count(obs.shape[0], time.monotonic() - t0, start.elapsed_time(done))
        return pin_a.numpy().copy(), pin_q.numpy().copy(), version

    def _alloc_io(self, obs) -> tuple:
        """Pinned staging for one batch shape (observations in; int32
        actions and float32 q out) and its two timing events."""
        n = obs.shape[0]
        pinned = dict(pin_memory=True)
        return (torch.empty(obs.shape, dtype=torch.from_numpy(obs[:0]).dtype, **pinned),
                torch.empty(n, dtype=torch.int32, **pinned),
                torch.empty(n, self.network.num_actions, dtype=torch.float32, **pinned),
                torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))

    def _count(self, bucket: int, host_s: float, device_ms: float) -> None:
        with self._times_lock:
            row = self._times.setdefault(int(bucket), [0, 0.0, 0.0])
            row[0] += 1
            row[1] += host_s
            row[2] += device_ms

    def forward_times(self) -> dict:
        """Per bucket: batches run, and the mean host ms (the batch worker's
        wall time of one batch) and device ms (copy-in, forward and copy-out
        on the batch stream, between two events; 0 on the CPU) per batch."""
        with self._times_lock:
            rows = sorted((b, tuple(r)) for b, r in self._times.items())
        return {str(b): {"batches": n, "host_ms": round(h / n * 1e3, 4),
                         "device_ms": round(d / n, 4)} for b, (n, h, d) in rows}

    # -- reload path ------------------------------------------------------

    def _upload(self, params) -> tuple:
        """(fresh device copies of ``params``, their ready event or None).
        On a card: host → pinned staging, then a non-blocking copy on the
        copy stream into NEW tensors, then an event; the staging is reused
        once the previous upload's event has completed."""
        if not self._cuda:
            return {k: v.detach().to(self.device, copy=True)
                    for k, v in params.items()}, None
        if self._staged is not None:
            self._staged.synchronize()
        out = {}
        with torch.cuda.stream(self._copy_stream):
            for k, v in params.items():
                st = self._staging.get(k)
                if st is None or st.shape != v.shape or st.dtype != v.dtype:
                    st = self._staging[k] = torch.empty(v.shape, dtype=v.dtype,
                                                        pin_memory=True)
                st.copy_(v.detach())
                out[k] = st.to(self.device, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record(self._copy_stream)
        self._staged = ready
        return out, ready

    def poll_reload(self) -> bool:
        """One source poll; True if new params were adopted.  The upload
        runs before the swap: requests keep being served on the old params
        meanwhile, and the swap itself is one assignment."""
        got = self._source.get(self._live[2])
        if got is None:
            return False
        params, version = got
        device_params, ready = self._upload(params)
        self._live = (device_params, ready, int(version), time.monotonic())
        self.reload_count += 1
        return True

    def _reload_loop(self) -> None:
        while not self._stop.wait(self._reload_poll_s):
            try:
                self.poll_reload()
            except Exception:  # noqa: BLE001 — a flaky source must not kill
                pass           # serving; stale params are the degraded mode

    # -- observability ----------------------------------------------------

    @property
    def batcher(self) -> MicroBatcher:
        """The micro-batcher behind this server (the socket front end's
        seam)."""
        return self._batcher

    def attach_transport(self, stats_fn) -> None:
        """Fold a transport's stats into ``stats()`` under ``net``."""
        self._transport_stats = stats_fn

    @property
    def param_version(self) -> int:
        return self._live[2]

    @property
    def param_age_s(self) -> float:
        """Seconds since the live params were adopted."""
        return time.monotonic() - self._live[3]

    def stats(self) -> dict:
        """Serving metrics snapshot (the JAX package's keys)."""
        b = self._batcher
        _, _, version, swapped_at = self._live
        out = {
            "qps": round(b.served.rate(), 1),
            "served_total": int(b.served.total),
            "shed_total": b.shed_count,
            "error_total": b.error_count,
            "queue_depth": b.queue_depth,
            "param_version": version,
            "param_age_s": round(time.monotonic() - swapped_at, 3),
            "degraded": self.degraded,
            "reloads": self.reload_count,
            "batch_hist": {str(k): v for k, v in sorted(b.batch_hist.items())},
            "latency": b.latency.summary(),
            "by_version": {
                str(v): {"replies": row["replies"], "latency": row["hist"].summary()}
                for v, row in sorted(b.by_version.items())
            },
        }
        if self._source is not None and hasattr(self._source, "version"):
            out["versions_behind"] = max(0, int(self._source.version) - version)
        if self._transport_stats is not None:
            out["net"] = self._transport_stats()
        return out

    def emit_metrics(self, logger, **extra) -> dict:
        """Flush a serving record onto a ``MetricLogger`` under ``serve/``."""
        s = self.stats()
        logger.log("serve/qps", s["qps"])
        logger.log("serve/queue_depth", s["queue_depth"])
        logger.log("serve/param_version", s["param_version"])
        logger.log("serve/param_age_s", s["param_age_s"])
        lat = s["latency"]
        if lat.get("count"):
            logger.log("serve/p50_ms", lat["p50_ms"])
            logger.log("serve/p95_ms", lat["p95_ms"])
            logger.log("serve/p99_ms", lat["p99_ms"])
        return logger.emit(
            **{
                "serve/shed_total": s["shed_total"],
                "serve/served_total": s["served_total"],
                "serve/reloads": s["reloads"],
                "serve/batch_hist": s["batch_hist"],
            },
            **extra,
        )
