"""The async Ape-X pipeline, device-replay form: actor thread ∥ fused learner.

Port of the thread-actor ``_ActorWorker`` (``ape_x_dqn_tpu/runtime/
async_pipeline.py:178-324``) and the strict fused path ``_run_fused``
(:1536-1631) with ``_emit_fused``:

  actor thread ──numpy chunks──▶ FusedDeviceLearner staging
        ▲                                   │ ingest (learner thread)
        └──── ParamStore (host copies) ◀── K-step fused calls on the device

* **Actor stage**: one supervised thread runs the fleet; a crash respawns
  it (actors are stateless modulo ε/seed) up to ``MAX_ACTOR_RESTARTS``.
* **Learner stage**: runs on the caller's thread — ingest staged chunks,
  one fused call of K steps, at most ``FUSED_INFLIGHT`` calls in flight
  before the oldest call's loss is read back, publish params at the capped
  rate, emit JSONL at ``log_every`` steps.

The overlapped pipeline, process actors, central inference, observability
and checkpoints of the JAX runtime are not part of the port yet.  A publish
copies the params to the host on the learner thread, which waits for the
device: with K steps per call it happens at most once per call.
"""

from __future__ import annotations

import threading
import time
from typing import List, Optional

import numpy as np

from ape_x_dqn_tpu_torch.actors.pool import EpisodeStat
from ape_x_dqn_tpu_torch.config import ApexConfig
from ape_x_dqn_tpu_torch.runtime.components import build_components
from ape_x_dqn_tpu_torch.runtime.param_store import ParamStore
from ape_x_dqn_tpu_torch.runtime.single_process import beta_schedule
from ape_x_dqn_tpu_torch.utils.metrics import MetricLogger, RateCounter

MAX_ACTOR_RESTARTS = 3
# At most this many fused calls in flight: reading call i-1's loss before
# dispatching i+1 keeps the actors' policy forwards from queueing behind a
# long backlog of learner work on the device.
FUSED_INFLIGHT = 2
WARMUP_TIMEOUT_S = 600.0


class _ActorWorker:
    """Supervised actor-fleet thread with respawn-on-crash."""

    def __init__(self, comps, store: ParamStore, stop: threading.Event,
                 logger: MetricLogger, fps: RateCounter, sink):
        self._comps = comps
        self._store = store
        self._stop = stop
        self._logger = logger
        self._fps = fps
        self._sink = sink            # (priorities, transitions) -> None
        self._quantum = comps.cfg.actor.flush_every
        self.restarts = 0
        self.finished = False        # clean exit (actor.T reached), not a crash
        self.heartbeat = time.monotonic()
        self.episodes: List[EpisodeStat] = []
        self._ep_lock = threading.Lock()
        self.actor_steps = 0
        self.error: Optional[BaseException] = None
        self._thread = threading.Thread(
            target=self._supervise, name="actor-fleet", daemon=True
        )

    def start(self):
        self._thread.start()

    def join(self, timeout: float = 30.0):
        self._thread.join(timeout)

    def drain_episodes(self) -> List[EpisodeStat]:
        with self._ep_lock:
            out, self.episodes = self.episodes, []
        return out

    def _supervise(self):
        # actor.T bounds TOTAL env steps, so a respawned fleet only gets the
        # remaining budget.
        steps_done = 0
        while not self._stop.is_set():
            fleet = None
            try:
                fleet = self._comps.make_fleet(seed_offset=self.restarts)
                fleet.sync_params(self._store)
                self._run_fleet(fleet, self._comps.cfg.actor.T - steps_done)
                self.finished = not self._stop.is_set()
                return
            except Exception as e:  # noqa: BLE001 — respawn boundary
                if self._stop.is_set():
                    return
                if fleet is not None:
                    steps_done += fleet.step_count
                self.restarts += 1
                self._logger.log("actor/restarts", self.restarts)
                if self.restarts > MAX_ACTOR_RESTARTS:
                    self.error = e
                    self._stop.set()
                    return
                time.sleep(0.1)

    def _run_fleet(self, fleet, max_steps: int):
        while not self._stop.is_set() and fleet.step_count < max_steps:
            quantum = min(self._quantum, max_steps - fleet.step_count)
            chunks, stats = fleet.collect(quantum, param_source=self._store)
            for chunk in chunks:
                self._sink(chunk.priorities, chunk.transitions)
                self.actor_steps += chunk.actor_steps
                self._fps.add(chunk.actor_steps)
            if stats:
                with self._ep_lock:
                    self.episodes.extend(stats)
            self.heartbeat = time.monotonic()


class AsyncPipeline:
    """One-host device-replay runtime.  ``run()`` blocks the caller as the
    learner."""

    def __init__(
        self,
        cfg: ApexConfig,
        logger: Optional[MetricLogger] = None,
        log_every: int = 500,
        device: str = "cuda",
    ):
        self.comps = build_components(cfg, device=device)
        self.cfg = self.comps.cfg
        self.logger = logger or MetricLogger()
        self.log_every = log_every
        self.stop_event = threading.Event()
        self._fps = RateCounter(window_s=30.0)
        self._steps_rate = RateCounter(window_s=30.0)
        self.fused = self.comps.make_fused_learner()
        self.store = ParamStore(self.comps.state.params)
        self.worker = _ActorWorker(
            self.comps, self.store, self.stop_event, self.logger, self._fps,
            sink=self.fused.add_chunk,
        )
        self._learner_step = 0
        self.train_seconds = 0.0  # wall time of the fused loop, after warmup

    def _force_fused(self, metrics) -> None:
        """Wait for one fused call (a tiny host read of its last loss) and
        credit its steps to the completion-time rate."""
        float(metrics.loss[-1])
        self._steps_rate.add(self.fused.steps_per_call)

    def _wait_for_warmup(self, timeout: float) -> None:
        """Ingest staged chunks until the ring holds min_replay_mem_size."""
        fused, need = self.fused, self.cfg.learner.min_replay_mem_size
        deadline = time.monotonic() + timeout
        while True:
            fused.ingest_staged(drain=self.worker.finished)
            if fused.size >= need:
                return
            if self.stop_event.is_set():
                raise RuntimeError("actors stopped during warmup") from self.worker.error
            if self.worker.finished and fused.staged_rows == 0:
                raise RuntimeError(
                    f"actors exhausted actor.T={self.cfg.actor.T} env steps "
                    f"with replay at {fused.size} / {need} — raise actor.T "
                    "or lower learner.min_replay_mem_size"
                )
            if time.monotonic() > deadline:
                raise TimeoutError(f"replay warmup stalled at {fused.size} / {need}")
            time.sleep(0.05)

    def run(self, learner_steps: Optional[int] = None) -> dict:
        """Device-replay mode: ingest staged actor chunks, then fused K-step
        calls until ``learner_steps`` (default: config total_steps)."""
        cfg = self.cfg
        fused = self.fused
        target = learner_steps if learner_steps is not None else cfg.learner.total_steps
        self.worker.start()
        last_metrics = None
        inflight: list = []  # metrics of dispatched calls not yet read back
        try:
            self._wait_for_warmup(WARMUP_TIMEOUT_S)
            t0 = time.monotonic()
            next_log = self._learner_step + self.log_every
            while self._learner_step < target and not self.stop_event.is_set():
                fused.ingest_staged(drain=self.worker.finished)
                beta = beta_schedule(self._learner_step, cfg.learner.total_steps,
                                     cfg.replay.is_exponent)
                last_metrics = fused.train(beta)
                inflight.append(last_metrics)
                if len(inflight) >= FUSED_INFLIGHT:
                    self._force_fused(inflight.pop(0))
                self._learner_step += fused.steps_per_call
                # Publish at most once per fused call.
                if self._learner_step % max(
                    cfg.learner.publish_every, fused.steps_per_call
                ) < fused.steps_per_call:
                    self.store.publish(fused.params_for_publish())
                if self._learner_step >= next_log:
                    self._emit_fused(last_metrics)
                    next_log += self.log_every
            while inflight:
                self._force_fused(inflight.pop(0))
            self.train_seconds = time.monotonic() - t0
        finally:
            self.stop_event.set()
            self.worker.join()
        if self.worker.error is not None:
            raise RuntimeError("actor worker died") from self.worker.error
        if last_metrics is not None:
            loss = last_metrics.loss.cpu().numpy()
            if not np.all(np.isfinite(loss)):
                raise FloatingPointError("non-finite loss in fused learner")
        return self._emit_fused(last_metrics, final=True)

    def _emit_fused(self, metrics, final: bool = False) -> dict:
        for e in self.worker.drain_episodes():
            self.logger.log("episode/return", e.episode_return)
            self.logger.log("episode/length", e.episode_length)
        if metrics is not None:
            # One host read per log period, not per call.
            self.logger.log("learner/loss", float(metrics.loss[-1]))
            self.logger.log("learner/mean_q", float(metrics.mean_q[-1]))
        return self.logger.emit(
            step=self._learner_step,
            actor_steps=self.worker.actor_steps,
            replay_size=self.fused.size,
            staged_rows=self.fused.staged_rows,
            steps_per_sec=round(self._steps_rate.rate(), 1),
            actor_fps=round(self._fps.rate(), 1),
            param_version=self.store.version,
            actor_restarts=self.worker.restarts,
            actor_heartbeat_age=round(time.monotonic() - self.worker.heartbeat, 3),
            train_s=round(self.train_seconds, 3),
            final=final,
        )
