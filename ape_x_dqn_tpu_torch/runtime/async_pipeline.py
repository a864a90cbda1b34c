"""The async Ape-X pipeline: actor thread ∥ replay ∥ learner on one host.

Port of ``ape_x_dqn_tpu/runtime/async_pipeline.py``: the thread-actor
``_ActorWorker`` (:178-324), ``_AsyncPublisher`` (:50-118) and the two
single-device learner loops of ``AsyncPipeline``:

* **host replay** (``learner.device_replay=false``, the default; ``run``
  at :1279-1380):

      actor thread ──chunks──▶ PrioritizedReplay ◀──sample── prefetch thread
            ▲                                                  │ copy stream
            └── ParamStore ◀── publisher thread ◀── learner ◀──┘

  The prefetch thread samples on the host and copies each batch to the
  device behind the running step (``runtime/infeed.py``).  The learner
  dispatches one train step per batch and defers the priority write-back:
  the (host indices, device priorities) of each step wait in ``pending``
  and are flushed in one batched ``update_priorities`` when
  ``len(pending) >= learner.pipeline_depth``, before the new step is
  appended — so at depth 1 step t's priorities land after step t+1 is
  dispatched, and their device→host read only waits for a step that
  already has a successor queued.  Every ``publish_every`` steps the
  learner clones the params on the device and a publisher thread copies
  them to the host store, latest wins.  ``stage_us`` in the JSONL gives
  µs per call of ``sample+place``, ``step_dispatch``,
  ``priority_writeback`` and ``publish``.
* **device replay** (``true``): the actor thread stages numpy chunks, the
  learner ingests them into the device ring and runs fused K-step calls,
  each a handful of CUDA-graph replays on a card
  (``runtime/graphed_call.py``).  Two loops, as in the JAX runtime
  (:376-386): the strict ``_run_fused`` (:1536-1631; ``pipeline_depth`` 1
  and ``sync_every`` 0) ingests inline and keeps at most
  ``FUSED_INFLIGHT`` calls in flight before the oldest call's loss is read
  back; the overlapped ``_run_fused_overlapped`` (:1382-1534;
  ``learner.pipeline_depth`` > 1 or ``learner.sync_every`` > 0) carves
  ingest blocks on a stager thread (``_IngestStagerThread``, :120-175),
  folds the last full block into the call where the learner can, chains
  calls through ``runtime/infeed.DispatchPipeline`` and reports a
  ``pipeline`` section in the JSONL.  Both publish through the same
  ``_AsyncPublisher`` (JAX :1168-1177) and drive the double-store
  ``FusedDeviceLearner`` and the frame-dedup ``FusedDedupLearner``
  (``replay.dedup``) through one interface.

Actors run as one thread in this process (``actor.mode=thread``) or as
``actor.num_workers`` CPU-only worker processes (``actor.mode=process``,
JAX :583-648; ``runtime/process_actors.py``): the pool's shared-memory
store takes the ``ParamStore``'s place, a pump thread drains the workers'
rings into the same sink, and the fused loop lets 8 calls queue and reads
them all back at once, since no actor touches the device (JAX :353-375).

With ``actor.inference=central`` (JAX :658-680, :936-1080) the actors
are paramless: the runtime hosts a ``PolicyServer`` behind a
``ServingNetServer`` in this process, on the learner's device, fed by the
param store's publishes (``_build_central_serving``); thread fleets get a
``CentralSelector`` each incarnation, process workers dial the endpoint
the pool hands them.  Every emit then carries an ``inference`` section
(the fleet's client counters, ``version_lag``, ``batch_occupancy_mean``),
and ``register_jsonl_section`` lets a caller (``serve --attach``) add its
own.

Checkpoints (JAX :420-450, :745-770, :1497-1501, :1595-1606,
:1633-1725): every ``learner.checkpoint_every`` steps each loop saves the
train state and the replay (``utils/checkpoint``), the fused loops after
draining the staged rows into the ring and, in the overlapped loop, after
``pipeline.sync()`` (graph replays update the state in place, so a call in
flight would tear the snapshot).  With ``learner.checkpoint_incremental``
the replay leg is the chain of ``utils/checkpoint_inc`` instead, its
writer thread built after the restore so that it continues a resumed
chain, and flushed at exit.  Each save logs the learner-visible stall as
``ckpt/learner_stall_ms`` and the writer's counters go in a ``ckpt``
section.  A restored run resumes at the checkpoint's step; the fused
learner's ring restores once the learner exists.

Supervision (JAX :566-581, :804-815, :1083; ``runtime/supervisor.py``):
with ``supervisor.enabled`` a ``FleetSupervisor`` is the process pool's
respawn policy, and its watchdog reads the learner's progress (step, host
syncs) every ``supervisor.poll_s``: a stall past
``supervisor.stall_deadline_s`` drops the overlapped pipeline to strict
depth 1, a second deadline declares the run wedged.  Its counters ride
every emit as a ``supervisor`` section and its events go to the JSONL.
Process actors add an ``xp_transport`` section, and on the tcp transport a
``net`` section (JAX :640-646, :1845-1858).

Observability (JAX :464-565, :760-815; ``obs/``): a ``MetricsRegistry``
and a ``Health`` are always built.  The registry holds
``learner/host_syncs`` and ``learner/overlap_gap_ms`` (the overlapped
loop's blocking reads and device gaps), ``host/rss_bytes``, the
supervisor's counters and the providers ``learner``, ``stage_us``,
``workers``, ``xp_transport``, ``net``, ``inference``, ``ckpt`` and, on
the host-replay path, ``lineage``; ``/healthz`` has the components
``learner`` (beaten once per step or fused call, and while warming up),
``ingest``, ``ingest_stager``, ``ckpt_writer`` and ``supervisor``.  A
``FlightRecorder`` dumps a post-mortem on a fault or SIGTERM into
``obs.postmortem_dir`` ("auto": ``<checkpoint_dir>/postmortem`` when
checkpoints are on), where the process pool also writes its salvaged
workers' stats blocks.  The host path keeps a ``LineageTracker`` (ingest
from the actors' sink, sample at each batch, trained at the deferred
priority write-back); the fused ring never surfaces its sample indices.
With ``obs.export_port`` set the ``/metrics``, ``/varz`` and ``/healthz``
exporter starts last, with ``/varz?trace=1`` wired to a ``TraceOnDemand``
over the learner's steps.

Chaos (JAX :816-831, :1418-1421, :1741, :1790; ``obs/chaos.py``): with
``chaos.enabled`` a ``ChaosMonkey`` is built once the actors exist,
attached to the process pool and the checkpoint dir, its ``chaos/<kind>``
counters and ``chaos`` provider on the registry and its faults in the
JSONL (``chaos_fault``); it starts with the supervisor and stops before it.
Its stuck-stager gate acts only in the overlapped loop, whose stager idles
through a stall without beating its heartbeat.

The autopilot (JAX :832-901, :1743-1745, :1774-1781; ``autopilot/``,
``obs/fleet.py``, ``obs/timeline.py``): with ``autopilot.enabled`` an
in-process ``FleetAggregator`` reads this registry's snapshot as its
``trainer`` endpoint, its ``SloEngine`` (``obs.fleet_slo_*``) feeds an
``AutopilotController`` with the pool's ``ActorPoolActuator``, and a
``TimelineStore`` under ``obs.timeline_dir`` ("auto":
``<checkpoint_dir>/timeline`` when checkpoints are on) records each sweep.
Both threads start with the supervisor and close with the exporter; the
controller's state is the ``autopilot`` provider and JSONL section, the
store's the ``timeline`` provider.  The age of experience comes from the
``LineageTracker``, so the actor loop's age rule is measurable on the
host-replay path only.
"""

from __future__ import annotations

import os
import threading
import time
from typing import List, Optional

import numpy as np
import torch

from ape_x_dqn_tpu_torch.actors.pool import EpisodeStat
from ape_x_dqn_tpu_torch.config import ApexConfig
from ape_x_dqn_tpu_torch.obs import (
    FlightRecorder,
    Health,
    LineageTracker,
    MetricsRegistry,
)
from ape_x_dqn_tpu_torch.ops import rmsprop, sampling
from ape_x_dqn_tpu_torch.parallel.multihost import process_count, process_index
from ape_x_dqn_tpu_torch.runtime.components import build_components
from ape_x_dqn_tpu_torch.runtime.infeed import (
    DevicePlacer,
    DispatchPipeline,
    MeshPlacer,
    PrefetchQueue,
    loss_probe,
)
from ape_x_dqn_tpu_torch.runtime.param_store import ParamStore
from ape_x_dqn_tpu_torch.runtime.single_process import beta_schedule
from ape_x_dqn_tpu_torch.types import DedupChunk
from ape_x_dqn_tpu_torch.utils.metrics import MetricLogger, RateCounter
from ape_x_dqn_tpu_torch.utils.profiling import StageTimer

MAX_ACTOR_RESTARTS = 3
# At most this many fused calls in flight: reading call i-1's loss before
# dispatching i+1 keeps the actors' policy forwards from queueing behind a
# long backlog of learner work on the device.
FUSED_INFLIGHT = 2
# Host replay: batches staged on the device ahead of the learner (double
# buffering; deeper only adds priority staleness).
PREFETCH_DEPTH = 2
WARMUP_TIMEOUT_S = 600.0


class _AsyncPublisher:
    """Publish param snapshots off the learner thread.

    The learner only clones the params on the device (no host sync) and
    records an event after the clone; this thread waits for the event,
    copies the clone to the host and publishes it.  A 1-slot latest-wins
    mailbox: if publishing lags, intermediate versions are skipped, which
    the versioned store's readers never notice (actors want the newest).
    """

    def __init__(self, store: ParamStore):
        self._store = store
        self._pending = None
        self._busy = False
        self._cv = threading.Condition()
        self._stop = False
        self.error: Optional[BaseException] = None
        self._thread = threading.Thread(
            target=self._loop, name="param-publisher", daemon=True
        )
        self._thread.start()

    def submit(self, params: dict) -> None:
        """Hand over the learner's params: cloned here, on the learner's
        stream, so later in-place updates do not reach the snapshot."""
        snapshot = {k: v.detach().clone() for k, v in params.items()}
        ready = None
        device = next(iter(snapshot.values())).device
        if device.type == "cuda":
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(device))
        with self._cv:
            self._pending = (snapshot, ready)  # latest wins
            self._cv.notify()

    def flush(self, timeout: float = 120.0) -> bool:
        """Block until the newest submitted snapshot has been published.
        Returns False if work is still outstanding at the timeout."""
        deadline = time.monotonic() + timeout
        with self._cv:
            while (self._pending is not None or self._busy) \
                    and time.monotonic() < deadline:
                self._cv.wait(timeout=0.1)
            return self._pending is None and not self._busy

    def close(self) -> None:
        with self._cv:
            self._stop = True
            self._cv.notify()
        self._thread.join(timeout=30.0)

    def _loop(self) -> None:
        while True:
            with self._cv:
                while self._pending is None and not self._stop:
                    self._cv.wait()
                if self._pending is None and self._stop:
                    return
                (params, ready), self._pending = self._pending, None
                self._busy = True
            try:
                if ready is not None:
                    ready.synchronize()
                self._store.publish(params)
            except BaseException as e:  # noqa: BLE001 — surfaced by runtime
                self.error = e
            finally:
                with self._cv:
                    self._busy = False
                    self._cv.notify_all()


class _IngestStagerThread:
    """Double-buffered ingest: carve the next call's ingest blocks while the
    card runs the current one.

    The fused learners split ingest into host-CPU assembly
    (``prepare_staged``: drain the staged chunks, concatenate, carve fixed
    ``ingest_block`` blocks) and the device half (``add_block`` /
    ``train_with_ingest``, learner thread only).  This thread runs the
    assembly half continuously, so the learner thread's ingest shrinks to
    the device copies and scatters.
    """

    def __init__(self, fused, stop_event: threading.Event, drain_fn,
                 period_s: float = 0.005, stall_fn=None):
        self._fused = fused
        self._stop = stop_event
        self._drain_fn = drain_fn
        # Chaos gate (obs/chaos.ChaosMonkey.stager_stalled): while it returns
        # True the stager idles without beating its heartbeat, which is what
        # a wedged stager looks like to /healthz.
        self._stall_fn = stall_fn
        self._period = float(period_s)
        self.heartbeat = time.monotonic()
        self.prepared_rows = 0
        self.error: Optional[BaseException] = None
        self._done = threading.Event()
        self._thread = threading.Thread(target=self._loop, name="ingest-stager",
                                        daemon=True)

    def start(self) -> None:
        self._thread.start()

    def stop(self, timeout: float = 10.0) -> None:
        self._done.set()
        if self._thread.is_alive():
            self._thread.join(timeout)

    def _loop(self) -> None:
        while not self._stop.is_set() and not self._done.is_set():
            try:
                if self._stall_fn is not None and self._stall_fn():
                    self._done.wait(self._period)
                    continue
                n = self._fused.prepare_staged(drain=bool(self._drain_fn()))
                self.prepared_rows += n
                self.heartbeat = time.monotonic()
                if not n:
                    # Nothing staged: idle briefly instead of spinning a
                    # core the actors need.
                    self._done.wait(self._period)
            except BaseException as e:  # noqa: BLE001 — surfaced by runtime
                self.error = e
                return


class _ActorWorker:
    """Supervised actor-fleet thread with respawn-on-crash."""

    def __init__(self, comps, store: ParamStore, stop: threading.Event,
                 logger: MetricLogger, fps: RateCounter, sink,
                 selector_factory=None, lineage=None, trace_sample_rate: float = 0.0):
        import random

        self._comps = comps
        # Lineage (host replay): the sink returns the chunk's slots, and a
        # share ``trace_sample_rate`` of chunks open a trace.
        self._lineage = lineage
        self._trace_rate = float(trace_sample_rate)
        self._trace_rng = random.Random(comps.cfg.seed ^ 0x11E4)
        # Central inference: (fleet, incarnation) -> CentralSelector.
        self._selector_factory = selector_factory
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
        if self._thread.is_alive():
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
                selector = None
                if self._selector_factory is not None:
                    selector = self._selector_factory(fleet, self.restarts)
                else:
                    fleet.sync_params(self._store)
                self._run_fleet(fleet, self._comps.cfg.actor.T - steps_done, selector)
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

    def _run_fleet(self, fleet, max_steps: int, selector=None):
        source = self._store if selector is None else None
        while not self._stop.is_set() and fleet.step_count < max_steps:
            quantum = min(self._quantum, max_steps - fleet.step_count)
            chunks, stats = fleet.collect(quantum, param_source=source,
                                          selector=selector)
            for chunk in chunks:
                trace_id = 0
                if (self._lineage is not None and self._trace_rate
                        and self._trace_rng.random() < self._trace_rate):
                    trace_id = self._trace_rng.getrandbits(63) or 1
                # A remote replay's add is an RPC: it carries the chunk's
                # trace id, so the hop joins the lineage timeline.
                if getattr(self._sink, "takes_trace", False):
                    idx = self._sink(chunk.priorities, chunk.transitions, trace_id)
                else:
                    idx = self._sink(chunk.priorities, chunk.transitions)
                self.actor_steps += chunk.actor_steps
                self._fps.add(chunk.actor_steps)
                if self._lineage is not None and idx is not None:
                    self._lineage.on_ingest(idx, trace_id=trace_id)
            if stats:
                with self._ep_lock:
                    self.episodes.extend(stats)
            self.heartbeat = time.monotonic()


class AsyncPipeline:
    """One-host async runtime.  ``run()`` blocks the caller as the learner."""

    def __init__(
        self,
        cfg: ApexConfig,
        logger: Optional[MetricLogger] = None,
        log_every: int = 500,
        device: str = "cuda",
        eval_every: int = 0,
        eval_episodes: int = 10,
    ):
        self.comps = build_components(cfg, device=device)
        self.cfg = self.comps.cfg
        self.logger = logger or MetricLogger()
        self.log_every = log_every
        self.stop_event = threading.Event()
        self._fps = RateCounter(window_s=30.0)
        self._steps_rate = RateCounter(window_s=30.0)
        # Per-stage host wall clock, exported as stage_us in every emit; the
        # process's current timer, so the fused learners, the graph runner
        # and the serving tier record their spans into it.
        self.timers = StageTimer().make_current()
        self._learner_step = self.comps.learner_step
        self.train_seconds = 0.0  # wall time of the learner loop, after warmup
        # Host path: write-back batching.  Device path: depth > 1 or a sync
        # cadence selects the overlapped loop (JAX :376-386).
        self._pipeline_depth = max(1, int(self.cfg.learner.pipeline_depth))
        self._sync_every = max(0, int(self.cfg.learner.sync_every))
        self._overlapped = self._pipeline_depth > 1 or self._sync_every > 0
        self._dispatch_pipeline: Optional[DispatchPipeline] = None
        self._run_start_step = 0
        self.fused = None
        process = self.cfg.actor.mode == "process"
        # Fused-call drain: with thread actors, read back the oldest call
        # once FUSED_INFLIGHT are queued, so the actors' forwards interleave
        # with the learner's calls.  Process actors never touch the device:
        # let 8 calls queue and read them all back in one burst.
        self._fused_inflight = 8 if process else FUSED_INFLIGHT
        self.mesh = None
        # Process identity in a process group (1 / 0 without one): every
        # seed, sample size and checkpoint path below is process-aware.
        self._n_proc = process_count()
        self._proc_idx = process_index()
        if self._n_proc > 1:
            # Multi-process sanity (JAX :395-420): each process would train a
            # divergent model on a fractional batch without a mesh over every
            # process, and the device ring has no multi-process story.
            if self.cfg.learner.device_replay:
                raise ValueError(
                    "learner.device_replay=True is single-process only — "
                    "multi-process runs use the host-replay path with "
                    "learner.data_parallel spanning every process's devices")
            if self.cfg.learner.data_parallel <= 1:
                raise ValueError(
                    f"process_count()={self._n_proc} requires learner.data_parallel "
                    "> 1: the mesh must span every process's devices, or each "
                    "process trains an independent model on a fractional batch")
            if self.cfg.learner.replay_sample_size % self._n_proc:
                raise ValueError("learner.replay_sample_size must divide by "
                                 f"process_count()={self._n_proc}")
        if self.cfg.learner.device_replay:
            self.fused = self.comps.make_fused_learner()
            if self.comps.restored_path is not None:
                self._restore_ring(self.comps.restored_path)
            sink = self.fused.add_chunk
        else:
            add = sink = self.comps.replay.add
            if getattr(self.comps.replay, "remote", False):
                # Replay as a service (JAX :616-622): the add RPC carries the
                # chunk's trace id.
                def sink(prio, trans, trace_id=0):
                    return add(prio, trans, trace_id=trace_id)

                sink.takes_trace = True
            if self.cfg.learner.data_parallel > 1:
                # The data-parallel learner (JAX :447-460): the same loop with
                # the mesh step, batches split over the slots, and replica 0's
                # params published as they are.  In a process group each
                # process samples its B / process_count rows from its own
                # replay and writes back only those.
                self.train_step, sharded, self.mesh = self.comps.make_sharded_train_step()
                self.comps.state = sharded
                self._place = MeshPlacer(self.mesh, local=self._n_proc > 1)
            else:
                self.train_step = self.comps.make_train_step()
                self._place = DevicePlacer(self.comps.device)
            self._sample = self.comps.make_sampler(
                lambda: self._learner_step,
                sample_size=self.cfg.learner.replay_sample_size // self._n_proc,
                rng_salt=self._proc_idx * 7919)
        central = self.cfg.actor.inference == "central"
        self._jsonl_sections: dict = {}
        self._build_obs()
        self.supervisor = None
        if self.cfg.supervisor.enabled:
            from ape_x_dqn_tpu_torch.runtime.supervisor import FleetSupervisor

            self.supervisor = FleetSupervisor(self.cfg.supervisor, registry=self.obs_registry,
                                              health=self.health, emit=self.logger.event,
                                              seed=self.cfg.seed)
            # A learner wedged inside a dispatch advances neither count.
            self.supervisor.attach_learner(
                progress_fn=lambda: (self._learner_step, int(self._host_syncs.value)),
                degrade_fn=self._degrade_pipeline)
            self.register_jsonl_section("supervisor", self._supervisor_section)
        self._central_server = None
        self._central_net = None
        self._central_selectors: list = []
        self._central_endpoint = None
        if process:
            self._init_process_actors(sink)
        else:
            self.store = ParamStore(self.comps.state.params)
            self.worker = _ActorWorker(
                self.comps, self.store, self.stop_event, self.logger, self._fps,
                sink=sink,
                selector_factory=self._make_central_selector if central else None,
                lineage=self._lineage, trace_sample_rate=self.cfg.obs.trace_sample_rate,
            )
        if central:
            try:
                self._build_central_serving()
            except BaseException:
                self._close_central()
                self.worker.join()   # releases a pool's segments
                raise
            self.register_jsonl_section("inference", self._inference_section)
            self.obs_registry.register_provider("inference", self._inference_section)
        self.obs_registry.register_provider("learner", self._learner_varz)
        self.obs_registry.register_provider("trace_spans", self._trace_spans)
        self.obs_registry.register_provider("stage_us", self.timers.us_per_call)
        if self.fused is not None:
            self.register_jsonl_section("learner_timeline", self.timers.timeline)
            self.obs_registry.register_provider("learner_timeline", self.timers.timeline)
        self.health.register("ingest", lambda: time.monotonic() - self.worker.heartbeat)
        self._publisher = _AsyncPublisher(self.store)
        # Built after the restore, so that its first save continues a
        # resumed run's committed chain instead of starting a new base.
        self._ckpt_inc = None
        lc = self.cfg.learner
        if lc.checkpoint_every and lc.checkpoint_incremental:
            from ape_x_dqn_tpu_torch.utils.checkpoint import replay_shard_suffix
            from ape_x_dqn_tpu_torch.utils.checkpoint_inc import IncrementalCheckpointer

            # One chain per process, under this process's shard suffix.
            self._ckpt_inc = IncrementalCheckpointer(
                lc.checkpoint_dir, self.fused if self.fused is not None else self.comps.replay,
                suffix=replay_shard_suffix(), base_every=lc.checkpoint_base_every,
                compress=lc.checkpoint_compress)
            self.register_jsonl_section("ckpt", self._ckpt_inc.stats)
            self.obs_registry.register_provider("ckpt", self._ckpt_inc.stats)
            # Saves are sparse, so the writer's liveness is structural: its
            # thread alive (or not started) and no error recorded.
            ckpt = self._ckpt_inc
            self.health.register("ckpt_writer", lambda: 0.0 if (
                ckpt.error is None and (ckpt._thread is None or ckpt._thread.is_alive())
            ) else float("inf"))
        # Periodic greedy evaluation on the learner thread; 0 disables.
        self._eval_every = int(eval_every)
        self._eval_episodes = int(eval_episodes)
        self._next_eval = self._eval_every
        self._evaluator = None
        self.eval_scores: List[float] = []
        self.fleet_registry = self._host_fleet_registry()
        self._chaos = None
        if self.cfg.chaos.enabled:
            # The chaos monkey (obs/chaos): a seeded fault schedule against
            # this run's own workers and checkpoint chain (JAX :816-831).
            from ape_x_dqn_tpu_torch.obs.chaos import ChaosMonkey

            self._chaos = ChaosMonkey(self.cfg.chaos, registry=self.obs_registry,
                                      emit=self.logger.event)
            self._chaos.attach(pool=getattr(self.worker, "pool", None),
                               ckpt_dirs=[lc.checkpoint_dir] if lc.checkpoint_every else [])
        self.autopilot = None
        self.autopilot_aggregator = None
        if self.cfg.autopilot.enabled:
            self._build_autopilot()
        self._start_exporter()

    # -- observability -------------------------------------------------------

    def _build_obs(self) -> None:
        """The registry, health, flight recorder and (host replay) lineage
        tracker, before anything registers on them (JAX :464-565)."""
        from ape_x_dqn_tpu_torch.utils.memory import rss_bytes

        ocfg = self.cfg.obs
        reg = self.obs_registry = MetricsRegistry()
        # Blocking device reads on the learner thread, and the device's idle
        # between fused dispatches (0 when the next call was queued in time):
        # the overlapped loop's two observables, counted per call or sync.
        self._host_syncs = reg.counter("learner/host_syncs",
                                       help="blocking device reads on the learner thread")
        self._overlap_gap = reg.histogram("learner/overlap_gap_ms",
                                          help="device idle between fused dispatches (ms)",
                                          min_s=1e-2, max_s=6e4, per_decade=10)
        reg.gauge("host/rss_bytes", help="resident set size of this process").set_fn(rss_bytes)
        self.health = Health(stale_after_s=ocfg.heartbeat_stale_s)
        self._postmortem_dir = self._resolve_postmortem_dir()
        self.recorder = FlightRecorder("trainer", depth=ocfg.recorder_depth)
        self.recorder.add_snapshot_provider("varz", reg.snapshot)
        self._lineage = None
        if self.fused is None:
            self._lineage = LineageTracker(self.cfg.replay.capacity, emit=self.logger.event)
            reg.register_provider("lineage", self._lineage.summary)
            lineage = self._lineage
            reg.gauge("lineage/clock_skew_clamped",
                      help="cross-host act timestamps clamped to ingest time"
                      ).set_fn(lambda: lineage.clock_skew_clamped)
        self._sigterm = False     # this run's SIGTERM dump is installed
        self.trace_on_demand = None
        self.obs_server = None
        self.obs_port = None
        self._build_tier_obs()
        self._build_replay_svc_obs()

    def _build_replay_svc_obs(self) -> None:
        """A service-attached replay (JAX :539-552, :1032): its stats are the
        ``replay_svc`` ``/varz`` provider and JSONL section, its age the
        ``replay_svc`` ``/healthz`` component (a down shard is DEGRADED,
        never a wedge); its RPC hop spans join the ``trace_spans`` provider."""
        self._remote_replay = None
        replay = self.comps.replay
        if replay is None or not getattr(replay, "remote", False):
            return
        self._remote_replay = replay
        reg = self.obs_registry
        reg.register_provider("replay_svc", replay.stats)
        self.health.register("replay_svc", replay.age_s)
        self.register_jsonl_section("replay_svc", replay.stats)

    def _build_tier_obs(self) -> None:
        """The tiered replay's instruments (JAX :508-537), only when the host
        replay runs with a hot frame budget: three gauges on the registry
        (``/metrics``), the tier dict as the ``replay_tier`` ``/varz``
        provider and JSONL section; the host loop runs a ``TierEvictor``
        thread beside it (spills never ride the learner thread)."""
        self._tier_evictor = None
        replay = self.comps.replay
        tier = getattr(replay, "tier", None)
        if tier is None:
            return
        reg = self.obs_registry
        reg.gauge("replay/spilled_bytes", help="bytes written to the replay cold tier"
                  ).set_fn(lambda: tier.spilled_bytes)
        reg.gauge("replay/fault_reads", help="cold-span fault reads on the sample path"
                  ).set_fn(lambda: tier.fault_reads)
        reg.gauge("replay/hot_bytes", help="resident frame bytes in the replay hot tier"
                  ).set_fn(lambda: tier.hot_bytes)
        reg.register_provider("replay_tier", replay.tier_stats)
        self.register_jsonl_section("replay_tier", replay.tier_stats)

    def _build_autopilot(self) -> None:
        """The elastic autopilot (``autopilot.*``; JAX :832-901, :933-934).
        Its sensor is an in-process ``FleetAggregator`` whose ``trainer``
        endpoint is this registry's own snapshot, with the config's SLO
        rules subscribed into the controller; a ``TimelineStore`` records
        every sweep (and rebuilds the SLO windows from a previous
        incarnation's tail).  The actor loop actuates on this run's pool; a
        caller attaches a serving or replay fleet itself
        (``autopilot.attach_serving`` / ``attach_replay``, their endpoints on
        ``autopilot_aggregator``).  Under ``fleet.discovery=registry`` the
        aggregator adopts the membership registry's members."""
        from ape_x_dqn_tpu_torch.autopilot import ActorPoolActuator, AutopilotController
        from ape_x_dqn_tpu_torch.obs.fleet import FleetAggregator, engine_from_config

        ocfg = self.cfg.obs
        slo = engine_from_config(ocfg, emit=self.logger.event)
        agg = self.autopilot_aggregator = FleetAggregator(
            scrape_interval_s=ocfg.fleet_scrape_interval_s,
            scrape_timeout_s=ocfg.fleet_scrape_timeout_s,
            window_s=ocfg.fleet_slo_window_s, slo=slo)
        agg.add_local("trainer", self.obs_registry.snapshot, kind="trainer")
        tl_dir = self._resolve_timeline_dir()
        if tl_dir is not None:
            from ape_x_dqn_tpu_torch.obs.timeline import TimelineStore

            try:
                agg.attach_timeline(TimelineStore(
                    tl_dir, max_bytes=ocfg.timeline_max_bytes,
                    segment_bytes=ocfg.timeline_segment_bytes,
                    tail_keep_s=ocfg.timeline_tail_keep_s))
                self.obs_registry.register_provider("timeline", agg.timeline.stats)
            except OSError as e:
                # An unwritable directory means no recorder; the sweeps and
                # the SLO engine still run.
                self.logger.event("timeline_open_failed", error=str(e))
        self.autopilot = AutopilotController(self.cfg.autopilot, rollup_fn=agg.rollup,
                                             emit=self.logger.event)
        slo.subscribe(self.autopilot.on_slo_event)
        pool = getattr(self.worker, "pool", None)
        if pool is not None:
            # Bound late: the overlapped loop builds its pipeline at run time.
            self.autopilot.attach_actor(ActorPoolActuator(
                pool, pipeline_fn=lambda: self._dispatch_pipeline))
        self.obs_registry.register_provider("autopilot", self.autopilot.state)
        self.register_jsonl_section("autopilot", self.autopilot.state)
        if self.fleet_registry is not None:
            agg.bind_registry(self.fleet_registry)

    def _resolve_timeline_dir(self) -> Optional[str]:
        """``obs.timeline_dir``, by ``_resolve_postmortem_dir``'s policy: a
        path is used as given; "auto" is ``<checkpoint_dir>/timeline`` when
        checkpoints are on, else off (JAX :1105-1119)."""
        import os

        d = self.cfg.obs.timeline_dir
        if d == "auto":
            lc = self.cfg.learner
            return os.path.join(lc.checkpoint_dir, "timeline") if lc.checkpoint_every else None
        return d

    def _resolve_postmortem_dir(self) -> Optional[str]:
        """``obs.postmortem_dir``: a path is used as given; "auto" is
        ``<checkpoint_dir>/postmortem`` when checkpoints are on, else off."""
        import os

        d = self.cfg.obs.postmortem_dir
        if d == "auto":
            lc = self.cfg.learner
            return os.path.join(lc.checkpoint_dir, "postmortem") if lc.checkpoint_every else None
        return d

    def _start_exporter(self) -> None:
        """The on-demand tracer and, with ``obs.export_port`` set, the
        exporter: last, once every provider is registered."""
        from ape_x_dqn_tpu_torch.obs import ObsServer, TraceOnDemand

        ocfg = self.cfg.obs
        self.trace_on_demand = TraceOnDemand(
            steps=ocfg.trace_steps, out_dir=ocfg.trace_dir,
            counters_fn=self._trace_counters, beat_fn=lambda: self.health.beat("learner"))
        if ocfg.export_port is not None:
            self.obs_server = ObsServer(self.obs_registry, self.health,
                                        port=ocfg.export_port,
                                        trace_hook=self.trace_on_demand.trigger)
            self.obs_port = self.obs_server.port
            self.logger.event("obs_exporter", port=self.obs_port, url=self.obs_server.url)

    def _host_fleet_registry(self):
        """Under ``fleet.discovery=registry`` the trainer hosts the run's
        membership registry (JAX :905-935): serving replicas and other
        members join over the announce wire.  Its port and token ride a
        ``fleet_registry_listen`` event; the membership snapshot is the
        ``fleet_membership`` provider, and the autopilot's aggregator adopts
        its members (``_build_autopilot``)."""
        f = self.cfg.fleet
        if f.discovery != "registry":
            return None
        import secrets

        from ape_x_dqn_tpu_torch.fleet.registry import FleetRegistry

        reg = FleetRegistry(token=secrets.randbits(63) or 1, host=f.registry_host,
                            port=f.registry_port, ttl_s=f.ttl_s,
                            on_event=self.logger.event).serve()
        self.logger.event("fleet_registry_listen", host=f.registry_host, port=reg.port,
                          token=reg.token)
        self.obs_registry.register_provider("fleet_membership", reg.snapshot)
        return reg

    def _trace_counters(self) -> dict:
        """What a capture's record holds as ``counters`` (deltas over its
        window): the sampler's and the RMSProp kernel's launches and, on the
        fused path, the graph runner's replays; on the host path the
        learner's steps (the fused path's ``_learner_step`` moves only after
        a call, and its window starts and stops inside one: its steps are
        ``steps_traced``)."""
        out = {"sampler_launches": sampling.sample_indices.launches,
               "rmsprop_launches": rmsprop.update_.launches}
        if self.fused is None:
            out["learner_steps"] = self._learner_step
        else:
            out["graph_replays"] = self.fused.graphed_call.replays
        return out

    def close_exporter(self) -> None:
        """Close the exporter (``serve --obs-port`` mounts its own over this
        registry, on the same port)."""
        if self.obs_server is not None:
            self.obs_server.close()
            self.obs_server = None

    def _obs_run_start(self, target: int) -> None:
        """The flight recorder's run header, the SIGTERM dump (main thread
        only) and the learner's first beat."""
        self._sigterm = bool(self._postmortem_dir) and self.recorder.install_sigterm(
            self._postmortem_dir)
        self.recorder.record("run_start", target=target,
                             mode="fused" if self.fused is not None else "host",
                             actor_mode=self.cfg.actor.mode)
        self.health.beat("learner")

    def _obs_fault(self, e: BaseException) -> None:
        """A fault: one recorded event and a post-mortem dump, neither of
        which may hide the exception that brought us here."""
        self.recorder.record("fault", error=f"{type(e).__name__}: {e}")
        self.recorder.dump(self._postmortem_dir, "fault")

    def _close_obs(self) -> None:
        """End of a run (learner thread): a capture in flight stops, the
        exporter and the fleet registry close and the SIGTERM handler this
        run installed gives way to the one before it (it holds this
        runtime)."""
        self.trace_on_demand.close()
        self.close_exporter()
        if self.autopilot is not None:
            # The controller first: it acts on what the aggregator senses.
            # Closing the aggregator commits the timeline's active segment.
            self.autopilot.close()
            self.autopilot_aggregator.close()
        if self.fleet_registry is not None:
            self.fleet_registry.close()
            self.fleet_registry = None
        if self._remote_replay is not None:
            # Stop the probe thread and release the RPC sockets.  Soft: a
            # later op on the client reconnects; only background recovery
            # stops.
            try:
                self._remote_replay.close()
            except Exception:  # noqa: BLE001 — teardown best-effort
                pass
        if self._sigterm:
            self.recorder.restore_sigterm()
            self._sigterm = False

    def _learner_varz(self) -> dict:
        """The ``learner`` section of ``/varz``: the numbers the JSONL emit
        carries, readable between emits."""
        return {
            "step": self._learner_step,
            "steps_per_sec": round(self._steps_rate.rate(), 1),
            "actor_fps": round(self._fps.rate(), 1),
            "actor_steps": self.worker.actor_steps,
            "actor_restarts": self.worker.restarts,
            "param_version": self.store.version,
            "actor_heartbeat_age": round(time.monotonic() - self.worker.heartbeat, 3),
            "replay_size": self._replay_size(),
        }

    def _obs_extra(self) -> dict:
        """The JSONL ``workers`` (the stats blocks' sweep) and ``lineage``
        sections."""
        out: dict = {}
        pool = getattr(self.worker, "pool", None)
        if pool is not None:
            ws = pool.worker_stats()
            if ws:
                out["workers"] = ws
        if self._lineage is not None and self._lineage.age_hist.count:
            out["lineage"] = self._lineage.summary(include_recent=False)
        return out

    def _restore_ring(self, path: str) -> None:
        """The second half of a resume: the device ring (and its staged
        rows) from the checkpoint's replay leg, the npz or the chain."""
        from ape_x_dqn_tpu_torch.utils.checkpoint import load_replay_leg
        from ape_x_dqn_tpu_torch.utils.metrics import emit_event

        if load_replay_leg(path, self.fused) is None:
            emit_event("checkpoint_restore_missing_replay", path=path,
                       consequence="fused ring resumes empty")

    def _init_process_actors(self, sink) -> None:
        """Actors in CPU-only worker processes (``runtime/process_actors``):
        the pool's shared-memory store replaces the ``ParamStore`` and gets
        the initial params before any worker starts."""
        from ape_x_dqn_tpu_torch.runtime.process_actors import (
            ProcessActorPool,
            ProcessActorWorker,
        )

        pool = ProcessActorPool(self.cfg, num_workers=self.cfg.actor.num_workers,
                                postmortem_dir=self._postmortem_dir)
        if self.supervisor is not None:
            self.supervisor.attach_pool(pool)
        self.register_jsonl_section("xp_transport", pool.transport_stats)
        self.obs_registry.register_provider("workers", pool.worker_stats)
        self.obs_registry.register_provider("xp_transport", pool.transport_stats)
        if pool.transport_kind == "tcp":
            self.register_jsonl_section("net", pool.net_stats)
            self.obs_registry.register_provider("net", pool.net_stats)
        if pool.store is None:
            # Central-paramless fleet: the workers get actions, not params;
            # a host store feeds the serving tier's reload.
            self.store = ParamStore(self.comps.state.params)
        else:
            self.store = pool.store
            try:
                self.store.publish(self.comps.state.params)
            except BaseException:
                pool.stop()
                raise
        if self.fused is not None:
            fused = self.fused

            def process_sink(prio, trans):
                # The pool hands over read-only views of one ring record;
                # the staging list keeps rows past the next poll, so copy.
                fused.add_chunk(prio.copy(), trans.copy() if isinstance(trans, DedupChunk)
                                else trans.map(np.copy))
        else:
            # replay.add copies into its own arrays (a remote add encodes
            # them into its request body).
            process_sink = sink
        self.worker = ProcessActorWorker(pool, process_sink, logger=self.logger,
                                         fps=self._fps, stop_event=self.stop_event,
                                         lineage=self._lineage)

    # -- central inference ---------------------------------------------------

    def _build_central_serving(self) -> None:
        """Resolve the central-inference endpoint (JAX :936-979): with port 0
        host a ``PolicyServer`` (on this runtime's device, reloading from
        the param store) behind a ``ServingNetServer`` on an ephemeral port
        with a fresh run token; a nonzero port names an external server.
        The endpoint goes to the process pool before its workers spawn."""
        a, s = self.cfg.actor, self.cfg.serving
        host, port, token = a.inference_host, int(a.inference_port), int(a.inference_token)
        if port == 0:
            import secrets

            from ape_x_dqn_tpu_torch.serving.net_server import ServingNetServer
            from ape_x_dqn_tpu_torch.serving.server import PolicyServer

            if token == 0:
                token = secrets.randbits(63) or 1
            server = PolicyServer(
                self.comps.network, param_source=self.store,
                max_batch=s.max_batch, max_wait_ms=s.max_wait_ms,
                queue_capacity=s.queue_capacity, reload_poll_s=s.reload_poll_s,
                device=self.comps.device,
            )
            self._central_server = server
            server.warmup(self.comps.obs_shape)
            server.start()
            self._central_net = ServingNetServer(
                server, host=host, port=0,
                max_request_bytes=s.max_request_bytes, run_token=token,
            ).start()
            port = self._central_net.port
            self.logger.event("central_inference_listen", port=port, host=host)
        self._central_endpoint = (host, port, token)
        pool = getattr(self.worker, "pool", None)
        if pool is not None:
            pool.set_inference_endpoint(host, port, token)

    def _make_central_selector(self, fleet, incarnation: int = 0):
        """Thread-mode selector factory (JAX :981-1019): one client and
        selector per fleet incarnation, dialing the resolved endpoint."""
        from ape_x_dqn_tpu_torch.serving.central import (
            CentralInferenceClient,
            CentralSelector,
            InferenceUnavailable,
        )

        a = self.cfg.actor
        host, port, token = self._central_endpoint
        rate = self.cfg.obs.trace_sample_rate
        client = CentralInferenceClient(
            host, port, wid=0, attempt=incarnation, token=token,
            codec=a.inference_codec, dedup=a.inference_dedup,
            inflight=a.inference_inflight, seed=self.cfg.seed, trace=rate > 0,
        )
        fallback = None
        if a.inference_fallback == "local":
            def fallback(obs, step):
                fleet.sync_params(self.store)
                if fleet.params is None:
                    raise InferenceUnavailable("no param snapshot yet")
                actions, q = fleet._policy_step(fleet.params, obs, fleet._epsilons)
                return actions, q, fleet.param_version
        sel = CentralSelector(
            client, fleet._epsilons.cpu().numpy(), fleet.envs.num_actions,
            seed=self.cfg.seed + 77_000 + incarnation,
            timeout_s=a.inference_timeout_s, trace_sample_rate=rate, fallback=fallback,
            should_stop=self.stop_event.is_set,
        )
        for old in self._central_selectors:
            old.close()
        self._central_selectors = [sel]   # the latest incarnation's
        return sel

    def _trace_spans(self) -> dict:
        """The ``trace_spans`` provider (JAX :1026-1047): the cross-tier
        spans of every log this process owns (the replay service client's
        RPC hops, the central serving tier's server hops, thread fleets'
        inference clients) and the live workers' (``act`` spans and their
        inference clients', swept off the stats blocks); the newest 256."""
        spans: list = []
        recorded = 0
        logs = []
        if self._remote_replay is not None:
            logs.append(self._remote_replay.spans)
        if self._central_net is not None:
            logs.append(self._central_net.spans)
        logs.extend(sel.client.spans for sel in self._central_selectors)
        for log in logs:
            snap = log.snapshot()
            recorded += snap["recorded"]
            spans.extend(snap["spans"])
        pool = getattr(self.worker, "pool", None)
        if pool is not None:
            worker_spans = pool.trace_events()
            recorded += len(worker_spans)
            spans.extend(worker_spans)
        return {"recorded": recorded, "spans": spans[-256:]}

    def _inference_section(self) -> dict:
        """The JSONL ``inference`` section (JAX :1049-1080): the fleet's
        client aggregate, ``version_lag`` (publishes the newest reply's
        version trails the store by) and the in-process batcher's mean
        occupancy."""
        from ape_x_dqn_tpu_torch.serving.central import aggregate_inference_stats

        pool = getattr(self.worker, "pool", None)
        if pool is not None:
            out = pool.inference_stats()
        else:
            out = aggregate_inference_stats(
                [s.stats(include_hist=True) for s in self._central_selectors])
        v = out.get("param_version", -1)
        out["version_lag"] = max(0, self.store.version - v) if v >= 0 else None
        occ = None
        if self._central_server is not None:
            hist = dict(self._central_server.batcher.batch_hist)
            total = sum(hist.values())
            if total:
                occ = round(sum(k * c for k, c in hist.items()) / total, 2)
        out["batch_occupancy_mean"] = occ
        return out

    def _close_central(self) -> None:
        """Close the serving tier (the workers are joined by then; the
        server's counters outlive it for the final emit)."""
        for part in (self._central_net, self._central_server, *self._central_selectors):
            if part is not None:
                try:
                    part.close()
                except Exception:  # noqa: BLE001 — teardown best-effort
                    pass

    def register_jsonl_section(self, name: str, fn) -> None:
        """Fold ``fn()`` into every emit as section ``name`` (JAX :1815); a
        section that raises is left out of that record."""
        self._jsonl_sections[str(name)] = fn

    def _sections_extra(self) -> dict:
        out = {}
        for name, fn in list(self._jsonl_sections.items()):
            try:
                out[name] = fn()
            except Exception:  # noqa: BLE001 — a sick section must not
                pass           # take the emit down
        return out

    @property
    def learner_step(self) -> int:
        return self._learner_step

    def _replay_size(self) -> int:
        return self.fused.size if self.fused is not None else self.comps.replay.size()

    def _wait_for_warmup(self, timeout: float) -> None:
        """Block until the replay holds min_replay_mem_size transitions; in
        device-replay mode each poll ingests staged chunks."""
        fused, need = self.fused, self.cfg.learner.min_replay_mem_size
        deadline = time.monotonic() + timeout
        while True:
            self.health.beat("learner")
            if fused is not None:
                fused.ingest_staged(drain=self.worker.finished)
            size = self._replay_size()
            if size >= need:
                return
            if self.stop_event.is_set():
                raise RuntimeError("actors stopped during warmup") from self.worker.error
            staged = fused.staged_rows if fused is not None else 0
            if self.worker.finished and staged == 0:
                raise RuntimeError(
                    f"actors exhausted actor.T={self.cfg.actor.T} env steps "
                    f"with replay at {size} / {need} — raise actor.T "
                    "or lower learner.min_replay_mem_size"
                )
            if time.monotonic() > deadline:
                raise TimeoutError(f"replay warmup stalled at {size} / {need}")
            time.sleep(0.05)

    def run(self, learner_steps: Optional[int] = None) -> dict:
        """Train until ``learner_steps`` (default: config total_steps)."""
        target = learner_steps if learner_steps is not None else self.cfg.learner.total_steps
        self._obs_run_start(target)
        if self.supervisor is not None:
            self.supervisor.start()
        if self._chaos is not None:
            self._chaos.start()
        if self.autopilot is not None:
            self.autopilot_aggregator.start()
            self.autopilot.start()
        try:
            if self.fused is None:
                return self._run_host(target)
            if self._overlapped:
                return self._run_fused_overlapped(target)
            return self._run_fused(target)
        except BaseException as e:
            self._obs_fault(e)
            raise
        finally:
            if self._chaos is not None:
                self._chaos.stop()
            if self.supervisor is not None:
                self.supervisor.close()
            self._close_obs()

    # -- supervision -------------------------------------------------------

    def _degrade_pipeline(self) -> None:
        """The watchdog's degrade action: strict dispatch from now on (and a
        flight-recorder mark)."""
        self.recorder.record("pipeline_degraded", step=self._learner_step)
        p = self._dispatch_pipeline
        if p is not None:
            p.degrade()

    def _supervisor_section(self) -> dict:
        """The JSONL ``supervisor`` section (JAX :1908-1921)."""
        s = self.supervisor
        return {"respawns": int(s.respawns.value), "quarantines": int(s.quarantines.value),
                "degradations": int(s.degradations.value),
                "fallback_restores": int(s.fallback_restores.value),
                "quarantined": sorted(s.respawn_policy.quarantined),
                "watchdog": s.watchdog.phase if s.watchdog is not None else None}

    # -- host replay -------------------------------------------------------

    def _run_host(self, target: int) -> dict:
        cfg = self.cfg
        metrics = None
        evictor = None
        if getattr(self.comps.replay, "tier", None) is not None:
            from ape_x_dqn_tpu_torch.replay.tiered import TierEvictor

            evictor = self._tier_evictor = TierEvictor(self.comps.replay)
        try:
            self.worker.start()
            if evictor is not None:
                evictor.start()
                self.health.register("tier_evictor",
                                     lambda: time.monotonic() - evictor.heartbeat)
            self._wait_for_warmup(WARMUP_TIMEOUT_S)
            t0 = time.monotonic()
            with PrefetchQueue(self._sample, place_fn=self._place,
                               depth=PREFETCH_DEPTH) as queue:
                # (host indices, device priorities) of steps whose
                # write-back is still deferred.
                pending: list = []
                state = self.comps.state
                while self._learner_step < target and not self.stop_event.is_set():
                    self.health.beat("learner")
                    with self.timers.stage("sample+place"):
                        placed = queue.get()
                        batch = placed.wait()
                    if self._lineage is not None:
                        self._lineage.on_sample(placed.indices)
                        if self._remote_replay is not None:
                            # A traced slot in the batch stamps the parked
                            # sample-RPC span (JAX :1318-1324).
                            tids = self._lineage.trace_ids_for(placed.indices)
                            if tids:
                                self._remote_replay.tag_sample_span(tids[0])
                    with self.timers.stage("step_dispatch"):
                        state, metrics = self.train_step(state, batch)
                    self.comps.state = state
                    self._learner_step += 1
                    self._steps_rate.add(1)
                    self.trace_on_demand.tick(self._learner_step)
                    if len(pending) >= self._pipeline_depth:
                        self._flush_priority_writeback(pending)
                    pending.append((placed.indices, metrics.priorities))
                    if self._learner_step % cfg.learner.publish_every == 0:
                        with self.timers.stage("publish"):
                            self._publish(state.params)
                    if (cfg.learner.checkpoint_every
                            and self._learner_step % cfg.learner.checkpoint_every == 0):
                        with self.timers.stage("checkpoint"):
                            self._save_checkpoint()
                    self._maybe_eval()
                    if self._learner_step % self.log_every == 0:
                        self._emit(metrics)
                if pending:
                    self._flush_priority_writeback(pending)
            self._finish_publishes()
            self._finish_checkpoints()
            self.train_seconds = time.monotonic() - t0
        finally:
            self.stop_event.set()
            self.worker.join()
            if evictor is not None and evictor.is_alive():
                evictor.stop()
            self._publisher.close()
            self._close_checkpoints()
            self._close_central()
        if self.worker.error is not None:
            raise RuntimeError("actor worker died") from self.worker.error
        if evictor is not None and evictor.error is not None:
            raise RuntimeError("tier evictor died") from evictor.error
        # The final emit carries the last step's metrics (one host read), so
        # the returned record always has learner/loss.
        return self._emit(metrics, final=True)

    # -- checkpoints -------------------------------------------------------

    def _save_checkpoint(self) -> str:
        """One periodic save (learner thread): the state leg (with the fused
        learner's sampling generator), and the replay as an npz or, with the
        incremental chain, a snapshot handed to its writer thread.  A fused
        learner's staged rows are drained into the ring first, so a restore
        from this checkpoint loses none of them; the host loop's deferred
        priority write-backs stay deferred, as in JAX."""
        from ape_x_dqn_tpu_torch.parallel.multihost import barrier
        from ape_x_dqn_tpu_torch.utils.checkpoint import (
            replay_shard_suffix,
            save_checkpoint,
            save_replay_snapshot,
        )

        fused = self.fused
        if fused is not None:
            fused.ingest_staged(drain=True)
            state, replay, generator = fused.state, fused, fused.generator
        else:
            state, replay, generator = self.comps.state, self.comps.replay, None
            if self.mesh is not None:
                state = state.host_state()
            if self._remote_replay is not None:
                replay = None   # the shards own their chains
        sfx = replay_shard_suffix()
        t0 = time.perf_counter()
        if self._ckpt_inc is not None:
            # Each process's chain commits on its own manifest: no barrier.
            self._ckpt_inc.save(int(state.step))
            replay = None
        elif self._n_proc > 1:
            # Every process's replay leg on disk before process 0 commits the
            # state leg that marks the step restorable (JAX :1662-1685).
            if self._proc_idx != 0 and replay is not None:
                save_replay_snapshot(self.cfg.learner.checkpoint_dir, int(state.step),
                                     replay, replay_suffix=sfx)
            barrier("replay-shards-before-state-commit")
        if self._proc_idx != 0:
            return os.path.join(self.cfg.learner.checkpoint_dir, f"step_{state.step}")
        path = save_checkpoint(self.cfg.learner.checkpoint_dir, state, replay=replay,
                               generator=generator, replay_suffix=sfx)
        stall_ms = (time.perf_counter() - t0) * 1e3
        self.logger.log("ckpt/learner_stall_ms", stall_ms)
        self.recorder.record("checkpoint", step=self._learner_step, stall_ms=round(stall_ms, 1))
        return path

    def _finish_checkpoints(self) -> None:
        """Drain the incremental writer on success: an unwritten final delta
        is replay lost at the next resume.  Re-raises a writer failure."""
        if self._ckpt_inc is not None and not self._ckpt_inc.flush():
            raise RuntimeError("incremental checkpoint writer could not drain within "
                               "its timeout — the final replay delta was never committed")

    def _close_checkpoints(self) -> None:
        """Exit-path close, best effort: the success path already surfaced
        writer failures."""
        if self._ckpt_inc is not None:
            try:
                self._ckpt_inc.close(timeout=30.0)
            except Exception:  # noqa: BLE001 — teardown must not mask the primary error
                pass

    def _flush_priority_writeback(self, pending: list) -> None:
        """Commit the deferred (indices, priorities) in one batched update,
        in step order, so the sum-tree's last-write-wins resolves duplicate
        slots exactly as sequential per-step updates would.  Clears
        ``pending`` in place."""
        with self.timers.stage("priority_writeback"):
            idx = np.concatenate([i for i, _ in pending])
            prio = torch.cat([p for _, p in pending]).cpu().numpy()
            if self._remote_replay is not None:
                # A traced experience among these slots stamps the
                # write-back RPC, the timeline's last hop (JAX :1228-1234).
                tids = (self._lineage.trace_ids_for(idx)
                        if self._lineage is not None else [])
                self._remote_replay.update_priorities(
                    idx, prio, trace_id=tids[0] if tids else 0)
            else:
                self.comps.replay.update_priorities(idx, prio)
        if self._lineage is not None:
            # The read above waited for these steps' device work: their
            # slots are trained.
            self._lineage.on_trained(idx)
        pending.clear()

    def _publish(self, params) -> None:
        # A publisher failure surfaces at the next publish, not at the end
        # of the run (actors would act on stale params the whole time).
        if self._publisher.error is not None:
            raise RuntimeError("param publisher failed") from self._publisher.error
        self._publisher.submit(params)

    def _finish_publishes(self) -> None:
        flushed = self._publisher.flush()
        if self._publisher.error is not None:
            raise RuntimeError("param publisher failed") from self._publisher.error
        if not flushed:
            raise RuntimeError("param publisher could not drain within its "
                               "timeout — the final snapshot was never published")

    def _maybe_eval(self) -> None:
        if not self._eval_every or self._learner_step < self._next_eval:
            return
        while self._next_eval <= self._learner_step:
            self._next_eval += self._eval_every
        from ape_x_dqn_tpu_torch.evaluation import log_result, make_evaluator

        if self._evaluator is None:
            self._evaluator = make_evaluator(
                self.comps.env_fns, self.comps.network,
                env_name=self.cfg.env.name, seed=self.cfg.seed,
                device=self.comps.device,
            )
        params = (self.fused.params_for_publish() if self.fused is not None
                  else self.comps.state.params)
        with self.timers.stage("eval"):
            res = self._evaluator.evaluate(params, episodes=self._eval_episodes)
        self.eval_scores.append(res.mean_score)
        log_result(self.logger, res)

    # -- device replay -----------------------------------------------------

    def _force_fused(self, metrics) -> None:
        """Wait for one fused call (a tiny host read of its last loss) and
        credit its steps to the completion-time rate."""
        float(metrics.loss[-1])
        self._steps_rate.add(self.fused.steps_per_call)

    def _run_fused(self, target: int) -> dict:
        """Ingest staged actor chunks, then fused K-step calls."""
        cfg = self.cfg
        fused = self.fused
        drain_all = cfg.actor.mode == "process"
        last_metrics = None
        inflight: list = []  # metrics of dispatched calls not yet read back
        try:
            self.worker.start()
            self._wait_for_warmup(WARMUP_TIMEOUT_S)
            t0 = time.monotonic()
            next_log = self._learner_step + self.log_every
            next_ckpt = self._next_checkpoint()
            while self._learner_step < target and not self.stop_event.is_set():
                with self.timers.stage("call"):
                    self.health.beat("learner")
                    fused.ingest_staged(drain=self.worker.finished)
                    beta = beta_schedule(self._learner_step, cfg.learner.total_steps,
                                         cfg.replay.is_exponent)
                    # The tracer ticks between the call's replays: a capture
                    # starts and stops inside a call.
                    last_metrics = fused.train(beta, on_replay=self.trace_on_demand.tick)
                    inflight.append(last_metrics)
                    if len(inflight) >= self._fused_inflight:
                        with self.timers.stage("drain"):
                            self._force_fused(inflight.pop(0))
                            while drain_all and inflight:
                                self._force_fused(inflight.pop(0))
                    self._learner_step += fused.steps_per_call
                    # Publish at most once per fused call.
                    if self._learner_step % max(
                        cfg.learner.publish_every, fused.steps_per_call
                    ) < fused.steps_per_call:
                        with self.timers.stage("publish"):
                            self._publish(fused.params_for_publish())
                    if next_ckpt is not None and self._learner_step >= next_ckpt:
                        with self.timers.stage("checkpoint"):
                            self._save_checkpoint()
                        next_ckpt += cfg.learner.checkpoint_every
                    self._maybe_eval()
                    if self._learner_step >= next_log:
                        with self.timers.stage("emit"):
                            self._emit(last_metrics)
                        next_log += self.log_every
            while inflight:
                self._force_fused(inflight.pop(0))
            self._finish_publishes()
            self._finish_checkpoints()
            self.train_seconds = time.monotonic() - t0
        finally:
            self.stop_event.set()
            self.worker.join()
            self._publisher.close()
            self._close_checkpoints()
            self._close_central()
        if self.worker.error is not None:
            raise RuntimeError("actor worker died") from self.worker.error
        if last_metrics is not None:
            loss = last_metrics.loss.cpu().numpy()
            if not np.all(np.isfinite(loss)):
                raise FloatingPointError("non-finite loss in fused learner")
        return self._emit(last_metrics, final=True)

    def _run_fused_overlapped(self, target: int) -> dict:
        """The overlapped pipeline (``learner.pipeline_depth`` > 1 or
        ``learner.sync_every`` > 0): chain fused calls with no host sync
        between them, carve ingest blocks on the stager thread while the
        card runs, fold the last full block into the next call where the
        learner supports it, and retire calls through their probes.

        Host syncs happen only when the window is full and the oldest call
        missed its poll deadline, at the ``sync_every`` cadence, and at emit
        and exit, each counted in ``pipeline.host_syncs``.  Bit for bit the
        strict path's result for the same chunk order
        (``tests/test_torch_pipeline_overlap.py``)."""
        cfg = self.cfg
        fused = self.fused
        self._run_start_step = self._learner_step
        last_metrics = None
        # The callbacks hold what they need, not ``self``: no reference
        # cycle keeps a finished pipeline (and its device ring) alive.
        rate, worker = self._steps_rate, self.worker
        pipeline = DispatchPipeline(
            self._pipeline_depth, probe_fn=loss_probe,
            on_retire=lambda _m, steps: rate.add(steps),
            sync_counter=self._host_syncs, gap_hist_ms=self._overlap_gap,
        )
        self._dispatch_pipeline = pipeline
        chaos = self._chaos
        stager = _IngestStagerThread(
            fused, self.stop_event, lambda: worker.finished,
            stall_fn=chaos.stager_stalled if chaos is not None else None)
        try:
            self.worker.start()
            self._wait_for_warmup(WARMUP_TIMEOUT_S)
            stager.start()
            self.health.register("ingest_stager",
                                 lambda: time.monotonic() - stager.heartbeat)
            t0 = time.monotonic()
            next_log = self._learner_step + self.log_every
            next_sync = (self._learner_step + self._sync_every
                         if self._sync_every else None)
            next_ckpt = self._next_checkpoint()
            while self._learner_step < target and not self.stop_event.is_set():
                with self.timers.stage("call"):
                    self.health.beat("learner")
                    if stager.error is not None:
                        raise RuntimeError("ingest stager failed") from stager.error
                    with self.timers.stage("ingest") as span:
                        # Device half only: the stager carved the blocks.  The
                        # last full block rides with the call where it can.
                        blocks = fused.pop_prepared()
                        fold = None
                        if blocks and fused.supports_ingest_fold \
                                and len(blocks[-1][0]) == cfg.learner.ingest_block:
                            fold = blocks.pop()
                        if blocks:
                            with fused.graphed_call.stream_piece():
                                span.rows = sum(fused.add_block(*blk) for blk in blocks)
                            span.blocks = len(blocks)
                    beta = beta_schedule(self._learner_step, cfg.learner.total_steps,
                                         cfg.replay.is_exponent)
                    tick = self.trace_on_demand.tick   # between the call's replays
                    with self.timers.stage("fused_dispatch"):
                        if fold is not None:
                            last_metrics = pipeline.dispatch(
                                lambda: fused.train_with_ingest(beta, *fold, on_replay=tick),
                                fused.steps_per_call)
                        else:
                            last_metrics = pipeline.dispatch(
                                lambda: fused.train(beta, on_replay=tick), fused.steps_per_call)
                    self._learner_step += fused.steps_per_call
                    if next_sync is not None and self._learner_step >= next_sync:
                        # Cadence: bound how far the host-visible metrics and
                        # flow control trail the dispatch edge.
                        with self.timers.stage("pipeline_sync"):
                            pipeline.sync()
                        while next_sync <= self._learner_step:
                            next_sync += self._sync_every
                    if self._learner_step % max(
                        cfg.learner.publish_every, fused.steps_per_call
                    ) < fused.steps_per_call:
                        with self.timers.stage("publish"):
                            self._publish(fused.params_for_publish())
                    if next_ckpt is not None and self._learner_step >= next_ckpt:
                        # Graph replays update the state in place: every call
                        # dispatched must have landed before the snapshot.
                        pipeline.sync()
                        with self.timers.stage("checkpoint"):
                            self._save_checkpoint()
                        next_ckpt += cfg.learner.checkpoint_every
                    self._maybe_eval()
                    if self._learner_step >= next_log:
                        with self.timers.stage("emit"):
                            pipeline.sync()  # the emit reads last_metrics on the host
                            self._emit(last_metrics)
                        next_log += self.log_every
            pipeline.sync()
            self._finish_publishes()
            self._finish_checkpoints()
            self.train_seconds = time.monotonic() - t0
        finally:
            self.stop_event.set()
            stager.stop()
            self.worker.join()
            self._publisher.close()
            self._close_checkpoints()
            self._close_central()
        if stager.error is not None and not isinstance(stager.error, Exception):
            raise RuntimeError("ingest stager died") from stager.error
        if self.worker.error is not None:
            raise RuntimeError("actor worker died") from self.worker.error
        if last_metrics is not None:
            loss = last_metrics.loss.cpu().numpy()
            if not np.all(np.isfinite(loss)):
                raise FloatingPointError("non-finite loss in fused learner")
        return self._emit(last_metrics, final=True)

    def _next_checkpoint(self) -> Optional[int]:
        every = self.cfg.learner.checkpoint_every
        return self._learner_step + every if every else None

    def _pipeline_extra(self) -> dict:
        """The JSONL ``pipeline`` section (JAX :1860-1881): host syncs
        against the steps this run took, and the overlap gaps."""
        p = self._dispatch_pipeline
        steps = max(1, self._learner_step - self._run_start_step)
        syncs = int(self._host_syncs.value)
        gp50, gp95 = (self._overlap_gap.percentile(q) for q in (50, 95))
        return {
            "depth": p.depth,
            "sync_every": self._sync_every,
            "host_syncs": syncs,
            "syncs_per_1k_steps": round(1000.0 * syncs / steps, 3),
            "overlap_gap_ms_p50": round(gp50, 3) if gp50 == gp50 else None,
            "overlap_gap_ms_p95": round(gp95, 3) if gp95 == gp95 else None,
            "gaps_observed": p.gaps_observed,
            "inflight": len(p),
        }

    # -- metrics -----------------------------------------------------------

    def _emit(self, metrics, final: bool = False) -> dict:
        for e in self.worker.drain_episodes():
            self.logger.log("episode/return", e.episode_return)
            self.logger.log("episode/length", e.episode_length)
        if metrics is not None:
            # One host read per log period; a fused call's metrics are
            # stacked over its K steps, the last one is logged.
            self.logger.log("learner/loss", float(metrics.loss.reshape(-1)[-1]))
            self.logger.log("learner/mean_q", float(metrics.mean_q.reshape(-1)[-1]))
        # The sampler kernel's launches in this process (0 on the host path,
        # which samples on the CPU) and the RMSProp kernel's (two a step on
        # the card): a learner run as its own process reports them here.
        path = {"stage_us": self.timers.us_per_call(),
                "sampler_launches": sampling.sample_indices.launches,
                "rmsprop_launches": rmsprop.update_.launches}
        if self.fused is not None:
            path["staged_rows"] = self.fused.staged_rows
        if self._dispatch_pipeline is not None:
            path["pipeline"] = self._pipeline_extra()
        path.update(self._obs_extra())
        path.update(self._sections_extra())
        return self.logger.emit(
            step=self._learner_step,
            actor_steps=self.worker.actor_steps,
            replay_size=self._replay_size(),
            steps_per_sec=round(self._steps_rate.rate(), 1),
            actor_fps=round(self._fps.rate(), 1),
            param_version=self.store.version,
            actor_restarts=self.worker.restarts,
            actor_heartbeat_age=round(time.monotonic() - self.worker.heartbeat, 3),
            train_s=round(self.train_seconds, 3),
            **path,
            final=final,
        )
