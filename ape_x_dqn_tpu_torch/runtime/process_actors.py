"""Process-parallel actors: N CPU-only worker processes feeding one learner.

Port of ``ape_x_dqn_tpu/runtime/process_actors.py`` (``actor.mode=process``)
on the same transport stack, so the segments and records are the JAX
package's:

  * **Param broadcast** — ``SharedParamBuffer``, a single-writer
    shared-memory seqlock holding one APXT snapshot
    (``utils/serialization``).  The learner writes at its publish rate;
    workers poll the version and deserialize only on change; a reader never
    blocks the writer and checks a crc32 of what it copied.
  * **Experience** — one SIGKILL-safe single-producer/single-consumer ring
    per worker incarnation (``runtime/shm_ring.ShmRing``): a worker gathers
    each chunk into its ring once, the learner drains every ring in one
    round-robin sweep per poll and hands whole chunks to the replay as
    read-only views over the record it copied out.  A worker killed
    mid-record leaves a detectably torn tail, not a held lock.  An
    ``mp.Queue`` per incarnation carries only control messages (episodes,
    done, errors, the worker's final report).
  * **Workers run on the CPU by design.**  Exactly one process, the
    learner, holds a context on the card.  A worker hides the card before
    it imports torch, builds its fleet with ``device="cpu"``, sets its
    intra-op threads to the usable cores divided by the worker count, and
    reports ``torch.cuda.is_initialized()`` when it finishes.  Workers are
    started with the ``spawn`` method, never ``fork``: the learner holds a
    CUDA context and threads before the pool starts.
  * Each worker runs an ``ActorFleet`` over its slice of the global actor
    set (``worker_slice``), with the ε-ladder indexed globally, so
    exploration matches the thread layout.  A respawned worker gets only
    its remaining ``actor.T`` budget.
  * With ``replay.dedup`` a worker's fleet emits ``DedupChunk``s, which
    travel as ``DXP`` records: the arrays in the APXT body, ``source``,
    ``chunk_seq`` and ``prev_frames`` in the record's prefix (JAX
    :537-548), and the pool decodes them back to ``DedupChunk``s (JAX
    :1404-1411).  A respawned worker's fresh fleet has a fresh source, so
    the consumer drops only the rows that carried into the dead one.

  * **Central inference** (``actor.inference=central``, JAX :394-500,
    :827, :1296-1320): a worker builds a ``CentralInferenceClient`` and
    ``CentralSelector`` against the endpoint the pool was given
    (``set_inference_endpoint``) and acts from the serving tier's replies.
    Without the local fallback the fleet is paramless: no param buffer
    exists, none is mapped and nothing is published to the workers
    (``param_spec = {"kind": "none"}``).  Each worker ships its client's
    counters on the control queue every quantum; ``inference_stats``
    folds them into the JSONL ``inference`` section.

  * **The tcp transport** (``actor.transport=tcp``, JAX :709-760): the
    rings become one ``NetChannel`` per worker incarnation behind one
    listener (``runtime/transport.TcpTransport``), drained by the same
    sweep; the params ride each connection in reverse as delta-or-full
    frames (``NetParamStore``; a worker's param spec is ``{"kind":
    "net"}`` and its source a ``NetParamSource`` over its writer).  No
    /dev/shm segment exists on this backend, so the shm budget gate does
    not apply; a dead incarnation's channel is salvaged (committed records
    delivered, a torn tail counted, never decoded) and retired from the
    transport's registry, its counters folded into the ``net`` stats.
  * **Remote workers** (``actor.remote_workers``, JAX :1046-1096): channels
    reserved for worker ids above the local capacity and a join spec
    written for ``python -m ape_x_dqn_tpu_torch.host_join``; the pool never
    spawns or supervises them.
  * **Elastic grow/retire** (``actor.max_workers``, JAX :1097-1200): the
    ε-ladder partition is carved over the local capacity at construction;
    ``grow`` spawns reserved ids, ``retire`` ends one worker's collect loop
    at its next quantum boundary (a clean drain, never a kill).

  * **Observability** (JAX :405-437, :800-905, :1548-1625): the parent
    creates one ``obs/shm_stats.WorkerStatsBlock`` per local worker
    incarnation and the worker is its single writer: slot values once per
    quantum and a flight recorder (``obs/recorder``) mirrored into the
    block's event ring, readable after a SIGKILL.  The salvage of a dead
    incarnation turns its block into a post-mortem record (and a file,
    with a post-mortem dir); blocks are unlinked at salvage, at retire
    and at ``stop``.  ``worker_stats`` sweeps the live blocks.  A worker
    stamps a random trace id on a share ``obs.trace_sample_rate`` of its
    chunks (the envelope's trace field) and the pump hands each chunk's
    slots, send time and trace id to the lineage tracker.  A central
    worker's client traces at the same rate into its recorder.  Remote
    workers have no block.

  * **Chaos** (JAX :363-371): with ``chaos.enabled`` and
    ``chaos.env_latency_ms`` > 0 each worker env is wrapped in
    ``obs/chaos.SlowEnv``, seeded ``chaos.seed + 71·i`` for the worker's
    i-th actor, as in the JAX package.

This module imports only the standard library and numpy at module scope:
a spawned child imports it before the worker target runs, and pays for
whatever it imports.
"""

from __future__ import annotations

import json
import multiprocessing as mp
import os
import queue as queue_mod
import struct
import threading
import time
import zlib
from multiprocessing import shared_memory
from typing import List, Optional

import numpy as np

from ape_x_dqn_tpu_torch.runtime.shm_ring import (
    DXP,
    XP,
    create_shared_memory,
    decode_chunk,
    encode_chunk_parts,
    owner_finalizer,
)
from ape_x_dqn_tpu_torch.runtime.transport import (
    NetParamSource,
    NetParamStore,
    connect_channel,
    make_transport,
)
from ape_x_dqn_tpu_torch.utils.metrics import TransportStats
from ape_x_dqn_tpu_torch.utils.serialization import restore_like, tree_to_bytes

_HEADER = struct.Struct("<qqI")  # (seqlock version, payload length, crc32)
_CONTROL_QUEUE_SIZE = 64          # control messages in flight per worker


class SharedParamBuffer:
    """Single-writer seqlock over one shared-memory snapshot slot.

    Write: bump the version to odd, copy the payload, commit crc32 + even
    version.  Read: accept a payload only if an even version reads the same
    before and after the copy AND the copy's crc32 matches the committed
    header.  The version recheck alone is only sound on TSO (x86) hosts;
    the crc closes the hole on weakly ordered ones.
    """

    def __init__(self, capacity: int, name: Optional[str] = None,
                 create: bool = True):
        self.capacity = int(capacity)
        size = _HEADER.size + self.capacity
        self._finalizer = None
        if create:
            self._shm = create_shared_memory("params", size)
            self._finalizer = owner_finalizer(self, self._shm)
            _HEADER.pack_into(self._shm.buf, 0, 0, 0, 0)
        else:
            self._shm = shared_memory.SharedMemory(name=name)

    @property
    def name(self) -> str:
        return self._shm.name

    def write(self, payload: bytes) -> int:
        if len(payload) > self.capacity:
            raise ValueError(
                f"snapshot of {len(payload)} bytes exceeds shared buffer "
                f"capacity {self.capacity}"
            )
        v, _, _ = _HEADER.unpack_from(self._shm.buf, 0)
        _HEADER.pack_into(self._shm.buf, 0, v + 1, len(payload), 0)  # odd: in flight
        self._shm.buf[_HEADER.size:_HEADER.size + len(payload)] = payload
        _HEADER.pack_into(self._shm.buf, 0, v + 2, len(payload),     # even: committed
                          zlib.crc32(payload))
        return (v + 2) // 2

    def read(self, have_version: int = -1,
             timeout: float = 1.0) -> Optional[tuple]:
        """(payload bytes, version) if newer than ``have_version``, else
        None.  Bounded: a write left in flight past ``timeout`` (a writer
        that died mid-write) returns None instead of hanging."""
        deadline = time.monotonic() + timeout
        while True:
            v1, length, _ = _HEADER.unpack_from(self._shm.buf, 0)
            if v1 % 2 == 0:
                if v1 // 2 <= have_version or length == 0:
                    return None
                payload = bytes(self._shm.buf[_HEADER.size:_HEADER.size + length])
                v2, _, crc = _HEADER.unpack_from(self._shm.buf, 0)
                if v1 == v2 and zlib.crc32(payload) == crc:
                    return payload, v1 // 2
                # torn read: a write landed mid-copy — retry
            if time.monotonic() > deadline:
                return None
            time.sleep(0.0005)

    def close(self) -> None:
        """Detach; the owner also unlinks the segment."""
        if self._finalizer is not None:
            self._finalizer()
        else:
            self._shm.close()


class SharedMemoryParamStore:
    """The learner's param store over the seqlock buffer: the surface of
    ``runtime/param_store.ParamStore`` (``publish`` / ``get`` /
    ``version``), so the async pipeline drives thread and process actors
    through one code path.  ``get`` serves in-process readers from the host
    copy, without a deserialize."""

    def __init__(self, buffer: SharedParamBuffer):
        self._buf = buffer
        self._lock = threading.Lock()
        self._params = None
        # The single writer's own count IS the buffer version, and it
        # survives the buffer being closed at shutdown.
        self._version = 0

    @property
    def version(self) -> int:
        return self._version

    def publish(self, params: dict) -> int:
        """Copy ``params`` (tensors on any device) to the host, serialize
        once, and write the snapshot to the shared buffer."""
        from ape_x_dqn_tpu_torch.actors.pool import host_params

        host = host_params(params)
        payload = tree_to_bytes(host)
        with self._lock:
            self._params = host
            self._version = self._buf.write(payload)
            return self._version

    def get(self, have_version: int = -1):
        with self._lock:
            if self._params is None or self._version <= have_version:
                return None
            return self._params, self._version


class SharedBufferParamSource:
    """Worker-side param source (``ActorFleet.sync_params``'s contract:
    ``get(have_version) -> (params, version) | None``): poll the seqlock
    buffer and deserialize into the worker's template on a new version."""

    def __init__(self, buffer: SharedParamBuffer, template: dict):
        self._buf = buffer
        self._template = template

    def get(self, have_version: int = -1):
        got = self._buf.read(have_version)
        if got is None:
            return None
        payload, version = got
        return restore_like(self._template, payload), version


def worker_slice(worker_id: int, num_actors: int, num_workers: int) -> tuple:
    """[lo, hi) of the global actor set owned by ``worker_id`` — the one
    partition rule, used by the worker (its fleet) and the pool (its
    restart-budget accounting)."""
    lo = worker_id * num_actors // num_workers
    hi = (worker_id + 1) * num_actors // num_workers
    return lo, hi


def worker_threads(num_workers: int) -> int:
    """Intra-op threads of one worker: the cores this process may run on,
    shared evenly among the workers (at least 1), so W workers do not
    oversubscribe the host and starve the learner's dispatch thread."""
    try:
        cores = len(os.sched_getaffinity(0))
    except AttributeError:  # no sched_getaffinity on this platform
        cores = os.cpu_count() or 1
    return max(1, cores // max(1, int(num_workers)))


def _cfg_from_dict(cfg_dict: dict):
    from ape_x_dqn_tpu_torch.config import (
        ActorConfig,
        ApexConfig,
        ChaosConfig,
        EnvConfig,
        LearnerConfig,
        ObsConfig,
        ReplayConfig,
        ServingConfig,
        SupervisorConfig,
    )

    return ApexConfig(
        env=EnvConfig(**cfg_dict["env"]),
        actor=ActorConfig(**cfg_dict["actor"]),
        learner=LearnerConfig(**cfg_dict["learner"]),
        replay=ReplayConfig(**cfg_dict["replay"]),
        supervisor=SupervisorConfig(**cfg_dict["supervisor"]),
        serving=ServingConfig(**cfg_dict["serving"]),
        obs=ObsConfig(**cfg_dict["obs"]),
        chaos=ChaosConfig(**cfg_dict.get("chaos", {})),
        network=cfg_dict["network"],
        seed=cfg_dict["seed"],
    )


def network_and_template(cfg):
    """(obs_shape, network, template params) on the CPU, without replay or
    optimizer: what a worker (and the pool's buffer sizing) needs.  The
    param names, shapes and dtypes match the learner's, which come from the
    same ``seeded_network``; the template's values are never used."""
    from ape_x_dqn_tpu_torch.envs import make_env
    from ape_x_dqn_tpu_torch.runtime.components import env_kwargs, seeded_network

    probe = make_env(cfg.env.name, seed=cfg.seed, **env_kwargs(cfg))
    obs_shape = tuple(probe.observation_shape)
    network = seeded_network(cfg, probe.num_actions, obs_shape)
    template = {k: v.detach().clone() for k, v in network.state_dict().items()}
    return obs_shape, network, template


def encode_record(chunk, param_version: int, trace_id: int = 0) -> list:
    """Ring-ready parts of one fleet chunk: an ``XP`` record for a dense
    ``NStepTransition``, a ``DXP`` record for a ``DedupChunk`` (its int
    identity fields ride the record's prefix); ``trace_id`` is the
    envelope's lineage trace id (0 = not sampled)."""
    from ape_x_dqn_tpu_torch.types import DedupChunk

    t = chunk.transitions
    if isinstance(t, DedupChunk):
        return encode_chunk_parts(
            DXP, param_version, chunk.actor_steps,
            {"prio": np.asarray(chunk.priorities),
             **{k: np.asarray(getattr(t, k)) for k in (
                 "frames", "obs_ref", "next_ref", "action", "reward", "discount")}},
            source=t.source, chunk_seq=t.chunk_seq, prev_frames=t.prev_frames,
            trace_id=trace_id,
        )
    return encode_chunk_parts(
        XP, param_version, chunk.actor_steps,
        {"prio": np.asarray(chunk.priorities), "obs": t.obs, "action": t.action,
         "reward": t.reward, "discount": t.discount, "next_obs": t.next_obs},
        trace_id=trace_id,
    )


def _central_selector(cfg, fleet, source, worker_id: int, attempt: int, stop_evt,
                      recorder=None):
    """The worker's ``CentralSelector`` (JAX :442-494): a pipelined client
    to the configured endpoint, ε from the fleet's ladder slice, a seeded
    stream per incarnation, and with ``inference_fallback=local`` the
    fleet's own policy step over its cached params as the outage path."""
    from ape_x_dqn_tpu_torch.serving.central import (
        CentralInferenceClient,
        CentralSelector,
        InferenceUnavailable,
    )

    a = cfg.actor
    trace_rate = float(cfg.obs.trace_sample_rate)
    client = CentralInferenceClient(
        a.inference_host, a.inference_port, wid=worker_id, attempt=attempt,
        token=a.inference_token, codec=a.inference_codec, dedup=a.inference_dedup,
        inflight=a.inference_inflight, seed=cfg.seed + worker_id,
        trace=trace_rate > 0, span_recorder=recorder,
    )
    fallback = None
    if a.inference_fallback == "local" and source is not None:
        def fallback(obs, step):
            fleet.sync_params(source)
            if fleet.params is None:
                raise InferenceUnavailable("fallback configured but no param "
                                           "snapshot adopted yet")
            actions, q = fleet._policy_step(fleet.params, obs, fleet._epsilons)
            return actions, q, fleet.param_version
    return CentralSelector(
        client, fleet._epsilons.cpu().numpy(), fleet.envs.num_actions,
        seed=cfg.seed + 77_000 + worker_id + 100_000 * attempt,
        timeout_s=a.inference_timeout_s, trace_sample_rate=trace_rate,
        fallback=fallback, should_stop=stop_evt.is_set,
    )


def _worker_main(worker_id: int, cfg_dict: dict, num_workers: int,
                 param_spec: dict, xp_spec: dict, ctl_queue, stop_evt,
                 steps_budget: int, quantum: int, attempt: int = 0, nice: int = 0,
                 retire_evt=None, stats_name: Optional[str] = None):
    """Worker process entry: one CPU ``ActorFleet`` over this worker's
    slice of ``num_workers`` (the pool's whole partition, remote slots
    included), chunks into this incarnation's channel (an shm ring or a tcp
    connection, as ``xp_spec`` says), control messages (episode stats, the
    final report, done, errors) on the queue.  Params come from the shared
    seqlock buffer (``param_spec`` kind ``shm``), from frames on the tcp
    connection (``net``) or not at all (``none``: central-paramless).  A
    set ``retire_evt`` ends the collect loop at the next quantum boundary:
    the worker flushes and exits through the clean "done" path.
    ``stats_name`` names this incarnation's stats block (the parent made
    it; this worker writes it); a block that cannot be attached leaves the
    worker without stats, never without work."""
    if nice:
        # Where workers share cores with the learner, a positive niceness
        # keeps the learner's dispatch thread scheduled first.
        try:
            os.nice(int(nice))
        except OSError:
            pass
    # The card belongs to the learner: hide it before torch can see it.
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    buf = None
    ring = None
    sblock = None
    try:
        import random

        from ape_x_dqn_tpu_torch.obs.recorder import FlightRecorder
        from ape_x_dqn_tpu_torch.obs.shm_stats import WorkerStatsBlock

        if stats_name:
            try:
                sblock = WorkerStatsBlock(name=stats_name, create=False)
            except (OSError, ValueError):
                sblock = None
        import torch

        from ape_x_dqn_tpu_torch.actors.pool import ActorFleet
        from ape_x_dqn_tpu_torch.serving.central import InferenceUnavailable
        from ape_x_dqn_tpu_torch.envs import make_env
        from ape_x_dqn_tpu_torch.runtime.components import dedup_groups, env_kwargs
        from ape_x_dqn_tpu_torch.utils.memory import trim_malloc

        threads = worker_threads(num_workers)
        torch.set_num_threads(threads)
        cfg = _cfg_from_dict(cfg_dict)
        N = cfg.actor.num_actors
        lo, hi = worker_slice(worker_id, N, num_workers)
        if hi == lo:
            ctl_queue.put(("done", worker_id, 0))
            return
        _, network, template = network_and_template(cfg)
        kwargs = env_kwargs(cfg)
        env_fns = [(lambda i=i: make_env(cfg.env.name, seed=cfg.seed + 1000 + i, **kwargs))
                   for i in range(lo, hi)]
        slow_env = cfg.chaos.enabled and cfg.chaos.env_latency_ms > 0
        if slow_env:
            # Slow-env chaos, seeded per actor so the latency stream
            # reproduces with the run.
            from ape_x_dqn_tpu_torch.obs.chaos import SlowEnv

            lat_s = cfg.chaos.env_latency_ms / 1e3
            env_fns = [(lambda fn=fn, i=i: SlowEnv(fn(), lat_s, seed=cfg.chaos.seed + 71 * i))
                       for i, fn in enumerate(env_fns)]
        fleet = ActorFleet(
            env_fns,
            network,
            n_step=cfg.actor.num_steps,
            gamma=cfg.actor.gamma,
            epsilon=cfg.actor.epsilon,
            epsilon_alpha=cfg.actor.alpha,
            flush_every=cfg.actor.flush_every,
            sync_every=cfg.actor.sync_every,
            # A respawned incarnation explores a fresh stream.
            seed=cfg.seed + 9000 + worker_id + 100_000 * attempt,
            emission=cfg.actor.emission,
            device="cpu",
            epsilon_index_offset=lo,
            epsilon_total=N,
            emit_dedup=cfg.replay.dedup,
            emit_dedup_groups=dedup_groups(cfg),
        )
        ring = connect_channel(xp_spec)
        source = None
        if param_spec["kind"] == "shm":
            buf = SharedParamBuffer(param_spec["capacity"], name=param_spec["name"],
                                    create=False)
            source = SharedBufferParamSource(buf, template)
        elif param_spec["kind"] == "net":
            # tcp: params ride the experience connection in reverse.
            source = NetParamSource(ring, template)
        # "none": a central-paramless worker; its actions come from the
        # serving tier.
        recorder = FlightRecorder(name=f"worker{worker_id}", depth=cfg.obs.recorder_depth,
                                  shm_sink=sblock)
        eps = fleet._epsilons.cpu().numpy()
        if sblock is not None:
            sblock.update(eps_mean=float(eps.mean()), eps_min=float(eps.min()),
                          eps_max=float(eps.max()))
        recorder.record("spawn", worker=worker_id, attempt=attempt, lo=lo, hi=hi,
                        budget=steps_budget)
        # Lineage: a sampled chunk carries a random nonzero 63-bit id.
        trace_rng = random.Random((os.getpid() << 20) ^ (worker_id << 8) ^ attempt)
        trace_rate = float(cfg.obs.trace_sample_rate)
        selector = (_central_selector(cfg, fleet, source, worker_id, attempt, stop_evt,
                                      recorder=recorder)
                    if cfg.actor.inference == "central" else None)
        if source is not None:
            # Wait for the learner's first publication (a central worker with
            # the local fallback does not gate on it).
            deadline = time.monotonic() + 60.0
            while selector is None and not fleet.sync_params(source):
                if stop_evt.is_set() or time.monotonic() > deadline:
                    ctl_queue.put(("done", worker_id, 0))
                    return
                time.sleep(0.01)
        collect_s = write_s = 0.0
        chunks_sent = transitions_sent = episodes_total = 0

        def retiring() -> bool:
            return retire_evt is not None and retire_evt.is_set()

        while not stop_evt.is_set() and not retiring() and fleet.step_count < steps_budget:
            # The budget bounds TOTAL fleet steps across incarnations, so the
            # last quantum is clamped to land on it exactly.
            t0 = time.monotonic()
            try:
                chunks, ep_stats = fleet.collect(
                    min(quantum, steps_budget - fleet.step_count),
                    param_source=source, selector=selector,
                )
            except InferenceUnavailable:
                if stop_evt.is_set():
                    break     # stopped while waiting for the serving tier
                raise
            collect_s += time.monotonic() - t0
            t0 = time.monotonic()
            for c in chunks:
                trace_id = 0
                if trace_rate and trace_rng.random() < trace_rate:
                    trace_id = trace_rng.getrandbits(63) or 1
                parts = encode_record(c, fleet.param_version, trace_id)
                # Backpressure: block on a full ring, abort promptly on stop
                # (a stopping learner no longer drains).
                if not ring.write(parts, should_stop=stop_evt.is_set):
                    break
                chunks_sent += 1
                transitions_sent += len(c.priorities)
                if trace_id:
                    recorder.record("trace_chunk", trace_id=trace_id,
                                    rows=len(c.priorities), v=fleet.param_version)
            # tcp's coalescing buffer holds no record across a collect.
            flush = getattr(ring, "flush", None)
            if flush is not None:
                flush(should_stop=stop_evt.is_set)
            write_s += time.monotonic() - t0
            if ep_stats:
                episodes_total += len(ep_stats)
                ctl_queue.put((
                    "episodes", worker_id,
                    [(s.actor_id + lo, s.episode_return, s.episode_length)
                     for s in ep_stats],
                ))
            if sblock is not None:
                # One slot update and heartbeat per quantum.
                sblock.update(env_steps=fleet.step_count, chunks=chunks_sent,
                              transitions=transitions_sent,
                              param_version=fleet.param_version, episodes=episodes_total,
                              collect_s=collect_s, write_s=write_s)
            if selector is not None:
                # The client's counters, at the quantum cadence (one dict).
                try:
                    ctl_queue.put_nowait(("inference", worker_id,
                                          selector.stats(include_hist=True)))
                except queue_mod.Full:
                    pass
            trim_malloc()  # the obs-batch stream otherwise grows the RSS
        recorder.record("done", steps=fleet.step_count, stopped=stop_evt.is_set(),
                        retired=retiring())
        report = {
            "cuda_initialized": bool(torch.cuda.is_initialized()),
            "param_buffer": buf is not None,
            "param_source": param_spec["kind"],
            "retired": retiring(),
            "held_params": fleet.params is not None,
            "threads": torch.get_num_threads(),
            "pid": os.getpid(),
            "env_steps": fleet.step_count * (hi - lo),
            "collect_s": collect_s,
            # The chaos SlowEnv's mean latency, 0 when the envs are not wrapped.
            "env_latency_ms": cfg.chaos.env_latency_ms if slow_env else 0.0,
        }
        if selector is not None:
            report["inference"] = selector.stats(include_hist=True)
            ctl_queue.put(("inference", worker_id, report["inference"]))
            selector.close()
        ctl_queue.put(("report", worker_id, report))
        ctl_queue.put(("done", worker_id, fleet.step_count))
    except Exception as e:  # noqa: BLE001 — reported on the control queue; the pool decides
        try:
            ctl_queue.put(("error", worker_id, f"{type(e).__name__}: {e}"))
        except Exception:  # noqa: BLE001 — last-breath report; the queue may be closed
            pass
    finally:
        if buf is not None:
            buf.close()
        if ring is not None:
            ring.close()
        if sblock is not None:
            sblock.close()


class ProcessActorPool:
    """Owner of the worker processes, the param channel (the shared seqlock
    buffer, or the tcp connections) and one experience channel (and control
    queue) per worker incarnation.

    Lifecycle: ``publish(params)`` once, ``start()``, then the learner side
    interleaves ``publish`` with ``supervise`` + ``poll``, then ``stop()``.
    ``poll`` drains every channel in one round-robin sweep (bounded by
    ``max_items`` and a byte budget) into (priorities, transitions) pairs.
    """

    def __init__(self, cfg, num_workers: int = 2, quantum: Optional[int] = None,
                 max_restarts: int = 3, postmortem_dir: Optional[str] = None):
        from ape_x_dqn_tpu_torch.config import to_dict

        self.cfg = cfg
        self.num_workers = int(num_workers)
        # The global actor partition is carved over every worker id the
        # run may hold: the local capacity (spawned now or grown later) and
        # the remote slots above it, so neither growth nor a joining host
        # ever moves a running worker's slice.
        self.remote_workers = int(cfg.actor.remote_workers)
        self.local_capacity = max(self.num_workers, int(cfg.actor.max_workers))
        self.total_workers = self.local_capacity + self.remote_workers
        self._ring_bytes = int(cfg.actor.xp_ring_bytes)
        self._drain_budget = int(cfg.actor.xp_drain_budget_bytes)
        self._transport = make_transport(cfg, self.total_workers, self._ring_bytes,
                                         self._drain_budget)
        # Central inference without the local fallback: paramless workers —
        # no param channel and no store (the runtime keeps a host
        # ParamStore for the serving tier's reload).
        self._central = cfg.actor.inference == "central"
        self._paramless = self._central and cfg.actor.inference_fallback != "local"
        self.inference_by_worker: dict = {}   # wid -> latest client stats
        self.buffer = self.store = None
        if self._paramless:
            pass   # no param channel at all
        elif self._transport.kind == "tcp":
            self.store = NetParamStore(self._transport)
        else:
            # The serialized template's size, with headroom.
            _, _, template = network_and_template(cfg)
            capacity = len(tree_to_bytes(template))
            self.buffer = SharedParamBuffer(capacity + capacity // 4 + 4096)
            self.store = SharedMemoryParamStore(self.buffer)
        # spawn, never fork: the learner holds a CUDA context and threads.
        self._ctx = mp.get_context("spawn")
        self._queues: dict = {}   # wid -> control queue of the live incarnation
        self._rings: dict = {}    # wid -> channel of the live incarnation
        self.transport = TransportStats()
        self._full_waits_base = 0  # full_waits of retired incarnations
        self.stop_event = self._ctx.Event()
        self._cfg_dict = to_dict(cfg)
        self._quantum = quantum or cfg.actor.flush_every
        self._procs: List = []    # indexed by local wid
        self.actor_steps = 0
        self.episodes: List[tuple] = []
        self.last_versions: dict = {}   # wid -> param version of its latest chunk
        self.chunks_by_worker: dict = {}
        self.finished_workers: set = set()
        self.final_steps: dict = {}     # wid -> fleet steps at clean "done"
        self.worker_reports: dict = {}  # wid -> the incarnation's final report
        self.worker_errors: dict = {}   # FATAL errors (restart budget exhausted)
        self.max_restarts = int(max_restarts)
        self.restarts = 0
        self._steps_by_worker: dict = {}  # cumulative, across restarts
        self._reported_errors: dict = {}  # wid -> last error message
        self._attempt: dict = {}          # wid -> spawn attempt count
        self._dead_since: dict = {}       # wid -> first-seen-dead time
        self._salvaged: list = []         # chunks drained before a respawn
        self._silent_death_grace_s = 10.0
        # With a policy attached (runtime/supervisor.FleetSupervisor or a
        # bare RespawnPolicy) respawn timing and the crash-loop budget are
        # its; without one, workers respawn at once until max_restarts, and
        # the next death is fatal.  The respawn_min_interval_s floor holds
        # either way.
        self.respawn_policy = None
        self.quarantined: set = set()
        # Elastic state: cleanly retired wids, each live incarnation's
        # retire event, every local wid ever spawned.
        self.retired: set = set()
        self._retire_events: dict = {}
        self._spawned_local: set = set()
        self.grows = 0
        self.retires = 0
        self._death_pending: dict = {}    # wid -> error, awaiting respawn
        self._last_spawn: dict = {}       # wid -> spawn time
        self._min_respawn_interval = float(cfg.actor.respawn_min_interval_s)
        # One stats block per live local incarnation (wid -> block); poll
        # sweeps them into a cached snapshot, a salvage turns a dead one
        # into a post-mortem record.
        self._stats_blocks: dict = {}
        self._stats_prev: dict = {}      # wid -> (t, env_steps, steps/s)
        self._worker_snap: dict = {}
        self._worker_snap_t = 0.0
        self.postmortems: List[dict] = []
        self._postmortem_dir = postmortem_dir

    def _spawn(self, wid: int, budget: int):
        if wid in self._queues:
            self._salvage_incarnation(wid)
        attempt = self._attempt.get(wid, 0)
        self._attempt[wid] = attempt + 1
        self._last_spawn[wid] = time.monotonic()
        self._spawned_local.add(wid)
        self._retire_events[wid] = self._ctx.Event()
        self._queues[wid] = self._ctx.Queue(maxsize=_CONTROL_QUEUE_SIZE)
        self._rings[wid] = self._transport.make_channel(wid, attempt)
        xp_spec = self._transport.endpoint(self._rings[wid], wid, attempt)
        from ape_x_dqn_tpu_torch.obs.shm_stats import WORKER_SLOTS, WorkerStatsBlock

        self._stats_prev.pop(wid, None)   # a fresh incarnation: its rate restarts
        try:
            blk = WorkerStatsBlock(slots=WORKER_SLOTS,
                                   event_depth=max(16, self.cfg.obs.recorder_depth))
            self._stats_blocks[wid] = blk
            stats_name = blk.name
        except OSError:
            stats_name = None   # stats must not block a spawn
        p = self._ctx.Process(
            target=_worker_main,
            args=(wid, self._cfg_dict, self.total_workers, self._param_spec(), xp_spec,
                  self._queues[wid], self.stop_event, budget, self._quantum,
                  attempt, self.cfg.actor.worker_nice, self._retire_events[wid],
                  stats_name),
            daemon=True,
        )
        p.start()
        return p

    def _param_spec(self) -> dict:
        if self.buffer is not None:
            return {"kind": "shm", "name": self.buffer.name,
                    "capacity": self.buffer.capacity}
        return {"kind": "net" if self.store is not None else "none"}

    def _salvage_incarnation(self, wid: int) -> None:
        """Drain every fully committed record out of a dead incarnation's
        channel (a kill mid-record leaves a torn tail: counted, never
        delivered) and its control queue, then release both.  A respawn
        gets a fresh channel, so its stream restarts seq-clean.  Its stats
        block (the final slots and the recorder's last events) becomes a
        post-mortem record in ``postmortems`` and, with a post-mortem dir,
        a ``worker<wid>-salvage-*.json`` file; then it is unlinked."""
        self._drain_control(self._queues[wid])
        ring = self._rings.pop(wid, None)
        ring_post: dict = {}
        if ring is not None:
            salvaged = 0
            while True:
                rec = ring.read_next()
                if rec is None:
                    break
                self._salvaged.append(self._decode_record(wid, rec))
                salvaged += 1
            torn = ring.torn_tail()
            self.transport.count_salvage(salvaged, torn=torn)
            self._full_waits_base += ring.full_waits
            ring_post = {"salvaged_records": salvaged, "torn_tail": bool(torn),
                         "full_waits": ring.full_waits}
            ring.close()
            ring.unlink()
            self._transport.drop_channel(wid, ring)
        post = {"worker": wid, "attempt": self._attempt.get(wid, 1) - 1, "ring": ring_post}
        blk = self._stats_blocks.pop(wid, None)
        if blk is not None:
            post["stats"] = blk.snapshot()
            post["events"], post["events_torn"] = blk.recent_events()
            blk.close()
            blk.unlink()
        if self._postmortem_dir:
            from ape_x_dqn_tpu_torch.obs.recorder import write_postmortem

            path = write_postmortem(self._postmortem_dir, f"worker{wid}", "salvage", post)
            if path:
                post["path"] = path
        self.postmortems.append(post)
        old = self._queues.pop(wid, None)
        if old is not None:
            old.close()  # release the pipe fds now, not at collection

    def _drain_control(self, q, limit: int = 4096) -> None:
        for _ in range(limit):
            try:
                self._dispatch(q.get_nowait())
            except queue_mod.Empty:
                return
            except Exception:  # noqa: BLE001 — a torn pickle from a writer killed mid-put is unrecoverable by design
                return

    def shm_accounting(self) -> dict:
        """Live fd and /dev/shm use of the transport (the planning twin is
        ``config.transport_budget``); tcp holds no segment."""
        try:
            n_fds = len(os.listdir("/proc/self/fd"))
        except OSError:
            n_fds = -1
        shm = self._transport.kind == "shm"
        return {
            "transport": self._transport.kind,
            "shm_segments": ((1 if self.buffer is not None else 0) + len(self._rings)
                             if shm else 0) + len(self._stats_blocks),
            "ring_bytes_each": self._ring_bytes if shm else 0,
            "ring_bytes_total": self._ring_bytes * len(self._rings) if shm else 0,
            "param_buffer_bytes": self.buffer.capacity if self.buffer is not None else 0,
            "process_fds": n_fds,
        }

    def worker_stats(self, max_age_s: float = 0.5) -> dict:
        """The per-worker sweep of the live stats blocks, keyed by
        ``str(wid)``: the slots, the writer's pid, seq, heartbeat age and
        events, a parent-side ``env_steps_s``, the channel's backlog and
        full waits, and ``alive``.  Cached for ``max_age_s``."""
        now = time.monotonic()
        if self._worker_snap and now - self._worker_snap_t < max_age_s:
            return self._worker_snap
        out: dict = {}
        for wid, blk in list(self._stats_blocks.items()):
            snap = blk.snapshot()
            ring = self._rings.get(wid)
            if ring is not None:
                snap["ring_backlog_bytes"] = max(0, ring.committed_bytes - ring.bytes_read)
                snap["ring_full_waits"] = ring.full_waits
            prev = self._stats_prev.get(wid)
            if prev is not None and now - prev[0] >= 0.2:
                rate = max(0.0, snap["env_steps"] - prev[1]) / (now - prev[0])
                snap["env_steps_s"] = round(rate, 1)
                self._stats_prev[wid] = (now, snap["env_steps"], rate)
            elif prev is not None:
                snap["env_steps_s"] = round(prev[2], 1)
            else:
                snap["env_steps_s"] = 0.0
                self._stats_prev[wid] = (now, snap["env_steps"], 0.0)
            p = self._procs[wid] if wid < len(self._procs) else None
            snap["alive"] = bool(p.is_alive()) if p is not None else False
            out[str(wid)] = snap
        self._worker_snap, self._worker_snap_t = out, now
        return out

    def net_stats(self) -> dict:
        """The JSONL ``net`` section (tcp: bytes/s, frames, coalescing and
        codec ratios, reconnects, torn frames, param pushes full and delta
        and their fan-out ms); empty on the shm backend."""
        return self._transport.stats()

    @property
    def transport_kind(self) -> str:
        return self._transport.kind

    def start(self, stagger_s: Optional[float] = None):
        """Spawn every worker, ``stagger_s`` seconds apart, then reserve the
        remote slots."""
        stagger = stagger_s if stagger_s is not None else self.cfg.actor.spawn_stagger_s
        self._gate_shm_budget(self.num_workers)
        for w in range(self.num_workers):
            self._procs.append(self._spawn(w, self.cfg.actor.T))
            if stagger and w + 1 < self.num_workers:
                time.sleep(stagger)
        if self.remote_workers:
            self.register_remote_workers()

    def _gate_shm_budget(self, new_rings: int) -> None:
        """Fail before spawning workers whose rings cannot fit /dev/shm
        (the shm backend only: tcp makes no ring)."""
        if self._transport.kind != "shm":
            return
        need = new_rings * self._ring_bytes
        try:
            st = os.statvfs("/dev/shm")
        except OSError:
            return
        free = st.f_bavail * st.f_frsize
        if need > free:
            raise RuntimeError(
                f"experience rings need {need} bytes of /dev/shm, {free} free — "
                "lower actor.xp_ring_bytes or actor.num_workers"
            )

    def register_remote_workers(self, path: Optional[str] = None) -> str:
        """Reserve a channel for each of the ``actor.remote_workers`` slots
        and write the join spec ``host_join`` reads (JSON, tmp + fsync +
        rename): one endpoint per remote wid (address, per-run token,
        attempt 0, the wire knobs), the run's config and the partition's
        width, so a joining host's actors land on the slices reserved for
        them.  Remote channels ride the poll sweep; a quiet one is seen as
        ``net.connections < net.expected``, never as a death."""
        if self._transport.kind != "tcp":
            raise RuntimeError("remote workers require actor.transport=tcp")
        path = path or self.cfg.actor.remote_join_path
        if not path:
            raise RuntimeError("actor.remote_join_path is empty")
        specs = []
        for k in range(self.remote_workers):
            wid = self.local_capacity + k
            if wid not in self._rings:
                self._attempt[wid] = 1   # attempt 0 is the joinable one
                self._rings[wid] = self._transport.make_channel(wid, 0)
            specs.append(self._transport.endpoint(self._rings[wid], wid, 0))
        doc = {"cfg": self._cfg_dict, "num_workers_total": self.total_workers,
               "num_local_workers": self.num_workers, "quantum": self._quantum,
               "budget": int(self.cfg.actor.T), "specs": specs}
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        return path

    # -- elastic grow/retire -----------------------------------------------

    def live_workers(self) -> List[int]:
        """Local wids contributing now: spawned, not retired, quarantined,
        finished or fatal (a booting respawn counts: its slice is held)."""
        out = (set(self.retired) | set(self.quarantined) | set(self.worker_errors)
               | set(self.finished_workers))
        return sorted(set(self._spawned_local) - out)

    def grow_candidates(self) -> List[int]:
        """Reserved local wids a ``grow`` could start now: never spawned, or
        cleanly retired and fully drained (process gone, channel and queue
        reclaimed), with budget left; quarantined and fatal wids stay
        written off."""
        live = set(self.live_workers())

        def settled(w: int) -> bool:
            if w < len(self._procs) and self._procs[w].is_alive():
                return False
            return w not in self._rings and w not in self._queues

        return sorted(w for w in range(self.local_capacity)
                      if w not in live and w not in self.quarantined
                      and w not in self.worker_errors and settled(w)
                      and self._remaining_budget(w) > 0)

    def grow(self, n: int = 1, stagger_s: Optional[float] = None) -> List[int]:
        """Start up to ``n`` reserved wids: ``start``'s spawn path (a fresh
        channel, the remaining budget, the stagger, the shm gate per ring)
        on slices carved at construction."""
        stagger = stagger_s if stagger_s is not None else self.cfg.actor.spawn_stagger_s
        grown: List[int] = []
        for wid in self.grow_candidates():
            if len(grown) >= n:
                break
            self._gate_shm_budget(1)
            if grown and stagger:
                time.sleep(stagger)
            self.retired.discard(wid)
            self.finished_workers.discard(wid)
            self._death_pending.pop(wid, None)
            self._dead_since.pop(wid, None)
            p = self._spawn(wid, self._remaining_budget(wid))
            if wid < len(self._procs):
                self._procs[wid] = p
            else:
                # Candidates ascend, so _procs stays indexed by wid.
                self._procs.append(p)
            self.grows += 1
            grown.append(wid)
        return grown

    def retire(self, wid: Optional[int] = None) -> Optional[int]:
        """Retire one worker by a clean drain, never a kill: its retire
        event ends the collect loop at the next quantum boundary, the
        worker flushes and exits through "done", and ``supervise`` drains
        its channel before reclaiming it.  Default: the highest live wid."""
        live = self.live_workers()
        if wid is None:
            if not live:
                return None
            wid = live[-1]
        if wid not in live:
            return None
        self.retired.add(wid)
        self.retires += 1
        ev = self._retire_events.get(wid)
        if ev is not None:
            ev.set()
        return wid

    def set_drain_budget(self, budget_bytes: int) -> int:
        """Tune the per-poll byte drain budget live (floored at 64 KiB)."""
        self._drain_budget = max(64 << 10, int(budget_bytes))
        return self._drain_budget

    @property
    def drain_budget_bytes(self) -> int:
        return self._drain_budget

    def supervise(self) -> None:
        """Respawn dead workers with their REMAINING step budget.  A worker
        that exited without a clean "done" — a reported exception or a
        silent death (crash, OOM kill, SIGKILL) — is respawned when the
        interval floor and the policy's backoff (if any) have passed; with
        no policy, the death after ``max_restarts`` respawns is fatal.  A
        retired worker is never respawned: once it exited, its channel is
        drained and reclaimed."""
        if self.stop_event.is_set():
            return
        now = time.monotonic()
        for wid, p in enumerate(self._procs):
            if wid in self.retired:
                if not p.is_alive() and wid in self._queues:
                    self._salvage_incarnation(wid)
                continue
            if wid in self.finished_workers or wid in self.worker_errors \
                    or wid in self.quarantined:
                continue
            if wid not in self._death_pending:
                if p.is_alive():
                    continue
                # A zero-exit death is normally a clean "done" (or a reported
                # error) whose message is still queued; only a grace-period
                # timeout turns it into a silent death.
                if p.exitcode == 0 and wid not in self._reported_errors:
                    first = self._dead_since.setdefault(wid, now)
                    if now - first < self._silent_death_grace_s:
                        continue
                self._dead_since.pop(wid, None)
                err = self._reported_errors.pop(
                    wid, f"worker exited silently (exitcode {p.exitcode})"
                )
                if self._remaining_budget(wid) == 0:
                    # Budget exhausted: a clean finish whatever the exit shape.
                    self.finished_workers.add(wid)
                    continue
                if self.respawn_policy is not None:
                    if self.respawn_policy.on_worker_death(wid, err) == "quarantine":
                        self._quarantine(wid)
                        continue
                elif self.restarts >= self.max_restarts:
                    self.worker_errors[wid] = err
                    continue
                self._death_pending[wid] = err
            if now - self._last_spawn.get(wid, 0.0) < self._min_respawn_interval:
                continue
            if self.respawn_policy is not None:
                verdict = self.respawn_policy.decide_respawn(wid)
                if verdict == "wait":
                    continue
                if verdict == "quarantine":
                    self._quarantine(wid)
                    continue
            self._death_pending.pop(wid, None)
            self.restarts += 1
            self._procs[wid] = self._spawn(wid, self._remaining_budget(wid))

    def _remaining_budget(self, wid: int) -> int:
        return max(0, self.cfg.actor.T - self._steps_by_worker.get(wid, 0))

    def _quarantine(self, wid: int) -> None:
        """Write a crash-looping worker off: salvage its last incarnation
        and run on without it."""
        self._death_pending.pop(wid, None)
        self.quarantined.add(wid)
        if wid in self._queues:
            self._salvage_incarnation(wid)

    def publish(self, params) -> int:
        if self.store is None:
            return -1    # central-paramless fleet: nothing to fan out
        return self.store.publish(params)

    def set_inference_endpoint(self, host: str, port: int, token: int) -> None:
        """Hand the resolved serving endpoint (auto mode binds an ephemeral
        port after the config was frozen) to every worker spawned from now
        on, and to the join spec."""
        a = self._cfg_dict["actor"]
        a["inference_host"] = str(host)
        a["inference_port"] = int(port)
        a["inference_token"] = int(token)

    def inference_stats(self) -> dict:
        """The fleet's ``inference`` section: the workers' client counters
        summed and their round-trip histograms merged."""
        from ape_x_dqn_tpu_torch.serving.central import aggregate_inference_stats

        return aggregate_inference_stats(
            list(self.inference_by_worker.values()),
            mode="central" if self._central else "local",
        )

    @property
    def finished(self) -> bool:
        """Every local worker still expected to produce (ever spawned, not
        retired) has settled: done, fatal or quarantined."""
        if not self._spawned_local:
            return False
        settled = self.finished_workers | set(self.worker_errors) | self.quarantined
        return all(w in settled for w in self._spawned_local - self.retired)

    def poll(self, max_items: int = 64, timeout: float = 0.0,
             max_bytes: Optional[int] = None, with_meta: bool = False) -> List[tuple]:
        """One batched sweep over the control queues and every live channel
        (a few records per channel per pass, so one hot worker cannot
        starve the sweep), bounded by ``max_items`` chunks and the byte
        budget; returns [(priorities, transitions), ...], or with
        ``with_meta`` [(priorities, transitions, meta), ...] where meta is
        the envelope's ``wid``, ``sent_t`` and ``trace_id``.  The arrays are
        read-only views over each record's own copy: a sink that keeps rows
        copies them.  On tcp each poll first accepts new connections and
        routes their hellos; the stats blocks' sweep rides the poll."""
        self._transport.pump()
        self.worker_stats()
        out = list(self._salvaged)
        self._salvaged.clear()
        budget = max_bytes if max_bytes is not None else self._drain_budget
        deadline = time.monotonic() + timeout if timeout else None
        while len(out) < max_items and budget > 0:
            got = False
            for q in list(self._queues.values()):
                try:
                    self._dispatch(q.get_nowait())
                    got = True
                except queue_mod.Empty:
                    continue
                except Exception:  # noqa: BLE001 — a torn pickle from a writer killed mid-put is unrecoverable by design
                    continue
            for wid, ring in list(self._rings.items()):
                for _ in range(4):
                    if len(out) >= max_items or budget <= 0:
                        break
                    rec = ring.read_next()
                    if rec is None:
                        break
                    got = True
                    budget -= len(rec)
                    out.append(self._decode_record(wid, rec))
            if not got:
                if not out and deadline and time.monotonic() < deadline:
                    time.sleep(min(0.01, timeout))
                    continue
                break
        if with_meta:
            return out
        return [(prio, trans) for prio, trans, _ in out]

    def _decode_record(self, wid: int, payload: bytes) -> tuple:
        """One record → (priorities, transitions, meta) + pool accounting;
        the transitions are a ``DedupChunk`` for a ``DXP`` record."""
        from ape_x_dqn_tpu_torch.types import DedupChunk, NStepTransition

        (kind, version, sent_t, steps, source, chunk_seq, prev_frames,
         trace_id, arrays) = decode_chunk(payload)
        self.last_versions[wid] = version
        self.chunks_by_worker[wid] = self.chunks_by_worker.get(wid, 0) + 1
        self.actor_steps += steps
        # Fleet steps = chunk rows / actors in the worker: a respawn gets
        # only the worker's REMAINING actor.T budget.
        lo, hi = worker_slice(wid, self.cfg.actor.num_actors, self.total_workers)
        self._steps_by_worker[wid] = (
            self._steps_by_worker.get(wid, 0) + steps // max(hi - lo, 1)
        )
        self.transport.record_chunk(len(payload), time.monotonic() - sent_t, steps)
        meta = {"wid": wid, "sent_t": sent_t, "trace_id": trace_id}
        prio = arrays.pop("prio")
        if kind == DXP:
            return prio, DedupChunk(source=source, chunk_seq=chunk_seq,
                                    prev_frames=prev_frames, **arrays), meta
        return prio, NStepTransition(**arrays), meta

    def trace_events(self, max_per_worker: int = 32) -> List[dict]:
        """Cross-tier trace spans of the live workers, swept off their
        stats blocks' event rings (JAX :1414): the flight recorder mirrors
        every ``trace_chunk`` / ``trace_span`` event there, so they read
        without more plumbing and survive a SIGKILL.  A ``trace_chunk`` (an
        actor's flush of a traced chunk) becomes a zero-length ``act`` span,
        the hop that puts the worker's pid on the timeline."""
        spans: List[dict] = []
        for wid, blk in list(self._stats_blocks.items()):
            try:
                events, _torn = blk.recent_events(max_per_worker)
                pid = blk.pid
            except Exception:  # noqa: BLE001 — a dying block reads as no spans
                continue
            for ev in events:
                tid = ev.get("trace_id")
                if not tid:
                    continue
                if ev.get("kind") == "trace_chunk":
                    t = float(ev.get("t", 0.0))
                    spans.append({"trace_id": int(tid), "hop": "act", "pid": pid,
                                  "t0_s": t, "t1_s": t, "dur_ms": 0.0, "wid": wid})
                elif ev.get("kind") == "trace_span":
                    spans.append({k: v for k, v in ev.items() if k != "kind"})
        return spans

    def transport_stats(self) -> dict:
        """The JSONL ``xp_transport`` section: chunks, bytes, latency,
        channel-full waits (live channels and retired incarnations),
        salvage and torn counts."""
        s = self.transport.summary()
        s["transport"] = self._transport.kind
        s["ring_full_waits"] = self._full_waits_base + sum(
            r.full_waits for r in self._rings.values()
        )
        s["rings"] = len(self._rings)
        s["ring_bytes"] = self._ring_bytes
        return s

    def _dispatch(self, msg) -> None:
        """Apply one control message to pool state."""
        kind, wid = msg[0], msg[1]
        if kind == "episodes":
            self.episodes.extend(msg[2])
        elif kind == "report":
            self.worker_reports[wid] = msg[2]
        elif kind == "inference":
            self.inference_by_worker[wid] = msg[2]
        elif kind == "done":
            self.finished_workers.add(wid)
            # Each "done" reports its own incarnation's fleet steps.
            self.final_steps[wid] = self.final_steps.get(wid, 0) + msg[2]
        elif kind == "error":
            # Respawnable until the restart budget runs out (supervise).
            self._reported_errors[wid] = msg[2]

    def stop(self, join_timeout: float = 15.0) -> None:
        """Stop every worker, drain what they committed, and release every
        channel, control queue, the listener and the param buffer — on
        every exit path.  A channel left with a torn tail counts on the
        transport's torn counter."""
        self.stop_event.set()
        try:
            deadline = time.monotonic() + join_timeout
            for p in self._procs:
                while p.is_alive() and time.monotonic() < deadline:
                    self.poll(max_items=256)
                    p.join(timeout=0.1)
                if p.is_alive():
                    p.terminate()
                    p.join(timeout=5.0)
            self.poll(max_items=256)  # last committed records + "done" messages
        finally:
            for wid in list(self._rings):
                ring = self._rings.pop(wid)
                self._full_waits_base += ring.full_waits
                if ring.torn_tail():
                    self.transport.count_salvage(0, torn=True)
                ring.close()
                ring.unlink()
                self._transport.drop_channel(wid, ring)
            for wid in list(self._queues):
                self._queues.pop(wid).close()
            for wid in list(self._stats_blocks):
                blk = self._stats_blocks.pop(wid)
                blk.close()
                blk.unlink()
            self._transport.close()
            if self.buffer is not None:
                self.buffer.close()


class ProcessActorWorker:
    """The thread-actor worker's interface (start / join / drain_episodes /
    finished / error / heartbeat / actor_steps / restarts) over a
    ``ProcessActorPool``, so ``AsyncPipeline`` drives both actor modes
    through one code path.  A pump thread supervises the pool and drains
    its rings into the runtime's sink (host replay or the fused learner's
    staging)."""

    def __init__(self, pool: ProcessActorPool, sink, logger=None, fps=None,
                 stop_event: Optional[threading.Event] = None, lineage=None):
        from ape_x_dqn_tpu_torch.actors.pool import EpisodeStat

        self._EpisodeStat = EpisodeStat
        self.pool = pool
        self._sink = sink
        # The lineage tracker (host replay): fed the slots each chunk landed
        # in (the host replay's sink returns them; a fused sink returns
        # None) with the envelope's send time and trace id.
        self._lineage = lineage
        self._logger = logger
        self._fps = fps
        self._stop = threading.Event()
        # The runtime's stop event: set on a fatal worker death so the
        # learner loop (and the warm-up wait) exits promptly.
        self._external_stop = stop_event
        self.error: Optional[BaseException] = None
        self.heartbeat = time.monotonic()
        self._ep_lock = threading.Lock()
        self.episodes: List = []
        self._thread = threading.Thread(target=self._pump, name="process-actor-pump",
                                        daemon=True)

    @property
    def finished(self) -> bool:
        return self.pool.finished and not self.pool.worker_errors

    @property
    def actor_steps(self) -> int:
        return self.pool.actor_steps

    @property
    def restarts(self) -> int:
        return self.pool.restarts

    def start(self):
        self.pool.start()
        self._thread.start()

    def join(self, timeout: float = 30.0):
        """Stop the pump, then the pool (which releases every segment);
        safe before ``start`` and after a failed one."""
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join(timeout)
        self.pool.stop()

    def drain_episodes(self) -> List:
        with self._ep_lock:
            out, self.episodes = self.episodes, []
        return out

    def _pump(self):
        try:
            while not self._stop.is_set():
                self.pool.supervise()
                items = self.pool.poll(max_items=64, timeout=0.05, with_meta=True)
                # A remote replay's add carries the record's trace id.
                sink_trace = getattr(self._sink, "takes_trace", False)
                for prio, trans, meta in items:
                    if sink_trace:
                        idx = self._sink(prio, trans, meta["trace_id"])
                    else:
                        idx = self._sink(prio, trans)
                    if self._fps is not None:
                        self._fps.add(len(prio))
                    if self._lineage is not None and idx is not None:
                        self._lineage.on_ingest(idx, t_act=meta["sent_t"],
                                                trace_id=meta["trace_id"], wid=meta["wid"])
                if items:
                    self.heartbeat = time.monotonic()
                if self.pool.episodes:
                    with self._ep_lock:
                        self.episodes.extend(self._EpisodeStat(a, r, l)
                                             for (a, r, l) in self.pool.episodes)
                    self.pool.episodes.clear()
                if self.pool.worker_errors and self.error is None:
                    self._fail(RuntimeError(
                        f"actor worker(s) died: {self.pool.worker_errors}"))
                    # Keep draining: surviving workers blocked on a full ring
                    # see the stop event only once their write returns.
                if self.pool.finished:
                    return
        except Exception as e:  # noqa: BLE001 — a sink or decode failure stops the run, never silently
            self._fail(e)

    def _fail(self, error: BaseException) -> None:
        self.error = error
        if self._logger is not None:
            self._logger.log("actor/worker_errors", len(self.pool.worker_errors))
        if self._external_stop is not None:
            self._external_stop.set()
        self.pool.stop_event.set()
