"""Typed configuration — the port's own copy of ``ape_x_dqn_tpu/config.py``.

The same vocabulary (``env`` / ``actor`` / ``learner`` / ``replay``
sections, plus ``supervisor``, ``serving``, ``obs``, ``fleet``,
``autopilot`` and ``chaos``, reference-format ``parameters.json`` files,
``--set section.field=value`` overrides), with the same defaults and
validation messages.  A key the JAX config does not have raises rather
than loading as a dead setting; the one path the port does not run yet,
the multi-GPU learner (ROADMAP item 8), is refused by its value
(``learner.data_parallel``).  The port owns this copy; it never imports
the JAX package's module.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Optional, Sequence

TRANSPORT_KINDS = ("shm", "tcp")


@dataclasses.dataclass
class EnvConfig:
    name: str = "chain:10"
    state_shape: Optional[Sequence[int]] = None   # validated if given
    action_dim: Optional[int] = None              # validated if given
    # The DQN wrapper stack of fake-atari and Atari envs (envs/atari.wrap_dqn).
    frame_skip: int = 4
    frame_stack: int = 1       # reference parity: a single frame
    episodic_life: bool = True
    clip_rewards: bool = True


@dataclasses.dataclass
class ActorConfig:
    num_actors: int = 5                   # parameters.json:9
    T: int = 50_000                       # per-actor env steps, parameters.json:10
    num_steps: int = 3                    # n-step horizon, parameters.json:11
    epsilon: float = 0.4                  # parameters.json:12
    alpha: float = 7.0                    # ε-ladder exponent, parameters.json:13
    gamma: float = 0.99                   # parameters.json:14
    flush_every: int = 16                 # chunk emission period (steps)
    sync_every: int = 500                 # param poll period, parameters.json:16
    # "overlapping" = every step starts a window (stride 1); "strided" =
    # only n-aligned starts (stride n, the reference's emission).
    emission: str = "overlapping"
    # Actor placement: "thread" = one fleet thread in the learner process;
    # "process" = num_workers CPU-only worker processes, each running its
    # slice of the actor set (runtime/process_actors.py).
    mode: str = "thread"
    num_workers: int = 2                  # worker processes (mode="process")
    # Unix niceness applied inside each worker, so the learner's dispatch
    # thread is scheduled first where workers share its cores.  0 = default.
    worker_nice: int = 0
    # Experience transport (mode="process"; runtime/transport.py): "shm" =
    # one shared-memory ring per worker incarnation and the params over a
    # shared-memory seqlock buffer, one host only; "tcp" (runtime/net.py) =
    # the same CRC-framed records over one socket per worker (loopback or
    # another host), the params as delta-or-full frames on the same
    # connection.
    transport: str = "shm"
    # The tcp listener's bind address and port (0 = ephemeral; a fixed
    # port is for workers on other hosts that need it in advance).
    transport_host: str = "127.0.0.1"
    transport_port: int = 0
    # Hosts the worker fleet spans: planning arithmetic of
    # transport_budget() only; 1 for shm (/dev/shm cannot cross hosts).
    transport_hosts: int = 1
    # Per-connection kernel socket buffer (SO_SNDBUF worker-side, SO_RCVBUF
    # learner-side): the tcp twin of xp_ring_bytes, the bytes a worker may
    # have in flight before its writes block (full_waits).
    net_conn_buf_bytes: int = 1 << 20
    # Wire-efficiency layers of the tcp transport (F_XPB frames): the batch
    # codec negotiated at the hello ("off" keeps the v1 wire; "zlib"
    # deflates every batch, kept only when smaller; "auto" only while the
    # writer meets backpressure), the coalescing budget (0 = one frame per
    # record), the longest a record waits in the coalescing buffer, and
    # in-window frame dedup (a frame already in the batch ships as a ref).
    net_codec: str = "off"
    net_coalesce_bytes: int = 0
    net_coalesce_wait_ms: float = 20.0
    net_dedup: bool = True
    # Bytes of each worker's experience ring: at least one chunk (about
    # flush_every × actors-per-worker × 2 × frame bytes) plus slack for the
    # learner's drain cadence.
    xp_ring_bytes: int = 8 << 20
    # Per-poll byte budget of the learner's sweep over the rings.
    xp_drain_budget_bytes: int = 64 << 20
    spawn_stagger_s: float = 0.0          # seconds between worker spawns
    # Floor between a worker's death and its respawn, with or without a
    # supervisor policy: a worker that crashes at start-up must not spin
    # the pool at spawn speed.
    respawn_min_interval_s: float = 0.25
    # Remote-worker slots (tcp only; python -m ape_x_dqn_tpu_torch.host_join):
    # worker ids beyond the local capacity whose channels the pool reserves
    # and whose actor slices are carved from the same global partition; the
    # pool writes a join spec to remote_join_path (required when > 0) and
    # never spawns or supervises them.
    remote_workers: int = 0
    remote_join_path: str = ""
    # Elastic headroom: the ε-ladder partition is carved over
    # max(num_workers, max_workers) local worker ids at construction, so a
    # worker grown later (ProcessActorPool.grow) claims a slice reserved
    # from step zero.  0 = num_workers (no headroom).
    max_workers: int = 0
    # --- central inference (serving/central.py; JAX config.py:160-210) ---
    # "local": each actor fleet holds params and runs its own forward.
    # "central": fleets hold NO params; each fleet step ships its
    # observation batch to the serving tier's micro-batcher and gets greedy
    # actions + q rows + param_version back; ε-greedy stays on the worker,
    # from its slice of the global ε-ladder.
    inference: str = "local"
    # The serving endpoint the workers dial.  Port 0 = auto: the trainer
    # hosts a PolicyServer + ServingNetServer in its own process (on the
    # learner's card) on an ephemeral port and hands the endpoint to the
    # workers before they spawn; a nonzero port names an external server.
    inference_host: str = "127.0.0.1"
    inference_port: int = 0
    # The v2 serve hello's run token; 0 = anonymous, and auto mode draws a
    # fresh one per run.
    inference_token: int = 0
    # Row groups each fleet step splits into, all in flight at once.
    inference_inflight: int = 4
    # Observation payload codec ("off" | "zlib", kept only when smaller)
    # and in-request frame dedup.
    inference_codec: str = "off"
    inference_dedup: bool = True
    # Per-select deadline across reconnects and retries, then the typed
    # InferenceUnavailable.
    inference_timeout_s: float = 30.0
    # On an outage: "none" blocks (stall counted) until the server
    # answers; "local" keeps the param subscription and acts from the
    # cached params meanwhile.
    inference_fallback: str = "none"


@dataclasses.dataclass
class LearnerConfig:
    total_steps: int = 500_000            # reference main.py:46
    q_target_sync_freq: int = 2500        # parameters.json:21
    min_replay_mem_size: int = 20_000     # parameters.json:22
    replay_sample_size: int = 32          # parameters.json:23
    optimizer: str = "rmsprop"            # "rmsprop" (parity) | "adam"
    learning_rate: float = 0.00025 / 4    # reference learner.py:26
    loss: str = "huber"                   # "huber" | "squared" (parity)
    max_grad_norm: Optional[float] = 40.0
    publish_every: int = 10               # param-store publish period (steps)
    # Checkpoints (utils/checkpoint.py): every checkpoint_every learner
    # steps (0 disables) the train state and the replay go to
    # checkpoint_dir/step_<N>/.  restore_from (the reference's
    # load_saved_state): False, True ("my checkpoint_dir") or a path; a
    # missing checkpoint warns and starts from scratch.
    checkpoint_every: int = 0
    checkpoint_dir: str = "checkpoints"
    restore_from: str | bool = False
    # The replay leg as the incremental chain of utils/checkpoint_inc
    # (dirty-span deltas written by a writer thread) instead of an inline
    # replay.npz; a full base every checkpoint_base_every deltas;
    # zlib-compressed chunk payloads with checkpoint_compress.
    checkpoint_incremental: bool = False
    checkpoint_base_every: int = 16
    checkpoint_compress: bool = False
    # True: the replay ring lives in device memory and each fused call runs
    # steps_per_call sample/train/restamp steps.  False (the default): the
    # host replay + one train step per sample (the golden path).
    device_replay: bool = False
    # Host-replay path: the deferred priority write-back is batched over
    # this many steps (1 = step t's priorities land after step t+1 is
    # dispatched).  Device replay: > 1 runs the overlapped fused pipeline
    # (runtime/infeed.DispatchPipeline): up to this many fused calls in
    # flight, ingest blocks carved on a stager thread.
    pipeline_depth: int = 1
    # Overlapped fused pipeline: a full drain of the calls in flight every
    # this many learner steps (0 = none; > 0 also selects the overlapped
    # pipeline at depth 1).  Device replay only.
    sync_every: int = 0
    steps_per_call: int = 128             # K steps per fused call
    ingest_block: int = 256               # rows per device ring add
    # True samples all K batches of a call in one sampler launch from
    # call-entry priorities and restamps once after the K steps; False is
    # strict sequential PER (one sampler launch per step).
    sample_ahead: bool = False
    # Data-parallel learner over several cards: only 1 is part of the port
    # (the multi-GPU learner is ROADMAP item 8).
    data_parallel: int = 1
    # Low-precision storage ("bfloat16" | "float32" | None): RMSProp's
    # second moment, the target net, and the network params (bfloat16
    # params step through a float32 master copy in the optimizer state).
    second_moment_dtype: Optional[str] = None
    target_dtype: Optional[str] = None
    param_dtype: Optional[str] = None


@dataclasses.dataclass
class ReplayConfig:
    capacity: int = 100_000               # parameters.json:28 soft_capacity
    priority_exponent: float = 0.6        # parameters.json:29
    is_exponent: float = 0.4              # parameters.json:30
    # zlib-compress stored frames in the host replay (a memory/CPU trade).
    frame_compression: bool = False
    # Frame-dedup storage (types.DedupChunk): actors ship each frame once and
    # the replay (the host DedupReplay, or the device ring with
    # learner.device_replay) stores one frame ring + per-transition refs.
    # frame_ratio sizes the frame ring per transition slot; it must cover the
    # emission's arrival ratio (≈ (flush_every + n) / flush_every plus
    # truncation extras) or the oldest transitions become unsampleable early.
    dedup: bool = False
    frame_ratio: float = 1.25
    # Tiered frame store (replay/tiered.py): > 0 caps the frame bytes the
    # host replay holds in DRAM; least-recently-sampled frame spans spill to
    # a CRC-framed cold file and fault back on sample, while the sum-tree and
    # every transition column stay hot (the sampling law is untouched).
    # 0 disables.  Host replay only (the device ring is its own tier).
    hot_frame_budget_bytes: int = 0
    # Spill-file directory.  "auto": <learner.checkpoint_dir>/replay_spill
    # when checkpointing is on (incremental bases then reference cold spans
    # by offset into a directory the run owns), else a per-pid temp dir.
    spill_dir: str = "auto"
    # Frames per spill span (the eviction and fault granule); 0: ~64 KiB.
    spill_span_frames: int = 0
    # Eviction hysteresis, as fractions of the hot budget: the evictor
    # thread wakes past high × budget and trims to low × budget.
    spill_watermark_high: float = 1.0
    spill_watermark_low: float = 0.9
    # --- replay as a service (replay/service.py; JAX config.py:357-397) ---
    # "attach" replaces the in-process replay with a retrying RPC client
    # over a sharded replay fleet (sample / add / update-priorities as
    # framed RPCs); the learner survives a shard dying (it trains on the
    # survivors, write-backs to the dead one buffer last-write-wins and
    # flush on recovery) and the shards own their checkpoint chains.
    # "off": the replay lives in the learner's address space.
    service_mode: str = "off"
    # The fleet's endpoints file (written atomically by ReplayServiceFleet,
    # re-read by the client when a shard moves).  Required in attach mode.
    service_endpoints: str = ""
    # RPC body codec: add/sample bodies are F_XPB-encoded (in-window frame
    # dedup + zlib negotiated at the hello).  "auto": shard-side sample
    # replies compress only while the shard's reply path sees blocked sends.
    service_codec: str = "zlib"
    service_dedup: bool = True
    # Per-request deadline across reconnects and whole-request retries;
    # past it the client raises ReplayShardUnavailable and routes around.
    service_request_timeout_s: float = 10.0
    # Down-shard probe cadence (re-resolve, digest probe, write-back flush).
    service_probe_interval_s: float = 0.5
    # Fleet width for the service-side launcher (the client takes its shard
    # map from the endpoints file).
    service_shards: int = 2
    # > 0 hosts each shard's replay on the tiered store (spill under
    # <ckpt_dir>/spill), capping its hot frame bytes.  0: dense shards.
    service_hot_frame_budget_bytes: int = 0


@dataclasses.dataclass
class FleetConfig:
    """The fleet's discovery plane (``fleet/registry.py``; JAX
    config.py:555-590): the run-token-scoped membership registry that the
    trainer hosts under ``discovery="registry"`` and that serving replicas
    (``serving/router.ServingFleet`` with a registry address) announce
    themselves to over ``F_FANN``/``F_FREP``."""

    # "registry": the trainer hosts the registry (a fleet_registry_listen
    # event carries its port and token); "endpoints": no registry.
    discovery: str = "endpoints"
    # Where the trainer hosts it; port 0 = ephemeral.
    registry_host: str = "127.0.0.1"
    registry_port: int = 0
    # A member's announce cadence; the lease sweep expires a member not
    # heard from within ttl_s (member_lost, reason ttl).
    heartbeat_s: float = 1.0
    ttl_s: float = 5.0

    def validate_section(self) -> list:
        return [
            (self.discovery in ("registry", "endpoints"),
             f"unknown fleet.discovery: {self.discovery}"),
            (0 <= self.registry_port <= 65535,
             "fleet.registry_port must be in [0, 65535]"),
            (self.heartbeat_s > 0.0, "fleet.heartbeat_s must be > 0"),
            (self.ttl_s >= self.heartbeat_s,
             "fleet.ttl_s must be >= fleet.heartbeat_s (a member must "
             "get at least one beat per lease)"),
        ]


@dataclasses.dataclass
class SupervisorConfig:
    """The supervision tier (runtime/supervisor.py).  Worker respawn: an
    exponential backoff (base doubling per death in the crash-loop window,
    capped) with multiplicative jitter; more than crash_loop_budget deaths
    inside the window quarantine the worker.  Disabled, a worker respawns
    at once until the pool's restart budget runs out, and the next death is
    fatal.  The learner watchdog: no progress (learner step or host syncs)
    for stall_deadline_s drops the overlapped pipeline to strict depth 1;
    still none wedge_deadline_s later declares the run wedged (an event,
    not a kill).  poll_s is the supervisor thread's cadence."""

    enabled: bool = True
    respawn_backoff_base_s: float = 0.5
    respawn_backoff_max_s: float = 30.0
    respawn_jitter: float = 0.25          # +/- fraction of the backoff
    crash_loop_window_s: float = 120.0
    crash_loop_budget: int = 5
    stall_deadline_s: float = 120.0
    wedge_deadline_s: float = 120.0
    poll_s: float = 0.5


@dataclasses.dataclass
class ServingConfig:
    """Policy-serving knobs (``serving/`` and ``python -m
    ape_x_dqn_tpu_torch.serve``; JAX config.py:401-443)."""

    max_batch: int = 32          # largest bucket one forward serves
    max_wait_ms: float = 5.0     # deadline: oldest request's max queue wait
    queue_capacity: int = 256    # admission bound (load shed beyond)
    reload_poll_s: float = 0.25  # param-source poll cadence (hot reload)
    # Staleness bound on the served params (ServingStalenessPolicy): past
    # this many seconds without a fresh snapshot the server sheds with the
    # typed ServerOverloaded until one lands.  0 = off.
    param_stale_s: float = 0.0
    # Bind host/port of the socket plane (serve --listen); port 0 =
    # ephemeral, announced as a serving_listen JSONL event.
    listen_host: str = "127.0.0.1"
    listen_port: int = 0
    # Fleet width of serve --replicas (serving/router.ServingFleet).
    replicas: int = 2
    # Length-prefix cap on the request plane.
    max_request_bytes: int = 8 << 20
    # The router's /healthz probe cadence, the fleet's budget for a
    # replica to announce its ports, and the param tail's full-snapshot
    # cadence (serving/sources.ParamTailWriter).
    probe_interval_s: float = 0.5
    replica_spawn_timeout_s: float = 240.0
    param_tail_base_every: int = 16


@dataclasses.dataclass
class ObsConfig:
    """Observability knobs (``obs/``; JAX config.py:445-551), with the
    fleet aggregator's and SLO engine's (``obs.fleet_*``, ``obs/fleet.py``)
    and the timeline store's (``obs.timeline_*``, ``obs/timeline.py``)."""

    # Port of the /metrics, /varz, /healthz exporter; None = no exporter,
    # 0 = an ephemeral port (AsyncPipeline.obs_port, an obs_exporter event).
    export_port: Optional[int] = None
    # Share of actor chunks stamped with a lineage trace id (0 = none).
    trace_sample_rate: float = 0.0
    # Flight-recorder depth, in memory and in each worker's stats block.
    recorder_depth: int = 256
    # /healthz: a component whose heartbeat is older than this is degraded.
    heartbeat_stale_s: float = 15.0
    # Post-mortem files: "auto" = <learner.checkpoint_dir>/postmortem when
    # checkpoints are on, else none; a path = there; None = none.
    postmortem_dir: Optional[str] = "auto"
    # /varz?trace=1: learner steps one capture traces, and where it goes
    # (None = a fresh temporary directory per capture).
    trace_steps: int = 512
    trace_dir: Optional[str] = None
    # --- the fleet aggregator (obs/fleet.py) ---
    # Scrape cadence and per-scrape timeout (HTTP and the shard stats RPC
    # alike); a dead scrape marks that endpoint down, never the sweep.
    fleet_scrape_interval_s: float = 1.0
    fleet_scrape_timeout_s: float = 2.0
    # Rollup exporter port for a tool that mounts the aggregator
    # (tools/obs_top.py --fleet scrapes it); None = the tool picks, 0 =
    # ephemeral.
    fleet_port: Optional[int] = None
    # --- SLO rules over the rollup (0 = rule off) ---
    # Ceilings (ms): the fleet-merged age-at-sample p95, the worst
    # trainer's inference rtt p99, the replica-merged serving p99.
    fleet_slo_age_p95_ms: float = 0.0
    fleet_slo_inference_rtt_p99_ms: float = 0.0
    fleet_slo_serving_p99_ms: float = 0.0
    # Floor on the summed replica QPS.
    fleet_slo_serving_qps_min: float = 0.0
    # Ring-occupancy band, as fractions of actor.xp_ring_bytes; (0, 1]
    # leaves both ends off.
    fleet_slo_ring_occupancy_low: float = 0.0
    fleet_slo_ring_occupancy_high: float = 1.0
    # Ceiling on the replay fleet's add QPS per live shard (the autopilot's
    # replay grow signal).
    fleet_slo_replay_add_qps_high: float = 0.0
    # Endpoint liveness (on by default): breach while any endpoint fails
    # its scrapes.
    fleet_slo_endpoint_alive: bool = True
    # Burn-rate window; a rule breaches at burn >= burn_threshold and
    # clears only at burn <= clear_threshold, after min_samples samples.
    fleet_slo_window_s: float = 30.0
    fleet_slo_burn_threshold: float = 0.5
    fleet_slo_clear_threshold: float = 0.1
    fleet_slo_min_samples: int = 3
    # --- the flight-data recorder (obs/timeline.py) ---
    # "auto" = <learner.checkpoint_dir>/timeline when checkpoints are on,
    # else none; a path = there; None = none.
    timeline_dir: Optional[str] = "auto"
    # On-disk budget (oldest committed segments pruned past it), segment
    # rotation size, and the in-memory tail the sweep path queries.
    timeline_max_bytes: int = 16 << 20
    timeline_segment_bytes: int = 1 << 20
    timeline_tail_keep_s: float = 600.0


@dataclasses.dataclass
class AutopilotConfig:
    """The elastic capacity controller (``autopilot/``; JAX
    config.py:648-745).  Default off.  It consumes the SLO engine's
    ``slo_breach`` / ``slo_clear`` events (``obs.fleet_slo_*``) and the
    rollup, and grows or retires actor workers, serving replicas and
    replay shards within guardrails: bounds, per-direction cooldowns and a
    hold against the opposite direction."""

    enabled: bool = False
    # Emit every decision as an autopilot_action event without actuating.
    dry_run: bool = False
    # Decision cadence (the controller's own thread).
    poll_s: float = 1.0
    # Actor floor; the ceiling is the pool's reserved capacity
    # (max(actor.num_workers, actor.max_workers)).
    actor_min_workers: int = 1
    serving_min_replicas: int = 1
    serving_max_replicas: int = 4
    # After an action the same direction waits its cooldown; the opposite
    # direction waits hold_opposite_s.
    cooldown_up_s: float = 10.0
    cooldown_down_s: float = 60.0
    hold_opposite_s: float = 30.0
    # Idle scale-down of replicas (per-replica QPS under this for the idle
    # window, every governing rule green); 0 = replicas only scale up.
    serving_idle_qps_per_replica: float = 0.0
    # Burn window of the idle rules (the controller's own SloEngine).
    idle_window_s: float = 30.0
    # The drain ladder: the pool's drain budget doubles per action up to
    # this multiple before any worker is retired.
    drain_tune_max_factor: float = 4.0
    # Replay fleet bounds and its idle rule (per-shard add QPS); 0 = the
    # replay fleet only scales up.
    replay_min_shards: int = 1
    replay_max_shards: int = 4
    replay_idle_add_qps_per_shard: float = 0.0

    def validate_section(self) -> list:
        return [
            (self.poll_s > 0.0, "autopilot.poll_s must be > 0"),
            (self.actor_min_workers >= 1,
             "autopilot.actor_min_workers must be >= 1"),
            (self.serving_min_replicas >= 1,
             "autopilot.serving_min_replicas must be >= 1"),
            (self.serving_max_replicas >= self.serving_min_replicas,
             "autopilot.serving_max_replicas must be >= "
             "autopilot.serving_min_replicas"),
            (self.cooldown_up_s >= 0.0,
             "autopilot.cooldown_up_s must be >= 0"),
            (self.cooldown_down_s >= 0.0,
             "autopilot.cooldown_down_s must be >= 0"),
            (self.hold_opposite_s >= 0.0,
             "autopilot.hold_opposite_s must be >= 0"),
            (self.serving_idle_qps_per_replica >= 0.0,
             "autopilot.serving_idle_qps_per_replica must be >= 0"),
            (self.idle_window_s > 0.0,
             "autopilot.idle_window_s must be > 0"),
            (self.drain_tune_max_factor >= 1.0,
             "autopilot.drain_tune_max_factor must be >= 1"),
            (self.replay_min_shards >= 1,
             "autopilot.replay_min_shards must be >= 1"),
            (self.replay_max_shards >= self.replay_min_shards,
             "autopilot.replay_max_shards must be >= "
             "autopilot.replay_min_shards"),
            (self.replay_idle_add_qps_per_shard >= 0.0,
             "autopilot.replay_idle_add_qps_per_shard must be >= 0"),
        ]


@dataclasses.dataclass
class ChaosConfig:
    """Deterministic fault injection (obs/chaos.py), JAX config.py:747-830.
    Default off.

    Every ``*_interval_s`` is the mean seconds between faults of that kind
    on one seeded schedule (0 disables the kind), so a chaos run
    reproduces: same seed, same fault sequence.  The monkey attacks only
    the run it is attached to: its own pool's workers, its own checkpoint
    dir, and the replay fleet it is attached to (``kill_shard``).
    """

    enabled: bool = False
    seed: int = 0
    kill_interval_s: float = 0.0          # SIGKILL a random live worker
    sigstop_interval_s: float = 0.0       # SIGSTOP, SIGCONT after the hold
    sigstop_hold_s: float = 0.5
    # SIGKILL a worker and scribble an uncommitted torn record into its
    # ring before salvage: the deterministic "killed mid-write".
    torn_record_interval_s: float = 0.0
    # Damage one committed APXC chunk (the restore fallback's trigger; it
    # takes effect at the next restore).
    corrupt_chunk_interval_s: float = 0.0
    # Hold the overlapped pipeline's ingest stager idle for the hold.
    stuck_stager_interval_s: float = 0.0
    stuck_stager_hold_s: float = 1.0
    # Transient /dev/shm pressure: hold shm_fill_bytes for the hold.
    shm_fill_interval_s: float = 0.0
    shm_fill_bytes: int = 64 << 20
    shm_fill_hold_s: float = 1.0
    # Mean per-env-step latency inside worker processes (ms, seeded ±50 %).
    env_latency_ms: float = 0.0
    # Mean per-batch latency in the PolicyServer's apply path (ms, seeded
    # ±25 %).
    serving_delay_ms: float = 0.0
    # --- RPC-plane chaos (replay/service.py shards; JAX :786-800) ---
    # Mean per-request delay (ms, seeded ±50 %) injected shard-side before
    # the request executes.
    rpc_delay_ms: float = 0.0
    # Probability a well-framed request is silently dropped shard-side (the
    # lost reply that forces a whole-request retry).  Seeded.
    rpc_drop_rate: float = 0.0
    # SIGKILL one fleet shard (seeded choice) when the learner's step count
    # first crosses this value (ReplayServiceFleet.maybe_kill_at_step).
    kill_shard_at_step: int = 0
    # Scheduled shard kills on the monkey's timeline; 0 disables the kind.
    kill_shard_interval_s: float = 0.0

    def validate_section(self) -> list:
        nonneg = [
            ("kill_interval_s", self.kill_interval_s),
            ("sigstop_interval_s", self.sigstop_interval_s),
            ("sigstop_hold_s", self.sigstop_hold_s),
            ("torn_record_interval_s", self.torn_record_interval_s),
            ("corrupt_chunk_interval_s", self.corrupt_chunk_interval_s),
            ("stuck_stager_interval_s", self.stuck_stager_interval_s),
            ("stuck_stager_hold_s", self.stuck_stager_hold_s),
            ("shm_fill_interval_s", self.shm_fill_interval_s),
            ("shm_fill_hold_s", self.shm_fill_hold_s),
            ("env_latency_ms", self.env_latency_ms),
            ("rpc_delay_ms", self.rpc_delay_ms),
            ("kill_shard_interval_s", self.kill_shard_interval_s),
            ("serving_delay_ms", self.serving_delay_ms),
        ]
        return [
            (v >= 0.0, f"chaos.{k} must be >= 0") for k, v in nonneg
        ] + [
            (self.shm_fill_bytes >= 0, "chaos.shm_fill_bytes must be >= 0"),
            (0.0 <= self.rpc_drop_rate <= 1.0,
             "chaos.rpc_drop_rate must be in [0, 1]"),
            (self.kill_shard_at_step >= 0,
             "chaos.kill_shard_at_step must be >= 0"),
        ]


@dataclasses.dataclass
class ApexConfig:
    env: EnvConfig = dataclasses.field(default_factory=EnvConfig)
    actor: ActorConfig = dataclasses.field(default_factory=ActorConfig)
    learner: LearnerConfig = dataclasses.field(default_factory=LearnerConfig)
    replay: ReplayConfig = dataclasses.field(default_factory=ReplayConfig)
    supervisor: SupervisorConfig = dataclasses.field(default_factory=SupervisorConfig)
    serving: ServingConfig = dataclasses.field(default_factory=ServingConfig)
    obs: ObsConfig = dataclasses.field(default_factory=ObsConfig)
    fleet: FleetConfig = dataclasses.field(default_factory=FleetConfig)
    autopilot: AutopilotConfig = dataclasses.field(default_factory=AutopilotConfig)
    chaos: ChaosConfig = dataclasses.field(default_factory=ChaosConfig)
    network: str = "conv"                 # "conv" | "nature" | "mlp"
    seed: int = 0

    def validate(self) -> "ApexConfig":
        a, l, r, s = self.actor, self.learner, self.replay, self.supervisor
        v, o = self.serving, self.obs
        checks = [
            (o.export_port is None or 0 <= o.export_port <= 65535,
             "obs.export_port must be None or in [0, 65535]"),
            (0.0 <= o.trace_sample_rate <= 1.0, "obs.trace_sample_rate must be in [0, 1]"),
            (o.recorder_depth >= 1, "obs.recorder_depth must be >= 1"),
            (o.heartbeat_stale_s > 0.0, "obs.heartbeat_stale_s must be > 0"),
            (o.trace_steps >= 1, "obs.trace_steps must be >= 1"),
            (o.fleet_scrape_interval_s > 0.0,
             "obs.fleet_scrape_interval_s must be > 0"),
            (o.fleet_scrape_timeout_s > 0.0,
             "obs.fleet_scrape_timeout_s must be > 0"),
            (o.fleet_port is None or 0 <= o.fleet_port <= 65535,
             "obs.fleet_port must be None or in [0, 65535]"),
            (o.fleet_slo_age_p95_ms >= 0.0,
             "obs.fleet_slo_age_p95_ms must be >= 0"),
            (o.fleet_slo_inference_rtt_p99_ms >= 0.0,
             "obs.fleet_slo_inference_rtt_p99_ms must be >= 0"),
            (o.fleet_slo_serving_p99_ms >= 0.0,
             "obs.fleet_slo_serving_p99_ms must be >= 0"),
            (o.fleet_slo_serving_qps_min >= 0.0,
             "obs.fleet_slo_serving_qps_min must be >= 0"),
            (0.0 <= o.fleet_slo_ring_occupancy_low
             <= o.fleet_slo_ring_occupancy_high <= 1.0,
             "obs.fleet_slo_ring_occupancy band must satisfy "
             "0 <= low <= high <= 1"),
            (o.fleet_slo_window_s > 0.0,
             "obs.fleet_slo_window_s must be > 0"),
            (0.0 <= o.fleet_slo_clear_threshold
             <= o.fleet_slo_burn_threshold <= 1.0,
             "obs.fleet_slo thresholds must satisfy "
             "0 <= clear <= burn <= 1"),
            (o.fleet_slo_min_samples >= 1,
             "obs.fleet_slo_min_samples must be >= 1"),
            (o.timeline_segment_bytes >= 1 << 12,
             "obs.timeline_segment_bytes must be >= 4 KiB (a segment "
             "must hold at least a few records before rotating)"),
            (o.timeline_max_bytes >= o.timeline_segment_bytes,
             "obs.timeline_max_bytes must be >= obs.timeline_segment_bytes"),
            (o.timeline_tail_keep_s > 0.0,
             "obs.timeline_tail_keep_s must be > 0"),
            (o.fleet_slo_replay_add_qps_high >= 0.0,
             "obs.fleet_slo_replay_add_qps_high must be >= 0"),
            (a.inference in ("local", "central"),
             f"unknown actor.inference: {a.inference}"),
            (0 <= a.inference_port <= 65535,
             "actor.inference_port must be in [0, 65535]"),
            (a.inference_inflight >= 1, "actor.inference_inflight must be >= 1"),
            (a.inference_codec in ("off", "zlib"),
             f"unknown actor.inference_codec: {a.inference_codec}"),
            (a.inference_timeout_s > 0.0, "actor.inference_timeout_s must be > 0"),
            (a.inference_fallback in ("none", "local"),
             f"unknown actor.inference_fallback: {a.inference_fallback}"),
            (v.max_batch >= 1, "serving.max_batch must be >= 1"),
            (v.max_wait_ms >= 0.0, "serving.max_wait_ms must be >= 0"),
            (v.queue_capacity >= v.max_batch,
             "serving.queue_capacity must be >= serving.max_batch (a full "
             "batch must be admissible)"),
            (v.reload_poll_s > 0.0, "serving.reload_poll_s must be > 0"),
            (v.param_stale_s >= 0.0, "serving.param_stale_s must be >= 0"),
            (0 <= v.listen_port <= 65535, "serving.listen_port must be in [0, 65535]"),
            (v.replicas >= 1, "serving.replicas must be >= 1"),
            (v.max_request_bytes >= 1 << 16,
             "serving.max_request_bytes must be >= 64 KiB (one batched "
             "observation must fit a frame)"),
            (v.probe_interval_s > 0.0, "serving.probe_interval_s must be > 0"),
            (v.replica_spawn_timeout_s > 0.0,
             "serving.replica_spawn_timeout_s must be > 0"),
            (v.param_tail_base_every >= 1,
             "serving.param_tail_base_every must be >= 1"),
            (a.mode in ("thread", "process"), f"unknown actor.mode: {a.mode}"),
            (a.num_workers >= 1, "actor.num_workers must be >= 1"),
            (a.mode != "process" or a.num_actors >= a.num_workers,
             "actor.num_actors must be >= actor.num_workers in process mode"),
            (a.transport in TRANSPORT_KINDS, f"unknown actor.transport: {a.transport}"),
            (0 <= a.transport_port <= 65535, "actor.transport_port must be in [0, 65535]"),
            (a.transport_hosts >= 1, "actor.transport_hosts must be >= 1"),
            (a.transport == "tcp" or a.transport_hosts == 1,
             "actor.transport_hosts > 1 requires actor.transport=tcp "
             "(shm rings cannot leave the host)"),
            (a.net_conn_buf_bytes >= 1 << 16,
             "actor.net_conn_buf_bytes must be >= 64 KiB (one chunk must "
             "fit the in-flight window)"),
            (a.net_codec in ("off", "zlib", "auto"), f"unknown actor.net_codec: {a.net_codec}"),
            (a.net_coalesce_bytes == 0 or a.net_coalesce_bytes >= 1 << 12,
             "actor.net_coalesce_bytes must be 0 (off) or >= 4 KiB (a "
             "budget below one record degenerates to per-record flushes)"),
            (a.net_coalesce_wait_ms >= 0.0, "actor.net_coalesce_wait_ms must be >= 0"),
            (a.transport == "tcp" or (a.net_codec == "off" and a.net_coalesce_bytes == 0),
             "actor.net_codec / net_coalesce_bytes require actor.transport=tcp "
             "(the shm ring has no wire bytes to save)"),
            (a.remote_workers >= 0, "actor.remote_workers must be >= 0"),
            (a.remote_workers == 0 or a.transport == "tcp",
             "actor.remote_workers requires actor.transport=tcp"),
            (a.remote_workers == 0 or bool(a.remote_join_path),
             "actor.remote_workers requires actor.remote_join_path (where the "
             "join spec is written)"),
            (a.max_workers == 0 or a.max_workers >= a.num_workers,
             "actor.max_workers must be 0 (no headroom) or >= "
             "actor.num_workers (the spawned width is part of the "
             "reserved partition)"),
            (a.max_workers == 0 or a.mode == "process",
             "actor.max_workers requires actor.mode=process (the elastic "
             "pool is the process fleet)"),
            (a.mode != "process" or a.num_actors >= max(a.num_workers, a.max_workers),
             "actor.num_actors must cover the reserved worker capacity "
             "(max(num_workers, max_workers)) in process mode"),
            (0 <= a.worker_nice <= 19, "actor.worker_nice must be in [0, 19]"),
            (a.xp_ring_bytes >= 1 << 16,
             "actor.xp_ring_bytes must be >= 64 KiB (one chunk + record header)"),
            (a.xp_drain_budget_bytes >= 1 << 16,
             "actor.xp_drain_budget_bytes must be >= 64 KiB"),
            (a.spawn_stagger_s >= 0.0, "actor.spawn_stagger_s must be >= 0"),
            (a.respawn_min_interval_s >= 0.0,
             "actor.respawn_min_interval_s must be >= 0"),
            (s.respawn_backoff_base_s >= 0.0,
             "supervisor.respawn_backoff_base_s must be >= 0"),
            (s.respawn_backoff_max_s >= s.respawn_backoff_base_s,
             "supervisor.respawn_backoff_max_s must be >= base"),
            (0.0 <= s.respawn_jitter <= 1.0, "supervisor.respawn_jitter must be in [0, 1]"),
            (s.crash_loop_window_s > 0.0, "supervisor.crash_loop_window_s must be > 0"),
            (s.crash_loop_budget >= 1, "supervisor.crash_loop_budget must be >= 1"),
            (s.stall_deadline_s > 0.0, "supervisor.stall_deadline_s must be > 0"),
            (s.wedge_deadline_s > 0.0, "supervisor.wedge_deadline_s must be > 0"),
            (s.poll_s > 0.0, "supervisor.poll_s must be > 0"),
            (a.num_actors >= 1, "actor.num_actors must be >= 1"),
            (a.num_steps >= 1, "actor.num_steps must be >= 1"),
            (0.0 <= a.epsilon <= 1.0, "actor.epsilon must be in [0, 1]"),
            (0.0 < a.gamma <= 1.0, "actor.gamma must be in (0, 1]"),
            (a.flush_every >= 1, "actor.flush_every must be >= 1"),
            (a.sync_every >= 1, "actor.sync_every must be >= 1"),
            (a.emission in ("overlapping", "strided"),
             f"unknown actor.emission: {a.emission}"),
            (a.emission != "strided" or a.flush_every >= a.num_steps,
             "actor.emission=strided requires flush_every >= num_steps"),
            (l.publish_every >= 1, "learner.publish_every must be >= 1"),
            (l.checkpoint_every >= 0, "learner.checkpoint_every must be >= 0"),
            (l.checkpoint_base_every >= 1,
             "learner.checkpoint_base_every must be >= 1"),
            (l.replay_sample_size >= 1, "learner.replay_sample_size must be >= 1"),
            (l.q_target_sync_freq >= 1, "learner.q_target_sync_freq must be >= 1"),
            (r.capacity >= l.replay_sample_size,
             "replay.capacity must be >= learner.replay_sample_size"),
            (l.min_replay_mem_size <= r.capacity,
             "learner.min_replay_mem_size must be <= replay.capacity"),
            (0.0 <= r.priority_exponent <= 1.0,
             "replay.priority_exponent must be in [0, 1]"),
            (0.0 <= r.is_exponent <= 1.0, "replay.is_exponent must be in [0, 1]"),
            (self.network in ("conv", "nature", "mlp"),
             f"unknown network kind: {self.network}"),
            (l.optimizer in ("rmsprop", "adam"),
             f"unknown optimizer kind: {l.optimizer}"),
            (l.loss in ("huber", "squared"), f"unknown loss kind: {l.loss}"),
            (l.steps_per_call >= 1, "learner.steps_per_call must be >= 1"),
            (l.ingest_block >= 1, "learner.ingest_block must be >= 1"),
            (not l.sample_ahead or l.device_replay,
             "learner.sample_ahead=True requires device_replay=True"),
            (l.pipeline_depth >= 1, "learner.pipeline_depth must be >= 1"),
            (l.sync_every >= 0, "learner.sync_every must be >= 0"),
            (not l.sync_every or l.device_replay,
             "learner.sync_every requires device_replay=True (it paces "
             "the overlapped fused-dispatch pipeline)"),
            (not (r.frame_compression and l.device_replay),
             "replay.frame_compression applies to the host replay only "
             "(learner.device_replay=false)"),
            (l.data_parallel == 1,
             f"learner.data_parallel={l.data_parallel}: the multi-GPU learner "
             "(parallel/dp.py, replay/device_dp.py, replay/device_dedup_dp.py) "
             "is not part of the port yet (ROADMAP item 8)"),
            (not r.dedup or a.flush_every >= a.num_steps,
             "replay.dedup requires actor.flush_every >= actor.num_steps "
             "(carry refs reach at most one chunk back)"),
            (not (r.dedup and r.frame_compression),
             "replay.dedup and replay.frame_compression are mutually "
             "exclusive (the dedup frame ring stores raw uint8)"),
            (r.frame_ratio > 0, "replay.frame_ratio must be positive"),
            (r.hot_frame_budget_bytes >= 0,
             "replay.hot_frame_budget_bytes must be >= 0"),
            (not (r.hot_frame_budget_bytes and r.frame_compression),
             "replay.hot_frame_budget_bytes and replay.frame_compression "
             "are mutually exclusive (the cold tier spans raw frame "
             "bytes; compressed slots are per-slot python objects)"),
            (not (r.hot_frame_budget_bytes and l.device_replay),
             "replay.hot_frame_budget_bytes requires device_replay=False "
             "(the tier spills the HOST frame ring; the HBM ring is its "
             "own tier)"),
            (r.spill_span_frames >= 0,
             "replay.spill_span_frames must be >= 0"),
            (0.0 < r.spill_watermark_low <= r.spill_watermark_high <= 1.0,
             "replay spill watermarks must satisfy "
             "0 < low <= high <= 1"),
            (r.service_mode in ("off", "attach"),
             f"unknown replay.service_mode: {r.service_mode}"),
            (r.service_mode == "off" or r.service_endpoints,
             "replay.service_mode=attach requires replay.service_endpoints "
             "(the fleet's endpoints file)"),
            (r.service_codec in ("off", "zlib", "auto"),
             f"unknown replay.service_codec: {r.service_codec}"),
            (r.service_request_timeout_s > 0.0,
             "replay.service_request_timeout_s must be > 0"),
            (r.service_probe_interval_s > 0.0,
             "replay.service_probe_interval_s must be > 0"),
            (r.service_shards >= 1, "replay.service_shards must be >= 1"),
            (r.service_hot_frame_budget_bytes >= 0,
             "replay.service_hot_frame_budget_bytes must be >= 0"),
            (r.service_mode == "off"
             or not (r.dedup or r.frame_compression
                     or r.hot_frame_budget_bytes or l.device_replay),
             "replay.service_mode=attach hosts a plain PrioritizedReplay "
             "per shard — dedup / frame_compression / hot_frame_budget / "
             "device_replay stay learner-local features"),
            (r.service_mode == "off" or not l.checkpoint_incremental,
             "replay.service_mode=attach is incompatible with "
             "learner.checkpoint_incremental: the shards own the replay's "
             "checkpoint chains (the learner's state leg is unaffected)"),
            (l.second_moment_dtype in (None, "bfloat16", "float32"),
             f"unknown second_moment_dtype: {l.second_moment_dtype}"),
            (l.target_dtype in (None, "bfloat16", "float32"),
             f"unknown target_dtype: {l.target_dtype}"),
            (l.param_dtype in (None, "bfloat16", "float32"),
             f"unknown param_dtype: {l.param_dtype}"),
            (not (l.second_moment_dtype is not None and l.optimizer == "adam"),
             "second_moment_dtype is only supported for rmsprop"),
        ]
        for ok, msg in (checks + self.fleet.validate_section()
                        + self.autopilot.validate_section()
                        + self.chaos.validate_section()):
            if not ok:
                raise ValueError(msg)
        return self


_REFERENCE_KEY_MAP = {
    # (reference section, reference key) -> (section attr, field, transform)
    ("env_conf", "name"): ("env", "name", str),
    ("env_conf", "state_shape"): ("env", "state_shape", tuple),
    ("env_conf", "action_dim"): ("env", "action_dim", int),
    ("Actor", "num_actors"): ("actor", "num_actors", int),
    ("Actor", "T"): ("actor", "T", int),
    ("Actor", "num_steps"): ("actor", "num_steps", int),
    ("Actor", "epsilon"): ("actor", "epsilon", float),
    ("Actor", "alpha"): ("actor", "alpha", float),
    ("Actor", "gamma"): ("actor", "gamma", float),
    ("Actor", "n_step_transition_batch_size"): ("actor", "flush_every", int),
    ("Actor", "Q_network_sync_freq"): ("actor", "sync_every", int),
    ("Learner", "T"): ("learner", "total_steps", int),
    ("Learner", "q_target_sync_freq"): ("learner", "q_target_sync_freq", int),
    ("Learner", "min_replay_mem_size"): ("learner", "min_replay_mem_size", int),
    ("Learner", "replay_sample_size"): ("learner", "replay_sample_size", int),
    ("Learner", "load_saved_state"): ("learner", "restore_from", lambda v: v),
    ("Learner", "remove_old_xp_freq"): (None, None, None),  # no-op (ring evicts)
    ("Replay_Memory", "soft_capacity"): ("replay", "capacity", int),
    ("Replay_Memory", "priority_exponent"): ("replay", "priority_exponent", float),
    ("Replay_Memory", "importance_sampling_exponent"): ("replay", "is_exponent", float),
}


def from_reference_json(data: dict) -> ApexConfig:
    """Load a reference-format parameters.json dict.  Unknown keys raise.
    ``Learner.load_saved_state`` maps to ``learner.restore_from``."""
    cfg = ApexConfig()
    for section, keys in data.items():
        if not isinstance(keys, dict):
            raise ValueError(f"unknown top-level config entry: {section}")
        for key, value in keys.items():
            mapping = _REFERENCE_KEY_MAP.get((section, key))
            if mapping is None:
                raise ValueError(f"unknown config key: {section}.{key}")
            attr, field, transform = mapping
            if attr is None:
                continue  # documented no-op
            setattr(getattr(cfg, attr), field, transform(value))
    return cfg.validate()


# Fields typed str | bool: only boolean words coerce, anything else is a
# path.
_PATH_OR_BOOL_FIELDS = {"restore_from"}

# Optional-typed fields where a CLI "none" legitimately means None.
_OPTIONAL_FIELDS = {"state_shape", "action_dim", "max_grad_norm",
                    "second_moment_dtype", "target_dtype", "param_dtype",
                    "export_port", "postmortem_dir", "trace_dir", "fleet_port"}


def _coerce(current: Any, raw: str, field: str = "") -> Any:
    if raw.lower() in ("none", "null") and field in _OPTIONAL_FIELDS:
        return None
    if current is None:
        for conv in (int, float):
            try:
                return conv(raw)
            except ValueError:
                continue
        return raw
    if isinstance(current, bool):
        low = raw.lower()
        if low in ("1", "true", "yes"):
            return True
        if low in ("0", "false", "no"):
            return False
        if field in _PATH_OR_BOOL_FIELDS:
            return raw   # a path (JAX config.py:1187-1192)
        raise ValueError(f"{field}: expected a boolean, got {raw!r}")
    if isinstance(current, int):
        return int(raw)
    if isinstance(current, float):
        return float(raw)
    return raw


# Keys of the JAX package's config whose feature the port does not run yet,
# refused by name with their ROADMAP item (any other unknown key is refused
# as unknown).  Every key of the JAX config now loads: the multi-GPU learner
# (item 8) is refused by value, in ``ApexConfig.validate``
# (``learner.data_parallel`` other than 1).
_NOT_PORTED: dict = {}


# Whole sections of the JAX package's config whose feature the port does
# not run yet: every key under them is refused by name.
_NOT_PORTED_SECTIONS: dict = {}


def _not_ported(path: str) -> Optional[str]:
    return _NOT_PORTED.get(path) or _NOT_PORTED_SECTIONS.get(path.split(".", 1)[0])


def _unknown_key(path: str) -> ValueError:
    what = _not_ported(path)
    if what is not None:
        return ValueError(f"{path}: {what} is not part of the port yet")
    return ValueError(f"unknown config field: {path}")


def apply_overrides(cfg: ApexConfig, overrides: Sequence[str]) -> ApexConfig:
    """Apply CLI ``section.field=value`` overrides (e.g.
    ``actor.num_actors=64``, ``network=mlp``)."""
    for item in overrides:
        if "=" not in item:
            raise ValueError(f"override must be key=value, got: {item}")
        path, raw = item.split("=", 1)
        if _not_ported(path) is not None:
            raise _unknown_key(path)
        parts = path.split(".")
        obj = cfg
        for p in parts[:-1]:
            if not hasattr(obj, p):
                raise ValueError(f"unknown config path: {path}")
            obj = getattr(obj, p)
        field = parts[-1]
        if not hasattr(obj, field):
            raise _unknown_key(path)
        setattr(obj, field, _coerce(getattr(obj, field), raw, field))
    return cfg.validate()


def load_config(path: Optional[str] = None, overrides: Sequence[str] = ()) -> ApexConfig:
    """Load config: native JSON (sections matching dataclass fields) or
    reference-format parameters.json, then CLI overrides."""
    cfg = ApexConfig()
    if path:
        with open(path) as f:
            data = json.load(f)
        if any(s in data for s in ("env_conf", "Actor", "Learner", "Replay_Memory")):
            cfg = from_reference_json(data)
        else:
            cfg = _from_native_json(data)
    return apply_overrides(cfg, overrides)


_SECTIONS = {
    "env": EnvConfig, "actor": ActorConfig,
    "learner": LearnerConfig, "replay": ReplayConfig,
    "supervisor": SupervisorConfig, "serving": ServingConfig, "obs": ObsConfig,
    "fleet": FleetConfig, "autopilot": AutopilotConfig, "chaos": ChaosConfig,
}


def _from_native_json(data: dict) -> ApexConfig:
    cfg = ApexConfig()
    for key, value in data.items():
        if key in _SECTIONS:
            known = {f.name for f in dataclasses.fields(_SECTIONS[key])}
            unknown = set(value) - known
            for field in sorted(unknown):
                if f"{key}.{field}" in _NOT_PORTED:
                    raise _unknown_key(f"{key}.{field}")
            if unknown:
                raise ValueError(
                    f"config keys in {key} the port does not run: "
                    f"{sorted(unknown)}"
                )
            setattr(cfg, key, _SECTIONS[key](**value))
        elif key in ("network", "seed"):
            setattr(cfg, key, data[key])
        elif key in _NOT_PORTED_SECTIONS:
            raise _unknown_key(key)
        elif isinstance(value, dict) and any(f"{key}.{f}" in _NOT_PORTED for f in value):
            raise _unknown_key(next(f"{key}.{f}" for f in value
                                    if f"{key}.{f}" in _NOT_PORTED))
        elif key.startswith("_"):
            pass  # "_comment" and friends: documentation, not config
        else:
            raise ValueError(f"config entry the port does not run: {key}")
    return cfg.validate()


def to_dict(cfg: ApexConfig) -> dict:
    return dataclasses.asdict(cfg)


def transport_budget(cfg: ApexConfig, num_workers: Optional[int] = None,
                     hosts: Optional[int] = None) -> dict:
    """fd, shm and socket budget of the process-actor transport at a given
    fleet width (JAX config.py:1266): the planning arithmetic whose live
    twin is ``ProcessActorPool.shm_accounting``.

    shm: per worker one ring segment, the control queue's pipe pair and
    the process sentinel (~5 fds), plus one param segment for the fleet.
    tcp: the ring becomes a connection and its bytes kernel socket buffers;
    the learner's host also holds one receive buffer per connection.
    ``per_host`` spreads the workers over ``hosts`` (default
    ``actor.transport_hosts``; host 0 is the learner's): shm bytes are
    charged to host 0 only, socket, coalescing and codec buffers to each
    worker's host and once more per connection to host 0.
    ``conn_drain_budget_bytes`` is the per-connection share of the poll
    sweep's byte budget that ``runtime/transport.make_transport`` gives
    each channel."""
    a = cfg.actor
    w = int(num_workers if num_workers is not None else a.num_workers)
    h_n = max(1, int(hosts if hosts is not None else a.transport_hosts))
    ring, conn = int(a.xp_ring_bytes), int(a.net_conn_buf_bytes)
    conn_drain = max(64 << 10, int(a.xp_drain_budget_bytes) // max(1, w))
    coal = int(a.net_coalesce_bytes)
    codec_scratch = max(coal, 1 << 20) if a.net_codec != "off" else 0
    shm = a.transport == "shm"

    def workers_and_learner(each: int, wh: int, h: int) -> int:
        return 0 if shm else wh * each + (w * each if h == 0 else 0)

    per_host = []
    for h in range(h_n):
        wh = (h + 1) * w // h_n - h * w // h_n
        per_host.append({
            "host": h,
            "workers": wh,
            "shm_bytes": w * ring if (shm and h == 0) else 0,
            "sock_buf_bytes": workers_and_learner(conn, wh, h),
            "conn_drain_budget_bytes": 0 if shm else conn_drain,
            "coalesce_buf_bytes": workers_and_learner(coal, wh, h),
            "codec_scratch_bytes": workers_and_learner(codec_scratch, wh, h),
        })
    return {
        "workers": w,
        "transport": a.transport,
        "hosts": h_n,
        "shm_segments": (w + 1) if shm else 0,   # rings + param buffer
        "ring_bytes_each": ring if shm else 0,
        "ring_bytes_total": w * ring if shm else 0,
        "fds_per_worker": 5,
        "est_parent_fds": 5 * w + 8,
        "per_host": per_host,
    }
