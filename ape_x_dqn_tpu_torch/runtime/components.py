"""Shared component construction: config → (network, state, replay, fleet).

Port of ``ape_x_dqn_tpu/runtime/components.build_components``: both
runtimes — the single-process driver and the async pipeline — wire the same
objects here.  With ``learner.device_replay=false`` (the default) the
replay is the host ``PrioritizedReplay`` (numpy, native sum-tree), or with
``replay.dedup=true`` the host ``DedupReplay`` (one frame ring, fed by
fleets that emit ``DedupChunk``s); ``replay.hot_frame_budget_bytes > 0``
tiers either's frames over a spill file (``resolve_spill_dir``).  With
``true`` it is ``None`` and the fused learner owns a device ring, the
frame-dedup ring with ``replay.dedup=true`` (``FusedDedupLearner``, fed by
fleets that emit ``DedupChunk``s).  The network, train state and actors
live on ``device`` ("cuda" unless the caller asks for the CPU).  The
low-precision knobs (``learner.param_dtype``, ``second_moment_dtype``,
``target_dtype``) are wired here as the JAX package wires them
(``components.py:233-253``).

``learner.restore_from`` is the resume gate (JAX :314-345, the reference's
``load_saved_state``): the train state and the host replay restore here,
in place, from the newest committed checkpoint (``True``: the config's
``checkpoint_dir``), and ``Components.restored_path`` tells the runtime to
restore the fused learner's ring once it exists.  A missing checkpoint
warns and starts from scratch, as the reference does.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import tempfile
from typing import Callable, List, Optional

import numpy as np
import torch

from ape_x_dqn_tpu_torch.actors.pool import ActorFleet
from ape_x_dqn_tpu_torch.config import ApexConfig
from ape_x_dqn_tpu_torch.envs import make_env
from ape_x_dqn_tpu_torch.learner.train_step import (
    Optimizer,
    build_train_step,
    init_train_state,
    make_optimizer,
)
from ape_x_dqn_tpu_torch.models.dueling import build_network
from ape_x_dqn_tpu_torch.replay.buffer import PrioritizedReplay
from ape_x_dqn_tpu_torch.runtime.single_process import beta_schedule
from ape_x_dqn_tpu_torch.types import TrainState


@dataclasses.dataclass
class Components:
    cfg: ApexConfig
    obs_shape: tuple
    num_actions: int
    network: torch.nn.Module
    optimizer: Optimizer
    state: TrainState
    replay: Optional[PrioritizedReplay]   # or a DedupReplay; None in device-replay mode
    env_fns: List[Callable]
    device: torch.device
    restored_path: Optional[str] = None   # the checkpoint resumed from, if any

    @property
    def learner_step(self) -> int:
        return self.state.step

    def make_train_step(self):
        """The host path's learner step.  It syncs the target inside the step
        at ``q_target_sync_freq`` as given (the fused path rounds it down to
        a multiple of K instead)."""
        return build_train_step(
            self.network,
            self.optimizer,
            loss_kind=self.cfg.learner.loss,
            target_sync_freq=self.cfg.learner.q_target_sync_freq,
        )

    def make_sampler(self, learner_step_fn: Callable[[], int]):
        """Host replay sampler with the β-annealed IS schedule, β read at
        sample time from ``learner_step_fn()``.  The numpy generator is
        seeded as the JAX package's on one host (seed + 7; its multi-host
        salt is 0 there), so the same seed draws the same slots in both
        packages."""
        rng = np.random.default_rng(self.cfg.seed + 7)
        cfg = self.cfg
        size = cfg.learner.replay_sample_size

        def sample():
            beta = beta_schedule(
                learner_step_fn(), cfg.learner.total_steps, cfg.replay.is_exponent
            )
            return self.replay.sample(size, beta=beta, rng=rng)

        return sample

    def make_fused_learner(self):
        """The device-resident fused learner (device ring + K-step loop):
        the frame-dedup ring with ``replay.dedup``, else the double-store."""
        cfg = self.cfg
        # The fused loop syncs targets at call boundaries, exact only when
        # freq % K == 0 — round the freq down to a multiple of K (never
        # below K), as the JAX package does (components.py:134-136).
        K = cfg.learner.steps_per_call
        freq = cfg.learner.q_target_sync_freq
        freq = max(K, freq - freq % K)
        kwargs = dict(
            capacity=cfg.replay.capacity,
            batch_size=cfg.learner.replay_sample_size,
            steps_per_call=K,
            ingest_block=cfg.learner.ingest_block,
            priority_exponent=cfg.replay.priority_exponent,
            target_sync_freq=freq,
            loss_kind=cfg.learner.loss,
            sample_ahead=cfg.learner.sample_ahead,
            device=self.device,
        )
        if cfg.replay.dedup:
            from ape_x_dqn_tpu_torch.runtime.fused_dedup import FusedDedupLearner

            return FusedDedupLearner(self.network, self.optimizer, self.state,
                                     self.obs_shape, frame_ratio=cfg.replay.frame_ratio,
                                     **kwargs)
        from ape_x_dqn_tpu_torch.runtime.fused_learner import FusedDeviceLearner

        return FusedDeviceLearner(self.network, self.optimizer, self.state,
                                  self.obs_shape, **kwargs)

    def make_fleet(self, seed_offset: int = 0) -> ActorFleet:
        """A fresh actor fleet (a respawn after a crash calls this again)."""
        cfg = self.cfg
        return ActorFleet(
            self.env_fns,
            self.network,
            n_step=cfg.actor.num_steps,
            gamma=cfg.actor.gamma,
            epsilon=cfg.actor.epsilon,
            epsilon_alpha=cfg.actor.alpha,
            flush_every=cfg.actor.flush_every,
            sync_every=cfg.actor.sync_every,
            seed=cfg.seed + seed_offset,
            emission=cfg.actor.emission,
            device=self.device,
            emit_dedup=cfg.replay.dedup,
            emit_dedup_groups=dedup_groups(cfg),
        )


def dedup_groups(cfg: ApexConfig) -> int:
    """Independent dedup streams per fleet (JAX ``components.py:183-189``):
    one per ring shard.  The port's ring has one shard (data_parallel is
    1), so one stream per fleet."""
    if cfg.replay.dedup and cfg.learner.device_replay:
        return max(1, cfg.learner.data_parallel)
    return 1


def resolve_spill_dir(cfg: ApexConfig) -> str:
    """Where the cold tier's spill files live (JAX :192-207).  "auto": a
    checkpointed run's ``<checkpoint_dir>/replay_spill`` (incremental bases
    reference cold spans by offset into the same tree), else a per-pid
    directory under the temp dir."""
    d = cfg.replay.spill_dir
    if d != "auto":
        return d
    if cfg.learner.checkpoint_every:
        return os.path.join(cfg.learner.checkpoint_dir, "replay_spill")
    return os.path.join(tempfile.gettempdir(), f"apex-spill-{os.getpid()}")


_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, None: None}


def seeded_network(cfg: ApexConfig, num_actions: int, obs_shape) -> torch.nn.Module:
    """The config's network, initialised from ``cfg.seed`` without touching
    the process-wide generator, its params stored in
    ``learner.param_dtype``.  The learner and every actor worker build it
    here, so their param names, shapes and dtypes agree."""
    kwargs = {}
    if cfg.learner.param_dtype is not None:
        kwargs["param_dtype"] = _DTYPES[cfg.learner.param_dtype]
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(cfg.seed)
        return build_network(cfg.network, num_actions, obs_shape, **kwargs)


def env_kwargs(cfg: ApexConfig) -> dict:
    """The DQN wrapper knobs ``make_env`` passes to fake-atari and Atari
    envs (JAX ``runtime/components.py:212-217``)."""
    e = cfg.env
    return dict(frame_skip=e.frame_skip, frame_stack=e.frame_stack,
                episodic_life=e.episodic_life, clip_rewards=e.clip_rewards)


def build_components(cfg: ApexConfig, device: str | torch.device = "cuda") -> Components:
    cfg.validate()
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but no CUDA device is "
                           "available (pass device='cpu' to run on the CPU)")
    kwargs = env_kwargs(cfg)
    probe = make_env(cfg.env.name, seed=cfg.seed, **kwargs)
    obs_shape = tuple(probe.observation_shape)
    num_actions = probe.num_actions
    if cfg.env.state_shape is not None:
        want = tuple(cfg.env.state_shape)
        # Accept the reference's CHW spelling ([1, 84, 84]) for our HWC layout.
        chw = (obs_shape[-1], *obs_shape[:-1]) if len(obs_shape) == 3 else obs_shape
        if want != obs_shape and want != chw:
            raise ValueError(f"config env.state_shape {want} != actual {obs_shape}")
    if cfg.env.action_dim is not None and cfg.env.action_dim != num_actions:
        raise ValueError(
            f"config env.action_dim {cfg.env.action_dim} != actual {num_actions}"
        )
    network = seeded_network(cfg, num_actions, obs_shape)
    optimizer = make_optimizer(
        cfg.learner.optimizer,
        learning_rate=cfg.learner.learning_rate,
        max_grad_norm=cfg.learner.max_grad_norm,
        second_moment_dtype=_DTYPES[cfg.learner.second_moment_dtype],
        # bfloat16 params need float32 update accumulation.
        float32_master=cfg.learner.param_dtype == "bfloat16",
    )
    state = init_train_state(network, optimizer, seed=cfg.seed, device=device,
                             target_dtype=_DTYPES[cfg.learner.target_dtype])
    # Tiered frame store (replay/tiered.py): a positive hot budget caps the
    # host replay's resident frame bytes (JAX :254-311).
    tier_kwargs = {}
    if cfg.replay.hot_frame_budget_bytes > 0:
        tier_kwargs = dict(
            hot_frame_budget_bytes=cfg.replay.hot_frame_budget_bytes,
            spill_dir=resolve_spill_dir(cfg),
            spill_span_frames=cfg.replay.spill_span_frames,
            spill_watermark_high=cfg.replay.spill_watermark_high,
            spill_watermark_low=cfg.replay.spill_watermark_low,
        )
    if cfg.learner.device_replay:
        # The fused learner keeps the ring on the device; a host replay here
        # would be ~capacity × 2 frames of dead host memory.
        replay = None
    elif cfg.replay.service_mode == "attach":
        # Replay as a service (replay/service.py; JAX :270-296): a retrying
        # RPC client over the shard fleet named by the endpoints file, with
        # the host replay's add / sample / update_priorities surface; the
        # learner survives a shard dying.
        from ape_x_dqn_tpu_torch.replay.service import ShardedReplayClient

        replay = ShardedReplayClient.from_endpoints_file(
            cfg.replay.service_endpoints,
            codec=cfg.replay.service_codec,
            dedup=cfg.replay.service_dedup,
            # Cross-tier tracing follows the lineage sample rate: a traced
            # chunk's add / sample / write-back RPCs carry its id.
            trace=cfg.obs.trace_sample_rate > 0,
            request_timeout_s=cfg.replay.service_request_timeout_s,
            probe_interval_s=cfg.replay.service_probe_interval_s,
            seed=cfg.seed,
        )
        if replay.capacity != cfg.replay.capacity:
            replay.close()
            raise ValueError(
                f"replay.capacity {cfg.replay.capacity} != the service "
                f"fleet's total {replay.capacity} "
                f"({cfg.replay.service_endpoints}) — the slot-index "
                "arithmetic (lineage, priority routing) must agree"
            )
    elif cfg.replay.dedup:
        from ape_x_dqn_tpu_torch.replay.dedup import DedupReplay

        replay = DedupReplay(
            cfg.replay.capacity, obs_shape,
            priority_exponent=cfg.replay.priority_exponent,
            frame_ratio=cfg.replay.frame_ratio,
            **tier_kwargs,
        )
    else:
        replay = PrioritizedReplay(
            cfg.replay.capacity, obs_shape,
            priority_exponent=cfg.replay.priority_exponent,
            frame_compression=cfg.replay.frame_compression,
            **tier_kwargs,
        )
    restored_path = _restore(cfg, state, replay)
    env_fns = [
        (lambda i=i: make_env(cfg.env.name, seed=cfg.seed + 1000 + i, **kwargs))
        for i in range(cfg.actor.num_actors)
    ]
    return Components(
        cfg=cfg, obs_shape=obs_shape, num_actions=num_actions,
        network=network, optimizer=optimizer, state=state, replay=replay,
        env_fns=env_fns, device=device, restored_path=restored_path,
    )


def _restore(cfg: ApexConfig, state: TrainState, replay) -> Optional[str]:
    """The resume gate: the path restored from, or None."""
    if not cfg.learner.restore_from:
        return None
    from ape_x_dqn_tpu_torch.utils.checkpoint import restore_checkpoint

    path = (cfg.learner.checkpoint_dir if cfg.learner.restore_from is True
            else str(cfg.learner.restore_from))
    try:
        # A service-attached replay: the shards own their chains, so only
        # the train-state leg restores here.
        _, step = restore_checkpoint(
            path, state, replay=None if getattr(replay, "remote", False) else replay)
    except FileNotFoundError:
        print(f"WARNING: no checkpoint at {path}; starting from scratch", file=sys.stderr)
        return None
    print(f"restored checkpoint at step {step}", file=sys.stderr)
    return path
