"""Shared component construction: config → (network, state, learner, fleet).

Port of the ``learner.device_replay=true`` subset of
``ape_x_dqn_tpu/runtime/components.build_components``.  Every component
lives on ``device`` ("cuda" unless the caller asks for the CPU).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List

import torch

from ape_x_dqn_tpu_torch.actors.pool import ActorFleet
from ape_x_dqn_tpu_torch.config import ApexConfig
from ape_x_dqn_tpu_torch.envs import make_env
from ape_x_dqn_tpu_torch.learner.train_step import (
    Optimizer,
    init_train_state,
    make_optimizer,
)
from ape_x_dqn_tpu_torch.models.dueling import build_network
from ape_x_dqn_tpu_torch.types import TrainState


@dataclasses.dataclass
class Components:
    cfg: ApexConfig
    obs_shape: tuple
    num_actions: int
    network: torch.nn.Module
    optimizer: Optimizer
    state: TrainState
    env_fns: List[Callable]
    device: torch.device

    def make_fused_learner(self):
        """The device-resident fused learner (device ring + K-step loop)."""
        from ape_x_dqn_tpu_torch.runtime.fused_learner import FusedDeviceLearner

        cfg = self.cfg
        # The fused loop syncs targets at call boundaries, exact only when
        # freq % K == 0 — round the freq down to a multiple of K (never
        # below K), as the JAX package does (components.py:134-136).
        K = cfg.learner.steps_per_call
        freq = cfg.learner.q_target_sync_freq
        freq = max(K, freq - freq % K)
        return FusedDeviceLearner(
            self.network, self.optimizer, self.state, self.obs_shape,
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
        )


def build_components(cfg: ApexConfig, device: str | torch.device = "cuda") -> Components:
    cfg.validate()
    if not cfg.learner.device_replay:
        raise ValueError(
            "the port runs the device-replay learner only so far; the "
            "host-replay path is not ported yet — set learner.device_replay=true"
        )
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but no CUDA device is "
                           "available (pass device='cpu' to run on the CPU)")
    probe = make_env(cfg.env.name, seed=cfg.seed)
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
    # Seeded init without touching the process-wide generator.
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(cfg.seed)
        network = build_network(cfg.network, num_actions, obs_shape)
    optimizer = make_optimizer(
        cfg.learner.optimizer,
        learning_rate=cfg.learner.learning_rate,
        max_grad_norm=cfg.learner.max_grad_norm,
    )
    state = init_train_state(network, optimizer, seed=cfg.seed, device=device)
    env_fns = [
        (lambda i=i: make_env(cfg.env.name, seed=cfg.seed + 1000 + i))
        for i in range(cfg.actor.num_actors)
    ]
    return Components(
        cfg=cfg, obs_shape=obs_shape, num_actions=num_actions,
        network=network, optimizer=optimizer, state=state,
        env_fns=env_fns, device=device,
    )
