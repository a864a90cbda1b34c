"""Single-process deterministic driver — the host-replay golden path.

Port of ``ape_x_dqn_tpu/runtime/single_process.py``.  One Python thread: the
actor fleet, the host replay and the learner are stepped round-robin with
seeded generators, so a run is reproducible and race-free — the path the
async runtime is checked against, and the smallest thing a user can run:
``SingleProcessDriver(cfg).run()``.

Per iteration: ``actor.flush_every`` fleet steps go into the replay; then,
once it holds ``min_replay_mem_size`` transitions, ``learner_steps_per_iter``
learner steps, each one sample on the host → explicit copy of the batch to
``device`` → train step → ``update_priorities`` with the host indices and
the priorities read back to the host; params are published to the fleet
every ``publish_every`` steps, and every ``learner.checkpoint_every`` steps
the train state and the replay are saved (JAX :95-115).  A driver built
with ``learner.restore_from`` resumes at the restored step.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ape_x_dqn_tpu_torch.actors.pool import EpisodeStat, LocalParamSource
from ape_x_dqn_tpu_torch.runtime.infeed import batch_to_device


class IterationResult(NamedTuple):
    learner_step: int
    actor_steps: int
    replay_size: int
    loss: float
    mean_q: float
    episodes: List[EpisodeStat]


def beta_schedule(step: int, total_steps: int, beta0: float) -> float:
    """Anneal the IS exponent β from β₀ to 1 over training (standard PER)."""
    frac = min(1.0, step / max(1, total_steps))
    return beta0 + (1.0 - beta0) * frac


class SingleProcessDriver:
    def __init__(self, cfg, learner_steps_per_iter: int = 1,
                 device: str | torch.device = "cuda"):
        from ape_x_dqn_tpu_torch.runtime.components import build_components

        comps = build_components(cfg, device=device)
        if comps.replay is None:
            raise ValueError(
                "the single-process driver is the host-replay golden path; "
                "learner.device_replay=true runs via the async pipeline"
            )
        self.cfg = comps.cfg
        self.comps = comps
        self.device = comps.device
        self.learner_steps_per_iter = learner_steps_per_iter
        self.obs_shape = comps.obs_shape
        self.num_actions = comps.num_actions
        self.network = comps.network
        self.state = comps.state
        self.replay = comps.replay
        self._learner_step = comps.learner_step
        self.train_step = comps.make_train_step()
        self._sample = comps.make_sampler(lambda: self._learner_step)
        self.fleet = comps.make_fleet()
        self.param_source = LocalParamSource(self.state.params)
        self.fleet.sync_params(self.param_source)
        self.total_actor_steps = 0

    @property
    def learner_step(self) -> int:
        return self._learner_step

    def learn_step(self) -> Tuple[object, object]:
        """One learner step: sample, place, train, write back, publish at the
        cadence.  Returns the host batch and the step's metrics."""
        host_batch = self._sample()
        self.state, metrics = self.train_step(
            self.state, batch_to_device(host_batch, self.device)
        )
        self._learner_step += 1
        self.replay.update_priorities(
            np.asarray(host_batch.indices), metrics.priorities.cpu().numpy()
        )
        if self._learner_step % self.cfg.learner.publish_every == 0:
            self.param_source.publish(self.state.params)
        every = self.cfg.learner.checkpoint_every
        if every and self._learner_step % every == 0:
            from ape_x_dqn_tpu_torch.utils.checkpoint import save_checkpoint

            # A service-attached replay: the shards own their chains.
            replay = None if getattr(self.replay, "remote", False) else self.replay
            save_checkpoint(self.cfg.learner.checkpoint_dir, self.state, replay=replay)
        return host_batch, metrics

    def run_iteration(self) -> IterationResult:
        cfg = self.cfg
        chunks, episodes = self.fleet.collect(
            cfg.actor.flush_every, param_source=self.param_source
        )
        for chunk in chunks:
            self.replay.add(chunk.priorities, chunk.transitions)
            self.total_actor_steps += chunk.actor_steps
        loss = mean_q = float("nan")
        if self.replay.size() >= cfg.learner.min_replay_mem_size:
            for _ in range(self.learner_steps_per_iter):
                _, metrics = self.learn_step()
                loss = float(metrics.loss)
                mean_q = float(metrics.mean_q)
        return IterationResult(
            learner_step=self.learner_step,
            actor_steps=self.total_actor_steps,
            replay_size=self.replay.size(),
            loss=loss,
            mean_q=mean_q,
            episodes=episodes,
        )

    def run(
        self,
        learner_steps: Optional[int] = None,
        max_iterations: Optional[int] = None,
    ) -> List[IterationResult]:
        """Run until ``learner_steps`` learner updates (default: config
        total_steps), until each actor has taken ``actor.T`` env steps, or
        until ``max_iterations`` — whichever comes first."""
        target = learner_steps if learner_steps is not None else self.cfg.learner.total_steps
        results = []
        it = 0
        while (
            self.learner_step < target
            and self.fleet.step_count < self.cfg.actor.T
        ):
            results.append(self.run_iteration())
            it += 1
            if max_iterations is not None and it >= max_iterations:
                break
        return results

    @torch.no_grad()
    def greedy_q_values(self, obs_batch: np.ndarray) -> np.ndarray:
        """Online-net Q values for evaluation (host convenience)."""
        obs = torch.as_tensor(np.asarray(obs_batch)).to(self.device)
        return self.network.apply_params(self.state.params, obs).q.cpu().numpy()
