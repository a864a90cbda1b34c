"""The actor fleet: batched rollouts, ε-ladder, n-step emission, priorities.

Port of ``ape_x_dqn_tpu/actors/pool.py`` (dense emission, overlapping and
strided; the frame-dedup wire format and central inference are not part of
the port yet):
  * N actor envs step in lockstep (``SyncVectorEnv``); action selection for
    the whole fleet is one batched forward + ε-greedy on the device.
  * Actor i uses ε^(1+α·i/(N−1)) (reference actor.py:111-114).
  * A host history ring of the last ``flush_every + n`` steps feeds
    sliding-window n-step emission every ``flush_every`` steps, with
    initial priorities |R + D·max_a Q(S_{t+n}) − Q(S_t)[A_t]| computed from
    the Q-values already taken during action selection.
  * Terminal masking folds into the per-step discount γ·(1−done); a window
    that meets a truncation re-targets ``next_obs`` to the episode's final
    observation with discount γ^(k+1), so the learner bootstraps there.

Parameter sync polls a ``ParamSource`` (``get(version) -> (params,
version) | None``) every ``sync_every`` fleet steps.  Published params are
host copies (the learner updates its tensors in place); the fleet uploads
them to its device once per adopted version.
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple, Sequence

import numpy as np
import torch

from ape_x_dqn_tpu_torch.envs.vector import SyncVectorEnv
from ape_x_dqn_tpu_torch.ops.exploration import epsilon_greedy, epsilon_ladder
from ape_x_dqn_tpu_torch.ops.nstep import nstep_returns_np
from ape_x_dqn_tpu_torch.types import NStepTransition


class Chunk(NamedTuple):
    """One flush: transitions + actor-computed initial priorities."""

    priorities: np.ndarray        # float32 [M]
    transitions: NStepTransition  # numpy, batch M
    actor_steps: int              # fleet env steps this chunk covers


class EpisodeStat(NamedTuple):
    actor_id: int
    episode_return: float
    episode_length: int


def host_params(params) -> dict:
    """Host (CPU) copies of a parameter dict — never views of live tensors,
    which the learner updates in place."""
    return {k: v.detach().to("cpu", copy=True) for k, v in params.items()}


def build_policy_step(network, seed: int = 0,
                      device: str | torch.device = "cuda") -> Callable:
    """Fleet policy: forward + ε-greedy in one call.

    Returns ``(params, obs, epsilons) -> (actions, q_values)`` as numpy;
    exploration draws come from a generator on ``device`` seeded with
    ``seed``, so distinct seeds give independent streams."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    @torch.no_grad()
    def policy_step(params, obs, epsilons):
        x = torch.as_tensor(obs).to(device)
        q = network.apply_params(params, x).q
        actions = epsilon_greedy(q, epsilons, generator=gen)
        return actions.cpu().numpy(), q.cpu().numpy()

    return policy_step


class ActorFleet:
    """N lockstep actors producing prioritized n-step chunks."""

    def __init__(
        self,
        env_fns: Sequence[Callable],
        network,
        n_step: int = 3,
        gamma: float = 0.99,
        epsilon: float = 0.4,
        epsilon_alpha: float = 7.0,
        flush_every: int = 16,
        sync_every: int = 500,
        seed: int = 0,
        emission: str = "overlapping",
        device: str | torch.device = "cuda",
    ):
        self.envs = SyncVectorEnv(env_fns)
        self.network = network
        self.device = torch.device(device)
        self.n_step = int(n_step)
        self.gamma = float(gamma)
        self.flush_every = int(flush_every)
        self.sync_every = int(sync_every)
        if emission not in ("overlapping", "strided"):
            raise ValueError(f"unknown emission mode: {emission}")
        self.stride = self.n_step if emission == "strided" else 1
        if self.flush_every < self.stride:
            raise ValueError(
                "strided emission needs flush_every >= num_steps (a flush "
                "window shorter than the stride can contain no aligned start)"
            )
        N = self.envs.num_envs
        self._epsilons = epsilon_ladder(epsilon, epsilon_alpha, N).to(self.device)
        self._policy_step = build_policy_step(network, seed=seed, device=self.device)
        self._obs = self.envs.reset(seed=seed)
        # History ring: H = flush_every + n rows; global step s lives at
        # slot s % H (rotating cursor, no per-step shift of the obs history).
        H = self.flush_every + self.n_step
        obs_shape = self.envs.observation_shape
        self._H = H
        self._hist_obs = np.zeros((H, N, *obs_shape), np.uint8)
        self._hist_action = np.zeros((H, N), np.int32)
        self._hist_reward = np.zeros((H, N), np.float32)
        self._hist_discount = np.zeros((H, N), np.float32)
        self._hist_qmax = np.zeros((H, N), np.float32)
        self._hist_qtaken = np.zeros((H, N), np.float32)
        # Final observation of a time-limited episode (valid where _hist_trunc).
        self._hist_trunc = np.zeros((H, N), bool)
        self._hist_trunc_obs = np.zeros((H, N, *obs_shape), np.uint8)
        self._rows = 0          # valid rows in history (grows to H, then stays)
        self._step_count = 0    # total fleet steps
        self.params = None
        self.param_version = -1

    @property
    def num_actors(self) -> int:
        return self.envs.num_envs

    @property
    def step_count(self) -> int:
        """Total fleet steps taken (== per-actor env steps, lockstep)."""
        return self._step_count

    def sync_params(self, source) -> bool:
        """Poll the param source; upload and adopt newer params.  Returns
        True if new params were adopted."""
        got = source.get(self.param_version)
        if got is None:
            return False
        params, self.param_version = got
        self.params = {k: v.to(self.device) for k, v in params.items()}
        return True

    def _roll_in(self, obs, action, reward, discount, qmax, qtaken,
                 trunc, final_obs):
        """Write one fleet step at the rotating cursor slot s % H."""
        slot = self._step_count % self._H
        self._hist_obs[slot] = obs
        self._hist_action[slot] = action
        self._hist_reward[slot] = reward
        self._hist_discount[slot] = discount
        self._hist_qmax[slot] = qmax
        self._hist_qtaken[slot] = qtaken
        self._hist_trunc[slot] = trunc
        if trunc.any():
            self._hist_trunc_obs[slot][trunc] = final_obs[trunc]
        self._rows = min(self._rows + 1, self._H)

    def _flush(self) -> Chunk:
        """Emit n-step transitions per actor from the full history ring:
        window starts 0..F-1 of the flush frame (overlapping) or its
        globally n-aligned subset (strided).  The oldest row (global step
        ``_step_count − H``) lives at slot ``_step_count % H``."""
        n, F, N = self.n_step, self.flush_every, self.num_actors
        order = (np.arange(self._H) + self._step_count) % self._H
        starts = np.arange(F)
        if self.stride > 1:
            s0 = self._step_count - self._H
            starts = starts[(s0 + starts) % self.stride == 0]
        S = len(starts)
        rewards = self._hist_reward[order[: F + n - 1]]
        discounts = self._hist_discount[order[: F + n - 1]]
        returns, boot = nstep_returns_np(rewards, discounts, n)  # [F, N]
        returns, boot = returns[starts], boot[starts]            # [S, N]
        next_idx = order[starts + n]
        qtaken = self._hist_qtaken[order[starts]]
        boot_qmax = self._hist_qmax[next_idx]
        truncs = self._hist_trunc[order[: F + n - 1]]
        # trunc_k[j, a] = offset k of the truncation that re-targets window
        # (starts[j], a)'s next_obs (−1: none).
        trunc_k = np.full((S, N), -1, np.int64)
        if truncs.any():
            # A window whose FIRST done is a truncation at offset k bootstraps
            # from the episode's final observation with discount γ^(k+1);
            # its priority uses Q(S_{t+k}) as the bootstrap proxy.
            qmax_seq = self._hist_qmax[order[: F + n - 1]]
            alive = np.ones(boot.shape, bool)
            for k in range(n):
                m = alive & truncs[starts + k]
                if m.any():
                    boot[m] = self.gamma ** (k + 1)
                    trunc_k[m] = k
                    boot_qmax[m] = qmax_seq[starts + k][m]
                alive &= discounts[starts + k] != 0.0
        td = returns + boot * boot_qmax - qtaken
        priorities = np.abs(td).astype(np.float32)          # [S, N]
        obs = self._hist_obs[order[starts]]                 # [S, N, *obs]
        next_obs = self._hist_obs[next_idx]                 # [S, N, *obs]
        for k in range(n):
            m = trunc_k == k
            if m.any():
                next_obs[m] = self._hist_trunc_obs[order[starts + k]][m]
        transitions = NStepTransition(
            obs=obs.reshape(S * N, *obs.shape[2:]),
            action=self._hist_action[order[starts]].reshape(-1),
            reward=returns.astype(np.float32).reshape(-1),
            discount=boot.astype(np.float32).reshape(-1),
            next_obs=next_obs.reshape(S * N, *next_obs.shape[2:]),
        )
        return Chunk(priorities.reshape(-1), transitions, F * N)

    def collect(self, num_steps: int, param_source=None):
        """Run ``num_steps`` fleet steps; return (chunks, episode stats)."""
        if self.params is None:
            if param_source is None or not self.sync_params(param_source):
                raise RuntimeError(
                    "ActorFleet has no params — call sync_params or pass param_source"
                )
        chunks: List[Chunk] = []
        stats: List[EpisodeStat] = []
        for _ in range(num_steps):
            actions, q = self._policy_step(self.params, self._obs, self._epsilons)
            vs = self.envs.step(actions)
            done = vs.terminated | vs.truncated
            discount = (self.gamma * (1.0 - done)).astype(np.float32)
            trunc = vs.truncated & ~vs.terminated
            self._roll_in(
                self._obs,
                actions,
                vs.reward,
                discount,
                q.max(axis=-1),
                np.take_along_axis(q, actions[:, None].astype(np.int64), axis=-1)[:, 0],
                trunc=trunc,
                final_obs=vs.obs,
            )
            self._obs = vs.reset_obs
            self._step_count += 1
            for i in np.nonzero(~np.isnan(vs.episode_return))[0]:
                stats.append(EpisodeStat(int(i), float(vs.episode_return[i]),
                                         int(vs.episode_length[i])))
            # Flush on ring-fill, then every flush_every steps after, so
            # every global step is a window start exactly once.
            if (
                self._rows == self._H
                and (self._step_count - self._H) % self.flush_every == 0
            ):
                chunks.append(self._flush())
            if param_source is not None and self._step_count % self.sync_every == 0:
                self.sync_params(param_source)
        return chunks, stats


class LocalParamSource:
    """In-process param source: keeps host copies of published params."""

    def __init__(self, params=None):
        self._params = host_params(params) if params is not None else None
        self._version = 0 if params is not None else -1

    def publish(self, params):
        self._params = host_params(params)
        self._version += 1

    def get(self, current_version: int):
        if self._params is None or self._version <= current_version:
            return None
        return self._params, self._version
