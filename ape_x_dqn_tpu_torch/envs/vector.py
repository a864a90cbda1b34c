"""Synchronous vectorized env — the actor fleet's batched substrate.

The port's copy of ``ape_x_dqn_tpu/envs/vector.py`` (numpy only, unchanged
in behaviour).

The reference runs one env per actor *process* with batch-1 inference
(reference actor.py:159-165), which can't feed a TPU learner (SURVEY §7 hard
parts #3).  The TPU-native pattern is the inverse: one host thread steps a
*batch* of envs in lockstep so action selection for the whole fleet is a
single jitted forward (batch = num_envs) — MXU-friendly, one device round
trip per fleet step.

Auto-reset semantics: when an env terminates or truncates, ``step`` returns
the *final* observation of the episode in ``obs`` and immediately resets the
env, exposing the fresh observation via ``reset_obs``; callers (the actor
pool) thread ``reset_obs`` in as the next step's input.  Per-env episode
returns/lengths are surfaced on completion for metrics.
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional, Sequence

import numpy as np

from ape_x_dqn_tpu_torch.envs.core import Env


class VectorStep(NamedTuple):
    obs: np.ndarray          # uint8 [N, *obs_shape] — obs produced by the step
    reward: np.ndarray       # float32 [N]
    terminated: np.ndarray   # bool [N]
    truncated: np.ndarray    # bool [N]
    reset_obs: np.ndarray    # uint8 [N, *obs_shape] — == obs unless done, then fresh
    episode_return: np.ndarray  # float32 [N] — NaN unless episode just ended
    episode_length: np.ndarray  # int32 [N] — 0 unless episode just ended


class SyncVectorEnv:
    """Step N protocol envs in lockstep on the calling thread."""

    def __init__(self, env_fns: Sequence[Callable[[], Env]]):
        if not env_fns:
            raise ValueError("need at least one env")
        self.envs: List[Env] = [fn() for fn in env_fns]
        self.num_envs = len(self.envs)
        self.observation_shape = self.envs[0].observation_shape
        self.num_actions = self.envs[0].num_actions
        for e in self.envs:
            if e.observation_shape != self.observation_shape:
                raise ValueError("heterogeneous observation shapes in vector env")
            if e.num_actions != self.num_actions:
                raise ValueError("heterogeneous action spaces in vector env")
        self._ep_return = np.zeros(self.num_envs, np.float64)
        self._ep_length = np.zeros(self.num_envs, np.int64)

    def reset(self, seed: Optional[int] = None) -> np.ndarray:
        obs = []
        for i, e in enumerate(self.envs):
            obs.append(e.reset(None if seed is None else seed + i))
        self._ep_return[:] = 0.0
        self._ep_length[:] = 0
        return np.stack(obs)

    def step(self, actions: np.ndarray) -> VectorStep:
        n = self.num_envs
        obs = np.empty((n, *self.observation_shape), np.uint8)
        reset_obs = obs.copy()
        reward = np.zeros(n, np.float32)
        terminated = np.zeros(n, bool)
        truncated = np.zeros(n, bool)
        ep_ret = np.full(n, np.nan, np.float32)
        ep_len = np.zeros(n, np.int32)
        for i, e in enumerate(self.envs):
            o, r, term, trunc = e.step(int(actions[i]))
            obs[i] = o
            reward[i] = r
            terminated[i] = term
            truncated[i] = trunc
            self._ep_return[i] += r
            self._ep_length[i] += 1
            if term or trunc:
                ep_ret[i] = self._ep_return[i]
                ep_len[i] = self._ep_length[i]
                self._ep_return[i] = 0.0
                self._ep_length[i] = 0
                reset_obs[i] = e.reset()
            else:
                reset_obs[i] = o
        return VectorStep(obs, reward, terminated, truncated, reset_obs, ep_ret, ep_len)
