"""Environment protocol + synthetic envs.

The port's copy of ``ape_x_dqn_tpu/envs/core.py`` (numpy only, unchanged
in behaviour).

The reference's env layer is a bare ``gym.make`` passthrough (reference
env.py:3-4) with broken preprocessing living in the actor (``np.resize`` is
byte-repetition, not rescaling — reference actor.py:117-119, SURVEY §2.8).
Here the env boundary is a minimal framework-native protocol so every
consumer (actors, tests, benches) is independent of gym's API churn, and the
synthetic envs below make the whole training stack testable with zero
external dependencies (SURVEY §4 levels 2-3).

Termination vs. truncation is explicit: a *terminated* step zeroes the
bootstrap discount; a *truncated* one (time limit) ends the episode but keeps
the bootstrap — a correctness distinction the reference collapses (it stores
no terminal signal at all).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Protocol, runtime_checkable

import numpy as np


class StepResult(NamedTuple):
    obs: np.ndarray       # uint8, NHWC-compatible (H, W, C) or flat (D,)
    reward: float
    terminated: bool      # MDP terminal — bootstrap discount must be 0
    truncated: bool       # time limit — episode ends, bootstrap survives


@runtime_checkable
class Env(Protocol):
    """The framework-native env interface."""

    observation_shape: tuple
    num_actions: int

    def reset(self, seed: Optional[int] = None) -> np.ndarray: ...

    def step(self, action: int) -> StepResult: ...


class ChainMDP:
    """N-state deterministic chain — the seconds-scale learning test env
    (SURVEY §4 level 3: "tiny MDP trained to optimal Q in seconds").

    States 0..n−1 on a line; action 1 moves right, action 0 moves left
    (clamped at 0).  Reaching state n−1 pays +1 and terminates; every other
    step pays ``step_reward``.  Optimal return from the start under γ is
    γ^(n−2), which tests can compute in closed form.

    Observation: one-hot uint8 row scaled to 255 (so the standard /255
    normalization recovers a clean one-hot float).
    """

    def __init__(self, n_states: int = 10, step_reward: float = 0.0,
                 time_limit: int = 100):
        if n_states < 2:
            raise ValueError("need at least 2 states")
        self.n_states = n_states
        self.step_reward = step_reward
        self.time_limit = time_limit
        self.observation_shape = (n_states,)
        self.num_actions = 2
        self._state = 0
        self._t = 0

    def _obs(self) -> np.ndarray:
        o = np.zeros(self.n_states, np.uint8)
        o[self._state] = 255
        return o

    def reset(self, seed: Optional[int] = None) -> np.ndarray:
        self._state = 0
        self._t = 0
        return self._obs()

    def step(self, action: int) -> StepResult:
        self._t += 1
        if action == 1:
            self._state += 1
        else:
            self._state = max(0, self._state - 1)
        if self._state == self.n_states - 1:
            return StepResult(self._obs(), 1.0, True, False)
        truncated = self._t >= self.time_limit
        return StepResult(self._obs(), self.step_reward, False, truncated)


class CatchEnv:
    """bsuite-style Catch: a ball falls down a (rows × cols) board; move the
    paddle to catch it.  Pixel observations, conv- or MLP-friendly; the
    standard small-scale pixel-control learning test.
    """

    def __init__(self, rows: int = 10, cols: int = 5, seed: int = 0):
        self.rows, self.cols = rows, cols
        self.observation_shape = (rows, cols, 1)
        self.num_actions = 3  # left, stay, right
        self._rng = np.random.default_rng(seed)
        self._ball_row = 0
        self._ball_col = 0
        self._paddle = 0

    def _obs(self) -> np.ndarray:
        o = np.zeros((self.rows, self.cols, 1), np.uint8)
        o[self._ball_row, self._ball_col, 0] = 255
        o[self.rows - 1, self._paddle, 0] = 255
        return o

    def reset(self, seed: Optional[int] = None) -> np.ndarray:
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._ball_row = 0
        self._ball_col = int(self._rng.integers(0, self.cols))
        self._paddle = self.cols // 2
        return self._obs()

    def step(self, action: int) -> StepResult:
        self._paddle = int(np.clip(self._paddle + (action - 1), 0, self.cols - 1))
        self._ball_row += 1
        if self._ball_row == self.rows - 1:
            reward = 1.0 if self._ball_col == self._paddle else -1.0
            return StepResult(self._obs(), reward, True, False)
        return StepResult(self._obs(), 0.0, False, False)


class PixelUpscale:
    """Integer-upscale (nearest-neighbor) + zero-pad a pixel env to a fixed
    (height, width) — e.g. Catch's 10×5 board to the conv net's 84×84.

    Keeps the game's state space tiny while exercising the REAL conv
    model/replay/learner shapes — the conv-scale learning workload this
    image supports without ALE (used by the ``catch:84`` factory spec and
    the hour-scale learning soak, tools/longrun.py).
    """

    def __init__(self, env: Env, height: int = 84, width: int = 84):
        r, c, ch = env.observation_shape
        if height < r or width < c:
            raise ValueError("target size smaller than source observation")
        self._env = env
        self._fy, self._fx = height // r, width // c
        py, px = height - r * self._fy, width - c * self._fx
        self._pad = ((py // 2, py - py // 2), (px // 2, px - px // 2), (0, 0))
        self.observation_shape = (height, width, ch)
        self.num_actions = env.num_actions

    def _up(self, obs: np.ndarray) -> np.ndarray:
        out = obs.repeat(self._fy, axis=0).repeat(self._fx, axis=1)
        return np.pad(out, self._pad)

    def reset(self, seed: Optional[int] = None) -> np.ndarray:
        return self._up(self._env.reset(seed))

    def step(self, action: int) -> StepResult:
        r = self._env.step(action)
        return r._replace(obs=self._up(r.obs))


class LoopEnv:
    """Single-state env paying +1 per step, ending only by time-limit
    truncation — the sharpest probe of truncation bootstrapping.

    The true value under "bootstrap survives truncation" (envs/core.py
    contract) is the infinite-horizon fixed point V = 1/(1−γ); collapsing
    truncation into termination instead drives Q toward the average
    *remaining-horizon* return E[(1−γ^(T−t))/(1−γ)], far below it.  A test
    can therefore assert the unbiased fixed point to detect the collapse.
    """

    def __init__(self, time_limit: int = 10):
        self.time_limit = int(time_limit)
        self.observation_shape = (4,)
        self.num_actions = 2
        self._t = 0

    def _obs(self) -> np.ndarray:
        return np.full(4, 255, np.uint8)

    def reset(self, seed: Optional[int] = None) -> np.ndarray:
        self._t = 0
        return self._obs()

    def step(self, action: int) -> StepResult:
        self._t += 1
        return StepResult(self._obs(), 1.0, False, self._t >= self.time_limit)


class RandomFrameEnv:
    """Throughput/bench env: random uint8 frames, fixed-length episodes, no
    dynamics.  Stands in for Atari when ALE isn't installed (this image), so
    pipeline benches measure the framework, not the emulator."""

    def __init__(self, obs_shape=(84, 84, 1), num_actions: int = 4,
                 episode_len: int = 1000, seed: int = 0):
        self.observation_shape = tuple(obs_shape)
        self.num_actions = num_actions
        self.episode_len = episode_len
        self._rng = np.random.default_rng(seed)
        self._t = 0

    def _obs(self) -> np.ndarray:
        return self._rng.integers(0, 256, self.observation_shape, dtype=np.uint8)

    def reset(self, seed: Optional[int] = None) -> np.ndarray:
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._t = 0
        return self._obs()

    def step(self, action: int) -> StepResult:
        self._t += 1
        done = self._t >= self.episode_len
        return StepResult(self._obs(), float(self._rng.normal()), done, False)
