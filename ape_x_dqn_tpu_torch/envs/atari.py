"""Gymnasium adapter + the DQN Atari preprocessing stack.

The port's copy of ``ape_x_dqn_tpu/envs/atari.py``: the same classes, the
same wrapper order, numpy only.  The JAX package preprocesses with cv2
(``cvtColor(COLOR_RGB2GRAY)`` then ``resize(INTER_AREA)``); the port has
no cv2 and reproduces both byte for byte in numpy:

  * **grayscale** is cv2's fixed-point luminance for uint8,
    ``(9798·R + 19235·G + 3735·B + 2¹⁴) >> 15`` (0.299 / 0.587 / 0.114 in
    15-bit fixed point, rounded);
  * **area resize** follows cv2's ``resizeArea``: per axis a table of
    (source index, float32 weight) taps per output pixel, the row taps
    summed in float32 in source order, then the column taps, then round
    half to even and saturate.  A float64 matrix product gives the same
    bytes except where the float32 sum sits on a .5 tie; the taps keep cv2's
    order, so they match on those too.  Integer scales take cv2's block-sum
    path instead (2×2 rounds half up there).

``gymnasium`` is imported only when a gym env is built (``gym:`` ids and
real Atari ids); without it those raise ``ModuleNotFoundError``, as in the
JAX package.  Every wrapper works over any protocol Env, so the stack runs
over the fake emulator (``envs/fake_atari.py``) with nothing installed.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np

from ape_x_dqn_tpu_torch.envs.core import Env, StepResult


class GymnasiumEnv:
    """Adapt a gymnasium env (5-tuple step API) to the framework protocol."""

    def __init__(self, env):
        self._env = env
        self.num_actions = int(env.action_space.n)
        self.observation_shape = tuple(env.observation_space.shape)

    def reset(self, seed: Optional[int] = None) -> np.ndarray:
        obs, _info = self._env.reset(seed=seed)
        return np.asarray(obs)

    def step(self, action: int) -> StepResult:
        obs, reward, terminated, truncated, _info = self._env.step(action)
        return StepResult(np.asarray(obs), float(reward), bool(terminated), bool(truncated))

    @property
    def unwrapped(self):
        return self._env


def make_local_env(env_name: str) -> GymnasiumEnv:
    """``gym.make`` passthrough (reference env.py:3-4)."""
    import gymnasium

    return GymnasiumEnv(gymnasium.make(env_name))


class QuantizeObs:
    """Affinely map a bounded float observation box to uint8:
    ``round(255 * (obs - low) / (high - low))``, clipped; infinite box
    bounds (CartPole's velocities) clamp to ``inf_bound``."""

    def __init__(self, env: Env, low=None, high=None, inf_bound: float = 10.0):
        self._env = env
        self.num_actions = env.num_actions
        shape = tuple(env.observation_shape)
        self.observation_shape = shape
        if low is None or high is None:
            space = getattr(getattr(env, "unwrapped", env), "observation_space", None)
            if space is None or not hasattr(space, "low"):
                raise ValueError(
                    "QuantizeObs needs explicit low/high bounds when the env "
                    "has no Box observation_space"
                )
            low = np.asarray(space.low, np.float64) if low is None else low
            high = np.asarray(space.high, np.float64) if high is None else high
        low = np.broadcast_to(np.asarray(low, np.float64), shape).copy()
        high = np.broadcast_to(np.asarray(high, np.float64), shape).copy()
        low[~np.isfinite(low)] = -float(inf_bound)
        high[~np.isfinite(high)] = float(inf_bound)
        if np.any(high <= low):
            raise ValueError("QuantizeObs requires high > low per dimension")
        self._low, self._scale = low, 255.0 / (high - low)

    def _q(self, obs: np.ndarray) -> np.ndarray:
        x = (np.asarray(obs, np.float64) - self._low) * self._scale
        return np.clip(np.round(x), 0, 255).astype(np.uint8)

    def reset(self, seed: Optional[int] = None) -> np.ndarray:
        return self._q(self._env.reset(seed))

    def step(self, action: int) -> StepResult:
        r = self._env.step(action)
        return r._replace(obs=self._q(r.obs))

    @property
    def unwrapped(self):
        return getattr(self._env, "unwrapped", self._env)


def make_gym_env(env_name: str, inf_bound: float = 10.0) -> Env:
    """A real gymnasium env ('CartPole-v1', ...), quantized to uint8."""
    return QuantizeObs(make_local_env(env_name), inf_bound=inf_bound)


def rgb_to_gray(rgb: np.ndarray) -> np.ndarray:
    """cv2's ``COLOR_RGB2GRAY`` on uint8 ``[..., 3]``, byte for byte."""
    rgb = np.asarray(rgb)
    r, g, b = (rgb[..., i].astype(np.uint32) for i in range(3))
    return ((9798 * r + 19235 * g + 3735 * b + (1 << 14)) >> 15).astype(np.uint8)


def _area_taps(src: int, dst: int) -> tuple:
    """cv2's ``computeResizeAreaTab`` for one axis (scale = src / dst ≥ 1):
    ``(index, weight)``, each ``[dst, taps]``, in cv2's tap order; unused
    taps have weight 0 (adding 0.0 leaves a float32 sum unchanged)."""
    scale = src / dst
    rows = []
    for d in range(dst):
        f1 = d * scale
        f2 = f1 + scale
        cell = min(scale, src - f1)
        s1, s2 = math.ceil(f1), math.floor(f2)
        s2 = min(s2, src - 1)
        s1 = min(s1, s2)
        taps = []
        if s1 - f1 > 1e-3:
            taps.append((s1 - 1, (s1 - f1) / cell))
        taps += [(s, 1.0 / cell) for s in range(s1, s2)]
        if f2 - s2 > 1e-3:
            taps.append((s2, min(f2 - s2, 1.0, cell) / cell))
        rows.append(taps)
    width = max(len(t) for t in rows)
    index = np.zeros((dst, width), np.int64)
    weight = np.zeros((dst, width), np.float32)
    for d, taps in enumerate(rows):
        for k, (s, w) in enumerate(taps):
            index[d, k], weight[d, k] = s, np.float32(w)
    return index, weight


_TAPS: dict = {}


def resize_area(img: np.ndarray, height: int, width: int) -> np.ndarray:
    """cv2's ``resize(INTER_AREA)`` of a uint8 ``[H, W]`` image shrunk to
    ``(height, width)``, byte for byte."""
    h, w = img.shape[:2]
    if h < height or w < width:
        raise ValueError(f"resize_area shrinks only: {(h, w)} -> {(height, width)}")
    if h % height == 0 and w % width == 0:
        # cv2's integer-scale path: block sums, 2×2 rounded half up (its
        # SIMD spelling), any other block times float32(1/area).
        sy, sx = h // height, w // width
        block = np.asarray(img, np.int32).reshape(height, sy, width, sx).sum(axis=(1, 3))
        if (sy, sx) == (2, 2):
            return ((block + 2) >> 2).astype(np.uint8)
        out = block.astype(np.float32) * np.float32(1.0 / (sy * sx))
        return np.clip(np.rint(out), 0, 255).astype(np.uint8)
    key = (h, w, height, width)
    if key not in _TAPS:
        _TAPS[key] = (_area_taps(w, width), _area_taps(h, height))
    (xi, xw), (yi, yw) = _TAPS[key]
    src = np.asarray(img, np.float32)
    rows = np.zeros((h, width), np.float32)
    for k in range(xi.shape[1]):
        rows += src[:, xi[:, k]] * xw[:, k]
    out = np.zeros((height, width), np.float32)
    for k in range(yi.shape[1]):
        out += rows[yi[:, k]] * yw[:, k, None]
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)


class ObsPreprocess:
    """Grayscale + resize to (height, width) uint8: the 84×84 grayscale the
    reference intended (actor.py:117-119, parameters.json:3)."""

    def __init__(self, env: Env, height: int = 84, width: int = 84,
                 grayscale: bool = True):
        self._env = env
        self._h, self._w = height, width
        self._gray = grayscale
        channels = 1 if grayscale else env.observation_shape[-1]
        self.observation_shape = (height, width, channels)
        self.num_actions = env.num_actions

    def _proc(self, obs: np.ndarray) -> np.ndarray:
        if self._gray and obs.ndim == 3 and obs.shape[-1] == 3:
            obs = rgb_to_gray(obs)
        if obs.shape[:2] != (self._h, self._w):
            if obs.ndim == 3:
                obs = np.stack([resize_area(obs[..., c], self._h, self._w)
                                for c in range(obs.shape[-1])], axis=-1)
            else:
                obs = resize_area(obs, self._h, self._w)
        if obs.ndim == 2:
            obs = obs[:, :, None]
        return np.asarray(obs, np.uint8)

    def reset(self, seed: Optional[int] = None) -> np.ndarray:
        return self._proc(self._env.reset(seed))

    def step(self, action: int) -> StepResult:
        r = self._env.step(action)
        return r._replace(obs=self._proc(r.obs))


class FrameSkip:
    """Repeat each action ``skip`` times, max-pooling the last two raw frames
    (the flicker fix); rewards accumulate over skipped frames."""

    def __init__(self, env: Env, skip: int = 4):
        if skip < 1:
            raise ValueError("skip must be >= 1")
        self._env = env
        self._skip = skip
        self.observation_shape = env.observation_shape
        self.num_actions = env.num_actions

    def reset(self, seed: Optional[int] = None) -> np.ndarray:
        return self._env.reset(seed)

    def step(self, action: int) -> StepResult:
        total = 0.0
        prev = obs = None
        terminated = truncated = False
        for _ in range(self._skip):
            prev = obs
            obs, reward, terminated, truncated = self._env.step(action)
            total += reward
            if terminated or truncated:
                break
        if prev is not None:
            obs = np.maximum(obs, prev)
        return StepResult(obs, total, terminated, truncated)


class FrameStack:
    """Stack the last ``k`` frames along the channel axis (NHWC)."""

    def __init__(self, env: Env, k: int = 4):
        self._env = env
        self._k = k
        h, w, c = env.observation_shape
        self.observation_shape = (h, w, c * k)
        self.num_actions = env.num_actions
        self._frames = None

    def reset(self, seed: Optional[int] = None) -> np.ndarray:
        first = self._env.reset(seed)
        self._frames = [first] * self._k
        return np.concatenate(self._frames, axis=-1)

    def step(self, action: int) -> StepResult:
        r = self._env.step(action)
        self._frames = self._frames[1:] + [r.obs]
        return r._replace(obs=np.concatenate(self._frames, axis=-1))


class RewardClip:
    """Clip rewards to [-1, 1]."""

    def __init__(self, env: Env):
        self._env = env
        self.observation_shape = env.observation_shape
        self.num_actions = env.num_actions

    def reset(self, seed: Optional[int] = None) -> np.ndarray:
        return self._env.reset(seed)

    def step(self, action: int) -> StepResult:
        r = self._env.step(action)
        return r._replace(reward=float(np.clip(r.reward, -1.0, 1.0)))


class EpisodicLife:
    """A life loss is a terminal for the learner (the bootstrap is cut);
    the emulator resets only when the game ends.  Works with any inner env
    exposing ``unwrapped.ale.lives()``; a no-op otherwise."""

    def __init__(self, env):
        self._env = env
        self.observation_shape = env.observation_shape
        self.num_actions = env.num_actions
        self._lives = 0
        self._real_done = True

    def _ale_lives(self) -> int:
        inner = getattr(self._env, "unwrapped", None)
        ale = getattr(inner, "ale", None)
        return int(ale.lives()) if ale is not None else 0

    def reset(self, seed: Optional[int] = None) -> np.ndarray:
        if self._real_done:
            obs = self._env.reset(seed)
        else:
            # Life lost mid-game: step a no-op past the death frame; if that
            # frame ends the game, reset fully, so no episode starts on a
            # game-over frame.
            r = self._env.step(0)
            obs = r.obs
            if r.terminated or r.truncated:
                self._real_done = True
                obs = self._env.reset(seed)
        self._lives = self._ale_lives()
        return obs

    def step(self, action: int) -> StepResult:
        r = self._env.step(action)
        self._real_done = r.terminated or r.truncated
        lives = self._ale_lives()
        terminated = r.terminated or (0 < lives < self._lives)
        self._lives = lives
        return r._replace(terminated=terminated)


def wrap_dqn(
    env: Env,
    frame_skip: int = 4,
    frame_stack: int = 1,
    episodic_life: bool = True,
    clip_rewards: bool = True,
    height: int = 84,
    width: int = 84,
) -> Env:
    """The DQN wrapper stack over any raw-frame env, in the one order the
    Atari factory and the fake emulator share."""
    if episodic_life:
        env = EpisodicLife(env)
    if frame_skip > 1:
        env = FrameSkip(env, frame_skip)
    env = ObsPreprocess(env, height, width)
    if frame_stack > 1:
        env = FrameStack(env, frame_stack)
    if clip_rewards:
        env = RewardClip(env)
    return env


def make_atari_env(
    env_name: str,
    frame_skip: int = 4,
    frame_stack: int = 1,
    episodic_life: bool = True,
    clip_rewards: bool = True,
    height: int = 84,
    width: int = 84,
) -> Env:
    """The full DQN Atari stack over a gymnasium env (needs ``gymnasium``
    and ``ale_py``).  ``frame_stack=1`` is reference parity; 4 is the
    Nature/Ape-X setting."""
    return wrap_dqn(
        make_local_env(env_name),
        frame_skip=frame_skip,
        frame_stack=frame_stack,
        episodic_life=episodic_life,
        clip_rewards=clip_rewards,
        height=height,
        width=width,
    )
