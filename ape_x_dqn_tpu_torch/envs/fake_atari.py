"""ALE-faithful fake emulator — drives the full Atari wrapper stack
without ALE.

The port's copy of ``ape_x_dqn_tpu/envs/fake_atari.py`` (numpy only, the
same frames, lives, rewards and flicker).

Without ALE (ale-py and its ROMs) the preprocessing stack (envs/atari.py)
would only ever see synthetic shape tests.  This fake reproduces the ALE
*behaviors the wrappers exist for*:

  * **RGB frames** (210×160×3, the real ALE geometry) with the current
    step index encoded in a corner pixel, so tests can prove frame
    continuity across EpisodicLife's fake resets;
  * **sprite flicker** — the sprite renders only on even frames, the
    classic ALE artifact (hardware sprite multiplexing) that
    ``FrameSkip``'s 2-frame max-pool exists to repair;
  * a **lives counter** surfaced exactly the way ``EpisodicLife``
    discovers it (``env.unwrapped.ale.lives()``), decremented every
    ``steps_per_life`` steps with ``terminated=False`` until the last
    life — the wrapper must convert in-game deaths to learner terminals
    and only truly reset on game over;
  * **unclipped rewards** (± ``reward`` every ``reward_every`` steps)
    for ``RewardClip``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ape_x_dqn_tpu_torch.envs.core import StepResult


class _FakeALEHandle:
    """The ``ale`` attribute EpisodicLife probes (``ale.lives()``)."""

    def __init__(self, env: "FakeAtariEnv"):
        self._env = env

    def lives(self) -> int:
        return self._env._lives


class FakeAtariEnv:
    """See module docstring.  Deterministic given the constructor args."""

    observation_shape = (210, 160, 3)
    num_actions = 4

    def __init__(
        self,
        lives: int = 3,
        steps_per_life: int = 12,
        reward_every: int = 5,
        reward: float = 7.0,
        flicker: bool = True,
    ):
        self._total_lives = int(lives)
        self._steps_per_life = int(steps_per_life)
        self._reward_every = int(reward_every)
        self._reward = float(reward)
        self._flicker = bool(flicker)
        self._lives = self._total_lives
        self._t = 0
        self.ale = _FakeALEHandle(self)
        self.full_resets = 0  # observability for tests

    @property
    def unwrapped(self) -> "FakeAtariEnv":
        return self

    def _frame(self) -> np.ndarray:
        f = np.zeros(self.observation_shape, np.uint8)
        # Static background gradient (grayscale ramp over rows).
        f[:, :, :] = (np.arange(210, dtype=np.uint16) * 100 // 210)[
            :, None, None
        ].astype(np.uint8)
        # The flickering sprite: a bright 16×16 block marching rightward,
        # drawn only on even frames (or always with flicker=False).
        if not self._flicker or self._t % 2 == 0:
            col = 8 + (self._t * 4) % 136
            f[100:116, col:col + 16, :] = 255
        # Step index in the corner (frame-continuity probe for tests).
        f[0, 0, :] = self._t % 256
        return f

    def reset(self, seed: Optional[int] = None) -> np.ndarray:
        self._t = 0
        self._lives = self._total_lives
        self.full_resets += 1
        return self._frame()

    def step(self, action: int) -> StepResult:
        self._t += 1
        reward = self._reward if self._t % self._reward_every == 0 else 0.0
        died = self._t % self._steps_per_life == 0
        if died:
            self._lives -= 1
        # Real ALE: losing a non-final life does NOT end the gym episode —
        # that's exactly the gap EpisodicLife closes for the learner.
        terminated = died and self._lives <= 0
        return StepResult(self._frame(), reward, terminated, False)


def make_fake_atari_env(**dqn_kwargs):
    """The production wrapper stack (envs/atari.wrap_dqn — same ordering
    as make_atari_env) over the fake emulator."""
    from ape_x_dqn_tpu_torch.envs.atari import wrap_dqn

    return wrap_dqn(FakeAtariEnv(), **dqn_kwargs)
