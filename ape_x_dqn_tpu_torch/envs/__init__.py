"""Environment layer: protocol, synthetic envs, vectorization.

``make_env`` is the config-string factory (the port's copy of
``ape_x_dqn_tpu/envs/__init__.make_env``) for the envs the port carries:
  * ``"chain:N"``   — N-state ChainMDP (learning tests)
  * ``"catch"``     — bsuite-style Catch; ``"catch:S"`` upscales to SxS
  * ``"loop:T"``    — single-state truncation-only env (bootstrap tests)
  * ``"random"`` / ``"random:HxWxC"`` — RandomFrameEnv (throughput)
  * ``"fake-atari"`` — the full DQN wrapper stack over the ALE-faithful
    fake emulator (lives counter, sprite flicker — envs/fake_atari.py)
  * ``"gym:Id"``    — an installed gymnasium env quantized to uint8
    (e.g. ``"gym:CartPole-v1"``; needs ``gymnasium``)
  * anything else   — the full Atari preprocessing stack via gymnasium
    (needs ``gymnasium``, ``ale_py`` and the game's ROM).

The Atari stack is numpy (no cv2); ``gymnasium`` is imported only when a
``gym:`` or Atari env is built.
"""

from __future__ import annotations

from ape_x_dqn_tpu_torch.envs.atari import (
    EpisodicLife,
    FrameSkip,
    FrameStack,
    GymnasiumEnv,
    ObsPreprocess,
    QuantizeObs,
    RewardClip,
    make_atari_env,
    make_gym_env,
    make_local_env,
    wrap_dqn,
)
from ape_x_dqn_tpu_torch.envs.fake_atari import FakeAtariEnv, make_fake_atari_env
from ape_x_dqn_tpu_torch.envs.core import (
    CatchEnv,
    ChainMDP,
    Env,
    LoopEnv,
    PixelUpscale,
    RandomFrameEnv,
    StepResult,
)
from ape_x_dqn_tpu_torch.envs.vector import SyncVectorEnv, VectorStep


def make_env(spec: str, seed: int = 0, **atari_kwargs) -> Env:
    """Build an env from a config string (see module docstring)."""
    if spec.startswith("chain"):
        n = int(spec.split(":")[1]) if ":" in spec else 10
        return ChainMDP(n_states=n)
    if spec.startswith("catch"):
        env = CatchEnv(seed=seed)
        if ":" in spec:
            size = int(spec.split(":")[1])
            env = PixelUpscale(env, size, size)
        return env
    if spec.startswith("loop"):
        t = int(spec.split(":")[1]) if ":" in spec else 10
        return LoopEnv(time_limit=t)
    if spec.startswith("random"):
        if ":" in spec:
            dims = tuple(int(d) for d in spec.split(":")[1].split("x"))
        else:
            dims = (84, 84, 1)
        return RandomFrameEnv(obs_shape=dims, seed=seed)
    if spec.startswith("gym:"):
        return make_gym_env(spec.split(":", 1)[1])
    if spec == "fake-atari":
        return make_fake_atari_env(**atari_kwargs)
    return make_atari_env(spec, **atari_kwargs)


__all__ = [
    "CatchEnv",
    "ChainMDP",
    "Env",
    "EpisodicLife",
    "FakeAtariEnv",
    "LoopEnv",
    "FrameSkip",
    "FrameStack",
    "GymnasiumEnv",
    "ObsPreprocess",
    "PixelUpscale",
    "QuantizeObs",
    "RandomFrameEnv",
    "RewardClip",
    "StepResult",
    "SyncVectorEnv",
    "VectorStep",
    "make_atari_env",
    "make_env",
    "make_gym_env",
    "make_fake_atari_env",
    "make_local_env",
    "wrap_dqn",
]
