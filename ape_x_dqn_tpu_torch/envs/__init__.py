"""Environment layer: protocol, synthetic envs, vectorization.

``make_env`` is the config-string factory (the port's copy of
``ape_x_dqn_tpu/envs/__init__.make_env``) for the envs the port carries:
  * ``"chain:N"``   — N-state ChainMDP (learning tests)
  * ``"catch"``     — bsuite-style Catch; ``"catch:S"`` upscales to SxS
  * ``"loop:T"``    — single-state truncation-only env (bootstrap tests)
  * ``"random"`` / ``"random:HxWxC"`` — RandomFrameEnv (throughput)

``fake-atari``, ``gym:`` and the Atari stack need ``cv2`` or
``gymnasium`` and are not part of the port yet; they raise here.
"""

from __future__ import annotations

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


def make_env(spec: str, seed: int = 0) -> Env:
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
    raise ValueError(
        f"env {spec!r} is not part of the port yet (it carries chain, catch, "
        "loop and random)"
    )


__all__ = [
    "CatchEnv",
    "ChainMDP",
    "Env",
    "LoopEnv",
    "PixelUpscale",
    "RandomFrameEnv",
    "StepResult",
    "SyncVectorEnv",
    "VectorStep",
    "make_env",
]
