"""Exploration: the Ape-X per-actor ε-ladder and ε-greedy action selection.

Port of ``ape_x_dqn_tpu/ops/exploration.py``.  Actor i of N uses
ε_i = ε^(1 + α·i/(N−1)) (reference actor.py:111-114); N == 1 uses ε.
Randomness comes from an explicit ``torch.Generator`` on the device of the
Q-values (JAX's threefry streams are not reproducible in torch; tests that
compare the two packages inject ε = 0 or the draws themselves).
"""

from __future__ import annotations

import torch


def epsilon_ladder(base_epsilon: float, alpha: float, num_actors: int) -> torch.Tensor:
    """float32 [num_actors] of per-actor ε values."""
    if num_actors <= 0:
        raise ValueError("num_actors must be positive")
    if num_actors == 1:
        return torch.tensor([base_epsilon], dtype=torch.float32)
    i = torch.arange(num_actors, dtype=torch.float32)
    exponent = 1.0 + alpha * i / (num_actors - 1)
    return torch.pow(torch.tensor(base_epsilon, dtype=torch.float32), exponent)


def epsilon_greedy(
    q_values: torch.Tensor,
    epsilon: torch.Tensor | float,
    generator: torch.Generator | None = None,
) -> torch.Tensor:
    """Batched ε-greedy: int32 [B] actions from float [B, A] Q-values and
    ε of shape [] or [B]."""
    B, A = q_values.shape
    dev = q_values.device
    greedy = torch.argmax(q_values, dim=-1).to(torch.int32)
    explore = torch.rand(B, generator=generator, device=dev) < (
        torch.as_tensor(epsilon, device=dev)
    )
    random_actions = torch.randint(
        0, A, (B,), generator=generator, device=dev, dtype=torch.int32
    )
    return torch.where(explore, random_actions, greedy)
