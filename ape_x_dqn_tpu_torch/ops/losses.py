"""Double-Q targets, TD errors, losses and priorities — pure functions.

Port of ``ape_x_dqn_tpu/ops/losses.py`` (intended semantics of reference
learner.py:29-52): n-step double-Q target with the terminal mask folded
into the discount, δ = Q(S_t, A_t) − G_t, IS-weighted Huber or ½δ² loss,
and per-transition priorities |δ| + ε.  Targets carry no gradient.
"""

from __future__ import annotations

import torch


def double_q_target(
    q_online_next: torch.Tensor,
    q_target_next: torch.Tensor,
    rewards: torch.Tensor,
    discounts: torch.Tensor,
) -> torch.Tensor:
    """n-step double-Q bootstrap target, float [B], detached: the online
    net picks the action at S_{t+n}, the target net evaluates it."""
    best_actions = torch.argmax(q_online_next, dim=-1)
    bootstrap = torch.gather(q_target_next, -1, best_actions[:, None])[:, 0]
    return (rewards + discounts * bootstrap).detach()


def max_q_target(q_next: torch.Tensor, rewards: torch.Tensor,
                 discounts: torch.Tensor) -> torch.Tensor:
    """Plain max-Q bootstrap, float [B], detached — the actor-side
    initial-priority rule (reference actor.py:138-142 uses max-Q, not
    double-Q)."""
    return (rewards + discounts * torch.amax(q_next, dim=-1)).detach()


def td_error(q_values: torch.Tensor, actions: torch.Tensor,
             targets: torch.Tensor) -> torch.Tensor:
    """δ = Q(S_t, A_t) − G_t, float [B]."""
    chosen = torch.gather(q_values, -1, actions[:, None].long())[:, 0]
    return chosen - targets


def huber(delta: torch.Tensor, kappa: float = 1.0) -> torch.Tensor:
    """Per-element Huber loss ℓ_κ(δ)."""
    abs_d = torch.abs(delta)
    quad = torch.clamp(abs_d, max=kappa)
    return 0.5 * quad**2 + kappa * (abs_d - quad)


def squared(delta: torch.Tensor) -> torch.Tensor:
    """Parity loss: ½δ² (reference learner.py:48)."""
    return 0.5 * delta**2


def td_loss(
    delta: torch.Tensor,
    is_weights: torch.Tensor | None = None,
    kind: str = "huber",
    huber_kappa: float = 1.0,
) -> torch.Tensor:
    """Weighted mean TD loss. ``kind`` in {"huber", "squared"}."""
    if kind == "huber":
        per = huber(delta, huber_kappa)
    elif kind == "squared":
        per = squared(delta)
    else:
        raise ValueError(f"unknown loss kind: {kind}")
    if is_weights is not None:
        per = per * is_weights
    return torch.mean(per)


def priorities_from_td(delta: torch.Tensor, epsilon: float = 1e-6) -> torch.Tensor:
    """Replay priorities p = |δ| + ε, per transition."""
    return torch.abs(delta) + epsilon
