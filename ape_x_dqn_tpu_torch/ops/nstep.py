"""Vectorized n-step return construction.

Port of ``ape_x_dqn_tpu/ops/nstep.py``: ``nstep_returns`` (torch, :31),
``build_nstep_transitions`` (:59) and the numpy twin ``nstep_returns_np``
(:101) that the actor fleet runs on the host.  For per-step reward r_t and discount d_t = γ·(1−done_t):

    R^{(n)}_t = Σ_{k=0}^{n-1} (Π_{j<k} d_{t+j}) · r_{t+k}
    D^{(n)}_t = Π_{j=0}^{n-1} d_{t+j}              (0 if any step terminated)

so the learner target is exactly ``R + D · Q_target(S')``.
"""

from __future__ import annotations

import numpy as np
import torch

from ape_x_dqn_tpu_torch.types import NStepTransition


def nstep_returns(rewards: torch.Tensor, discounts: torch.Tensor, n: int):
    """n-step returns and bootstrap discounts for every start index.

    Args:
      rewards: float32 [T] — reward received after step t.
      discounts: float32 [T] — γ·(1−done_t) for step t.
      n: the n-step horizon.

    Returns:
      (returns, boot_discounts): each float32 [T - n + 1]; entry t covers the
      window [t, t+n).
    """
    T = rewards.shape[0]
    if T < n:
        raise ValueError(f"rollout length {T} < n-step horizon {n}")
    out_len = T - n + 1
    acc = torch.zeros(out_len, dtype=torch.float32, device=rewards.device)
    cumdisc = torch.ones(out_len, dtype=torch.float32, device=rewards.device)
    for k in range(n):
        acc = acc + cumdisc * rewards[k:k + out_len]
        cumdisc = cumdisc * discounts[k:k + out_len]
    return acc, cumdisc


def build_nstep_transitions(
    obs: torch.Tensor,
    actions: torch.Tensor,
    rewards: torch.Tensor,
    discounts: torch.Tensor,
    bootstrap_obs: torch.Tensor,
    n: int,
    stride: int = 1,
) -> NStepTransition:
    """n-step transitions from a rollout segment S_0..S_{T-1} (obs [T, ...],
    actions, rewards, discounts γ·(1−done) [T]) and the one observation S_T
    after it (``bootstrap_obs``): start indices 0, stride, ... ≤ T − n, each
    with its n-step return, bootstrap discount and S_{t+n}.  ``stride`` 1
    overlaps the windows (Ape-X); ``n`` is the reference's non-overlapping
    emission."""
    returns, boot = nstep_returns(rewards, discounts, n)
    all_obs = torch.cat([obs, bootstrap_obs[None]], 0)
    starts = torch.arange(0, returns.shape[0], stride, device=obs.device)
    return NStepTransition(obs=obs[starts], action=actions[starts], reward=returns[starts],
                           discount=boot[starts], next_obs=all_obs[starts + n])


def nstep_returns_np(rewards: np.ndarray, discounts: np.ndarray, n: int):
    """Numpy twin of :func:`nstep_returns` for the host-side actor fleet.
    Leading axis is time; trailing axes (an actor axis [T, N]) broadcast."""
    T = rewards.shape[0]
    if T < n:
        raise ValueError(f"rollout length {T} < n-step horizon {n}")
    out_len = T - n + 1
    acc = np.zeros_like(rewards[:out_len], dtype=np.float32)
    cumdisc = np.ones_like(discounts[:out_len], dtype=np.float32)
    for k in range(n):
        acc += cumdisc * rewards[k : k + out_len]
        cumdisc = cumdisc * discounts[k : k + out_len]
    return acc, cumdisc
