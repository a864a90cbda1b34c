"""Vectorized n-step return construction.

Port of ``ape_x_dqn_tpu/ops/nstep.py``: ``nstep_returns`` (torch, :31) and
its numpy twin ``nstep_returns_np`` (:101) that the actor fleet runs on the
host.  For per-step reward r_t and discount d_t = γ·(1−done_t):

    R^{(n)}_t = Σ_{k=0}^{n-1} (Π_{j<k} d_{t+j}) · r_{t+k}
    D^{(n)}_t = Π_{j=0}^{n-1} d_{t+j}              (0 if any step terminated)

so the learner target is exactly ``R + D · Q_target(S')``.
"""

from __future__ import annotations

import numpy as np
import torch


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
