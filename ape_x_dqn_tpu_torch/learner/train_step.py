"""The learner step: double-Q TD loss, hand-written optimizer, priorities.

Port of ``ape_x_dqn_tpu/learner/train_step.py``: ``make_optimizer``,
``init_train_state`` and ``build_train_step``.

The optimizer is written by hand to match optax, not taken from
``torch.optim``:
  * RMSProp as ``optax.rmsprop``: ν ← ρ·ν + (1−ρ)·g², update
    −lr·g·rsqrt(ν+ε) with ε inside the square root (``train_step.py:80-83``
    of the JAX package).  ``torch.optim.RMSprop`` divides by √ν+ε, which
    differs most in the first steps, while ν ≈ 0.
  * ``clip_by_global_norm`` as optax does it: g·max/‖g‖ only when
    ‖g‖ ≥ max, with no epsilon (``clip_grad_norm_`` adds 1e-6).
  * Adam as ``optax.adam`` (bias-corrected, ε outside the square root).
Parameters, optimizer state and the target net update in place.

The bf16 master-weight and bf16 second-moment options of the JAX package
are not part of the port yet.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch

from ape_x_dqn_tpu_torch.ops import losses
from ape_x_dqn_tpu_torch.types import PrioritizedBatch, TrainState

Params = Dict[str, torch.Tensor]


@dataclasses.dataclass
class StepMetrics:
    loss: torch.Tensor            # float32 []  (or [K] stacked by the fused loop)
    mean_abs_td: torch.Tensor     # float32 []
    max_abs_td: torch.Tensor      # float32 []
    priorities: torch.Tensor      # float32 [B] — new replay priorities
    mean_q: torch.Tensor          # float32 []


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """optax-equivalent RMSProp or Adam, with optional global-norm clip."""

    kind: str = "rmsprop"
    learning_rate: float = 0.00025 / 4
    rmsprop_decay: float = 0.95
    rmsprop_eps: float = 1.5e-7
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    adam_eps: float = 1e-8
    max_grad_norm: Optional[float] = 40.0

    def init(self, params: Params) -> dict:
        zeros = lambda: {k: torch.zeros_like(v) for k, v in params.items()}  # noqa: E731
        if self.kind == "rmsprop":
            return {"nu": zeros()}
        return {"mu": zeros(), "nu": zeros(), "count": 0}

    @torch.no_grad()
    def update_(self, params: Params, grads: Params, state: dict) -> None:
        """One step: clip, transform, and add the update to ``params``."""
        if self.max_grad_norm is not None:
            g_norm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
            keep = g_norm < self.max_grad_norm
            grads = {
                k: torch.where(keep, g, (g / g_norm) * self.max_grad_norm)
                for k, g in grads.items()
            }
        lr = self.learning_rate
        if self.kind == "rmsprop":
            rho = self.rmsprop_decay
            for k, g in grads.items():
                nu = state["nu"][k]
                nu.copy_((1.0 - rho) * (g * g) + rho * nu)
                params[k].add_(-lr * (g * torch.rsqrt(nu + self.rmsprop_eps)))
            return
        b1, b2 = self.adam_b1, self.adam_b2
        state["count"] += 1
        c1 = 1.0 - b1 ** state["count"]
        c2 = 1.0 - b2 ** state["count"]
        for k, g in grads.items():
            mu, nu = state["mu"][k], state["nu"][k]
            mu.copy_((1.0 - b1) * g + b1 * mu)
            nu.copy_((1.0 - b2) * (g * g) + b2 * nu)
            upd = (mu / c1) / (torch.sqrt(nu / c2) + self.adam_eps)
            params[k].add_(-lr * upd)


def make_optimizer(
    kind: str = "rmsprop",
    learning_rate: float = 0.00025 / 4,
    max_grad_norm: float | None = 40.0,
) -> Optimizer:
    """Reference-parity RMSProp (lr 0.00025/4, decay 0.95, eps 1.5e-7) or
    Adam (optax's defaults), with the global-norm clip at ``max_grad_norm``
    (None drops it)."""
    if kind not in ("rmsprop", "adam"):
        raise ValueError(f"unknown optimizer kind: {kind}")
    return Optimizer(kind, learning_rate, max_grad_norm=max_grad_norm)


def init_train_state(network, optimizer: Optimizer, seed: int = 0,
                     device: str | torch.device = "cuda") -> TrainState:
    """Params from the network's own init, a target that is a real copy,
    and fresh optimizer state, all on ``device``."""
    params = {k: v.detach().to(device, copy=True)
              for k, v in network.state_dict().items()}
    target = {k: v.clone() for k, v in params.items()}
    return TrainState(params=params, target_params=target,
                      opt_state=optimizer.init(params), step=0, seed=seed)


def sync_target_(state: TrainState) -> None:
    """Copy online → target params in place."""
    with torch.no_grad():
        for k, v in state.params.items():
            state.target_params[k].copy_(v)


def build_train_step(
    network,
    optimizer: Optimizer,
    loss_kind: str = "huber",
    target_sync_freq: int = 2500,
    sync_in_step: bool = True,
) -> Callable[[TrainState, PrioritizedBatch], Tuple[TrainState, StepMetrics]]:
    """Build ``train_step(state, batch) -> (state, metrics)``; ``state`` is
    updated in place and returned.

    ``sync_in_step=False`` leaves the target net alone, for callers that
    sync at their own cadence (the fused K-step loop syncs after the loop).
    """
    if loss_kind not in ("huber", "squared"):
        raise ValueError(f"unknown loss kind: {loss_kind}")

    def train_step(state: TrainState, batch: PrioritizedBatch):
        t = batch.transition
        B = t.action.shape[0]
        live = {k: v.detach().requires_grad_(True) for k, v in state.params.items()}
        # One online forward over [obs; next_obs] (2B rows), one target forward.
        q_both = network.apply_params(live, torch.cat([t.obs, t.next_obs], 0)).q
        q_values, q_next_online = q_both[:B], q_both[B:]
        with torch.no_grad():
            q_next_target = network.apply_params(state.target_params, t.next_obs).q
        targets = losses.double_q_target(
            q_next_online, q_next_target, t.reward, t.discount
        )
        delta = losses.td_error(q_values, t.action, targets)
        loss = losses.td_loss(delta, batch.is_weights, kind=loss_kind)
        grads = dict(zip(live, torch.autograd.grad(loss, list(live.values()))))
        optimizer.update_(state.params, grads, state.opt_state)
        state.step += 1
        if sync_in_step and state.step % target_sync_freq == 0:
            sync_target_(state)
        delta = delta.detach()
        metrics = StepMetrics(
            loss=loss.detach(),
            mean_abs_td=delta.abs().mean(),
            max_abs_td=delta.abs().max(),
            priorities=losses.priorities_from_td(delta),
            mean_q=q_values.detach().mean(),
        )
        return state, metrics

    return train_step
