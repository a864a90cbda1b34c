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
    Its step ``count`` is an int32 tensor on the params' device and the
    bias corrections 1 − b^count are computed from it in float32, as optax
    does, so a step captured in a CUDA graph corrects right on every replay.
Parameters, optimizer state and the target net update in place.

The JAX package's low-precision knobs (``train_step.py:52-134,174-210``):
  * ``second_moment_dtype`` (RMSProp only) stores ν in that dtype: ν is
    upcast, blended in float32 and stored back down, and the update uses
    the float32 ν before rounding.
  * ``float32_master`` (``with_float32_master``, for bfloat16 params) keeps
    a float32 copy of the params in the optimizer state; the optimizer
    steps the master, and the update added to the params is
    ``cast(master) − params``.
  * ``init_train_state(target_dtype=...)`` stores the target net in that
    dtype, always as a real copy; target syncs cast online → target dtype.
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
    second_moment_dtype: Optional[torch.dtype] = None  # RMSProp's ν storage
    float32_master: bool = False

    def init(self, params: Params) -> dict:
        if self.float32_master:
            master = {k: v.detach().to(torch.float32, copy=True) for k, v in params.items()}
            return {"master": master, **self._init(master)}
        return self._init(params)

    def _init(self, params: Params) -> dict:
        def zeros(dtype=None):
            return {k: torch.zeros_like(v, dtype=dtype) for k, v in params.items()}

        if self.kind == "rmsprop":
            return {"nu": zeros(self.second_moment_dtype)}
        device = next(iter(params.values())).device
        return {"mu": zeros(), "nu": zeros(),
                "count": torch.zeros((), dtype=torch.int32, device=device)}

    @torch.no_grad()
    def update_(self, params: Params, grads: Params, state: dict) -> None:
        """One step: clip, transform, and add the update to ``params``."""
        if not self.float32_master:
            self._update(params, grads, state)
            return
        master = state["master"]
        self._update(master, {k: g.to(torch.float32) for k, g in grads.items()}, state)
        for k, p in params.items():
            p.add_(master[k].to(p.dtype) - p)

    def _update(self, params: Params, grads: Params, state: dict) -> None:
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
                if self.second_moment_dtype is None:
                    nu.copy_((1.0 - rho) * (g * g) + rho * nu)
                    params[k].add_(-lr * (g * torch.rsqrt(nu + self.rmsprop_eps)))
                    continue
                # Blend in float32 and step with the float32 ν; only the
                # stored copy is rounded (JAX train_step.py:72-89).
                g32 = g.to(torch.float32)
                nu32 = rho * nu.to(torch.float32) + (1.0 - rho) * (g32 * g32)
                scaled = (g32 * torch.rsqrt(nu32 + self.rmsprop_eps)).to(g.dtype)
                nu.copy_(nu32)
                params[k].add_(-lr * scaled)
            return
        b1, b2 = self.adam_b1, self.adam_b2
        count = state["count"]
        count.add_(1)
        t = count.to(torch.float32)
        c1 = 1.0 - torch.pow(b1, t)
        c2 = 1.0 - torch.pow(b2, t)
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
    second_moment_dtype: Optional[torch.dtype] = None,
    float32_master: bool = False,
) -> Optimizer:
    """Reference-parity RMSProp (lr 0.00025/4, decay 0.95, eps 1.5e-7) or
    Adam (optax's defaults), with the global-norm clip at ``max_grad_norm``
    (None drops it).  ``second_moment_dtype`` (RMSProp only) stores ν in
    that dtype; ``float32_master`` wraps the optimizer around a float32
    master copy of the params (for bfloat16 params)."""
    if kind not in ("rmsprop", "adam"):
        raise ValueError(f"unknown optimizer kind: {kind}")
    if second_moment_dtype is not None and kind != "rmsprop":
        raise ValueError("second_moment_dtype is only supported for rmsprop")
    return Optimizer(kind, learning_rate, max_grad_norm=max_grad_norm,
                     second_moment_dtype=second_moment_dtype,
                     float32_master=float32_master)


def init_train_state(network, optimizer: Optimizer, seed: int = 0,
                     device: str | torch.device = "cuda",
                     target_dtype: Optional[torch.dtype] = None) -> TrainState:
    """Params from the network's own init, a target that is a real copy
    (in ``target_dtype`` when given), and fresh optimizer state, all on
    ``device``."""
    params = {k: v.detach().to(device, copy=True)
              for k, v in network.state_dict().items()}
    target = {k: v.to(target_dtype or v.dtype, copy=True) for k, v in params.items()}
    return TrainState(params=params, target_params=target,
                      opt_state=optimizer.init(params), step=0, seed=seed)


def sync_target_(state: TrainState) -> None:
    """Copy online → target params in place, cast to the target's dtype."""
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

    ``train_step.update(state, batch) -> metrics`` is the device work of
    one step alone: it reads no host value that changes between steps and
    leaves ``state.step`` and the target net to the caller, so a CUDA graph
    can capture it (the fused call advances ``step`` by K after its
    replays).
    """
    if loss_kind not in ("huber", "squared"):
        raise ValueError(f"unknown loss kind: {loss_kind}")

    def update(state: TrainState, batch: PrioritizedBatch) -> StepMetrics:
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
        delta = delta.detach()
        return StepMetrics(
            loss=loss.detach(),
            mean_abs_td=delta.abs().mean(),
            max_abs_td=delta.abs().max(),
            priorities=losses.priorities_from_td(delta),
            mean_q=q_values.detach().mean(),
        )

    def train_step(state: TrainState, batch: PrioritizedBatch):
        metrics = update(state, batch)
        state.step += 1
        if sync_in_step and state.step % target_sync_freq == 0:
            sync_target_(state)
        return state, metrics

    train_step.update = update
    return train_step
