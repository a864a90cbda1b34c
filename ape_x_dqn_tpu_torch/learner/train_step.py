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
Parameters, optimizer state and the target net update in place.  On the
card, RMSProp's clip and update run as one hand-written kernel pair over
every leaf (``ops/rmsprop.py``, dispatched in ``Optimizer.update_``); the
op-by-op code here is its plain version and runs every other case.

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
from typing import Callable, Dict, List, Optional, Tuple

import torch

from ape_x_dqn_tpu_torch.ops import losses, rmsprop
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
        """One step: clip, transform, and add the update to ``params``.

        RMSProp without a master copy on the card (any param or gradient a
        CUDA tensor, ``rmsprop.on_card``) always runs as the fused kernel
        pair of ``ops/rmsprop``, which raises for tensors it cannot take;
        every other case runs ``clip`` then ``apply_``, the plain version of
        the same arithmetic."""
        if self.kind == "rmsprop" and not self.float32_master \
                and rmsprop.on_card(params, grads):
            rmsprop.update_(params, grads, state["nu"], learning_rate=self.learning_rate,
                            decay=self.rmsprop_decay, eps=self.rmsprop_eps,
                            max_grad_norm=self.max_grad_norm)
            return
        self.apply_(params, self.clip(grads), state)

    @torch.no_grad()
    def clip(self, grads: Params) -> Params:
        """The gradients as ``apply_`` takes them: float32 under the master
        copy, then scaled by max/‖g‖ when the global norm ‖g‖ over all of
        them reaches ``max_grad_norm``.  A caller that steps parts of the
        params apart (the model axis's chunks, ``parallel/dp.py``) clips the
        whole gradient here first, so the norm stays global."""
        if self.float32_master:
            grads = {k: g.to(torch.float32) for k, g in grads.items()}
        if self.max_grad_norm is None:
            return grads
        g_norm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
        keep = g_norm < self.max_grad_norm
        return {k: torch.where(keep, g, (g / g_norm) * self.max_grad_norm)
                for k, g in grads.items()}

    @torch.no_grad()
    def apply_(self, params: Params, grads: Params, state: dict) -> None:
        """Transform clipped gradients (``clip``) and add the update to
        ``params``: every key of ``grads`` is stepped, so a slice of the
        params with the matching slice of the state steps alone."""
        if not self.float32_master:
            self._update(params, grads, state)
            return
        master = state["master"]
        self._update(master, grads, state)
        for k in grads:
            p = params[k]
            p.add_(master[k].to(p.dtype) - p)

    def _update(self, params: Params, grads: Params, state: dict) -> None:
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
    grad_reduce_axis: Optional[str] = None,
) -> Callable[[TrainState, PrioritizedBatch], Tuple[TrainState, StepMetrics]]:
    """Build ``train_step(state, batch) -> (state, metrics)``; ``state`` is
    updated in place and returned.

    ``sync_in_step=False`` leaves the target net alone, for callers that
    sync at their own cadence (the fused K-step loop syncs after the loop).

    ``grad_reduce_axis`` (JAX ``train_step.py:259-290``): ``"data"`` builds
    the mesh step, ``train_step(sharded, batches) -> (sharded, metrics)``
    over a ``parallel/mesh.ShardedTrainState`` and one batch per local data
    slot (``parallel/dp.place_batch``).  Each slot takes the gradient of
    its own rows' local-mean loss on its replica, the model-sharded leaves
    gathered for the forward; the gradients are averaged over the slots
    (``slot_mean``: every slot, and across processes when a process group
    is up) and clipped once on the whole mean; each slot (d, m) then steps
    its replica, its chunk of a model-sharded leaf with that chunk of the
    gradient, so the replicas stay bit-identical and a model-sharded step
    equals the model = 1 step.  The loss, mean |δ| and mean Q reported are
    the slots' means, max |δ| their max; priorities are each slot's rows,
    concatenated in slot order.

    ``train_step.update(state, batch) -> metrics`` is the device work of
    one step alone: it reads no host value that changes between steps and
    leaves ``state.step`` and the target net to the caller, so a CUDA graph
    can capture it (the fused call advances ``step`` by K after its
    replays).  ``train_step.local_grads(state, batch) -> (grads, metrics)``
    is its first half, before the optimizer, for callers that reduce the
    gradients over slots themselves; ``params``/``target`` override the
    state's (the model axis gathers its chunks into them).
    ``train_step.apply_(state, grads)`` is the second half: the optimizer
    on (reduced) gradients.
    """
    if loss_kind not in ("huber", "squared"):
        raise ValueError(f"unknown loss kind: {loss_kind}")
    if grad_reduce_axis not in (None, "data"):
        raise ValueError(f"gradients reduce over the mesh's 'data' axis, "
                         f"not {grad_reduce_axis!r}")

    def local_grads(state: TrainState, batch: PrioritizedBatch,
                    params: Optional[Params] = None,
                    target: Optional[Params] = None) -> Tuple[Params, StepMetrics]:
        t = batch.transition
        B = t.action.shape[0]
        params = state.params if params is None else params
        target = state.target_params if target is None else target
        live = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        # One online forward over [obs; next_obs] (2B rows), one target forward.
        q_both = network.apply_params(live, torch.cat([t.obs, t.next_obs], 0)).q
        q_values, q_next_online = q_both[:B], q_both[B:]
        with torch.no_grad():
            q_next_target = network.apply_params(target, t.next_obs).q
        targets = losses.double_q_target(
            q_next_online, q_next_target, t.reward, t.discount
        )
        delta = losses.td_error(q_values, t.action, targets)
        loss = losses.td_loss(delta, batch.is_weights, kind=loss_kind)
        grads = dict(zip(live, torch.autograd.grad(loss, list(live.values()))))
        delta = delta.detach()
        return grads, StepMetrics(
            loss=loss.detach(),
            mean_abs_td=delta.abs().mean(),
            max_abs_td=delta.abs().max(),
            priorities=losses.priorities_from_td(delta),
            mean_q=q_values.detach().mean(),
        )

    def update(state: TrainState, batch: PrioritizedBatch) -> StepMetrics:
        grads, metrics = local_grads(state, batch)
        optimizer.update_(state.params, grads, state.opt_state)
        return metrics

    def advance(state: TrainState) -> None:
        state.step += 1
        if sync_in_step and state.step % target_sync_freq == 0:
            sync_target_(state)

    def train_step(state: TrainState, batch: PrioritizedBatch):
        metrics = update(state, batch)
        advance(state)
        return state, metrics

    def sharded_step(state, batches: List[PrioritizedBatch]):
        mesh = state.mesh
        if len(batches) != mesh.local_data:
            raise ValueError(f"{len(batches)} batches for {mesh.local_data} data slots")
        outs = [local_grads(row[0], batch, params=state.gather(d),
                            target=state.gather(d, "target_params"))
                for d, (row, batch) in enumerate(zip(state.replicas, batches))]
        mean = slot_mean([g for g, _ in outs])
        m = mesh.shape["model"]
        for row, devs in zip(state.replicas, mesh.devices):
            g = optimizer.clip({k: v.to(devs[0], copy=True) for k, v in mean.items()})
            for j, (rep, dev) in enumerate(zip(row, devs)):
                part = {k: (v.chunk(m, 0)[j] if k in state.sharded else v).to(dev)
                        for k, v in g.items()}
                optimizer.apply_(rep.params, part, rep.opt_state)
                advance(rep)
        return state, reduce_slot_metrics([mt for _, mt in outs])

    step = train_step if grad_reduce_axis is None else sharded_step
    step.update = update
    step.local_grads = local_grads
    step.apply_ = lambda state, grads: optimizer.update_(state.params, grads, state.opt_state)
    return step


def slot_mean(grads: List[Params]) -> Params:
    """The all-reduce of the data axis: the mean over slots of each slot's
    gradient dict, on the first slot's device.  The sum runs in slot order
    and is divided by the slot count (as JAX's psum/n); with a process
    group up it is then averaged across the processes
    (``parallel/multihost.all_reduce_mean_``).  Nothing here asks whether
    two slots share a device: each slot is reduced."""
    from ape_x_dqn_tpu_torch.parallel import multihost

    mean = {}
    for k, g0 in grads[0].items():
        acc = g0.clone()
        for g in grads[1:]:
            acc.add_(g[k].to(acc.device))
        mean[k] = acc.div_(len(grads))
    multihost.all_reduce_mean_(mean)
    return mean


def reduce_slot_metrics(metrics: List[StepMetrics]) -> StepMetrics:
    """One step's metrics over the data slots (and processes): the means of
    loss, mean |δ| and mean Q, the max of max |δ| (JAX's pmean/pmax), and
    the slots' priorities concatenated in slot order (this process's rows,
    the inverse of ``multihost.local_shard``), on the first slot's device."""
    from ape_x_dqn_tpu_torch.parallel import multihost

    dev = metrics[0].loss.device

    def col(f):
        return torch.stack([getattr(m, f).to(dev) for m in metrics])

    means = torch.stack([col(f).mean(0) for f in ("loss", "mean_abs_td", "mean_q")])
    peak = col("max_abs_td").amax(0)
    means, peak = multihost.all_reduce_metrics_(means, peak)
    return StepMetrics(loss=means[0], mean_abs_td=means[1], max_abs_td=peak,
                       priorities=torch.cat([m.priorities.to(dev) for m in metrics], -1),
                       mean_q=means[2])
