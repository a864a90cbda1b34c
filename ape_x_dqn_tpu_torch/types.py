"""Transition schema and train state as dataclasses of tensors.

Port of ``ape_x_dqn_tpu/types.py``: ``NStepTransition`` (:35),
``PrioritizedBatch`` (:120) and ``TrainState`` (:129).  Leaves are torch
tensors on device or numpy arrays on the host (the actor fleet emits numpy;
the learner moves rows to the device once, on ingest).  Observations stay
uint8 end to end and are cast to the compute dtype inside the network.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict

import torch


@dataclasses.dataclass
class NStepTransition:
    """An n-step transition (batched along the leading axis).

    ``reward`` is the accumulated n-step return R_{t→t+n}; ``discount`` is
    γ^n with terminal masking, so the learner target is
    ``reward + discount * bootstrap`` with no special cases.
    """

    obs: Any          # uint8 [..., *obs_shape] — S_t
    action: Any       # int   [...]             — A_t
    reward: Any       # float32 [...]           — R_{t→t+n}
    discount: Any     # float32 [...]           — prod_k γ·(1−done_k)
    next_obs: Any     # uint8 [..., *obs_shape] — S_{t+n}

    def map(self, fn: Callable[[Any], Any]) -> "NStepTransition":
        """Apply ``fn`` to every field (slice, stack, move to device)."""
        return NStepTransition(*(fn(getattr(self, f.name))
                                 for f in dataclasses.fields(self)))


@dataclasses.dataclass
class PrioritizedBatch:
    """A replay sample as fed to the learner: transitions + sampling metadata."""

    transition: NStepTransition
    indices: torch.Tensor     # int32 [B] — replay slots, echoed back for restamp
    is_weights: torch.Tensor  # float32 [B] — importance-sampling weights


@dataclasses.dataclass
class TrainState:
    """Full learner state.

    ``params`` and ``target_params`` are name → tensor dicts in the layout of
    the network's ``state_dict`` (applied with ``torch.func.functional_call``);
    ``opt_state`` is the hand-written optimizer's state dict.  The train step
    updates the tensors in place.  ``step`` is a host int (the JAX package
    keeps a device scalar; here the host owns the count, so the fused loop
    never reads the device to decide a target sync).  ``seed`` roots the
    learner's sampling stream, as the JAX state's PRNG key does.
    """

    params: Dict[str, torch.Tensor]
    target_params: Dict[str, torch.Tensor]
    opt_state: Dict[str, Any]
    step: int
    seed: int
