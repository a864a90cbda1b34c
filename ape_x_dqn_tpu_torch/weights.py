"""Carry network weights and train states between the JAX package and the port.

``params_from_jax(network, flax_params)`` returns a ``state_dict``-layout
dict of tensors for the port's ``network``, each leaf in its own dtype
(float32, or bfloat16 for the JAX package's ``param_dtype`` /
``target_dtype`` / ``second_moment_dtype`` knobs: any tree shaped like the
params, a target net or an optimizer's ν or master copy, carries the
same way); ``params_to_jax(network, params)`` is its inverse and returns a
flax ``{"params": ...}`` tree of float32 numpy arrays.  Both work on numpy
arrays on the flax side, so this module imports no JAX.  Conversions:
  * conv kernels HWIO ↔ OIHW;
  * Dense kernels (in, out) ↔ Linear weights (out, in);
  * the first Dense after the conv torso's flatten also has its input rows
    permuted: flax flattens NHWC as (h, w, c) (``models/dueling.py:94`` of
    the JAX package), the port flattens NCHW as (c, h, w).

``train_state_from_jax`` / ``train_state_to_jax`` carry a whole train
state the same way: params, target, the optax chain's moments (found by
their ``nu`` / ``mu`` / ``count`` fields in its nested state tuples, and
the float32 master copy that ``with_float32_master`` keeps first) as the
port's ``{"master", "nu", "mu", "count"}`` optimizer dict, and ``step``.
JAX's threefry PRNG key cannot become a ``torch.Generator``: a state
carried into the port reseeds its sampling stream from ``seed``, and one
carried back keeps its template's key.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np
import torch

from ape_x_dqn_tpu_torch.models.dueling import DuelingDQN, DuelingMLP
from ape_x_dqn_tpu_torch.types import TrainState


def _layer_map(network) -> List[Tuple[str, str, str]]:
    """(flax module name, torch prefix, kind) in flax creation order."""
    if isinstance(network, DuelingDQN):
        return [
            *[(f"Conv_{i}", f"convs.{i}", "conv") for i in range(len(network.convs))],
            ("Dense_0", "value_hidden", "flat"),
            ("Dense_1", "adv_hidden", "flat"),
            ("Dense_2", "value", "dense"),
            ("Dense_3", "advantage", "dense"),
        ]
    if isinstance(network, DuelingMLP):
        n = len(network.hidden)
        return [
            *[(f"Dense_{i}", f"hidden.{i}", "dense") for i in range(n)],
            (f"Dense_{n}", "value", "dense"),
            (f"Dense_{n + 1}", "advantage", "dense"),
        ]
    raise TypeError(f"no weight layout for {type(network).__name__}")


def _to_torch(a: np.ndarray) -> torch.Tensor:
    """A numpy leaf as a tensor of the same dtype.  numpy has no bfloat16 of
    its own (JAX's comes from ``ml_dtypes``): its bits travel as int16."""
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def params_from_jax(network, flax_params) -> Dict[str, torch.Tensor]:
    """flax ``{"params": {...}}`` (numpy or jax arrays) → port state_dict,
    every leaf in its own dtype."""
    tree = flax_params["params"] if "params" in flax_params else flax_params
    out: Dict[str, torch.Tensor] = {}
    for fname, prefix, kind in _layer_map(network):
        kernel = np.asarray(tree[fname]["kernel"])
        bias = np.asarray(tree[fname]["bias"])
        if kind == "conv":
            w = kernel.transpose(3, 2, 0, 1)                  # HWIO → OIHW
        elif kind == "flat":
            h, wd, c = network.torso_shape
            w = (kernel.reshape(h, wd, c, -1).transpose(2, 0, 1, 3)
                 .reshape(c * h * wd, -1).T)                  # rows (h,w,c) → (c,h,w)
        else:
            w = kernel.T                                      # (in, out) → (out, in)
        out[f"{prefix}.weight"] = _to_torch(w)
        out[f"{prefix}.bias"] = _to_torch(bias)
    return out


def params_to_jax(network, params: Dict[str, torch.Tensor]) -> dict:
    """Port state_dict → flax ``{"params": {...}}`` of numpy arrays."""
    tree = {}
    for fname, prefix, kind in _layer_map(network):
        w = params[f"{prefix}.weight"].detach().float().cpu().numpy()
        bias = params[f"{prefix}.bias"].detach().float().cpu().numpy()
        if kind == "conv":
            kernel = w.transpose(2, 3, 1, 0)                  # OIHW → HWIO
        elif kind == "flat":
            h, wd, c = network.torso_shape
            kernel = (w.T.reshape(c, h, wd, -1).transpose(1, 2, 0, 3)
                      .reshape(h * wd * c, -1))
        else:
            kernel = w.T
        tree[fname] = {"kernel": np.ascontiguousarray(kernel), "bias": bias.copy()}
    return {"params": tree}


def _moments(opt_state):
    """The optax state node that holds the second moment (``nu``: RMSProp's
    or Adam's state), searched depth first through the chain's tuples."""
    if hasattr(opt_state, "_fields"):
        if "nu" in opt_state._fields:
            return opt_state
        children = tuple(opt_state)
    elif isinstance(opt_state, (tuple, list)):
        children = opt_state
    else:
        return None
    for child in children:
        found = _moments(child)
        if found is not None:
            return found
    return None


def train_state_from_jax(network, optimizer, jax_state, seed: int = 0) -> TrainState:
    """A JAX ``TrainState`` (numpy or jax leaves) → the port's, on the CPU,
    every leaf in its own dtype.  ``optimizer`` is the port's (its
    ``float32_master`` and ``kind`` say what the optax state holds); the
    sampling stream reseeds from ``seed``."""
    opt = jax_state.opt_state
    out = {}
    if optimizer.float32_master:
        master, opt = opt            # with_float32_master: (master, inner)
        out["master"] = params_from_jax(network, master)
    moments = _moments(opt)
    if moments is None:
        raise ValueError("no second-moment state (nu) in the JAX optimizer state")
    out["nu"] = params_from_jax(network, moments.nu)
    if optimizer.kind == "adam":
        out["mu"] = params_from_jax(network, moments.mu)
        out["count"] = torch.tensor(int(np.asarray(moments.count)), dtype=torch.int32)
    return TrainState(params=params_from_jax(network, jax_state.params),
                      target_params=params_from_jax(network, jax_state.target_params),
                      opt_state=out, step=int(np.asarray(jax_state.step)), seed=int(seed))


def _flax_like(network, params, like) -> dict:
    """``params_to_jax`` with every leaf cast to the dtype of ``like``'s
    (a bf16 value survives the float32 round trip exactly)."""
    tree = params_to_jax(network, params)
    want = like["params"] if "params" in like else like

    def cast(node, ref):
        if isinstance(node, dict):
            return {k: cast(v, ref[k]) for k, v in node.items()}
        return node.astype(np.asarray(ref).dtype)

    out = cast(tree["params"], want)
    return {"params": out} if "params" in like else out


def train_state_to_jax(network, state: TrainState, template):
    """The port's ``TrainState`` → a JAX ``TrainState`` of numpy leaves, in
    the structure and dtypes of ``template`` (an initialised JAX state of
    the same network and optimizer), whose PRNG key it keeps."""
    opt = state.opt_state

    def moments(node):
        if hasattr(node, "_fields"):
            if "nu" in node._fields:
                fields = {"nu": _flax_like(network, opt["nu"], node.nu)}
                if "mu" in node._fields:
                    fields["mu"] = _flax_like(network, opt["mu"], node.mu)
                    fields["count"] = np.asarray(int(opt["count"]),
                                                 np.asarray(node.count).dtype)
                return node._replace(**fields)
            return node._replace(**{f: moments(getattr(node, f)) for f in node._fields})
        if isinstance(node, (tuple, list)):
            return type(node)(moments(c) for c in node)
        return node

    if "master" in opt:
        master, inner = template.opt_state
        new_opt = (_flax_like(network, opt["master"], master), moments(inner))
    else:
        new_opt = moments(template.opt_state)
    return dataclasses.replace(
        template,
        params=_flax_like(network, state.params, template.params),
        target_params=_flax_like(network, state.target_params, template.target_params),
        opt_state=new_opt,
        step=np.asarray(int(state.step), np.asarray(template.step).dtype),
    )
