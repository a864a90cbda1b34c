"""Carry network weights between the JAX package's flax params and the port.

``params_from_jax(network, flax_params)`` returns a ``state_dict``-layout
dict of float32 tensors for the port's ``network``;
``params_to_jax(network, params)`` is its inverse and returns a flax
``{"params": ...}`` tree of numpy arrays.  Both work on numpy arrays on
the flax side, so this module imports no JAX.  Conversions:
  * conv kernels HWIO ↔ OIHW;
  * Dense kernels (in, out) ↔ Linear weights (out, in);
  * the first Dense after the conv torso's flatten also has its input rows
    permuted: flax flattens NHWC as (h, w, c) (``models/dueling.py:94`` of
    the JAX package), the port flattens NCHW as (c, h, w).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from ape_x_dqn_tpu_torch.models.dueling import DuelingDQN, DuelingMLP


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


def params_from_jax(network, flax_params) -> Dict[str, torch.Tensor]:
    """flax ``{"params": {...}}`` (numpy or jax arrays) → port state_dict."""
    tree = flax_params["params"] if "params" in flax_params else flax_params
    out: Dict[str, torch.Tensor] = {}
    for fname, prefix, kind in _layer_map(network):
        kernel = np.asarray(tree[fname]["kernel"], np.float32)
        bias = np.asarray(tree[fname]["bias"], np.float32)
        if kind == "conv":
            w = kernel.transpose(3, 2, 0, 1)                  # HWIO → OIHW
        elif kind == "flat":
            h, wd, c = network.torso_shape
            w = (kernel.reshape(h, wd, c, -1).transpose(2, 0, 1, 3)
                 .reshape(c * h * wd, -1).T)                  # rows (h,w,c) → (c,h,w)
        else:
            w = kernel.T                                      # (in, out) → (out, in)
        out[f"{prefix}.weight"] = torch.from_numpy(np.array(w, np.float32, order="C"))
        out[f"{prefix}.bias"] = torch.from_numpy(bias.copy())
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
