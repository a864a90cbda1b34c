"""Param sources beyond the live ``ParamStore``: a checkpoint root.

Port of ``CheckpointParamSource`` in ``ape_x_dqn_tpu/serving/sources.py``
(:37-68).  The serving tier polls the same ``get(have_version) ->
(params, version)`` protocol the actor fleets do, so "attach to a live
trainer" and "watch a checkpoint dir" are one server with another source.
The version is the newest committed step (``utils/checkpoint.latest_step``:
the state leg lands last, so a half-written step is never visible), and
only the params subtree of its state leg is read: the server never holds
the optimizer state or the target net.  The ``PolicyServer``'s reload
uploads them to fresh device tensors on its copy stream.

The socket param source (the param hub) and the param tail are not part of
the port yet (ROADMAP item 1).
"""

from __future__ import annotations

import os
from typing import Any, Optional, Tuple

import numpy as np
import torch

from ape_x_dqn_tpu_torch.utils.checkpoint import latest_step, read_state_leg


class CheckpointParamSource:
    """A param source over a checkpoint root; version = training step.
    ``template`` (the network's params, e.g. ``build_components``' state)
    gives the names, shapes and dtypes each read is checked against."""

    def __init__(self, root: str, template: dict):
        self.root = root
        self._template = {k: (tuple(v.shape), v.dtype) for k, v in template.items()}

    @property
    def version(self) -> int:
        """Newest committed step (-1 when there is none)."""
        step = latest_step(self.root)
        return -1 if step is None else int(step)

    def get(self, have_version: int = -1) -> Optional[Tuple[Any, int]]:
        step = latest_step(self.root)
        if step is None or step <= have_version:
            return None
        # A newer step may commit between the probe and the read; the read
        # names the step it resolved, so the version stays exact.
        tree = read_state_leg(os.path.join(self.root, f"step_{step}"), subtree="params")
        params = {}
        for k, (shape, dtype) in self._template.items():
            v = tree[k]
            t = v if isinstance(v, torch.Tensor) else torch.from_numpy(np.asarray(v))
            if tuple(t.shape) != shape or t.dtype != dtype:
                raise ValueError(f"checkpoint param {k}: {t.dtype}{tuple(t.shape)} != "
                                 f"the served network's {dtype}{shape}")
            params[k] = t
        if set(tree) != set(self._template):
            raise ValueError(f"checkpoint params {sorted(tree)} != the served "
                             f"network's {sorted(self._template)}")
        return params, int(step)
