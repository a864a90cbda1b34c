"""Dueling Q-networks as ``nn.Module``s.

Port of ``ape_x_dqn_tpu/models/dueling.py``:
  * ``DuelingDQN``: Conv(8×8/4) → Conv(4×4/2) → Conv(3×3/1) → flatten → two
    ``hidden``-unit streams → value (1) + advantage (A); channels 64/64/64
    by default, ``nature`` = 32/64/64.
  * ``DuelingMLP`` for flat observations.
  * Q = V + (A − mean_a A), per row.
  * Observations arrive NHWC uint8, as in the JAX package, and are scaled
    by 1/255 in the compute dtype, then permuted to NCHW inside; an input
    that looks NCHW raises, as the JAX model does (:72-79).
  * Compute dtype bfloat16 by default with float32 heads (:63, :91-104);
    params stay float32 and are cast per use.
  * Init follows flax: lecun-normal (truncated normal, variance 1/fan_in)
    kernels and zero biases.

``apply_params(params, x)`` returns ``DuelingOutput(value, advantage, q)``
for a parameter dict in the module's ``state_dict`` layout; it reads only
its arguments, so the learner and actor threads can run one module with
their own tensors concurrently.  ``forward(x)`` applies the module's own
parameters.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Sequence

import torch
import torch.nn.functional as F
from torch import nn

_KERNELS = ((8, 4), (4, 2), (3, 1))  # (size, stride) of the three convs


class DuelingOutput(NamedTuple):
    value: torch.Tensor
    advantage: torch.Tensor
    q: torch.Tensor


def _dueling_aggregate(value: torch.Tensor, advantage: torch.Tensor) -> torch.Tensor:
    return value + advantage - advantage.mean(dim=-1, keepdim=True)


def _lecun_normal_(w: torch.Tensor, fan_in: int) -> None:
    # flax's lecun_normal: truncated normal on [-2σ, 2σ], σ rescaled so the
    # truncated distribution has variance 1/fan_in.
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std)


def _linear(fan_in: int, fan_out: int) -> nn.Linear:
    layer = nn.Linear(fan_in, fan_out)
    _lecun_normal_(layer.weight, fan_in)
    nn.init.zeros_(layer.bias)
    return layer


def _scale_input(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    if x.dtype == torch.uint8:
        return x.to(dtype) / 255.0
    return x.to(dtype)


def _dense(x: torch.Tensor, params: dict, name: str, dtype: torch.dtype) -> torch.Tensor:
    return F.linear(x.to(dtype), params[f"{name}.weight"].to(dtype),
                    params[f"{name}.bias"].to(dtype))


class DuelingDQN(nn.Module):
    """Convolutional dueling Q-network for NHWC image observations."""

    def __init__(self, num_actions: int, obs_shape: Sequence[int],
                 channels: Sequence[int] = (64, 64, 64), hidden: int = 512,
                 compute_dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        if len(channels) != len(_KERNELS):
            raise ValueError(
                f"channels must have exactly {len(_KERNELS)} entries, got {channels}"
            )
        h, w, c = obs_shape
        self.num_actions = num_actions
        self.compute_dtype = compute_dtype
        convs = []
        for ch, (k, s) in zip(channels, _KERNELS):
            conv = nn.Conv2d(c, ch, k, s)
            _lecun_normal_(conv.weight, c * k * k)
            nn.init.zeros_(conv.bias)
            convs.append(conv)
            h, w, c = (h - k) // s + 1, (w - k) // s + 1, ch
        if h < 1 or w < 1:
            raise ValueError(f"observation {tuple(obs_shape)} too small for the conv torso")
        self.convs = nn.ModuleList(convs)
        self.torso_shape = (h, w, c)  # NHWC of the flattened torso output
        flat = h * w * c
        self.value_hidden = _linear(flat, hidden)
        self.adv_hidden = _linear(flat, hidden)
        self.value = _linear(hidden, 1)
        self.advantage = _linear(hidden, num_actions)

    def forward(self, x: torch.Tensor) -> DuelingOutput:
        return self.apply_params(dict(self.named_parameters()), x)

    def apply_params(self, params: dict, x: torch.Tensor) -> DuelingOutput:
        if x.dim() != 4:
            raise ValueError(f"expected NHWC [B, H, W, C] observations, got shape {tuple(x.shape)}")
        if x.shape[1] <= 4 and x.shape[3] > 4 and x.shape[2] == x.shape[3]:
            raise ValueError(
                f"observations look NCHW (shape {tuple(x.shape)}); this framework uses "
                "NHWC [B, H, W, C] — transpose with x.permute(0, 2, 3, 1)"
            )
        dt = self.compute_dtype
        x = _scale_input(x, dt).permute(0, 3, 1, 2)
        for i, (_, stride) in enumerate(_KERNELS):
            x = F.relu(F.conv2d(x, params[f"convs.{i}.weight"].to(dt),
                                params[f"convs.{i}.bias"].to(dt), stride=stride))
        x = x.flatten(1)  # (c, h, w) order; weights.py permutes flax's (h, w, c)
        v = F.relu(_dense(x, params, "value_hidden", dt))
        a = F.relu(_dense(x, params, "adv_hidden", dt))
        value = _dense(v, params, "value", torch.float32)
        advantage = _dense(a, params, "advantage", torch.float32)
        return DuelingOutput(value, advantage, _dueling_aggregate(value, advantage))


class DuelingMLP(nn.Module):
    """Dueling Q-network for flat/vector observations."""

    def __init__(self, num_actions: int, obs_shape: Sequence[int],
                 hidden_sizes: Sequence[int] = (256, 256),
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_actions = num_actions
        self.compute_dtype = compute_dtype
        fan_in = math.prod(obs_shape)
        layers = []
        for h in hidden_sizes:
            layers.append(_linear(fan_in, h))
            fan_in = h
        self.hidden = nn.ModuleList(layers)
        self.value = _linear(fan_in, 1)
        self.advantage = _linear(fan_in, num_actions)

    def forward(self, x: torch.Tensor) -> DuelingOutput:
        return self.apply_params(dict(self.named_parameters()), x)

    def apply_params(self, params: dict, x: torch.Tensor) -> DuelingOutput:
        dt = self.compute_dtype
        x = _scale_input(x, dt).flatten(1)
        for i in range(len(self.hidden)):
            x = F.relu(_dense(x, params, f"hidden.{i}", dt))
        value = _dense(x, params, "value", torch.float32)
        advantage = _dense(x, params, "advantage", torch.float32)
        return DuelingOutput(value, advantage, _dueling_aggregate(value, advantage))


def build_greedy_apply(network: nn.Module) -> Callable:
    """Serving entry: ``(params, obs[B]) -> (actions[B] int32, q[B, A] f32)``,
    pure greedy argmax, no gradient."""

    @torch.no_grad()
    def greedy_apply(params, obs):
        q = network.apply_params(params, obs).q
        return torch.argmax(q, dim=-1).to(torch.int32), q

    return greedy_apply


def build_network(kind: str, num_actions: int, obs_shape: Sequence[int],
                  **kwargs) -> nn.Module:
    """Factory keyed by config string: {"conv", "nature", "mlp"}.  Unlike
    flax, torch layers need the input shape up front: ``obs_shape`` is the
    per-example NHWC (or flat) observation shape."""
    if kind == "conv":
        return DuelingDQN(num_actions, obs_shape, **kwargs)
    if kind == "nature":
        kwargs.setdefault("channels", (32, 64, 64))
        return DuelingDQN(num_actions, obs_shape, **kwargs)
    if kind == "mlp":
        return DuelingMLP(num_actions, obs_shape, **kwargs)
    raise ValueError(f"unknown network kind: {kind}")
