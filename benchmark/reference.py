"""The plain reference: the conv dueling Q-network, the double-Q learner
step with its RMSProp, and Ape-X's prioritized sampling law, in plain
PyTorch.  It imports nothing of the program.

It follows the published description (Horgan et al. 2018, the Ape-X
learner; the reference implementation's RMSProp, lr 0.00025/4, decay 0.95,
ε 1.5e-7 inside the square root, as ``optax.rmsprop``; global-norm clip
40; Huber loss with IS weights normalised by the batch's largest; priorities
|δ| + 1e-6) at float32 with TF32 off, except where the configuration
itself states a storage precision: the target network and RMSProp's
second moment are stored in bfloat16 (``learner.target_dtype``,
``learner.second_moment_dtype``), so their values are rounded to
bfloat16 here as well.

``precision="fp8"`` is the control: every input, weight and activation of
the torso (the three convolutions and the two hidden layers) is rounded to
float8 e4m3 with a per-tensor scale before its operation (gradients pass
straight through), the step below the bfloat16 torso the program computes.
``precision="bf16"`` is a witness, not a check: the torso's inputs,
weights and products in bfloat16 and the heads in float32, as the
program's network computes them, to show how far bfloat16 alone carries a
trajectory from the float32 one.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F

KERNELS = ((8, 4), (4, 2), (3, 1))
LEARNING_RATE = 0.00025 / 4
RMSPROP_DECAY = 0.95
RMSPROP_EPS = 1.5e-7
MAX_GRAD_NORM = 40.0
PRIORITY_EPS = 1e-6
HUBER_KAPPA = 1.0
_TRUNC = 0.87962566103423978   # std of a standard normal truncated to [-2, 2]


def weight_shapes(obs_shape: Sequence[int], channels: Sequence[int], hidden: int,
                  num_actions: int) -> Dict[str, Tuple[tuple, int]]:
    """name → (shape, fan_in), in the program's parameter naming (the
    layout its train state takes weights in)."""
    h, w, c = obs_shape
    out = {}
    for i, (ch, (k, s)) in enumerate(zip(channels, KERNELS)):
        out[f"convs.{i}.weight"] = ((ch, c, k, k), c * k * k)
        out[f"convs.{i}.bias"] = ((ch,), c * k * k)
        h, w, c = (h - k) // s + 1, (w - k) // s + 1, ch
    flat = h * w * c
    for name, fin, fout in (("value_hidden", flat, hidden), ("adv_hidden", flat, hidden),
                            ("value", hidden, 1), ("advantage", hidden, num_actions)):
        out[f"{name}.weight"] = ((fout, fin), fin)
        out[f"{name}.bias"] = ((fout,), fin)
    return out


def init_weights(seed: int, obs_shape, channels, hidden: int, num_actions: int,
                 device) -> Dict[str, torch.Tensor]:
    """Lecun-normal kernels (a normal truncated to ±2σ, rescaled to variance
    1/fan_in) and zero biases, drawn on ``device`` from ``seed`` in one
    uniform draw for every kernel."""
    from benchmark.prefill import stream_seed

    shapes = weight_shapes(obs_shape, channels, hidden, num_actions)
    kernels = [(k, s, fin) for k, (s, fin) in shapes.items() if k.endswith(".weight")]
    total = sum(math.prod(s) for _, s, _ in kernels)
    g = torch.Generator(device=device)
    g.manual_seed(stream_seed(seed, 3))
    u = torch.rand(total, generator=g, device=device, dtype=torch.float64)
    lo, hi = _normal_cdf(-2.0), _normal_cdf(2.0)
    z = torch.special.ndtri(lo + u * (hi - lo)).clamp_(-2.0, 2.0)
    out, off = {}, 0
    for name, shape, fin in kernels:
        n = math.prod(shape)
        std = math.sqrt(1.0 / fin) / _TRUNC
        out[name] = (z[off:off + n] * std).to(torch.float32).reshape(shape)
        off += n
    for name, (shape, _) in shapes.items():
        if name.endswith(".bias"):
            out[name] = torch.zeros(shape, dtype=torch.float32, device=device)
    return {k: out[k] for k in shapes}


def _normal_cdf(x: float) -> float:
    return 0.5 * (1.0 + math.erf(x / math.sqrt(2.0)))


def _fp8(x: torch.Tensor) -> torch.Tensor:
    """Per-tensor scaled float8 e4m3 rounding, gradients straight through."""
    amax = x.detach().abs().amax().clamp(min=1e-30)
    scale = 448.0 / amax
    q = (x.detach() * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale
    return x + (q - x.detach())


def q_values(params: Dict[str, torch.Tensor], obs: torch.Tensor,
             precision: str = "fp32") -> torch.Tensor:
    """Q = V + A − mean A for NHWC uint8 observations, [rows, actions]."""
    if precision == "bf16":
        def rnd(t):
            return t.to(torch.bfloat16)
        x = (obs.to(torch.bfloat16) / 255.0).permute(0, 3, 1, 2)
    else:
        rnd = _fp8 if precision == "fp8" else (lambda t: t)
        x = (obs.to(torch.float32) / 255.0).permute(0, 3, 1, 2)
    for i, (_, stride) in enumerate(KERNELS):
        x = F.relu(F.conv2d(rnd(x), rnd(params[f"convs.{i}.weight"]),
                            rnd(params[f"convs.{i}.bias"]), stride=stride))
    x = x.flatten(1)
    v = F.relu(F.linear(rnd(x), rnd(params["value_hidden.weight"]),
                        rnd(params["value_hidden.bias"]))).to(torch.float32)
    a = F.relu(F.linear(rnd(x), rnd(params["adv_hidden.weight"]),
                        rnd(params["adv_hidden.bias"]))).to(torch.float32)
    value = F.linear(v, params["value.weight"], params["value.bias"])
    adv = F.linear(a, params["advantage.weight"], params["advantage.bias"])
    return value + adv - adv.mean(dim=-1, keepdim=True)


def to_bf16(params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Values as a bfloat16 store holds them, back in float32."""
    return {k: v.to(torch.bfloat16).to(torch.float32) for k, v in params.items()}


class plain_math:
    """float32 matrix products and convolutions without TF32, for the
    reference's span; the flags are put back after."""

    def __enter__(self):
        self._saved = (torch.backends.cuda.matmul.allow_tf32,
                       torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        return self

    def __exit__(self, *exc):
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = self._saved


def learner_step(params, nu, target, obs, action, reward, discount, next_obs, weights,
                 precision: str = "fp32", half_batch: bool = False, branches: bool = False,
                 lr_scale: float = 1.0, decay: float = RMSPROP_DECAY):
    """One double-Q step, in place on ``params`` and ``nu`` (float32 values
    of the bfloat16 store).  Returns (loss, priorities [B], grads, extra).
    Planted faults: ``half_batch``, the loss's mean over the first half
    of the rows only; ``lr_scale``, the learning rate scaled; ``decay``,
    another RMSProp decay than the configured 0.95.  ``branches`` fills ``extra`` with each row's TD
    error under the online net's best and second-best action at S_{t+n},
    the margin between those two Q values over the row's largest |Q|, and
    the IS weights: where the margin is within rounding, either action is
    the double-Q target's."""
    B = action.shape[0]
    live = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    q_both = q_values(live, torch.cat([obs, next_obs], 0), precision)
    q, q_next_online = q_both[:B], q_both[B:]
    with torch.no_grad():
        q_next_target = q_values(target, next_obs, precision)
        best = torch.argmax(q_next_online, dim=-1)
        boot = torch.gather(q_next_target, -1, best[:, None])[:, 0]
        tgt = reward + discount * boot
    chosen = torch.gather(q, -1, action[:, None].long())[:, 0]
    delta = chosen - tgt
    extra = None
    if branches:
        with torch.no_grad():
            top = torch.topk(q_next_online, 2, dim=-1)
            boot2 = torch.gather(q_next_target, -1, top.indices[:, 1:2])[:, 0]
            scale = q_next_online.abs().amax(-1).clamp(min=1e-12)
            extra = {"delta": delta.detach(), "delta2": chosen.detach() - (reward + discount * boot2),
                     "margin": (top.values[:, 0] - top.values[:, 1]) / scale,
                     "weights": weights}
    ad = delta.abs()
    quad = torch.clamp(ad, max=HUBER_KAPPA)
    per = (0.5 * quad ** 2 + HUBER_KAPPA * (ad - quad)) * weights
    loss = per[: B // 2].mean() if half_batch else per.mean()
    grads = dict(zip(live, torch.autograd.grad(loss, list(live.values()))))
    with torch.no_grad():
        keys = list(grads)
        g = [grads[k] for k in keys]
        # The global-norm clip, without a host read: scale 1 under the bound.
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(g)))
        scale = torch.where(norm < MAX_GRAD_NORM, torch.ones_like(norm), MAX_GRAD_NORM / norm)
        g = torch._foreach_mul(g, scale)
        grads = dict(zip(keys, g))
        # ν ← ρ·ν + (1−ρ)·g², p ← p − lr·g/√(ν + ε), then ν stored as bfloat16.
        sq = torch._foreach_mul(g, g)
        nus = [nu[k] for k in keys]
        nu32 = torch._foreach_mul(nus, decay)
        torch._foreach_add_(nu32, sq, alpha=1.0 - decay)
        step = torch._foreach_add(nu32, RMSPROP_EPS)
        torch._foreach_rsqrt_(step)
        torch._foreach_mul_(step, g)
        torch._foreach_add_([params[k] for k in keys], step, alpha=-LEARNING_RATE * lr_scale)
        for k, v in zip(keys, nu32):
            nu[k].copy_(v.to(torch.bfloat16))
    return loss.detach(), ad.detach() + PRIORITY_EPS, grads, extra


def huber_loss(delta: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """The IS-weighted mean Huber loss of a batch's TD errors."""
    ad = delta.abs()
    quad = torch.clamp(ad, max=HUBER_KAPPA)
    return ((0.5 * quad ** 2 + HUBER_KAPPA * (ad - quad)) * weights).mean()


def exact_targets(mass64: torch.Tensor, u: torch.Tensor, batch: int) -> torch.Tensor:
    """The stratified targets of Ape-X's proportional sampling in float64:
    (b + u[k, b]) · total / B, clamped below the total."""
    total = mass64.sum()
    t = (torch.arange(batch, dtype=torch.float64, device=mass64.device)[None, :]
         + u.to(torch.float64)) * (total / batch)
    return torch.minimum(t, total * (1.0 - 1e-7))


def exact_indices(mass64: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """The slot whose interval of the float64 cumulative mass holds each
    target."""
    cdf = torch.cumsum(mass64, 0)
    return torch.clamp(torch.searchsorted(cdf, targets, right=True), max=mass64.numel() - 1)


def is_weights(mass64: torch.Tensor, idx: torch.Tensor, beta: float) -> torch.Tensor:
    """Importance weights (N·P(i))^−β over each batch's largest, float32."""
    probs = mass64[idx] / mass64.sum()
    w = torch.pow(mass64.numel() * probs, -beta)
    return (w / w.max(dim=-1, keepdim=True).values).to(torch.float32)
