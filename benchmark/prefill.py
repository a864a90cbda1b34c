"""The traffic generator's ring prefill: every slot of the device ring
filled from ``--seed`` on the card, through the port's own ring functions.

The data follow one law, shared by the prefill and by the plain
reference (which regenerates what it needs rather than reading the
program's ring):

  * frame ``f`` (a uint8 84×84×1 observation) is row ``f mod chunk`` of
    chunk ``f // chunk``, drawn uniformly by a ``torch.Generator`` on the
    card seeded from (seed, chunk index), so any frame can be made again
    alone with its chunk;
  * slot ``i`` of the ring holds the transition S_t = frame ``off + i``,
    S_{t+n} = frame ``off + i + n``, where ``off`` leaves the frame
    ring's slack (frame ratio 1.25) before the oldest referenced frame;
  * the per-slot columns (priority, action, n-step return, discount) come
    from one generator seeded from (seed, 1) in a fixed order of calls:
    priorities from the traffic file's law, actions uniform, each of the n
    rewards from the file's values and probabilities, and a terminal
    inside the n steps with the file's share (discount 0, else γ^n).

The layout copies ``ape_x_dqn_tpu_torch/profile_fused.py``'s ``_fill_dedup``
(every slot live, ``next_ref = obs_ref + n``), with seeded frames written
through ``dedup_device_add_frames`` / ``dedup_device_add_transitions`` (the
dedup ring) or ``device_replay_add`` (the plain ring).
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch

_MASK = (1 << 63) - 1


def stream_seed(seed: int, *tags: int) -> int:
    """A generator seed for one stream of a run: (seed, tags) mixed into
    63 bits (a large ``--seed`` stays distinct from its neighbours)."""
    x = int(seed) & _MASK
    for t in tags:
        x = (x * 6364136223846793005 + 1442695040888963407 + int(t)) & _MASK
    return x


def frame_chunk(seed: int, c: int, rows: int, obs_shape, device) -> torch.Tensor:
    """Chunk ``c`` of the frame law: ``rows`` uint8 frames."""
    g = torch.Generator(device=device)
    g.manual_seed(stream_seed(seed, 2, c))
    return torch.randint(0, 256, (rows, *obs_shape), generator=g, device=device,
                         dtype=torch.uint8)


def frames_at(seed: int, seqs: torch.Tensor, chunk: int, obs_shape, device) -> torch.Tensor:
    """Frames ``seqs`` (int64, any shape) of the law, made again chunk by
    chunk: [*seqs.shape, *obs_shape]."""
    flat = seqs.reshape(-1).to(device)
    out = torch.empty((flat.numel(), *obs_shape), dtype=torch.uint8, device=device)
    which = torch.div(flat, chunk, rounding_mode="floor")
    for c in torch.unique(which).tolist():
        sel = torch.nonzero(which == c).reshape(-1)
        block = frame_chunk(seed, c, chunk, obs_shape, device)
        out[sel] = block[flat[sel] - c * chunk]
    return out.reshape(*seqs.shape, *obs_shape)


def columns(seed: int, capacity: int, num_actions: int, gamma: float, n: int,
            law: dict, device) -> Dict[str, torch.Tensor]:
    """Per-slot priority, action, n-step return and discount (see the
    module docstring)."""
    g = torch.Generator(device=device)
    g.manual_seed(stream_seed(seed, 1))
    pri = law["priority"]
    if pri["law"] != "pareto":
        raise ValueError(f"unknown priority law {pri['law']!r}")
    u = torch.rand(capacity, generator=g, device=device, dtype=torch.float32)
    prio = float(pri["scale"]) * torch.pow(1.0 - u, -1.0 / float(pri["shape"]))
    action = torch.randint(0, num_actions, (capacity,), generator=g, device=device,
                           dtype=torch.int64).to(torch.int32)
    values = torch.tensor(law["step_reward"]["values"], dtype=torch.float32, device=device)
    cum = torch.cumsum(torch.tensor(law["step_reward"]["probs"], dtype=torch.float32,
                                    device=device), 0)
    ret = torch.zeros(capacity, dtype=torch.float32, device=device)
    for k in range(n):
        r = torch.rand(capacity, generator=g, device=device)
        pick = torch.clamp(torch.searchsorted(cum, r, right=True), max=len(values) - 1)
        ret += (gamma ** k) * values[pick]
    terminal = torch.rand(capacity, generator=g, device=device) < float(law["terminal_share"])
    discount = torch.where(terminal, torch.zeros_like(ret),
                           torch.full_like(ret, gamma ** n))
    return {"prio": prio, "action": action, "reward": ret, "discount": discount}


@dataclasses.dataclass(frozen=True)
class Layout:
    """Where the law put slot ``i``'s frames: S_t = frame ``off + i``,
    S_{t+n} = frame ``off + i + n``."""

    capacity: int
    n: int
    off: int
    chunk: int

    def obs_seq(self, slots: torch.Tensor) -> torch.Tensor:
        return slots.long() + self.off

    def next_seq(self, slots: torch.Tensor) -> torch.Tensor:
        return slots.long() + self.off + self.n


def prefill(fused, seed: int, cfg, num_actions: int, law: dict) -> Layout:
    """Fill every slot of ``fused``'s device ring (a ``FusedDedupLearner``
    or a ``FusedDeviceLearner``) from ``seed``, and bring the learner's
    host counters level with it.  Returns the layout the reference reads."""
    ring = fused.replay
    dev = ring.mass.device
    C, n, chunk = ring.capacity, int(cfg.actor.num_steps), int(law["frame_chunk"])
    obs_shape = tuple(ring.frames.shape[1:]) if hasattr(ring, "frames") \
        else tuple(ring.obs.shape[1:])
    cols = columns(seed, C, num_actions, float(cfg.actor.gamma), n, law, dev)
    alpha = float(cfg.replay.priority_exponent)
    if hasattr(ring, "frames"):
        layout = _prefill_dedup(fused, ring, seed, cols, C, n, chunk, obs_shape, alpha)
    else:
        layout = _prefill_plain(ring, seed, cols, C, n, chunk, obs_shape, alpha)
    # The learner's host count of ingested transitions gates its warm-up
    # (``learner.min_replay_mem_size``); a ring filled on the device has
    # no public way to raise it, so it is set, and read back through the
    # public ``size``.
    fused._size = C
    if fused.size != C:
        raise RuntimeError(f"the learner reports {fused.size} transitions after a "
                           f"prefill of {C}: its host count was not raised")
    return layout


def _prefill_dedup(fused, ring, seed, cols, C, n, chunk, obs_shape, alpha) -> Layout:
    from ape_x_dqn_tpu_torch.replay.device_dedup import (
        dedup_device_add_frames,
        dedup_device_add_transitions,
    )

    F = ring.frame_capacity
    if F < C + n:
        raise ValueError(f"frame ring {F} cannot hold {C} transitions n = {n} apart")
    for c0 in range(0, F, chunk):
        rows = min(chunk, F - c0)
        dedup_device_add_frames(ring, frame_chunk(seed, c0 // chunk, chunk, obs_shape,
                                                  ring.mass.device)[:rows])
    off = F - C - n
    ref = torch.arange(C, device=ring.mass.device, dtype=torch.int64) + off
    dedup_device_add_transitions(ring, ref.to(torch.int32), (ref + n).to(torch.int32),
                                 cols["action"], cols["reward"], cols["discount"],
                                 cols["prio"], priority_exponent=alpha)
    # The stager numbers the actors' frames from where the prefill left
    # the ring's frame counter, through its public snapshot interface.
    st = fused.stager.state_dict()
    st["s0_fseq"] = st["s0_shipped_f"] = F
    fused.stager.load_state_dict(st)
    return Layout(capacity=C, n=n, off=off, chunk=chunk)


def _prefill_plain(ring, seed, cols, C, n, chunk, obs_shape, alpha) -> Layout:
    from ape_x_dqn_tpu_torch.replay.device import device_replay_add
    from ape_x_dqn_tpu_torch.types import NStepTransition

    dev = ring.mass.device
    for s0 in range(0, C, chunk):
        rows = min(chunk, C - s0)
        seqs = torch.arange(s0, s0 + rows + n, device=dev)
        frames = frames_at(seed, seqs, chunk, obs_shape, dev)
        sl = slice(s0, s0 + rows)
        device_replay_add(ring, NStepTransition(
            obs=frames[:rows], action=cols["action"][sl], reward=cols["reward"][sl],
            discount=cols["discount"][sl], next_obs=frames[n:]), cols["prio"][sl], alpha)
    return Layout(capacity=C, n=n, off=0, chunk=chunk)
