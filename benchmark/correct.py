"""What decides ``correct``: the numbers the timed path's outputs are held
to, each against a limit of its own (``limits.json``).

Training (every cell): the learner's first fused call of the run, made in
set-up through the window's own call, learner and feed, with the
benchmark's weights, ring and uniforms.  After the window the reference
works out again, from the seed alone, the ring, the sampling law, the IS
weights and the K steps of the call, and compares:

  * ``sample_gap``: for every one of the call's K·B draws, how far (as a
    share of the total mass) the program's slot lies from the exact
    float64 target of the same uniform: 0 inside the slot's interval;
  * ``td_gap``: the first step's priorities |δ| + ε, the widest row gap
    over the median reference priority.  A row whose online Q values at
    S_{t+n} tie within ``TIE_MARGIN`` takes the double-Q target of
    whichever of the two actions the program's priority matches
    (``branch_choice``): the argmax of near-equal values flips with the
    program's bfloat16 rounding;
  * ``update_gap``: per parameter leaf, the gap between the norms of the
    program's and the reference's change over the call, over the larger
    of the reference leaf's and the median leaf's; the median leaf's gap
    is compared (over a call of 1024 or 2048 steps the bfloat16 and
    float32 trajectories drift apart, and which leaf drifts most changes
    from seed to seed: the worst leaf is reported beside it);
  * ``restamp_gap``: every slot's mass after the call against the
    last-wins restamp law applied to the program's own priorities (and to
    the prefill for slots no step drew), relative.

A fused call cannot be stopped after one or three steps, so the
optimizer's first steps are read from the program's own train step (the
``update`` its graphs captured), run eagerly from the state the call
started from, on the call's first three batches:

  * ``grad1_gap``: the first gradient as RMSProp holds it, √(ν/(1−ρ))
    after one step, per leaf as above; the worst leaf's gap is compared;
  * ``change3_gap``: the change of the parameters after three steps, the
    worst leaf's gap.

Leaves whose first reference gradient is under a thousandth of the median
leaf's are left out of the leaf gaps (none at these widths).  Reported,
not compared (no control or fault reads three times their sound
readings): the loss of the call's first three steps, and RMSProp's second
moment after the whole call.

Ingest (every cell): a seeded sample of the rows the actors handed the
learner's sink during the run, recorded as they came, against the ring
slots they landed in after the window: ``ingest_rows_gap`` counts the rows
whose action, return, discount or either frame differ bit for bit,
``ingest_mass_gap`` is the widest relative gap of the slot's mass from
the last-wins law (the row's own priority, or that of the last call that
drew the slot after it landed).

Serving (``c3_central_2m``): a sample of the batches the ``PolicyServer``
answered in the window, drawn from the seed, with the largest batches in
it.  ``served_params_gap`` counts the parameter elements of each served
version that differ bit for bit from what the learner published as that
version; the reference recomputes Q in float32 from the served
observations and the learner's published params, and compares
``served_q_gap`` (the widest |Q gap| of a row over the row's largest |Q|,
floored at the median row's) and ``served_greedy_gap`` (how far the
served action's reference Q lies below the row's best, on the same
scale).

The reference follows the program's sampled slots (each first held by
``sample_gap`` against the exact law): the float32 prefix sums of any
sampler move a draw next to a slot boundary to its neighbour, and one
row of 32 moved would swamp the comparison.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

import torch

from benchmark import reference as ref
from benchmark.prefill import columns, frames_at

LIMITS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "limits.json")
CHECKED_STEPS = 3
# The online net's two best Q values at S_{t+n} closer than this share of
# the row's largest |Q| make the double-Q target's action ambiguous at
# the program's bfloat16 (its served Q lay up to 0.019 of that scale from
# float32 on an H100): either action is the target's.
TIE_MARGIN = 0.05


def load_limits(path: str = LIMITS) -> Dict[str, float]:
    with open(path) as f:
        return {k: float(v) for k, v in json.load(f)["limits"].items()}


def leaf_gaps(prog: Dict[str, torch.Tensor], refd: Dict[str, torch.Tensor],
              keep) -> Dict[str, float]:
    """Per leaf, |‖program‖ − ‖reference‖| over the larger of the
    reference leaf's norm and the median leaf's."""
    norms = {k: float(torch.linalg.vector_norm(refd[k].double())) for k in keep}
    med = sorted(norms.values())[len(norms) // 2]
    return {k: abs(float(torch.linalg.vector_norm(prog[k].double())) - norms[k])
            / max(norms[k], med, 1e-30) for k in keep}


def median_leaf(gaps: Dict[str, float]) -> float:
    """The median leaf's gap (the upper median of an even count)."""
    v = sorted(gaps.values())
    return v[len(v) // 2]


def training_inputs(seed: int, cfg, num_actions: int, law: dict, layout, snap: dict,
                    device) -> dict:
    """What the reference needs of the run, made again from the seed:
    the float64 mass, the K·B draws' rows and IS weights."""
    C = layout.capacity
    cols = columns(seed, C, num_actions, float(cfg.actor.gamma), layout.n, law, device)
    alpha = float(cfg.replay.priority_exponent)
    mass64 = torch.pow(torch.clamp(cols["prio"].double(), min=1e-12), alpha)
    idx = snap["indices"].to(device).long()
    obs_shape = tuple(snap["obs_shape"])
    both = frames_at(seed, torch.stack([layout.obs_seq(idx), layout.next_seq(idx)]),
                     layout.chunk, obs_shape, device)
    return {
        "cols": cols, "mass64": mass64, "alpha": alpha, "idx": idx,
        "obs": both[0], "next_obs": both[1],
        "weights": ref.is_weights(mass64, idx, snap["beta"]),
    }


def sample_gap(mass64: torch.Tensor, u: torch.Tensor, idx: torch.Tensor) -> float:
    B = idx.shape[-1]
    t = ref.exact_targets(mass64, u.to(mass64.device), B)
    cdf = torch.cumsum(mass64, 0)
    total = cdf[-1]
    hi = cdf[idx]
    lo = torch.where(idx > 0, cdf[(idx - 1).clamp(min=0)], torch.zeros_like(hi))
    gap = torch.clamp(torch.maximum(lo - t, t - hi), min=0.0)
    return float(gap.max() / total)


def follow(weights0: Dict[str, torch.Tensor], inp: dict, steps: int,
           precision: str = "fp32", half_batch: bool = False, lr_scale: float = 1.0,
           decay: float = ref.RMSPROP_DECAY) -> dict:
    """The reference's ``steps`` steps over the call's rows, from the
    benchmark's weights: losses, priorities, final params and ν, ν after
    the first step and the params after ``CHECKED_STEPS``, and the first
    step's gradients.  ``half_batch``, ``lr_scale`` and ``decay`` plant
    the faults of ``reference.learner_step``."""
    params = {k: v.clone() for k, v in weights0.items()}
    target = ref.to_bf16(weights0)
    nu = {k: torch.zeros_like(v) for k, v in params.items()}
    cols, idx = inp["cols"], inp["idx"]
    losses, prios, first_grads, branches = [], [], None, []
    nu1 = params3 = None
    with ref.plain_math():
        for k in range(steps):
            row = idx[k]
            loss, prio, grads, extra = ref.learner_step(
                params, nu, target, inp["obs"][k], cols["action"][row], cols["reward"][row],
                cols["discount"][row], inp["next_obs"][k], inp["weights"][k],
                precision=precision, half_batch=half_batch, branches=k < CHECKED_STEPS,
                lr_scale=lr_scale, decay=decay)
            losses.append(loss)
            prios.append(prio)
            if extra is not None:
                branches.append(extra)
            if first_grads is None:
                first_grads = grads
                nu1 = {n: v.clone() for n, v in nu.items()}
            if k == min(steps, CHECKED_STEPS) - 1:
                params3 = {n: v.clone() for n, v in params.items()}
    return {"loss": torch.stack(losses), "prio": torch.stack(prios), "params": params,
            "nu": nu, "first_grads": first_grads, "branches": branches,
            "eager": {"nu1": nu1, "params3": params3}}


def branch_choice(extra: dict, prio_prog: torch.Tensor):
    """Per row, the reference's TD error under the double-Q target the
    program's priority matches: the best action's, or where the online
    net's top two Q values lie within ``TIE_MARGIN`` of each other, the
    second's if the program's |δ| is nearer it.  Returns (δ, rows that
    took the second)."""
    d1, d2 = extra["delta"].double(), extra["delta2"].double()
    p = prio_prog.double() - ref.PRIORITY_EPS
    second = (extra["margin"] < TIE_MARGIN) & ((p - d2.abs()).abs() < (p - d1.abs()).abs())
    return torch.where(second, d2, d1), second


def training_numbers(weights0: Dict[str, torch.Tensor], snap: dict, inp: dict,
                     refrun: dict, detail: Optional[dict] = None) -> Dict[str, float]:
    """The compared numbers of the checked call and of the program's first
    eager steps (``snap["eager"]``; see the module docstring); ``detail``,
    where given, receives every leaf's gaps and the uncompared readings."""
    dev = inp["mass64"].device
    gnorm = {k: float(torch.linalg.vector_norm(g.double()))
             for k, g in refrun["first_grads"].items()}
    keep = kept_leaves(weights0, refrun)
    loss_p = snap["loss"].to(dev).double()
    loss_r = refrun["loss"].double()
    gaps, seconds, delta0 = [], [], None
    for k, extra in enumerate(refrun["branches"]):
        delta, second = branch_choice(extra, snap["prio"][k].to(dev))
        lr = ref.huber_loss(delta, extra["weights"].double())
        gaps.append(float(abs(loss_p[k] - lr) / abs(lr)))
        seconds.append(int(second.sum()))
        delta0 = delta if delta0 is None else delta0
    prio_p = snap["prio"][0].to(dev).double()
    prio_r = delta0.abs() + ref.PRIORITY_EPS
    td_gap = float((prio_p - prio_r).abs().max() / prio_r.median())
    d_prog = {k: snap["params"][k].to(dev).float() - weights0[k] for k in keep}
    d_ref = {k: refrun["params"][k] - weights0[k] for k in keep}
    nu_prog = {k: snap["nu"][k].to(dev).float().clamp(min=0).sqrt() for k in keep}
    nu_ref = {k: refrun["nu"][k].clamp(min=0).sqrt() for k in keep}
    upd = leaf_gaps(d_prog, d_ref, keep)
    nug = leaf_gaps(nu_prog, nu_ref, keep)
    g1, c3 = eager_gaps(weights0, snap["eager"], refrun["eager"], keep)
    if detail is not None:
        rel = ((loss_p - loss_r).abs() / loss_r.abs()).cpu()
        K = rel.numel()
        detail["loss_gap"] = max(gaps)
        detail["update_gap_worst_leaf"] = max(upd.values())
        detail["nu_gap_median_leaf"] = median_leaf(nug)
        detail["nu_gap_worst_leaf"] = max(nug.values())
        detail["update_leaf_gaps"] = upd
        detail["nu_leaf_gaps"] = nug
        detail["grad1_leaf_gaps"] = g1
        detail["change3_leaf_gaps"] = c3
        detail["first_grad_norms"] = gnorm
        detail["loss_gap_at"] = {str(k): float(rel[k]) for k in
                                 sorted({0, 1, 2, 15, 127, K // 2, K - 1}) if k < K}
        detail["loss_gap_mean_last_256"] = float(rel[-256:].mean())
        detail["checked_steps"] = {"loss_gap": gaps, "second_action_rows": seconds,
                                   "tie_rows": [int((e["margin"] < TIE_MARGIN).sum())
                                                for e in refrun["branches"]]}
    return {
        "sample_gap": sample_gap(inp["mass64"], snap["u"], snap["indices"].to(dev).long()),
        "td_gap": td_gap,
        "update_gap": median_leaf(upd),
        "restamp_gap": restamp_gap(inp["mass64"], inp["alpha"], snap["indices"].to(dev).long(),
                                   snap["prio"].to(dev), snap["mass"].to(dev)),
        "grad1_gap": max(g1.values()),
        "change3_gap": max(c3.values()),
    }


def kept_leaves(weights0: Dict[str, torch.Tensor], refrun: dict) -> list:
    """The leaves whose first reference gradient is at least a thousandth
    of the median leaf's."""
    gnorm = {k: float(torch.linalg.vector_norm(g.double()))
             for k, g in refrun["first_grads"].items()}
    med_g = sorted(gnorm.values())[len(gnorm) // 2]
    return [k for k in weights0 if gnorm[k] >= 1e-3 * med_g]


def eager_gaps(weights0: Dict[str, torch.Tensor], prog: dict, refd: dict, keep) -> tuple:
    """Per leaf, the first gradient's and the three steps' change's gaps
    (``prog`` and ``refd``: ν after the first step, params after three)."""
    dev = weights0[keep[0]].device
    g1 = leaf_gaps(first_gradient(prog["nu1"], keep, dev),
                   first_gradient(refd["nu1"], keep, dev), keep)
    c3 = leaf_gaps({k: prog["params3"][k].to(dev).float() - weights0[k] for k in keep},
                   {k: refd["params3"][k] - weights0[k] for k in keep}, keep)
    return g1, c3


def first_gradient(nu1: Dict[str, torch.Tensor], keep, device) -> Dict[str, torch.Tensor]:
    """The first step's gradient as RMSProp holds it after that step, from
    a zero ν: √(ν / (1 − ρ)) with the configured decay ρ."""
    return {k: (nu1[k].to(device).float().clamp(min=0) / (1.0 - ref.RMSPROP_DECAY)).sqrt()
            for k in keep}


def eager_batches(inp: dict, steps: int = CHECKED_STEPS) -> list:
    """The first ``steps`` rows of the call as (obs, action, reward,
    discount, next_obs, IS weights, slots): the benchmark's own inputs,
    which the reference steps over too."""
    cols, idx = inp["cols"], inp["idx"]
    return [(inp["obs"][k], cols["action"][idx[k]], cols["reward"][idx[k]],
             cols["discount"][idx[k]], inp["next_obs"][k], inp["weights"][k], idx[k])
            for k in range(min(steps, idx.shape[0]))]


def restamp_gap(mass64: torch.Tensor, alpha: float, idx: torch.Tensor, prio: torch.Tensor,
                mass_after: torch.Tensor) -> float:
    """Every slot's mass after the call against the last-wins law: the
    prefill's mass where no step drew the slot, else the mass of the
    priority of the last step that drew it."""
    expect = mass64.clone()
    flat_idx = idx.reshape(-1)
    flat_p = torch.pow(torch.clamp(prio.reshape(-1).double(), min=1e-12), alpha)
    order = torch.arange(flat_idx.numel(), device=idx.device)
    last = torch.full((mass64.numel(),), -1, dtype=torch.long, device=idx.device)
    last.scatter_reduce_(0, flat_idx, order, reduce="amax")
    drawn = last >= 0
    expect[drawn] = flat_p[last[drawn]]
    return float(((mass_after.double() - expect).abs() / expect).max())


def served_numbers(records: list, published: Optional[dict] = None,
                   precision: str = "fp32") -> Optional[Dict[str, float]]:
    """Served Q rows against the reference (see the module docstring);
    None when no batch was recorded.  ``published`` maps a version to the
    params the learner published as it; without it (the control) the
    records' own params stand for them and no params gap is read."""
    if not records:
        return None
    q_gaps, greedy, scales, differ = [], [], [], 0
    seen = {}
    with ref.plain_math():
        for rec in records:
            params = rec["params"]
            if published is not None:
                v = rec["version"]
                if v not in seen:
                    seen[v] = params_differ(rec["params"], published.get(v))
                    differ += seen[v]
                params = published.get(v) or rec["params"]
            dev = params["value.bias"].device
            obs = torch.as_tensor(rec["obs"]).to(dev)
            with torch.no_grad():
                q_ref = ref.q_values(params, obs, precision).double()
            q_srv = torch.as_tensor(rec["q"]).to(dev).double()
            act = torch.as_tensor(rec["actions"]).to(dev).long()
            scale = q_ref.abs().amax(-1)
            scales.append(scale)
            q_gaps.append((q_srv - q_ref).abs().amax(-1))
            best = q_ref.amax(-1)
            greedy.append(best - torch.gather(q_ref, -1, act[:, None])[:, 0])
    scale = torch.cat(scales)
    floor = torch.clamp(scale, min=float(scale.median()))
    out = {
        "served_q_gap": float((torch.cat(q_gaps) / floor).max()),
        "served_greedy_gap": float((torch.cat(greedy) / floor).max()),
    }
    if published is not None:
        out["served_params_gap"] = float(differ)
    return out


def params_differ(served: Dict[str, torch.Tensor], published: Optional[dict]) -> int:
    """Elements of the served params that differ bit for bit from the
    published ones (every element, where the version was never published
    or a leaf's shape or type differs)."""
    total = sum(v.numel() for v in served.values())
    if published is None or set(published) != set(served):
        return total
    n = 0
    for k, v in served.items():
        p = published[k].to(v.device)
        if p.shape != v.shape or p.dtype != v.dtype:
            n += v.numel()
        else:
            n += int((_bits(v) != _bits(p)).sum())
    return n


def _bits(t: torch.Tensor) -> torch.Tensor:
    """A tensor's bit patterns as integers of its width."""
    width = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}[t.element_size()]
    return t.detach().contiguous().view(width)


INGEST_FIELDS = ("action", "reward", "discount", "obs", "next_obs")


def ingest_numbers(rows: dict, ring: dict, calls: list, alpha: float, capacity: int,
                   detail: Optional[dict] = None) -> Dict[str, float]:
    """The recorded rows (``rows``: each field [R, ...] as the sink got it,
    ``a`` its place in the order the learner accepted rows, ``prio`` its
    priority) against their ring slots read after the window (``ring``:
    the same fields, ``slot`` and ``mass``).  ``calls``: (rows the learner
    had ingested before the call, the call's sampled slots [K, B], its
    priorities [K, B]) for every call after the rows began: a row's mass
    follows the last call that drew its slot after it landed, else its own
    priority.  NaN where no recorded row was judged."""
    R = len(rows["a"])
    if R == 0:
        return {"ingest_rows_gap": float("nan"), "ingest_mass_gap": float("nan")}
    bad = torch.zeros(R, dtype=torch.bool)
    for f in INGEST_FIELDS:
        a, b = torch.as_tensor(rows[f]), torch.as_tensor(ring[f])
        bad |= (_bits(a) != _bits(b)).reshape(R, -1).any(dim=1)
    a = torch.as_tensor(rows["a"]).long()
    slots = torch.as_tensor(ring["slot"]).long()
    prio = torch.as_tensor(rows["prio"]).double()
    restamped = torch.zeros(R, dtype=torch.bool)
    for ingested_before, idx, p in calls:
        flat = idx.reshape(-1).long()
        last = torch.full((capacity,), -1, dtype=torch.long, device=flat.device)
        last.scatter_reduce_(0, flat, torch.arange(flat.numel(), device=flat.device),
                             reduce="amax")
        pos = last[slots.to(flat.device)].cpu()
        hit = (pos >= 0) & (a < ingested_before)
        if hit.any():
            prio[hit] = p.reshape(-1)[pos[hit].to(p.device)].double().cpu()
            restamped |= hit
    expect = torch.pow(torch.clamp(prio, min=1e-12), alpha)
    mass = torch.as_tensor(ring["mass"]).double()
    if detail is not None:
        detail["ingest_rows_judged"] = R
        detail["ingest_rows_restamped"] = int(restamped.sum())
    return {"ingest_rows_gap": float(bad.sum()),
            "ingest_mass_gap": float(((mass - expect).abs() / expect).max())}


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every compared number within its limit (a NaN fails)."""
    return all(numbers[k] <= limits[k] for k in numbers)
