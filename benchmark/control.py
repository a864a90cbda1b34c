"""The check's control, its planted faults and the program's readings, at
a cell's own size:

    python3 -m benchmark.control --workload NAME --seeds S [S ...] [--steps K]
        [--program-seeds N] [--witness]

For each seed it builds what a run's checked call starts from (the
weights, the ring's columns and frames, the uniforms) with the harness's
own generators, puts the plain reference in the program's place, and
compares it with the float32 reference exactly as ``correct.py`` compares
the program:

  * ``control``: the reference computed in float8 e4m3 (the step below
    the program's bfloat16 torso), on the exact law's slots;
  * ``half_batch``: the float32 reference whose loss takes the mean over
    the first half of the batch;
  * ``lr_scaled``: the float32 reference with its learning rate × 1.25;
  * ``decay_wrong``: the float32 reference with RMSProp's decay 0.99 (the
    common default) for the configured 0.95;
  * ``sampler_altered``: the float32 reference's outputs with the first
    step's 32 slots each moved to its neighbour;
  * ``answer_altered``: the float32 reference's outputs with the first
    row's priority raised by 1 where each step produces it;
  * ``state_unchanged``: the weights, a zero second moment and the
    prefill's priorities handed back as the call's result;
  * with ``--witness``, ``bf16_witness``: the reference with the program's
    bfloat16 torso, read as a program would be (how far bfloat16 alone
    carries the call's trajectory);
  * with central inference, ``served_control`` (float8 Q on served-size
    batches of the ring's frames) and ``served_altered`` (one row's action
    replaced by the row's worst).

``--program-seeds N`` adds, for N further seeds, the program's own
readings of the numbers its first eager steps give (``grad1_gap``,
``change3_gap``): the port's train step, built as the cell builds it, run
from the seed's weights over the exact law's first batches.  One JSON line
per seed and case.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from benchmark import correct
from benchmark import reference as ref
from benchmark.prefill import Layout, columns, frames_at, stream_seed

class _Cfg:
    """The few configuration values the check reads, from the cell's file
    (the same names as the port's config)."""

    def __init__(self, data: dict):
        class S:
            pass
        self.actor, self.replay = S(), S()
        self.actor.gamma = data["actor"]["gamma"]
        self.replay.priority_exponent = data["replay"]["priority_exponent"]


def cell_setup(workload: str, root: str) -> dict:
    from benchmark.harness import load_cell

    cell = load_cell(workload, root)
    with open(cell["config_file"]) as f:
        data = json.load(f)
    return {"cell": cell, "data": data, "cfg": _Cfg(data)}


def layout_of(data: dict, chunk: int) -> Layout:
    C, n = data["replay"]["capacity"], data["actor"]["num_steps"]
    if data["replay"].get("dedup"):
        F = int(round(C * data["replay"].get("frame_ratio", 1.25)))
        return Layout(capacity=C, n=n, off=F - C - n, chunk=chunk)
    return Layout(capacity=C, n=n, off=0, chunk=chunk)


def readings(workload: str, seed: int, device, steps=None, root=None,
             capacity=None, witness: bool = False) -> list:
    """Every case's compared numbers for one seed (see the module
    docstring); ``capacity`` shrinks the ring for a test."""
    from benchmark.harness import ROOT

    s = cell_setup(workload, root or ROOT)
    data, cfg, law = s["data"], s["cfg"], s["cell"]["traffic"]["prefill"]
    if capacity is not None:
        data["replay"]["capacity"] = capacity
    net = data["_net"]
    obs_shape = tuple(net["obs_shape"])
    K = steps or data["learner"]["steps_per_call"]
    B = data["learner"]["replay_sample_size"]
    layout = layout_of(data, int(law["frame_chunk"]))
    weights0 = ref.init_weights(seed, obs_shape, net["channels"], net["hidden"],
                                net["num_actions"], device)
    g = torch.Generator(device=device)
    g.manual_seed(stream_seed(seed, 4))
    u = torch.rand((data["learner"]["steps_per_call"], B), generator=g, device=device)[:K]
    cols = columns(seed, layout.capacity, net["num_actions"], cfg.actor.gamma,
                   layout.n, law, device)
    mass64 = torch.pow(torch.clamp(cols["prio"].double(), min=1e-12),
                       cfg.replay.priority_exponent)
    idx = ref.exact_indices(mass64, ref.exact_targets(mass64, u, B))
    beta = float(data["replay"]["is_exponent"])
    snap0 = {"indices": idx, "u": u, "beta": beta, "obs_shape": obs_shape}
    inp = correct.training_inputs(seed, cfg, net["num_actions"], law, layout, snap0, device)
    base = correct.follow(weights0, inp, K)
    alpha = cfg.replay.priority_exponent

    def as_program(run, indices=idx):
        prio = run["prio"]
        mass = mass64.to(torch.float32).clone()
        flat = indices.reshape(-1)
        m = torch.pow(torch.clamp(prio.reshape(-1), min=1e-12), alpha).to(torch.float32)
        order = torch.arange(flat.numel(), device=flat.device)
        last = torch.full((mass.numel(),), -1, dtype=torch.long, device=flat.device)
        last.scatter_reduce_(0, flat, order, reduce="amax")
        drawn = last >= 0
        mass[drawn] = m[last[drawn]]
        return {**snap0, "indices": indices, "loss": run["loss"], "prio": prio,
                "params": run["params"], "nu": run["nu"], "mass": mass, "eager": run["eager"]}

    out = []

    def case(name, snap):
        t0 = time.monotonic()
        detail = {}
        nums = correct.training_numbers(weights0, snap, inp, base, detail)
        out.append({"workload": workload, "seed": seed, "case": name, "numbers": nums,
                    "loss_gap": detail["loss_gap"],
                    "update_gap_worst_leaf": detail["update_gap_worst_leaf"],
                    "nu_gap_median_leaf": detail["nu_gap_median_leaf"],
                    "seconds": round(time.monotonic() - t0, 3)})

    case("control", as_program(correct.follow(weights0, inp, K, precision="fp8")))
    case("half_batch", as_program(correct.follow(weights0, inp, K, half_batch=True)))
    case("lr_scaled", as_program(correct.follow(weights0, inp, K, lr_scale=1.25)))
    case("decay_wrong", as_program(correct.follow(weights0, inp, K, decay=0.99)))
    if witness:
        case("bf16_witness", as_program(correct.follow(weights0, inp, K, precision="bf16")))
    moved = idx.clone()
    moved[0] = (moved[0] + 1) % layout.capacity
    case("sampler_altered", as_program(base, moved))
    altered = dict(base)
    altered["prio"] = base["prio"].clone()
    altered["prio"][:, 0] += 1.0
    case("answer_altered", as_program(altered))
    zeros = {k: torch.zeros_like(v) for k, v in weights0.items()}
    case("state_unchanged", {**as_program(base), "params": weights0, "nu": zeros,
                             "mass": mass64.to(torch.float32),
                             "eager": {"nu1": zeros, "params3": weights0}})
    if s["cell"]["traffic"].get("overrides", {}).get("actor.inference") == "central":
        out += served_readings(workload, seed, base["params"], layout, law, obs_shape, device)
    return out


def served_readings(workload, seed, params, layout, law, obs_shape, device,
                    batches: int = 48, rows: int = 32) -> list:
    """The served check's control and fault on batches of the ring's
    frames, served by the trained reference params."""
    g = torch.Generator(device=device)
    g.manual_seed(stream_seed(seed, 5))
    seqs = torch.randint(0, layout.capacity, (batches, rows), generator=g, device=device)
    recs = []
    for b in range(batches):
        obs = frames_at(seed, layout.obs_seq(seqs[b]), layout.chunk, obs_shape, device)
        with torch.no_grad(), ref.plain_math():
            q = ref.q_values(params, obs, "fp8")
        recs.append({"obs": obs.cpu().numpy(), "q": q.cpu().numpy(),
                     "actions": q.argmax(-1).cpu().numpy(), "params": params})
    out = [{"workload": workload, "seed": seed, "case": "served_control",
            "numbers": correct.served_numbers(recs)}]
    with torch.no_grad(), ref.plain_math():
        q = ref.q_values(params, torch.as_tensor(recs[0]["obs"]).to(device))
    altered = dict(recs[0])
    altered["actions"] = recs[0]["actions"].copy()
    altered["actions"][0] = int(q[0].argmin())
    fp32 = [{**r, "q": ref.q_values(params, torch.as_tensor(r["obs"]).to(device)
                                    ).detach().cpu().numpy()} for r in [altered]]
    out.append({"workload": workload, "seed": seed, "case": "served_altered",
                "numbers": correct.served_numbers(fp32)})
    return out


def program_readings(workload: str, seeds, device, root=None) -> list:
    """The program's ``grad1_gap`` and ``change3_gap`` for each seed: the
    port's train step (the ``update`` a cell's fused learner captures,
    built from the cell's configuration with a small ring and call, which
    the step does not depend on) run eagerly from the seed's weights and a
    fresh optimizer state over the exact law's first batches, against the
    reference's first steps over the same rows."""
    from ape_x_dqn_tpu_torch.config import load_config
    from ape_x_dqn_tpu_torch.runtime.components import build_components
    from benchmark.harness import ROOT, _clone, eager_steps

    s = cell_setup(workload, root or ROOT)
    data, cfg, law = s["data"], s["cfg"], s["cell"]["traffic"]["prefill"]
    sets = ["replay.capacity=4096", "learner.steps_per_call=8", "learner.ingest_block=64",
            "learner.min_replay_mem_size=256"]
    fused = build_components(load_config(s["cell"]["config_file"], overrides=sets),
                             device=device).make_fused_learner()
    update, st = fused.graphed_call._update, fused.state
    net = data["_net"]
    obs_shape = tuple(net["obs_shape"])
    B = data["learner"]["replay_sample_size"]
    layout = layout_of(data, int(law["frame_chunk"]))
    out = []
    for seed in seeds:
        t0 = time.monotonic()
        weights0 = ref.init_weights(seed, obs_shape, net["channels"], net["hidden"],
                                    net["num_actions"], device)
        with torch.no_grad():
            for k, w in weights0.items():
                st.params[k].copy_(w)
                st.target_params[k].copy_(w)
        state0 = {"params": _clone(st.params), "target_params": _clone(st.target_params),
                  "opt_state": {k: _clone(v) for k, v in st.opt_state.items()}}
        g = torch.Generator(device=device)
        g.manual_seed(stream_seed(seed, 4))
        u = torch.rand((data["learner"]["steps_per_call"], B), generator=g,
                       device=device)[:correct.CHECKED_STEPS]
        cols = columns(seed, layout.capacity, net["num_actions"], cfg.actor.gamma,
                       layout.n, law, device)
        mass64 = torch.pow(torch.clamp(cols["prio"].double(), min=1e-12),
                           cfg.replay.priority_exponent)
        idx = ref.exact_indices(mass64, ref.exact_targets(mass64, u, B))
        snap0 = {"indices": idx, "u": u, "beta": float(data["replay"]["is_exponent"]),
                 "obs_shape": obs_shape}
        inp = correct.training_inputs(seed, cfg, net["num_actions"], law, layout, snap0,
                                      device)
        prog = eager_steps(update, state0, correct.eager_batches(inp))
        base = correct.follow(weights0, inp, correct.CHECKED_STEPS)
        g1, c3 = correct.eager_gaps(weights0, prog, base["eager"],
                                    correct.kept_leaves(weights0, base))
        out.append({"workload": workload, "seed": seed, "case": "program",
                    "numbers": {"grad1_gap": max(g1.values()), "change3_gap": max(c3.values())},
                    "grad1_median_leaf": correct.median_leaf(g1),
                    "change3_median_leaf": correct.median_leaf(c3),
                    "seconds": round(time.monotonic() - t0, 3)})
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="benchmark.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--steps", type=int, default=None,
                   help="steps of the call followed (default: the config's K)")
    p.add_argument("--program-seeds", type=int, default=0,
                   help="seeds (after the last of --seeds) of the program's eager readings")
    p.add_argument("--witness", action="store_true",
                   help="also the bfloat16 reference read as a program")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("benchmark.control: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    for seed in args.seeds:
        for rec in readings(args.workload, seed, dev, args.steps, witness=args.witness):
            print(json.dumps(rec), flush=True)
    if args.program_seeds:
        more = [max(args.seeds) + 1 + i for i in range(args.program_seeds)]
        for rec in program_readings(args.workload, more, dev):
            print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
