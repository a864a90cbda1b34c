"""The benchmark's own tests, on the CPU at small sizes:

    python -m pytest -q benchmark/test_benchmark_cpu.py

The FLOP and byte arithmetic against hand counts, the whole-name import
check, the ring prefill against the generator's law, the percentile,
window and trace arithmetic, the check's control, and whole runs of each
cell (the card's look skipped, thread actors, a tiny ring) with the timed
path broken underneath, which must come out not correct.  The test marked
``gpu`` runs the control at a cell's own size and skips without a card.
"""

from __future__ import annotations

import json
import math
import os
import statistics

import numpy as np
import pytest
import torch

from benchmark import correct, harness, yardstick
from benchmark import reference as ref
from benchmark.prefill import columns, frame_chunk, frames_at

ROOT = harness.ROOT
TINY = ["replay.capacity=4096", "learner.steps_per_call=8", "learner.ingest_block=64",
        "learner.min_replay_mem_size=256", "actor.num_actors=4", "actor.mode=thread"]
NET = dict(obs_shape=(84, 84, 1), channels=(64, 64, 64), hidden=512, num_actions=4)


# -- arithmetic ---------------------------------------------------------------

def test_layer_macs_match_hand_counts():
    macs = dict(yardstick.dueling_layer_macs(**NET))
    assert macs == {"conv0": 20 * 20 * 64 * 8 * 8 * 1, "conv1": 9 * 9 * 64 * 4 * 4 * 64,
                    "conv2": 7 * 7 * 64 * 3 * 3 * 64, "value_hidden": 3136 * 512,
                    "adv_hidden": 3136 * 512, "value": 512, "advantage": 512 * 4}
    assert sum(macs.values()) == 11_966_976


def test_learner_step_flops_match_hand_count_and_torch_counter():
    # 3B forward rows, B backward rows at twice the forward less conv0's
    # input gradient: 32 * (10 * 11 966 976 - 2 * 1 638 400).
    assert yardstick.learner_step_flops(batch=32, **NET) == 3_724_574_720
    from torch.utils.flop_counter import FlopCounterMode

    w = ref.init_weights(0, NET["obs_shape"], NET["channels"], NET["hidden"],
                         NET["num_actions"], torch.device("cpu"))
    with FlopCounterMode(display=False) as fc:
        ref.q_values(w, torch.zeros((1, 84, 84, 1), dtype=torch.uint8))
    # The counter counts the convolutions and matrix products: 2 per MAC.
    assert fc.get_total_flops() == 2 * 11_966_976


@pytest.mark.parametrize("C,T,bytes_", [(2_000_000, 65_536, 8_524_288),
                                        (100_000, 32_768, 662_144)])
def test_sampler_byte_bound(C, T, bytes_):
    assert yardstick.sampler_bytes(C, T) == bytes_
    assert yardstick.sampler_bound_s(C, T) == pytest.approx(bytes_ / 3.35e12)


def test_sampler_bound_at_config3_is_0_00254_ms():
    assert yardstick.sampler_bound_s(2_000_000, 65_536) * 1e3 == pytest.approx(0.002545, abs=1e-6)


# -- the import check ---------------------------------------------------------

@pytest.mark.parametrize("modules,found", [
    ({"ape_x_dqn_tpu_torch", "ape_x_dqn_tpu_torch.ops.sampling", "torch"}, []),
    ({"ape_x_dqn_tpu", "torch"}, ["ape_x_dqn_tpu"]),
    ({"ape_x_dqn_tpu.ops.pallas.sampling"}, ["ape_x_dqn_tpu"]),
    ({"jax._src.core", "jaxlib.xla_client", "flax.linen"}, ["flax", "jax", "jaxlib"]),
    ({"jax_utils", "jaxtyping", "flaxen", "ape_x_dqn_tpu2"}, []),
])
def test_forbidden_modules_compare_whole_top_level_names(modules, found):
    assert harness.forbidden_modules(modules) == found


def test_the_harness_loads_no_forbidden_module():
    import subprocess
    import sys

    code = ("import sys; import benchmark.run, benchmark.harness, benchmark.correct, "
            "benchmark.control; from benchmark.harness import forbidden_modules; "
            "from ape_x_dqn_tpu_torch.runtime.async_pipeline import AsyncPipeline; "
            "print(forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


# -- percentiles, windows, traces -----------------------------------------------

def test_spread_uses_statistics_quantiles():
    v = [10.0, 11.0, 12.0, 13.0, 14.0, 15.0]
    q1, q2, q3 = statistics.quantiles(v, n=4)
    assert yardstick.spread(v) == pytest.approx((q3 - q1) / q2)


def test_histogram_percentile_interpolates_inside_the_bucket():
    edges = [0.0, 1.0, 2.0, 4.0, 8.0]
    counts = [0, 50, 40, 10]
    # rank 95 of 100 falls halfway into [4, 8): geometric midpoint.
    assert yardstick.histogram_percentile(counts, edges, 95.0) == pytest.approx(math.sqrt(32))
    assert yardstick.histogram_percentile(counts, edges, 50.0) == pytest.approx(2.0)
    assert math.isnan(yardstick.histogram_percentile([0, 0], [0.0, 1.0, 2.0], 50.0))


def test_latency_edges_follow_the_port_histogram_layout():
    from ape_x_dqn_tpu_torch.utils.metrics import LatencyHistogram

    h = LatencyHistogram()
    edges = yardstick.latency_edges(1e-5, 20, len(h._counts) - 1)
    assert len(edges) == len(h._counts) + 1
    for s in (3e-6, 2.5e-4, 0.0123, 1.7, 500.0):
        i = h._index(s)
        assert edges[i] <= s < edges[i + 1] or i == len(h._counts) - 1


def test_window_rate_counts_what_completed_inside_over_the_whole_window():
    log = [(0.0, 0), (1.0, 100), (2.0, 200), (3.0, 300), (4.0, 400)]
    assert yardstick.count_at(log, 2.5) == 200
    assert yardstick.count_at(log, -1.0) == 0
    assert yardstick.window_rate(log, 1.5, 3.5) == pytest.approx((300 - 100) / 2.0)


def test_union_and_trace_reduction():
    assert yardstick.union_of_spans([(0, 2), (1, 3), (5, 6)]) == 4
    ev = [
        {"cat": "cuda_runtime", "name": "cudaGraphLaunch", "ts": 10, "dur": 2, "tid": 7,
         "args": {"correlation": 1}},
        {"cat": "kernel", "name": "k_a", "ts": 12, "dur": 4, "args": {"correlation": 1}},
        {"cat": "kernel", "name": "sample_kernel", "ts": 16, "dur": 2,
         "args": {"correlation": 1}},
        {"cat": "cpu_op", "name": "aten::index_put_", "ts": 18, "dur": 6, "tid": 7},
        {"cat": "kernel", "name": "k_b", "ts": 22, "dur": 2, "args": {"correlation": 9}},
        {"cat": "cuda_runtime", "name": "cudaGraphLaunch", "ts": 25, "dur": 2, "tid": 7,
         "args": {"correlation": 2}},
        {"cat": "kernel", "name": "k_a", "ts": 29, "dur": 3, "args": {"correlation": 2}},
        {"cat": "kernel", "name": "lead", "ts": 1, "dur": 1, "args": {"correlation": 0}},
    ]
    assert yardstick.launch_device_starts(ev) == [12.0, 29.0]
    red = yardstick.reduce_trace(ev, 12.0, 29.0)
    # From the first launch's device start to the next one's: the second
    # launch's kernel lies outside, the host's gaps inside.
    assert red["busy_us"] == 8 and red["span_us"] == 17 and red["graph_kernels"] == 2
    assert red["device_records"] == 3
    assert red["idle_gaps"] == [("cudaGraphLaunch", 5.0), ("aten::index_put_", 4.0)]
    assert red["count_by_name"]["sample_kernel"] == 1
    assert yardstick.reduce_trace(ev, 40.0, 50.0) is None


# -- the prefill ----------------------------------------------------------------

def _law():
    with open(os.path.join(ROOT, "benchmark", "traffic", "full_ring_local.json")) as f:
        return json.load(f)["prefill"]


def _cfg(path, *sets):
    from ape_x_dqn_tpu_torch.config import load_config

    return load_config(os.path.join(ROOT, "benchmark", "configs", path), overrides=list(sets))


@pytest.mark.parametrize("config", ["config3_seaquest_2m.json", "config5_atari57_100k.json"])
def test_prefill_fills_the_ring_by_the_generator_law(config):
    from ape_x_dqn_tpu_torch.runtime.components import build_components

    from benchmark.prefill import prefill

    cfg = _cfg(config, "replay.capacity=600", "learner.steps_per_call=4",
               "learner.ingest_block=8", "learner.min_replay_mem_size=100",
               "actor.num_actors=2", "actor.mode=thread")
    comps = build_components(cfg, device="cpu")
    fused = comps.make_fused_learner()
    law = dict(_law(), frame_chunk=256)
    seed = 2**31 + 99
    layout = prefill(fused, seed, cfg, comps.num_actions, law)
    ring = fused.replay
    C, n = 600, 3
    assert fused.size == C
    cols = columns(seed, C, comps.num_actions, 0.99, n, law, torch.device("cpu"))
    mass = torch.pow(torch.clamp(cols["prio"], min=1e-12), 0.6)
    assert torch.equal(ring.mass, mass) and bool((ring.mass > 0).all())
    assert torch.equal(ring.action, cols["action"])
    assert torch.equal(ring.reward, cols["reward"])
    slots = torch.arange(C)
    want_obs = frames_at(seed, layout.obs_seq(slots), 256, (84, 84, 1), torch.device("cpu"))
    want_next = frames_at(seed, layout.next_seq(slots), 256, (84, 84, 1), torch.device("cpu"))
    if hasattr(ring, "frames"):
        assert layout.off == ring.frame_capacity - C - n
        Cf = ring.frame_capacity
        assert torch.equal(ring.frames[ring.obs_ref.long() % Cf], want_obs)
        assert torch.equal(ring.frames[ring.next_ref.long() % Cf], want_next)
        st = fused.stager.state_dict()
        assert st["s0_fseq"] == st["s0_shipped_f"] == Cf
    else:
        assert torch.equal(ring.obs, want_obs) and torch.equal(ring.next_obs, want_next)
    # A frame made again alone equals its chunk's row.
    assert torch.equal(frames_at(seed, torch.tensor([257]), 256, (84, 84, 1),
                                 torch.device("cpu"))[0],
                       frame_chunk(seed, 1, 256, (84, 84, 1), torch.device("cpu"))[1])
    # Rewards are discounted sums of n clipped steps; discounts 0 or γ^n.
    gn = torch.tensor(0.99 ** 3, dtype=torch.float32).item()
    assert set(torch.unique(ring.discount).tolist()) <= {0.0, gn}


def test_exact_sampling_law_and_is_weights():
    mass = torch.tensor([1.0, 0.0, 3.0, 4.0], dtype=torch.float64)
    u = torch.tensor([[0.5, 0.0]])
    t = ref.exact_targets(mass, u, 2)
    assert t.tolist() == [[2.0, 4.0]]
    # A target on a boundary takes the next slot, as side="right" does.
    assert ref.exact_indices(mass, t).tolist() == [[2, 3]]
    w = ref.is_weights(mass, torch.tensor([[0, 3]]), 1.0)
    assert w.tolist() == [[1.0, 0.25]]


def test_sample_gap_is_zero_on_the_exact_law_and_positive_off_it():
    g = torch.Generator().manual_seed(0)
    mass = torch.rand(1000, generator=g, dtype=torch.float64) + 0.1
    u = torch.rand((4, 8), generator=g)
    idx = ref.exact_indices(mass, ref.exact_targets(mass, u, 8))
    assert correct.sample_gap(mass, u, idx) == 0.0
    assert correct.sample_gap(mass, u, (idx + 1) % 1000) > 0.0


def test_restamp_gap_reads_the_last_wins_law():
    mass = torch.tensor([1.0, 2.0, 3.0], dtype=torch.float64)
    idx = torch.tensor([[0, 2], [2, 2]])
    prio = torch.tensor([[4.0, 5.0], [6.0, 7.0]])
    after = torch.tensor([4.0, 2.0, 7.0])
    assert correct.restamp_gap(mass, 1.0, idx, prio, after) == 0.0
    assert correct.restamp_gap(mass, 1.0, idx, prio, torch.tensor([4.0, 2.0, 6.0])) > 0.1


# -- the control and the faults --------------------------------------------------

def test_the_control_and_each_planted_fault_fail_the_check():
    limits = correct.load_limits()
    for wl in ("c5_fed_100k", "c3_central_2m"):
        cases = {r["case"]: r["numbers"] for r in
                 __import__("benchmark.control", fromlist=["readings"]).readings(
                     wl, 2**31 + 5, torch.device("cpu"), steps=4, capacity=4096)}
        for name in ("control", "half_batch", "lr_scaled", "decay_wrong", "sampler_altered",
                     "answer_altered", "state_unchanged"):
            assert not correct.judge(cases[name], limits), (wl, name, cases[name])
        if wl == "c3_central_2m":
            assert not correct.judge(cases["served_control"], limits)


def _run(wl, **kw):
    return harness.run_cell(wl, 2**31 + 4321, 2.0, False, device="cpu", overrides=TINY,
                            out=lambda s: None, err=lambda s: None, **kw)


@pytest.mark.parametrize("wl", ["c3_fed_2m", "c5_fed_100k", "c3_central_2m"])
def test_a_sound_run_is_correct(wl):
    res = _run(wl)
    assert res["correct"], res["checks"]
    assert res["metrics"]["learner_steps_per_s"]["value"] > 0
    assert list(res)[-1] == "checks"


def _state_unchanged(monkeypatch):
    from ape_x_dqn_tpu_torch.learner import train_step

    monkeypatch.setattr(train_step.Optimizer, "update_", lambda self, p, g, s: None)


def _half_batch(monkeypatch):
    from ape_x_dqn_tpu_torch.ops import losses

    loss = losses.td_loss

    def half(delta, is_weights=None, kind="huber", huber_kappa=1.0):
        n = delta.shape[0] // 2
        return loss(delta[:n], None if is_weights is None else is_weights[:n], kind,
                    huber_kappa)

    monkeypatch.setattr(losses, "td_loss", half)


def _answer_altered(monkeypatch):
    from ape_x_dqn_tpu_torch.ops import losses

    prio = losses.priorities_from_td

    def altered(delta, epsilon=1e-6):
        p = prio(delta, epsilon)
        return torch.cat([p[:1] + 1.0, p[1:]])

    monkeypatch.setattr(losses, "priorities_from_td", altered)


def _served_altered(monkeypatch):
    from ape_x_dqn_tpu_torch.serving.server import PolicyServer

    run_batch = PolicyServer._run_batch

    def altered(self, obs):
        actions, q, version = run_batch(self, obs)
        actions = actions.copy()
        actions[0] = int(np.argmin(q[0]))
        return actions, q, version

    monkeypatch.setattr(PolicyServer, "_run_batch", altered)


def _lr_scaled(monkeypatch):
    _optimizer_replaced(monkeypatch, learning_rate=1.25 * ref.LEARNING_RATE)


def _decay_wrong(monkeypatch):
    _optimizer_replaced(monkeypatch, rmsprop_decay=0.99)


def _optimizer_replaced(monkeypatch, **changes):
    import dataclasses

    from ape_x_dqn_tpu_torch.runtime import components

    make = components.make_optimizer
    monkeypatch.setattr(components, "make_optimizer",
                        lambda *a, **k: dataclasses.replace(make(*a, **k), **changes))


def _ingest_altered(monkeypatch):
    # A frame reference off by one where the learner writes a block into
    # the ring: the dedup ring's S_t one frame back, the plain ring's S_t
    # the block's previous row's.
    import dataclasses

    from ape_x_dqn_tpu_torch.runtime import fused_dedup, fused_learner

    add_dedup = fused_dedup.sharded_dedup_add_transitions
    add_plain = fused_learner.device_replay_add

    def dedup(state, obs_ref, *rest, **kw):
        return add_dedup(state, [r - 1 for r in obs_ref], *rest, **kw)

    def plain(state, t, *rest, **kw):
        return add_plain(state, dataclasses.replace(t, obs=torch.roll(t.obs, 1, 0)),
                         *rest, **kw)

    monkeypatch.setattr(fused_dedup, "sharded_dedup_add_transitions", dedup)
    monkeypatch.setattr(fused_learner, "device_replay_add", plain)


@pytest.mark.parametrize("wl", ["c3_fed_2m", "c5_fed_100k", "c3_central_2m"])
@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch, _answer_altered, _lr_scaled,
                                   _decay_wrong, _ingest_altered])
def test_a_run_with_the_timed_path_broken_is_not_correct(wl, fault, monkeypatch):
    fault(monkeypatch)
    assert not _run(wl)["correct"]


def test_a_central_run_with_the_served_params_altered_is_not_correct(monkeypatch):
    from ape_x_dqn_tpu_torch.serving.server import PolicyServer

    upload = PolicyServer._upload

    def altered(self, params):
        out, ready = upload(self, params)
        w = out["value.bias"]
        w.copy_(torch.nextafter(w, torch.full_like(w, math.inf)))
        return out, ready

    monkeypatch.setattr(PolicyServer, "_upload", altered)
    res = _run("c3_central_2m")
    assert not res["correct"]
    assert res["checks"]["served_params_gap"]["value"] > 0


def test_a_central_run_with_a_served_action_altered_is_not_correct(monkeypatch):
    _served_altered(monkeypatch)
    res = _run("c3_central_2m")
    assert not res["correct"]
    assert res["checks"]["served_greedy_gap"]["value"] > res["checks"]["served_greedy_gap"]["limit"]


# -- BENCHMARK.json and its files -------------------------------------------------

def test_every_entry_finds_its_files():
    bench = harness.load_benchmark()
    for c in bench["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            data = json.load(f)
        for key in c["reduced"]:
            assert key in data["_reduced"], key
    for w in bench["workloads"]:
        cell = harness.load_cell(w["name"])
        assert cell["end_to_end"] and cell["per_layer"]
        assert "setup_s" in {m["name"] for m in cell["end_to_end"]}
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert os.path.exists(os.path.join(ROOT, "benchmark", "metrics", f"{m['name']}.py"))
    assert set(correct.load_limits()) == {
        "sample_gap", "td_gap", "update_gap", "restamp_gap", "grad1_gap", "change3_gap",
        "ingest_rows_gap", "ingest_mass_gap", "served_params_gap", "served_q_gap",
        "served_greedy_gap"}


# -- on the card ------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the control at a cell's own size")
    return torch.device("cuda")


@pytest.mark.gpu
def test_the_control_fails_at_the_cells_own_size(card):
    from benchmark.control import readings

    limits = correct.load_limits()
    cases = {r["case"]: r["numbers"] for r in readings("c5_fed_100k", 12345, card)}
    assert not correct.judge(cases["control"], limits)
    assert all(np.isfinite(v) for v in cases["control"].values())
