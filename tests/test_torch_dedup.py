"""Frame-dedup emission and carry resolution of the port against the JAX
package, plus the config checks of the dedup paths (the host ``DedupReplay``, the
tiered store and the replay service's dedup, with the JAX package's
messages).

* ``CarryResolver`` (``replay/dedup.py``): the same chunk stream, with
  sequence gaps and source eviction, gives identical absolute seqs, keep
  masks, source records and ``dropped_carry``.
* The fleet's dedup emission at ε = 0 with carried weights: every
  ``DedupChunk`` equals the JAX fleet's in every field but ``source``
  (fresh random ids per fleet, in both packages), priorities within rtol
  1e-5 (float32 Q-values from two libraries); grouped emission included.
* ``materialize_dedup`` of the dedup stream equals the dense emission of
  the same fleet, and the JAX package's ``materialize_dedup``.
"""

from __future__ import annotations

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ape_x_dqn_tpu.actors import pool as jpool
from ape_x_dqn_tpu.envs import make_env as jmake_env
from ape_x_dqn_tpu.models import dueling as jdueling
from ape_x_dqn_tpu.replay.dedup import CarryResolver as JCarryResolver
from ape_x_dqn_tpu.types import DedupChunk as JDedupChunk
from ape_x_dqn_tpu.types import materialize_dedup as jmaterialize
from ape_x_dqn_tpu_torch.actors import pool as tpool
from ape_x_dqn_tpu_torch.config import ApexConfig, apply_overrides, load_config
from ape_x_dqn_tpu_torch.envs import make_env as tmake_env
from ape_x_dqn_tpu_torch.models import dueling as tdueling
from ape_x_dqn_tpu_torch.replay.dedup import CarryResolver
from ape_x_dqn_tpu_torch.types import DedupChunk, materialize_dedup
from ape_x_dqn_tpu_torch.weights import params_from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIELDS = ("frames", "obs_ref", "next_ref", "action", "reward", "discount")


def _chunk(src, seq, n_tx, carry, prev_frames, rng):
    U = n_tx + 1
    return dict(
        frames=rng.integers(0, 256, (U, 3), dtype=np.uint8),
        obs_ref=np.concatenate([-np.arange(carry, 0, -1), np.arange(n_tx)]).astype(np.int32),
        next_ref=np.concatenate([np.zeros(carry), np.arange(1, n_tx + 1)]).astype(np.int32),
        action=np.zeros(n_tx + carry, np.int32),
        reward=np.zeros(n_tx + carry, np.float32),
        discount=np.ones(n_tx + carry, np.float32),
        source=src, chunk_seq=seq, prev_frames=prev_frames,
    )


@pytest.mark.parametrize("max_sources", [4096, 3])
def test_carry_resolver_matches_jax(max_sources):
    """Six sources interleaved; some chunks skipped (a gap drops only the
    carried rows), some sent with a wrong prev_frames; with 3 records at
    most, the oldest half is evicted and a returning source counts as new."""
    rng = np.random.default_rng(0)
    jres, tres = JCarryResolver(max_sources), CarryResolver(max_sources)
    seqs, last_u = {}, {}
    base = 0
    for i in range(80):
        src = int(rng.integers(0, 6))
        seq = seqs.get(src, -1) + 1 + int(rng.random() < 0.15)   # a gap now and then
        seqs[src] = seq
        carry = 0 if seq == 0 else int(rng.integers(0, 4))
        prev = last_u.get(src, 0) + int(rng.random() < 0.1)      # a size mismatch
        kw = _chunk(src, seq, int(rng.integers(1, 6)), carry, prev, rng)
        last_u[src] = kw["frames"].shape[0]
        j = jres.resolve(JDedupChunk(**kw), base)
        t = tres.resolve(DedupChunk(**kw), base)
        for a, b in zip(t, j):
            np.testing.assert_array_equal(a, b)
        assert t[0].dtype == np.int64 and t[1].dtype == np.int64
        assert tres.sources == jres.sources
        base += kw["frames"].shape[0]
    assert tres.dropped_carry == jres.dropped_carry > 0


def _fleets(env, n_actors=3, groups=1, emission="overlapping", flush=4, dedup=True):
    jnet = jdueling.build_network("mlp", 2, hidden_sizes=(16,))
    obs_dim = jmake_env(env).observation_shape
    jparams = jnet.init(jax.random.PRNGKey(3), jnp.zeros((1, *obs_dim), jnp.uint8))
    tnet = tdueling.build_network("mlp", 2, obs_dim, hidden_sizes=(16,))
    tparams = params_from_jax(tnet, jax.device_get(jparams))
    kw = dict(n_step=3, gamma=0.9, epsilon=0.0, flush_every=flush, emission=emission,
              emit_dedup=dedup, emit_dedup_groups=groups)
    jfleet = jpool.ActorFleet([lambda: jmake_env(env)] * n_actors, jnet, **kw)
    tfleet = tpool.ActorFleet([lambda: tmake_env(env)] * n_actors, tnet, device="cpu", **kw)
    jfleet.sync_params(jpool.LocalParamSource(jparams))
    tfleet.sync_params(tpool.LocalParamSource(tparams))
    return jfleet, tfleet


def _assert_chunks_equal(tchunks, jchunks):
    assert len(tchunks) == len(jchunks)
    for tc, jc in zip(tchunks, jchunks):
        assert tc.actor_steps == jc.actor_steps
        np.testing.assert_allclose(tc.priorities, jc.priorities, rtol=1e-5, atol=1e-6)
        t, j = tc.transitions, jc.transitions
        assert isinstance(t, DedupChunk)
        for f in FIELDS:
            np.testing.assert_array_equal(getattr(t, f), np.asarray(getattr(j, f)), err_msg=f)
            assert getattr(t, f).dtype == np.asarray(getattr(j, f)).dtype, f
        assert (t.chunk_seq, t.prev_frames) == (j.chunk_seq, j.prev_frames)


@pytest.mark.parametrize("env,emission", [
    ("chain:10", "overlapping"),
    ("loop:5", "overlapping"),      # truncation extras in the frame list
    ("chain:10", "strided"),
])
def test_fleet_dedup_emission_matches_jax(env, emission):
    jfleet, tfleet = _fleets(env, emission=emission)
    jchunks, jstats = jfleet.collect(31)
    tchunks, tstats = tfleet.collect(31)
    assert tstats == jstats
    assert len(tchunks) == 7        # the first flush at step 7, then every 4
    _assert_chunks_equal(tchunks, jchunks)
    assert any(int(c.transitions.obs_ref.min()) < 0 for c in tchunks)  # carries


def test_grouped_dedup_emission_matches_jax():
    """Two groups of a 5-actor fleet: independent streams, each with its own
    source, chunk_seq and carry refs."""
    jfleet, tfleet = _fleets("loop:5", n_actors=5, groups=2)
    jchunks, _ = jfleet.collect(23)
    tchunks, _ = tfleet.collect(23)
    assert len(tchunks) == 2 * 5
    _assert_chunks_equal(tchunks, jchunks)
    sources = [c.transitions.source for c in tchunks]
    assert len(set(sources)) == 2 and sources[0] != sources[1]
    # bounds round(b·5/2): columns [0, 2) and [2, 5).
    assert [c.transitions.obs_ref.shape[0] for c in tchunks[:2]] == [4 * 2, 4 * 3]


def test_materialize_dedup_equals_dense_emission():
    """The same fleet seed, dedup and dense: the dedup stream decodes (port
    and JAX decoders) to exactly the dense chunks."""
    _, tdedup = _fleets("loop:5")
    _, tdense = _fleets("loop:5", dedup=False)
    dchunks, _ = tdedup.collect(31)
    nchunks, _ = tdense.collect(31)
    prev = None
    for dc, nc in zip(dchunks, nchunks):
        got = materialize_dedup(dc.transitions, prev)
        jgot = jmaterialize(JDedupChunk(**dc.transitions._asdict()),
                            None if prev is None else JDedupChunk(**prev._asdict()))
        for f in ("obs", "action", "reward", "discount", "next_obs"):
            np.testing.assert_array_equal(getattr(got, f), getattr(nc.transitions, f))
            np.testing.assert_array_equal(getattr(got, f), np.asarray(getattr(jgot, f)))
        np.testing.assert_array_equal(dc.priorities, nc.priorities)
        prev = dc.transitions
    with pytest.raises(ValueError, match="no previous chunk"):
        materialize_dedup(dchunks[1].transitions)


def test_dedup_frames_cut_the_frame_traffic():
    """Steady state ships F new frames per actor per flush against 2F dense."""
    _, tdedup = _fleets("chain:10")
    chunks, _ = tdedup.collect(31)
    N, F, n = 3, 4, 3
    assert chunks[0].transitions.frames.shape[0] == (F + n) * N   # first flush: all H rows
    assert all(c.transitions.frames.shape[0] == F * N for c in chunks[1:])


def test_fleet_sources_are_fresh_63_bit_ids():
    _, a = _fleets("chain:10", n_actors=4, groups=2)
    _, b = _fleets("chain:10", n_actors=4, groups=2)
    ids = a._source + b._source
    assert len(set(ids)) == 4 and all(0 <= s < 2**63 for s in ids)


@pytest.mark.parametrize("kw,message", [
    (dict(emit_dedup=True, flush_every=2), "flush_every >= num_steps"),
    (dict(emit_dedup=True, emit_dedup_groups=4), "exceeds the fleet's 3 actors"),
    (dict(emit_dedup_groups=2), "requires emit_dedup=True"),
    (dict(emit_dedup=True, emit_dedup_groups=0), "must be >= 1"),
])
def test_fleet_dedup_arguments_checked(kw, message):
    net = tdueling.build_network("mlp", 2, (10,), hidden_sizes=(8,))
    with pytest.raises(ValueError, match=message):
        tpool.ActorFleet([lambda: tmake_env("chain:10")] * 3, net, device="cpu", n_step=3,
                         **{"flush_every": 4, **kw})


# -- config ---------------------------------------------------------------


@pytest.mark.parametrize("override,message", [
    # The host dedup replay and the tiered store are ported: their keys are
    # checked with the JAX package's own messages (the next test holds them
    # equal to JAX's).
    ("replay.hot_frame_budget_bytes=-1", "hot_frame_budget_bytes must be >= 0"),
    ("replay.spill_span_frames=-1", "spill_span_frames must be >= 0"),
    ("replay.spill_watermark_high=1.5", "0 < low <= high <= 1"),
    ("replay.spill_watermark_low=0", "0 < low <= high <= 1"),
    ("replay.spill_watermark_high=0.5", "0 < low <= high <= 1"),   # below low 0.9
    ("learner.device_replay=true,replay.hot_frame_budget_bytes=1000000",
     "requires device_replay=False"),
    # The replay service is ported: its frame dedup (service_dedup) is an
    # accepted key, and attaching to it keeps replay.dedup learner-local.
    ("replay.service_dedup=true,replay.service_mode=attach,"
     "replay.service_endpoints=e.json,replay.dedup=true", "stay learner-local features"),
    ("learner.data_parallel=4", "multi-GPU learner.*ROADMAP item 8"),
    ("replay.frame_ratio=0", "frame_ratio must be positive"),
    ("learner.target_dtype=float16", "unknown target_dtype"),
])
def test_dedup_config_refusals_name_their_item(override, message):
    with pytest.raises(ValueError, match=message):
        apply_overrides(ApexConfig(), override.split(","))


@pytest.mark.parametrize("overrides", [
    ["replay.dedup=true", "replay.frame_compression=true"],
    ["replay.hot_frame_budget_bytes=-1"],
    ["replay.hot_frame_budget_bytes=1000000", "replay.frame_compression=true"],
    ["replay.hot_frame_budget_bytes=1000000", "learner.device_replay=true"],
    ["replay.spill_span_frames=-1"],
    ["replay.spill_watermark_high=0.5", "replay.spill_watermark_low=0.9"],
    ["replay.spill_watermark_low=0"],
    ["replay.spill_watermark_high=1.5"],
])
def test_host_dedup_and_tier_checks_are_the_jax_messages(overrides):
    from ape_x_dqn_tpu.config import ApexConfig as JApexConfig
    from ape_x_dqn_tpu.config import apply_overrides as japply

    with pytest.raises(ValueError) as jerr:
        japply(JApexConfig(), overrides)
    with pytest.raises(ValueError) as terr:
        apply_overrides(ApexConfig(), overrides)
    assert str(terr.value) == str(jerr.value)


def test_host_dedup_and_tier_keys_load_as_in_jax():
    from ape_x_dqn_tpu.config import ApexConfig as JApexConfig
    from ape_x_dqn_tpu.config import apply_overrides as japply

    overrides = ["replay.dedup=true", "replay.hot_frame_budget_bytes=33554432",
                 "replay.spill_dir=/data/spill", "replay.spill_span_frames=64",
                 "replay.spill_watermark_high=0.95", "replay.spill_watermark_low=0.5"]
    t, j = apply_overrides(ApexConfig(), overrides), japply(JApexConfig(), overrides)
    for key in ("dedup", "hot_frame_budget_bytes", "spill_dir", "spill_span_frames",
                "spill_watermark_high", "spill_watermark_low"):
        assert getattr(t.replay, key) == getattr(j.replay, key), key
    d, jd = ApexConfig().replay, JApexConfig().replay
    assert (d.hot_frame_budget_bytes, d.spill_dir, d.spill_span_frames,
            d.spill_watermark_high, d.spill_watermark_low) == (
        jd.hot_frame_budget_bytes, jd.spill_dir, jd.spill_span_frames,
        jd.spill_watermark_high, jd.spill_watermark_low)


@pytest.mark.parametrize("overrides,message", [
    (["learner.device_replay=true", "replay.dedup=true", "actor.flush_every=2"],
     "flush_every >= actor.num_steps"),
    (["learner.device_replay=true", "replay.dedup=true", "replay.frame_compression=true"],
     "frame_compression applies to the host replay only"),
    (["learner.optimizer=adam", "learner.second_moment_dtype=bfloat16"], "only supported for rmsprop"),
])
def test_dedup_config_checks_match_jax(overrides, message):
    with pytest.raises(ValueError, match=message):
        apply_overrides(ApexConfig(), overrides)


def test_config3_learner_and_replay_keys_load_except_data_parallel(tmp_path):
    with open(os.path.join(REPO, "configs", "config3_seaquest_256actors_2m.json")) as f:
        data = json.load(f)
    path = tmp_path / "config3.json"
    path.write_text(json.dumps(data))
    with pytest.raises(ValueError, match="data_parallel=4.*ROADMAP item 8"):
        load_config(str(path))
    data["learner"].pop("data_parallel")
    path.write_text(json.dumps(data))
    cfg = load_config(str(path))
    assert cfg.replay.dedup and cfg.replay.frame_ratio == 1.25
    assert cfg.learner.second_moment_dtype == cfg.learner.target_dtype == "bfloat16"
    assert cfg.learner.sample_ahead and cfg.learner.steps_per_call == 2048
    assert cfg.actor.mode == "process" and cfg.replay.capacity == 2_000_000
    none = apply_overrides(cfg, ["learner.target_dtype=none"])
    assert none.learner.target_dtype is None


def test_config3_on_host_replay_builds_a_dedup_replay(tmp_path):
    """Config3 with ``learner.device_replay=false`` (cut to a small ring and
    a small env here) builds the host ``DedupReplay``, tiered when a hot
    budget is set, with its spill directory resolved as JAX does."""
    from ape_x_dqn_tpu_torch.replay.dedup import DedupReplay
    from ape_x_dqn_tpu_torch.replay.tiered import TieredFrameRing
    from ape_x_dqn_tpu_torch.runtime.components import build_components, resolve_spill_dir

    with open(os.path.join(REPO, "configs", "config3_seaquest_256actors_2m.json")) as f:
        data = json.load(f)
    data["learner"].pop("data_parallel")
    path = tmp_path / "config3.json"
    path.write_text(json.dumps(data))
    cfg = apply_overrides(load_config(str(path)), [
        "learner.device_replay=false", "learner.sample_ahead=false",
        "env.name=chain:6", "network=mlp", "replay.capacity=4096",
        "learner.min_replay_mem_size=256", "actor.num_actors=8"])
    comps = build_components(cfg, device="cpu")
    assert type(comps.replay) is DedupReplay and comps.replay.tier is None
    assert comps.replay.frame_capacity == 5120
    spill = str(tmp_path / "spill")
    cfg = apply_overrides(cfg, ["replay.hot_frame_budget_bytes=4096", f"replay.spill_dir={spill}"])
    comps = build_components(cfg, device="cpu")
    assert isinstance(comps.replay.tier, TieredFrameRing)
    assert comps.replay.tier.store.path == os.path.join(spill, "frames.cold")
    cfg.replay.spill_dir = "auto"
    cfg.learner.checkpoint_every = 64
    cfg.learner.checkpoint_dir = str(tmp_path / "ck")
    assert resolve_spill_dir(cfg) == os.path.join(str(tmp_path / "ck"), "replay_spill")
