"""``FusedDedupLearner`` and ``DedupStager`` of the port against
``ape_x_dqn_tpu/runtime/fused_dedup.py``, and the dedup path end to end.

* The stager's gating (a transition block ships only after its frames),
  carry gaps (only carried rows drop) and power-of-2 drains, the cases of
  the JAX package's ``tests/test_fused_dedup.py:39-230``; on a real fleet
  stream every frame and transition block equals the JAX stager's
  (``n_shards=1``), exactly.
* The learner's ring after ingest equals the JAX learner's ring exactly;
  its fused calls equal the port's double-store learner fed the
  materialised stream, exactly, with the same uniforms.
* ``AsyncPipeline`` runs the dedup ring with thread actors and with two
  worker processes (one intra-op thread each).  (The ``DXP`` record's
  decode against the JAX pool is in ``test_torch_shm_ring.py``.)
"""

from __future__ import annotations

import io
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ape_x_dqn_tpu.learner import train_step as jtrain
from ape_x_dqn_tpu.models import dueling as jdueling
from ape_x_dqn_tpu.runtime.fused_dedup import DedupStager as JDedupStager
from ape_x_dqn_tpu.runtime.fused_dedup import FusedDedupLearner as JFusedDedupLearner
from ape_x_dqn_tpu.types import DedupChunk as JDedupChunk
from ape_x_dqn_tpu_torch.actors import pool as tpool
from ape_x_dqn_tpu_torch.config import ApexConfig
from ape_x_dqn_tpu_torch.envs import make_env as tmake_env
from ape_x_dqn_tpu_torch.learner import train_step as ttrain
from ape_x_dqn_tpu_torch.models import dueling as tdueling
from ape_x_dqn_tpu_torch.replay.buffer import NotPortedError
from ape_x_dqn_tpu_torch.runtime.async_pipeline import AsyncPipeline
from ape_x_dqn_tpu_torch.runtime.fused_dedup import DedupStager, FusedDedupLearner
from ape_x_dqn_tpu_torch.runtime.fused_learner import FusedDeviceLearner
from ape_x_dqn_tpu_torch.types import DedupChunk, materialize_dedup
from ape_x_dqn_tpu_torch.utils.metrics import MetricLogger

OBS = (10, 5, 1)   # the catch board
TXN = ("obs_seq", "next_seq", "action", "reward", "discount", "prio")


def _chunk(src, seq, n_tx=4, carry=0, prev_frames=0, fbase=0):
    U = n_tx + 1
    frames = np.full((U, *OBS), (fbase + np.arange(U))[:, None, None, None] % 251, np.uint8)
    return dict(
        frames=frames,
        obs_ref=np.concatenate([-np.arange(carry, 0, -1), np.arange(n_tx)]).astype(np.int32),
        next_ref=np.concatenate([np.zeros(carry), np.arange(1, n_tx + 1)]).astype(np.int32),
        action=np.zeros(n_tx + carry, np.int32),
        reward=np.zeros(n_tx + carry, np.float32),
        discount=np.ones(n_tx + carry, np.float32),
        source=src, chunk_seq=seq, prev_frames=prev_frames,
    )


def _fleet_chunks(n_steps=96, num=4, seed=3, flush=8, dedup=True):
    """A port fleet's chunks at ε = 0.4 on catch (the port's own weights)."""
    net = tdueling.build_network("mlp", 3, OBS, hidden_sizes=(16,))
    fleet = tpool.ActorFleet([lambda: tmake_env("catch", seed=5)] * num, net, n_step=3,
                             flush_every=flush, seed=seed, emit_dedup=dedup, device="cpu")
    fleet.sync_params(tpool.LocalParamSource(dict(net.state_dict())))
    chunks, _ = fleet.collect(n_steps)
    return chunks


# -- the stager ---------------------------------------------------------------


def test_txn_blocks_gate_on_shipped_frames():
    st, jst = DedupStager(), JDedupStager(1)
    for s in (st, jst):
        s.add_chunk(np.ones(4), (DedupChunk if s is st else JDedupChunk)(**_chunk(1, 0)))
    # 5 frames staged, 4 transitions staged, nothing shipped yet.
    assert st.frame_blocks_available(4) == jst.frame_blocks_available(4) == 1
    assert st.txn_blocks_available(4) == jst.txn_blocks_available(4) == 0
    np.testing.assert_array_equal(st.take_frame_block(4), jst.take_frame_block(4)[0])
    assert st.txn_blocks_available(4) == 0       # the transitions need frame 4
    np.testing.assert_array_equal(st.take_frame_block(1), jst.take_frame_block(1)[0])
    assert st.txn_blocks_available(4) == jst.txn_blocks_available(4) == 1
    blk, jblk = st.take_txn_block(4), jst.take_txn_block(4)
    for f in TXN:
        np.testing.assert_array_equal(blk[f], jblk[f][0], err_msg=f)
    np.testing.assert_array_equal(blk["obs_seq"], [0, 1, 2, 3])
    np.testing.assert_array_equal(blk["next_seq"], [1, 2, 3, 4])


def test_carry_gap_drops_only_carried_rows():
    st = DedupStager()
    st.add_chunk(np.ones(4), DedupChunk(**_chunk(1, 0)))
    st.add_chunk(np.ones(6), DedupChunk(**_chunk(1, 3, carry=2, prev_frames=5)))
    assert st.dropped_carry == 2 and st.staged_rows == 8   # 4 + (6 − 2)
    # A contiguous continuation resolves its carries into the last chunk.
    st.add_chunk(np.ones(6), DedupChunk(**_chunk(1, 4, carry=2, prev_frames=5)))
    assert st.dropped_carry == 2 and st.staged_rows == 14
    # A respawned worker's fleet is a fresh source whose first chunk has no
    # carry refs: nothing more is dropped.
    st.add_chunk(np.ones(4), DedupChunk(**_chunk(2, 0)))
    assert st.dropped_carry == 2 and st.staged_rows == 18


def test_dropped_chunk_in_a_fleet_stream_drops_its_successors_carries():
    chunks = _fleet_chunks(64)
    st = DedupStager()
    kept = [c for i, c in enumerate(chunks) if i != 3]
    for c in kept:
        st.add_chunk(c.priorities, c.transitions)
    carried = int((chunks[4].transitions.obs_ref < 0).sum())
    assert carried > 0 and st.dropped_carry == carried
    assert st.rows_in == sum(len(c.priorities) for c in kept) - carried


@pytest.mark.parametrize("block", [32, 64])
def test_stager_blocks_match_jax_on_a_fleet_stream(block):
    """Frame blocks and transition blocks, full and power-of-2 tails,
    carved in the same order from the same stream: identical."""
    st, jst = DedupStager(), JDedupStager(1)
    for c in _fleet_chunks(96):
        st.add_chunk(c.priorities, c.transitions)
        jst.add_chunk(c.priorities, JDedupChunk(**c.transitions._asdict()))
    assert st.staged_rows == jst.staged_rows and st.fseq == jst.shards[0].fseq
    b = block
    while b >= 1:
        while st.frame_blocks_available(b):
            assert jst.frame_blocks_available(b)
            np.testing.assert_array_equal(st.take_frame_block(b), jst.take_frame_block(b)[0])
        while st.txn_blocks_available(b):
            assert jst.txn_blocks_available(b)
            got, want = st.take_txn_block(b), jst.take_txn_block(b)
            for f in TXN:
                np.testing.assert_array_equal(got[f], want[f][0], err_msg=f)
        assert jst.txn_blocks_available(b) == 0
        b >>= 1
    assert st.staged_rows == jst.staged_rows == 0


# -- the learner --------------------------------------------------------------


def _parts(seed=0):
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        net = tdueling.build_network("mlp", 3, OBS, hidden_sizes=(16,))
    opt = ttrain.make_optimizer("adam", learning_rate=1e-3)
    return net, opt, ttrain.init_train_state(net, opt, seed=seed, device="cpu")


def _learner(cls=FusedDedupLearner, **kw):
    net, opt, st = _parts()
    args = dict(capacity=2048, batch_size=8, steps_per_call=4, ingest_block=32,
                target_sync_freq=8, device="cpu")
    if cls is FusedDedupLearner:
        args["frame_ratio"] = 1.5
    args.update(kw)
    return cls(net, opt, st, OBS, **args)


def test_learner_trains_end_to_end():
    learner = _learner()
    for c in _fleet_chunks(96):
        learner.add_chunk(c.priorities, c.transitions)
    n = learner.ingest_staged()
    assert n > 0 and learner.size == n and n % 32 == 0
    for _ in range(3):
        metrics = learner.train(0.4)
    assert torch.isfinite(metrics.loss).all() and learner.step == 12
    assert not learner.supports_ingest_fold


def test_learner_refuses_dense_chunks_a_mesh_and_snapshots():
    learner = _learner()
    dense = _fleet_chunks(24, dedup=False)
    with pytest.raises(TypeError, match="DedupChunk"):
        learner.add_chunk(dense[0].priorities, dense[0].transitions)
    with pytest.raises(NotPortedError, match="ROADMAP item 8"):
        _learner(mesh=object())
    # Snapshots are ported; a snapshot of another layout is refused.
    with pytest.raises(ValueError, match="not a dedup-ring snapshot"):
        learner.load_state_dict({})
    with pytest.raises(ValueError, match="not a delta snapshot"):
        learner.apply_delta_state_dict(learner.state_dict())
    stage = learner.stager.state_dict()
    with pytest.raises(ValueError, match="ROADMAP item 8"):
        learner.stager.load_state_dict({**stage, "n_shards": 2})


def test_drain_ships_unaligned_tails():
    learner = _learner(ingest_block=64)
    for c in _fleet_chunks(40):   # 40 steps × 4 actors, not a multiple of 64
        learner.add_chunk(c.priorities, c.transitions)
    n_full = learner.ingest_staged()
    n_drain = learner.ingest_staged(drain=True)
    assert n_drain > 0 and learner.staged_rows == 0
    assert learner.size == n_full + n_drain


def test_learner_ring_matches_the_jax_learner_ring():
    """The JAX learner and the port's, fed one fleet stream and drained:
    identical rings (frames, refs mod Q, columns, counters; masses rtol
    1e-6)."""
    jnet = jdueling.DuelingMLP(num_actions=3, hidden_sizes=(16,))
    jopt = jtrain.make_optimizer("adam", learning_rate=1e-3)
    jstate = jtrain.init_train_state(jnet, jopt, jax.random.PRNGKey(0),
                                     jnp.zeros((1, *OBS), jnp.uint8))
    jl = JFusedDedupLearner(jnet, jopt, jstate, OBS, capacity=256, batch_size=8,
                            steps_per_call=4, ingest_block=32, frame_ratio=1.25)
    tl = _learner(capacity=256, frame_ratio=1.25)
    for c in _fleet_chunks(96):   # 372 rows into 256 slots and 320 frames
        jl.add_chunk(c.priorities, JDedupChunk(**c.transitions._asdict()))
        tl.add_chunk(c.priorities, c.transitions)
        assert tl.ingest_staged() == jl.ingest_staged()
    assert tl.ingest_staged(drain=True) == jl.ingest_staged(drain=True)
    jr, tr = jl._replay, tl.replay
    for f in ("frames", "obs_ref", "next_ref", "action", "reward", "discount"):
        np.testing.assert_array_equal(getattr(tr, f).numpy(), np.asarray(getattr(jr, f)), err_msg=f)
    np.testing.assert_array_equal(tr.mass.numpy() == 0, np.asarray(jr.mass) == 0)
    np.testing.assert_allclose(tr.mass.numpy(), np.asarray(jr.mass), rtol=1e-6)
    assert (tr.cursor, tr.count, tr.fcount) == (int(jr.cursor), int(jr.count), int(jr.fcount))
    assert tl.size == jl.size == 256 and tr.fcount > tr.frame_capacity  # both rings wrapped


@pytest.mark.parametrize("sample_ahead", [False, True])
def test_learner_matches_the_double_store_learner(sample_ahead):
    """One actor stream into ``FusedDedupLearner`` and, materialised, into
    ``FusedDeviceLearner``; the same uniforms: identical losses and params."""
    a = _learner(frame_ratio=2.0, sample_ahead=sample_ahead)
    b = _learner(FusedDeviceLearner, sample_ahead=sample_ahead)
    prev = None
    for c in _fleet_chunks(96):
        a.add_chunk(c.priorities, c.transitions)
        b.add_chunk(c.priorities, materialize_dedup(c.transitions, prev))
        prev = c.transitions
    na, nb = a.ingest_staged(drain=True), b.ingest_staged(drain=True)
    assert na == nb > 0
    gen = torch.Generator().manual_seed(7)
    for i in range(3):
        u = torch.rand((4, 8), generator=gen)
        ma, mb = a.train(0.4, u=u), b.train(0.4, u=u)
        assert torch.equal(ma.loss, mb.loss), f"call {i}"
    for k in a.state.params:
        assert torch.equal(a.state.params[k], b.state.params[k]), k
    assert torch.equal(a.replay.mass, b.replay.mass)


# -- the pipeline ---------------------------------------------------------------


def _pipe_cfg(mode):
    cfg = ApexConfig()
    cfg.network = "mlp"
    cfg.env.name = "chain:6"
    cfg.seed = 1
    cfg.actor.mode = mode
    cfg.actor.num_actors = 4
    cfg.actor.num_workers = 2
    cfg.actor.flush_every = 8
    cfg.actor.sync_every = 32
    cfg.learner.min_replay_mem_size = 256
    cfg.learner.replay_sample_size = 16
    cfg.learner.publish_every = 8
    cfg.learner.device_replay = True
    cfg.learner.sample_ahead = True
    cfg.learner.steps_per_call = 8
    cfg.learner.ingest_block = 64
    cfg.learner.second_moment_dtype = "bfloat16"
    cfg.learner.target_dtype = "bfloat16"
    cfg.replay.capacity = 2048
    cfg.replay.dedup = True
    return cfg.validate()


@pytest.mark.parametrize("mode", ["thread", "process"])
def test_async_pipeline_runs_the_dedup_ring(mode):
    cfg = _pipe_cfg(mode)
    pipe = AsyncPipeline(cfg, logger=MetricLogger(stream=io.StringIO()), log_every=1000,
                         device="cpu")
    assert isinstance(pipe.fused, FusedDedupLearner)
    # Two usable cores for the run: the spawned workers inherit them and
    # take one intra-op thread each (process_actors.worker_threads).
    cores = os.sched_getaffinity(0)
    os.sched_setaffinity(0, sorted(cores)[:2])
    try:
        final = pipe.run(learner_steps=64)
    finally:
        os.sched_setaffinity(0, cores)
    assert final["final"] and final["step"] >= 64 and np.isfinite(final["learner/loss"])
    fused = pipe.fused
    assert fused.size >= 256 and fused.stager.rows_in > 0
    assert fused.stager.dropped_carry == 0
    assert all(v.dtype == torch.bfloat16 for v in fused.state.target_params.values())
    assert all(v.dtype == torch.bfloat16 for v in fused.state.opt_state["nu"].values())
    if mode == "process":
        pool = pipe.worker.pool
        assert set(pool.last_versions) == {0, 1} and not pool.worker_errors
        assert all(r["threads"] == 1 and not r["cuda_initialized"]
                   for r in pool.worker_reports.values())
        assert not [n for n in os.listdir("/dev/shm") if f"_{os.getpid()}_" in n]
