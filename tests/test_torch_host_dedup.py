"""The port's host frame-dedup replay (``replay/dedup.DedupReplay``) against
the JAX package's, twin of ``tests/test_dedup.py``'s ``TestStoreEquivalence``,
``TestDedupEdges`` and ``TestDedupRuntimes``.

The same numpy-built chunk stream and the same sampler generators go
through both packages' ``DedupReplay`` (numpy sum-trees) and, materialized,
through the port's double-store: identical slots, indices, IS weights
(exact: both compute in float64 numpy) and frame bytes through a ring wrap,
frame death and a carry gap; snapshots and delta chains restore across the
packages both ways.  Then ``replay.dedup=true`` with host replay through
both runtimes, ``--device cpu``.
"""

from __future__ import annotations

import io

import numpy as np
import pytest

from ape_x_dqn_tpu.replay.dedup import DedupReplay as JDedupReplay
from ape_x_dqn_tpu.replay.sum_tree import SumTree as JSumTree
from ape_x_dqn_tpu.types import DedupChunk as JDedupChunk
from ape_x_dqn_tpu_torch.replay import native as tnative
from ape_x_dqn_tpu_torch.replay.buffer import PrioritizedReplay
from ape_x_dqn_tpu_torch.replay.dedup import DedupReplay
from ape_x_dqn_tpu_torch.replay.sum_tree import SumTree
from ape_x_dqn_tpu_torch.types import DedupChunk, materialize_dedup

OBS = (3, 3, 1)
COLUMNS = ("obs", "action", "reward", "discount", "next_obs")


def frame(seq: int) -> np.ndarray:
    """A frame whose content encodes its global sequence number."""
    return np.full(OBS, seq % 251, np.uint8)


def chunk_fields(source, chunk_seq, fbase, n_tx=4, carry=0, prev_frames=0, extras=0):
    """``tests/test_dedup.make_chunk``'s fields: ``n_tx + carry`` rows over
    ``n_tx + 1 + extras`` fresh frames, the carried rows first."""
    U = n_tx + 1 + extras
    m = n_tx + carry
    rng = np.random.default_rng(chunk_seq * 977 + source % 1000)
    return dict(
        frames=np.stack([frame(fbase + i) for i in range(U)]),
        obs_ref=np.concatenate([-np.arange(carry, 0, -1, dtype=np.int32),
                                np.arange(n_tx, dtype=np.int32)]),
        next_ref=np.concatenate([np.zeros(carry, np.int32),
                                 np.arange(1, n_tx + 1, dtype=np.int32)]),
        action=rng.integers(0, 4, m).astype(np.int32),
        reward=rng.normal(size=m).astype(np.float32),
        discount=np.full(m, 0.97, np.float32),
        source=source, chunk_seq=chunk_seq, prev_frames=prev_frames,
    )


def stream(n_chunks, source=11, n_tx=4, extras=True):
    """A contiguous single-source stream with cross-chunk carry (fields)."""
    out, fbase, prev_U = [], 0, 0
    for i in range(n_chunks):
        f = chunk_fields(source, i, fbase, n_tx=n_tx, carry=2 if i else 0,
                         prev_frames=prev_U, extras=int(extras and i % 3 == 2))
        out.append(f)
        fbase += f["frames"].shape[0]
        prev_U = f["frames"].shape[0]
    return out


def pair(capacity=64, frame_ratio=2.0):
    """(port, JAX) DedupReplay over numpy trees."""
    return (DedupReplay(capacity, OBS, sum_tree_cls=SumTree, frame_ratio=frame_ratio),
            JDedupReplay(capacity, OBS, sum_tree_cls=JSumTree, frame_ratio=frame_ratio))


def feed(replays, fields_list, prio_rng=None):
    """Add every chunk to every replay (port chunks to the port's, JAX chunks
    to the JAX one's); the returned slots must agree."""
    for f in fields_list:
        m = f["action"].shape[0]
        p = (np.abs(prio_rng.normal(size=m)) + 0.1) if prio_rng is not None else np.ones(m)
        slots = [r.add(p, (JDedupChunk if isinstance(r, JDedupReplay) else DedupChunk)(**f))
                 for r in replays]
        for s in slots[1:]:
            np.testing.assert_array_equal(s, slots[0])


def assert_same_batch(a, b):
    np.testing.assert_array_equal(np.asarray(a.indices), np.asarray(b.indices))
    np.testing.assert_array_equal(np.asarray(a.is_weights), np.asarray(b.is_weights))
    for f in COLUMNS:
        np.testing.assert_array_equal(np.asarray(getattr(a.transition, f)),
                                      np.asarray(getattr(b.transition, f)), err_msg=f)


def assert_same_state(s1, s2):
    assert set(s1) == set(s2), set(s1) ^ set(s2)
    for k in s1:
        a, b = np.asarray(s1[k]), np.asarray(s2[k])
        assert a.dtype == b.dtype and a.shape == b.shape, (k, a.dtype, b.dtype, a.shape, b.shape)
        np.testing.assert_array_equal(a, b, err_msg=k)


def npz_roundtrip(snap: dict) -> dict:
    buf = io.BytesIO()
    np.savez(buf, **snap)
    buf.seek(0)
    with np.load(buf) as z:
        return {k: z[k] for k in z.files}


class TestStoreEquivalence:
    def test_identical_samples_through_wrap(self):
        """40 chunks (~3-4× capacity) through both packages' DedupReplay and,
        materialized, the port's double-store: same slots, batches, IS
        weights and restamps."""
        td, jd = pair()
        ds = PrioritizedReplay(64, OBS, sum_tree_cls=SumTree)
        prev = {}
        prng = np.random.default_rng(0)
        for f in stream(40):
            p = np.abs(prng.normal(size=f["action"].shape[0])) + 0.1
            c = DedupChunk(**f)
            i1 = td.add(p, c)
            np.testing.assert_array_equal(i1, jd.add(p, JDedupChunk(**f)))
            np.testing.assert_array_equal(i1, ds.add(p, materialize_dedup(c, prev.get(11))))
            prev[11] = c
        assert td.size() == jd.size() == ds.size() == 64
        assert td.stats == jd.stats and td.stats["frame_dead"] == 0
        for trial in range(5):
            b1 = td.sample(16, beta=0.5, rng=np.random.default_rng(trial))
            assert_same_batch(b1, jd.sample(16, beta=0.5, rng=np.random.default_rng(trial)))
            assert_same_batch(b1, ds.sample(16, beta=0.5, rng=np.random.default_rng(trial)))
            upd = np.abs(np.random.default_rng(100 + trial).normal(size=16)) + 0.05
            for r in (td, jd, ds):
                r.update_priorities(b1.indices, upd)
        assert td.max_priority() == jd.max_priority() == pytest.approx(ds.max_priority())
        assert_same_state(td.state_dict(), jd.state_dict())

    def test_memory_halves(self):
        td, jd = pair(frame_ratio=1.25)
        ds = PrioritizedReplay(64, OBS, sum_tree_cls=SumTree)
        assert td.frames_nbytes() == jd.frames_nbytes()
        assert td.frames_nbytes() == pytest.approx(0.625 * ds.frames_nbytes(), rel=0.02)

    def test_default_tree_is_the_native_one(self):
        """As in JAX, the default sum-tree is the native C++ one, and it draws
        the slots the numpy tree draws."""
        a = DedupReplay(64, OBS)
        b = DedupReplay(64, OBS, sum_tree_cls=SumTree)
        assert isinstance(a._tree, tnative.NativeSumTree)
        feed([a, b], stream(20), np.random.default_rng(1))
        assert_same_batch(a.sample(16, rng=np.random.default_rng(3)),
                          b.sample(16, rng=np.random.default_rng(3)))


class TestDedupEdges:
    def _undersized(self):
        td, jd = pair(frame_ratio=0.5)
        feed([td, jd], stream(30, source=5, extras=False))
        return td, jd

    def test_frame_death_sweep_and_sample_consistency(self):
        """An undersized frame ring invalidates (never corrupts): the same
        slots die in both packages, and every sampled row's frames are its
        own insertion-time refs."""
        td, jd = self._undersized()
        assert td.stats == jd.stats and td.stats["frame_dead"] > 0
        np.testing.assert_array_equal(td._alive, jd._alive)
        for t in range(10):
            b = td.sample(8, rng=np.random.default_rng(t))
            assert_same_batch(b, jd.sample(8, rng=np.random.default_rng(t)))
            seqs, nxt = td._obs_seq[b.indices], td._next_seq[b.indices]
            assert (seqs >= td._fcount - td.frame_capacity).all(), "sampled a dead slot"
            np.testing.assert_array_equal(b.transition.obs, np.stack([frame(s) for s in seqs]))
            np.testing.assert_array_equal(b.transition.next_obs,
                                          np.stack([frame(s) for s in nxt]))

    def test_restamp_cannot_resurrect_dead_slot(self):
        td, jd = self._undersized()
        dead = np.nonzero(~td._alive[: td.size()])[0]
        assert dead.size, "expected frame-dead slots at ratio 0.5"
        for r in (td, jd):
            r.update_priorities(dead[:4], np.full(4, 9.9))
        assert (td._tree.get(dead[:4]) == 0.0).all()
        np.testing.assert_array_equal(td._tree.get(np.arange(64)), jd._tree.get(np.arange(64)))

    def test_carry_gap_drops_only_carried_rows(self):
        td, jd = pair(frame_ratio=1.25)
        c0 = chunk_fields(7, 0, 0)
        # chunk_seq jumps 0 -> 2: the 2 carry rows drop, the rest land.
        c2 = chunk_fields(7, 2, 5, carry=2, prev_frames=5)
        alien = chunk_fields(99, 5, 40, n_tx=3, carry=1, prev_frames=17)
        for r in (td, jd):
            cls = JDedupChunk if r is jd else DedupChunk
            assert len(r.add(np.ones(4), cls(**c0))) == 4
            assert len(r.add(np.ones(6), cls(**c2))) == 4
            assert len(r.add(np.ones(4), cls(**alien))) == 3
        assert td.stats == jd.stats == {"frame_dead": 0, "dropped_carry": 3}
        assert td.size() == jd.size() == 11
        assert_same_state(td.state_dict(), jd.state_dict())

    @pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
    def test_checkpoint_roundtrip_wrapped_ring_across_packages(self, direction):
        """A snapshot of a wrapped ring, through npz, restores in the other
        package; samples agree and a continuing source keeps its carry."""
        td = DedupReplay(32, OBS, sum_tree_cls=SumTree, frame_ratio=1.5)
        jd = JDedupReplay(32, OBS, sum_tree_cls=JSumTree, frame_ratio=1.5)
        fields = stream(26, source=5, extras=False)
        for i, f in enumerate(fields[:25]):
            p = np.full(f["action"].shape[0], 0.3 + 0.01 * i)
            td.add(p, DedupChunk(**f))
            jd.add(p, JDedupChunk(**f))
        src, dst = ((td, JDedupReplay(32, OBS, sum_tree_cls=JSumTree, frame_ratio=1.5))
                    if direction == "port_to_jax" else
                    (jd, DedupReplay(32, OBS, sum_tree_cls=SumTree, frame_ratio=1.5)))
        dst.load_state_dict(npz_roundtrip(src.state_dict()))
        assert_same_state(src.state_dict(), dst.state_dict())
        assert_same_batch(src.sample(16, rng=np.random.default_rng(5)),
                          dst.sample(16, rng=np.random.default_rng(5)))
        cls = JDedupChunk if isinstance(dst, JDedupReplay) else DedupChunk
        assert len(dst.add(np.ones(6), cls(**fields[25]))) == 6
        assert dst.stats["dropped_carry"] == 0

    def test_frame_capacity_mismatch_rejected(self):
        td = DedupReplay(32, OBS, sum_tree_cls=SumTree, frame_ratio=1.5)
        td.add(np.ones(4), DedupChunk(**chunk_fields(5, 0, 0)))
        snap = td.state_dict()
        with pytest.raises(ValueError, match="frame ring"):
            DedupReplay(32, OBS, sum_tree_cls=SumTree, frame_ratio=2.0).load_state_dict(snap)
        with pytest.raises(ValueError, match="frame ring"):
            JDedupReplay(32, OBS, sum_tree_cls=JSumTree, frame_ratio=2.0).load_state_dict(snap)
        double = PrioritizedReplay(32, OBS, sum_tree_cls=SumTree)
        with pytest.raises(ValueError, match="dedup"):
            td.load_state_dict(double.state_dict())

    def test_add_checks_sizes(self):
        td = DedupReplay(8, OBS, sum_tree_cls=SumTree, frame_ratio=1.0)
        with pytest.raises(ValueError, match="mismatch"):
            td.add(np.ones(3), DedupChunk(**chunk_fields(1, 0, 0)))
        with pytest.raises(ValueError, match="exceeds capacity"):
            td.add(np.ones(9), DedupChunk(**chunk_fields(1, 0, 0, n_tx=9)))
        with pytest.raises(ValueError, match="empty replay"):
            td.sample(4, rng=np.random.default_rng(0))

    @pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
    def test_delta_chain_restores_across_packages(self, direction):
        """base + deltas (with restamps and sweeps between them) written by one
        package apply in the other: keys, dtypes and shapes equal, the chain
        restores to the writer's state."""
        td, jd = pair(capacity=32, frame_ratio=1.0)
        writer, reader = (td, pair(32, 1.0)[1]) if direction == "port_to_jax" \
            else (jd, pair(32, 1.0)[0])
        fields = stream(24, source=3, extras=False)
        chain = []
        prng = np.random.default_rng(4)
        for k in range(6):
            feed([td, jd], fields[4 * k:4 * k + 4], prng)
            b = td.sample(8, rng=np.random.default_rng(k))
            upd = np.abs(prng.normal(size=8)) + 0.1
            td.update_priorities(b.indices, upd)
            jd.update_priorities(b.indices, upd)
            d_t, d_j = td.delta_state_dict(), jd.delta_state_dict()
            assert_same_state(d_t, d_j)
            chain.append(d_t if writer is td else d_j)
        assert "delta" not in chain[0] and all("delta" in d for d in chain[1:])
        reader.load_state_dict(npz_roundtrip(chain[0]))
        for d in chain[1:]:
            reader.apply_delta_state_dict(npz_roundtrip(d))
        assert_same_state(writer.state_dict(), reader.state_dict())
        with pytest.raises(ValueError, match="discontinuity"):
            reader.apply_delta_state_dict(chain[2])


def _host_dedup_cfg():
    from ape_x_dqn_tpu_torch.config import ApexConfig

    cfg = ApexConfig()
    cfg.env.name = "chain:5"
    cfg.network = "mlp"
    cfg.actor.num_actors = 4
    cfg.actor.flush_every = 8
    cfg.learner.min_replay_mem_size = 64
    cfg.learner.optimizer = "adam"
    cfg.replay.capacity = 2048
    cfg.replay.dedup = True
    return cfg


class TestDedupRuntimes:
    """``replay.dedup=true`` on host replay through both runtimes."""

    def test_single_process_driver_trains_on_dedup(self):
        from ape_x_dqn_tpu_torch.runtime.single_process import SingleProcessDriver

        driver = SingleProcessDriver(_host_dedup_cfg(), device="cpu")
        assert isinstance(driver.replay, DedupReplay)
        for _ in range(30):
            res = driver.run_iteration()
        assert driver.learner_step > 0
        assert np.isfinite(res.loss)
        assert driver.replay.stats == {"frame_dead": 0, "dropped_carry": 0}
        assert driver.replay.total_added > 0

    def test_async_pipeline_host_dedup_end_to_end(self):
        from ape_x_dqn_tpu_torch.runtime.async_pipeline import AsyncPipeline
        from ape_x_dqn_tpu_torch.utils.metrics import MetricLogger

        cfg = _host_dedup_cfg()
        cfg.actor.T = 100_000
        cfg.actor.sync_every = 16
        cfg.learner.publish_every = 10
        pipe = AsyncPipeline(cfg, logger=MetricLogger(stream=io.StringIO()), log_every=50,
                             device="cpu")
        result = pipe.run(learner_steps=60)
        assert result["step"] >= 60
        assert np.isfinite(result["learner/loss"])
        assert isinstance(pipe.comps.replay, DedupReplay)
        assert pipe.comps.replay.stats["dropped_carry"] == 0
        assert "replay_tier" not in result     # no hot budget, no tier
