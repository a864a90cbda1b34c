"""The port's host ``PrioritizedReplay`` against the JAX package's.

Both get the same adds (wrapping the ring), raw and compressed, over the
numpy and the native tree.  The replay is numpy float64 in both packages,
so everything compares exactly: ``digest()`` dicts (crc over every live
column included), sampled indices and transitions, IS weights bit for bit,
last-write-wins priority updates, and a JAX ``state_dict()`` loaded into
the port (and back) reproduces the digest.
"""

from __future__ import annotations

import numpy as np
import pytest

from ape_x_dqn_tpu.replay import native as jnative
from ape_x_dqn_tpu.replay import sum_tree as jsum
from ape_x_dqn_tpu.replay.buffer import PrioritizedReplay as JReplay
from ape_x_dqn_tpu.types import NStepTransition as JTransition
from ape_x_dqn_tpu_torch.replay import PrioritizedReplay as TReplay
from ape_x_dqn_tpu_torch.replay import native as tnative
from ape_x_dqn_tpu_torch.replay import sum_tree as tsum
from ape_x_dqn_tpu_torch.replay.buffer import NotPortedError
from ape_x_dqn_tpu_torch.types import NStepTransition

OBS, A, CAP = (6, 6, 1), 4, 200
TREES = {"numpy": (jsum.SumTree, tsum.SumTree),
         "native": (jnative.NativeSumTree, tnative.NativeSumTree)}


def _adds(seed=0, n=7, m=47):
    """n chunks of m rows: 329 rows into 200 slots wraps the ring."""
    r = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        out.append(((r.random(m) * 2 + r.choice([0.0, 1e-13], m)).astype(np.float32), dict(
            obs=r.integers(0, 256, (m, *OBS), dtype=np.uint8),
            action=r.integers(0, A, m).astype(np.int32),
            reward=r.normal(size=m).astype(np.float32),
            discount=(0.97 * (r.random(m) > 0.1)).astype(np.float32),
            next_obs=r.integers(0, 256, (m, *OBS), dtype=np.uint8),
        )))
    return out


def _pair(tree, compressed, alpha=0.6):
    jcls, tcls = TREES[tree]
    kw = dict(priority_exponent=alpha, frame_compression=compressed)
    j = JReplay(CAP, OBS, sum_tree_cls=jcls, **kw)
    t = TReplay(CAP, OBS, sum_tree_cls=tcls, **kw)
    for prio, fields in _adds():
        ji = j.add(prio, JTransition(**fields))
        ti = t.add(prio, NStepTransition(**fields))
        np.testing.assert_array_equal(ti, ji)
    return j, t


CASES = [(tree, comp) for tree in TREES for comp in (False, True)]


@pytest.mark.parametrize("tree,compressed", CASES)
def test_adds_give_the_jax_digest(tree, compressed):
    j, t = _pair(tree, compressed)
    assert t.digest() == j.digest()
    assert t.digest()["count"] == 329 and t.digest()["cursor"] == 129
    assert t.size() == j.size() == CAP and t.total_added == j.total_added
    assert t.max_priority() == j.max_priority()
    assert t.frames_nbytes() == j.frames_nbytes()


@pytest.mark.parametrize("tree,compressed", CASES)
def test_sample_identical_indices_transitions_and_weights(tree, compressed):
    j, t = _pair(tree, compressed)
    jr, tr = np.random.default_rng(5), np.random.default_rng(5)
    for beta in (0.4, 0.7, 1.0):
        jb = j.sample(32, beta=beta, rng=jr)
        tb = t.sample(32, beta=beta, rng=tr)
        assert tb.indices.dtype == np.int32 and tb.is_weights.dtype == np.float32
        np.testing.assert_array_equal(tb.indices, jb.indices)
        assert tb.is_weights.tobytes() == jb.is_weights.tobytes()
        for f in ("obs", "action", "reward", "discount", "next_obs"):
            got, want = getattr(tb.transition, f), np.asarray(getattr(jb.transition, f))
            assert got.dtype == want.dtype and got.tobytes() == want.tobytes(), f
    jt, ji, jm, jtot, js = j.sample_with_mass(16, rng=np.random.default_rng(2))
    tt, ti, tm, ttot, ts = t.sample_with_mass(16, rng=np.random.default_rng(2))
    np.testing.assert_array_equal(ti, ji)
    assert tm.tobytes() == jm.tobytes() and ttot == jtot and ts == js


@pytest.mark.parametrize("tree", list(TREES))
def test_update_priorities_last_write_wins(tree):
    j, t = _pair(tree, False)
    r = np.random.default_rng(3)
    for _ in range(5):
        idx = r.integers(0, CAP, 64)
        idx[-1] = idx[0]                                    # a duplicate
        prio = r.random(64).astype(np.float32) * 3
        j.update_priorities(idx, prio)
        t.update_priorities(idx, prio)
        assert t.digest() == j.digest()
        last = np.power(max(float(prio[-1]), 1e-12), 0.6)
        assert t._tree.get(np.array([idx[0]]))[0] == last
    t.update_priorities(np.array([], np.int64), np.array([], np.float32))
    assert t.digest() == j.digest()


@pytest.mark.parametrize("tree,compressed", CASES)
def test_jax_state_dict_loads_into_the_port(tree, compressed):
    j, _ = _pair(tree, compressed)
    jcls, tcls = TREES[tree]
    fresh = TReplay(CAP, OBS, sum_tree_cls=tcls, frame_compression=compressed)
    fresh.add(np.ones(3, np.float32), NStepTransition(**{
        k: v[:3] for k, v in _adds(seed=8, n=1)[0][1].items()}))  # warm: cleared on load
    fresh.load_state_dict(j.state_dict())
    assert fresh.digest() == j.digest()
    # ...and the port's snapshot loads back into the JAX replay.
    back = JReplay(CAP, OBS, sum_tree_cls=jcls, frame_compression=compressed)
    back.load_state_dict(fresh.state_dict())
    assert back.digest() == j.digest()
    # A compressed snapshot restores into a raw store and the reverse.
    cross = TReplay(CAP, OBS, sum_tree_cls=tcls, frame_compression=not compressed)
    cross.load_state_dict(j.state_dict())
    assert cross.digest() == j.digest()


def test_partial_fill_and_errors():
    t = TReplay(CAP, OBS, sum_tree_cls=tsum.SumTree)
    j = JReplay(CAP, OBS, sum_tree_cls=jsum.SumTree)
    with pytest.raises(ValueError):
        t.sample(4, rng=np.random.default_rng(0))
    prio, fields = _adds(n=1)[0]
    t.add(prio, NStepTransition(**fields))
    j.add(prio, JTransition(**fields))
    assert t.digest() == j.digest() and t.size() == 47
    with pytest.raises(ValueError, match="exceeds capacity"):
        t.add(np.ones(CAP + 1), NStepTransition(**{
            k: np.repeat(v[:1], CAP + 1, 0) for k, v in fields.items()}))
    assert len(t.add(np.zeros(0), NStepTransition(**{k: v[:0] for k, v in fields.items()}))) == 0


def test_tiered_and_delta_requests_raise_by_name(tmp_path):
    """The tiered double-store is ported: it needs a spill directory (refused
    by message without one, as in JAX) and then holds the same slots, frames
    and digest as the JAX package's tiered replay, with spills and faults."""
    with pytest.raises(ValueError, match="spill_dir"):
        TReplay(CAP, OBS, sum_tree_cls=tsum.SumTree, hot_frame_budget_bytes=1 << 20)
    kw = dict(hot_frame_budget_bytes=4 * 64 * int(np.prod(OBS)), spill_span_frames=4)
    t = TReplay(CAP, OBS, sum_tree_cls=tsum.SumTree, spill_dir=str(tmp_path / "t"), **kw)
    j = JReplay(CAP, OBS, sum_tree_cls=jsum.SumTree, spill_dir=str(tmp_path / "j"), **kw)
    for prio, fields in _adds(n=4):
        np.testing.assert_array_equal(t.add(prio, NStepTransition(**fields)),
                                      j.add(prio, JTransition(**fields)))
        assert t.spill_cold() == j.spill_cold()
    for seed in range(3):
        a = t.sample(16, rng=np.random.default_rng(seed))
        b = j.sample(16, rng=np.random.default_rng(seed))
        np.testing.assert_array_equal(a.indices, b.indices)
        np.testing.assert_array_equal(a.transition.obs, b.transition.obs)
        np.testing.assert_array_equal(a.transition.next_obs, b.transition.next_obs)
    assert t.digest() == j.digest()
    stats = t.tier_stats()
    assert stats["spill_writes"] > 0 and stats["fault_reads"] > 0
    # The delta protocol is ported (tests/test_torch_checkpoint_inc.py): the
    # first request is a full base, and a non-delta is refused by name.
    t = TReplay(CAP, OBS, sum_tree_cls=tsum.SumTree)
    base = t.delta_state_dict()
    assert "delta" not in base and base["chain_mark"].tolist() == [0]
    with pytest.raises(ValueError, match="not a delta"):
        t.apply_delta_state_dict({})
    assert issubclass(NotPortedError, NotImplementedError)


def test_default_tree_is_native():
    assert isinstance(TReplay(8, (2,))._tree, tnative.NativeSumTree)
