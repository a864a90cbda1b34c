"""The port's native dedup core (``replay/native_dedup.NativeDedupReplay``
over its own ``_native/replay_core.cc``) against both packages, twin of
``tests/test_native_dedup.py``.

* ``n_stripes=1`` is bit-exact with the port's and the JAX package's numpy
  ``DedupReplay`` (slots, samples, frame bytes; IS weights to rtol 2e-7,
  libm's ``pow`` against numpy's) and with the JAX ``NativeDedupReplay``
  exactly, through a wrap, frame death, restamps, a carry gap and snapshots
  that restore across all four.
* Striped: the per-stripe law, the fan-out against the serial C call and
  duplicate last-wins against the JAX core, threaded adds.
* A failed build raises; nothing falls back to the numpy replay.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np
import pytest

from ape_x_dqn_tpu.replay.dedup import DedupReplay as JDedupReplay
from ape_x_dqn_tpu.replay.native_dedup import NativeDedupReplay as JNativeDedupReplay
from ape_x_dqn_tpu.replay.sum_tree import SumTree as JSumTree
from ape_x_dqn_tpu.types import DedupChunk as JDedupChunk
from ape_x_dqn_tpu_torch.replay import native_dedup as tnd
from ape_x_dqn_tpu_torch.replay.dedup import DedupReplay
from ape_x_dqn_tpu_torch.replay.native_dedup import NativeDedupReplay
from ape_x_dqn_tpu_torch.replay.sum_tree import SumTree
from ape_x_dqn_tpu_torch.types import DedupChunk

from _torch_harness import joined, port_deadline  # noqa: F401 — port_deadline is autouse

OBS = (5, 5, 1)
COLUMNS = ("obs", "action", "reward", "discount", "next_obs")


def frame(seq: int) -> np.ndarray:
    return np.full(OBS, seq % 251, np.uint8)


def chunk_fields(source, chunk_seq, fbase, n_tx=6, carry=0, prev_frames=0):
    rng = np.random.default_rng(chunk_seq * 131 + source)
    m = n_tx + carry
    return dict(
        frames=np.stack([frame(fbase + i) for i in range(n_tx + 1)]),
        obs_ref=np.concatenate([-np.arange(carry, 0, -1, dtype=np.int32),
                                np.arange(n_tx, dtype=np.int32)]),
        next_ref=np.concatenate([np.zeros(carry, np.int32),
                                 np.arange(1, n_tx + 1, dtype=np.int32)]),
        action=rng.integers(0, 4, m).astype(np.int32),
        reward=rng.normal(size=m).astype(np.float32),
        discount=np.full(m, 0.97, np.float32),
        source=source, chunk_seq=chunk_seq, prev_frames=prev_frames,
    )


def stream(n_chunks, n_tx=6, source=9):
    out, fbase, prev_U = [], 0, 0
    for i in range(n_chunks):
        f = chunk_fields(source, i, fbase, n_tx=n_tx, carry=2 if i else 0, prev_frames=prev_U)
        out.append(f)
        fbase += f["frames"].shape[0]
        prev_U = f["frames"].shape[0]
    return out


def _is_jax(r) -> bool:
    return type(r).__module__.startswith("ape_x_dqn_tpu.")


def add(r, p, fields):
    return r.add(p, (JDedupChunk if _is_jax(r) else DedupChunk)(**fields))


def four(capacity=64, frame_ratio=2.0):
    """(port native, JAX native, port numpy, JAX numpy)."""
    return (NativeDedupReplay(capacity, OBS, frame_ratio=frame_ratio),
            JNativeDedupReplay(capacity, OBS, frame_ratio=frame_ratio),
            DedupReplay(capacity, OBS, sum_tree_cls=SumTree, frame_ratio=frame_ratio),
            JDedupReplay(capacity, OBS, sum_tree_cls=JSumTree, frame_ratio=frame_ratio))


def assert_batch(a, b, exact_weights=True):
    np.testing.assert_array_equal(a.indices, b.indices)
    if exact_weights:
        np.testing.assert_array_equal(a.is_weights, b.is_weights)
    else:
        np.testing.assert_allclose(a.is_weights, b.is_weights, rtol=2e-7)
    for f in COLUMNS:
        np.testing.assert_array_equal(getattr(a.transition, f), getattr(b.transition, f), f)


def masses(r) -> np.ndarray:
    return np.array([r._lib.rc_get_mass(r._handle, s) for s in range(r.capacity)])


class TestNativeParity:
    def test_bit_exact_through_wrap(self):
        nat, jnat, ref, jref = reps = four()
        prng = np.random.default_rng(0)
        for f in stream(40):
            p = np.abs(prng.normal(size=f["action"].shape[0])) + 0.1
            slots = [add(r, p, f) for r in reps]
            for s in slots[1:]:
                np.testing.assert_array_equal(slots[0], s)
        assert all(r.size() == 64 for r in reps)
        assert nat.stats == jnat.stats == ref.stats == jref.stats
        assert nat.max_priority() == jnat.max_priority() == pytest.approx(ref.max_priority())
        for t in range(6):
            b = [r.sample(16, beta=0.5, rng=np.random.default_rng(t)) for r in reps]
            assert_batch(b[0], b[1])                       # same C core
            assert_batch(b[0], b[2], exact_weights=False)  # libm vs numpy pow
            assert_batch(b[2], b[3])
            upd = np.abs(np.random.default_rng(50 + t).normal(size=16)) + 0.1
            for r in reps:
                r.update_priorities(b[0].indices, upd)
        np.testing.assert_array_equal(masses(nat), masses(jnat))

    def test_frame_death_and_restamp_guard_parity(self):
        nat, jnat, ref, jref = reps = four(frame_ratio=0.5)
        for f in stream(30, n_tx=4):
            for r in reps:
                add(r, np.ones(f["action"].shape[0]), f)
        assert nat.stats == jnat.stats == ref.stats == jref.stats
        assert nat.stats["frame_dead"] > 0
        dead = np.nonzero(~ref._alive[: ref.size()])[0]
        assert dead.size
        for r in reps:
            r.update_priorities(dead[:4], np.full(4, 7.7))
        assert (masses(nat)[dead[:4]] == 0.0).all()
        np.testing.assert_array_equal(masses(nat), masses(jnat))
        b = [r.sample(16, rng=np.random.default_rng(1)) for r in reps]
        assert_batch(b[0], b[1])
        assert_batch(b[0], b[2], exact_weights=False)

    def test_carry_gap_parity(self):
        reps = four()
        for r in reps:
            add(r, np.ones(6), chunk_fields(3, 0, 0))
            add(r, np.ones(8), chunk_fields(3, 4, 7, carry=2, prev_frames=7))
        assert all(r.stats["dropped_carry"] == 2 for r in reps)
        assert len({r.size() for r in reps}) == 1

    @pytest.mark.parametrize("src_kind", ["port_native", "jax_native", "port_numpy", "jax_numpy"])
    def test_snapshots_interchange(self, src_kind):
        """A snapshot of any of the four restores into the port's native core
        and the port's native snapshot into the other three; carry continues
        across the restore."""
        reps = four(capacity=32, frame_ratio=1.5)
        prng = np.random.default_rng(2)
        fields = stream(21, n_tx=4)
        for f in fields[:20]:
            p = np.abs(prng.normal(size=f["action"].shape[0])) + 0.1
            for r in reps:
                add(r, p, f)
        kinds = dict(zip(["port_native", "jax_native", "port_numpy", "jax_numpy"], reps))
        src = kinds[src_kind]
        fresh = four(capacity=32, frame_ratio=1.5)
        # src -> port native; port native -> every fresh twin
        fresh[0].load_state_dict(src.state_dict())
        for dst in fresh[1:]:
            dst.load_state_dict(fresh[0].state_dict())
        want = src.sample(8, rng=np.random.default_rng(5))
        for dst in fresh:
            assert_batch(want, dst.sample(8, rng=np.random.default_rng(5)),
                         exact_weights=False)
        idx = add(fresh[0], np.ones(6), fields[20])
        assert len(idx) == 6 and fresh[0].stats["dropped_carry"] == 0

    @pytest.mark.parametrize("direction", ["port_native_writes", "jax_numpy_writes"])
    def test_delta_chain_interchanges(self, direction):
        """The native delta protocol: a chain written by the port's core
        restores in the JAX numpy replay, and one written by the JAX numpy
        replay restores in the port's core."""
        a = NativeDedupReplay(32, OBS, frame_ratio=1.0)
        b = JDedupReplay(32, OBS, sum_tree_cls=JSumTree, frame_ratio=1.0)
        writer = a if direction == "port_native_writes" else b
        reader = (JDedupReplay(32, OBS, sum_tree_cls=JSumTree, frame_ratio=1.0)
                  if writer is a else NativeDedupReplay(32, OBS, frame_ratio=1.0))
        prng = np.random.default_rng(6)
        fields = stream(24, n_tx=4)
        chain = []
        for k in range(6):
            for f in fields[4 * k:4 * k + 4]:
                p = np.abs(prng.normal(size=f["action"].shape[0])) + 0.1
                add(a, p, f)
                add(b, p, f)
            bt = b.sample(8, rng=np.random.default_rng(k))
            upd = np.abs(prng.normal(size=8)) + 0.1
            a.update_priorities(bt.indices, upd)
            b.update_priorities(bt.indices, upd)
            da, db = a.delta_state_dict(), b.delta_state_dict()
            assert set(da) == set(db)
            for key in da:
                assert np.asarray(da[key]).dtype == np.asarray(db[key]).dtype, key
            chain.append(da if writer is a else db)
        reader.load_state_dict(chain[0])
        for d in chain[1:]:
            reader.apply_delta_state_dict(d)
        assert_batch(writer.sample(16, rng=np.random.default_rng(9)),
                     reader.sample(16, rng=np.random.default_rng(9)), exact_weights=False)
        assert reader.size() == writer.size() and reader.stats == writer.stats


class TestStripedLaw:
    def _striped_pair(self, capacity=64, n_stripes=4, chunks=40):
        nat = NativeDedupReplay(capacity, OBS, frame_ratio=2.0, n_stripes=n_stripes)
        jnat = JNativeDedupReplay(capacity, OBS, frame_ratio=2.0, n_stripes=n_stripes)
        prng = np.random.default_rng(0)
        for f in stream(chunks):
            p = np.abs(prng.normal(size=f["action"].shape[0])) + 0.1
            add(nat, p, f)
            add(jnat, p, f)
        return nat, jnat

    def test_stripes_cover_all_slots_and_weights_bounded(self):
        nat, jnat = self._striped_pair()
        seen = set()
        for t in range(200):
            b = nat.sample(16, rng=np.random.default_rng(t))
            if t < 20:
                assert_batch(b, jnat.sample(16, rng=np.random.default_rng(t)))
            seen.update(int(i) for i in b.indices)
            assert np.all(b.is_weights > 0) and np.all(b.is_weights <= 1.0)
            stripes = np.asarray(b.indices) % 4
            assert all((stripes == s).sum() == 4 for s in range(4))
        assert len(seen) > 55

    def test_striped_frequency_matches_realized_law(self):
        """Empirical frequency ∝ (mass / stripe_total) / K — the law the IS
        weights correct for."""
        C, K = 16, 4
        nat = NativeDedupReplay(C, OBS, frame_ratio=4.0, n_stripes=K)
        add(nat, np.arange(1, C + 1, dtype=np.float64), chunk_fields(1, 0, 0, n_tx=C))
        mass = masses(nat)
        stripe_tot = np.array([mass[s::K].sum() for s in range(K)])
        expect = np.array([mass[s] / stripe_tot[s % K] / K for s in range(C)])
        counts = np.zeros(C)
        trials = 3000
        for t in range(trials):
            for i in nat.sample(8, rng=np.random.default_rng(t)).indices:
                counts[int(i)] += 1
        np.testing.assert_allclose(counts / (trials * 8), expect, atol=0.01)

    def test_batch_not_divisible_rejected(self):
        nat = NativeDedupReplay(64, OBS, n_stripes=4)
        add(nat, np.ones(6), chunk_fields(1, 0, 0))
        with pytest.raises(ValueError, match="n_stripes"):
            nat.sample(10)

    def test_threaded_adds_and_samples(self):
        nat = NativeDedupReplay(256, OBS, frame_ratio=2.0, n_stripes=4)
        for f in stream(10):
            add(nat, np.ones(f["action"].shape[0]), f)
        errs = []

        def sampler():
            try:
                for t in range(50):
                    assert np.isfinite(nat.sample(16, rng=np.random.default_rng(t))
                                       .is_weights).all()
            except Exception as e:  # noqa: BLE001
                errs.append(e)

        def adder(src):
            try:
                fbase, prev = 0, 0
                for i in range(30):
                    f = chunk_fields(src, i, fbase, carry=2 if i else 0, prev_frames=prev)
                    add(nat, np.ones(f["action"].shape[0]), f)
                    fbase += f["frames"].shape[0]
                    prev = f["frames"].shape[0]
            except Exception as e:  # noqa: BLE001
                errs.append(e)

        threads = [threading.Thread(target=sampler)] + [
            threading.Thread(target=adder, args=(100 + s,)) for s in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            joined(t, 120.0, f"{t.name} of the concurrent sample/add run")
        assert not errs
        assert nat.total_added == (6 + 9 * 8) + 2 * (6 + 29 * 8)
        assert nat.stats["dropped_carry"] == 0


class TestStripedFanOut:
    def test_fanout_bit_parity_with_serial_rc_sample(self):
        """Same uniforms through the per-stripe fan-out and the serial C
        ``rc_sample``: identical slots, weights and rows."""
        nat, _ = TestStripedLaw()._striped_pair(capacity=256)
        B = 32
        p = tnd._p
        for trial in range(5):
            u = np.ascontiguousarray(np.random.default_rng(trial).random(B))
            got = nat._sample_with_uniforms(u.copy(), beta=0.5)
            idx = np.empty(B, np.int64)
            w = np.empty(B, np.float64)
            obs = np.empty((B, *OBS), np.uint8)
            nxt = np.empty((B, *OBS), np.uint8)
            act = np.empty(B, np.int32)
            rew = np.empty(B, np.float32)
            dis = np.empty(B, np.float32)
            rc = nat._lib.rc_sample(
                nat._handle, B, 0.5, p(u, tnd._f64p), p(idx, tnd._i64p), p(w, tnd._f64p),
                p(obs, tnd._u8p), p(nxt, tnd._u8p), p(act, tnd._i32p), p(rew, tnd._f32p),
                p(dis, tnd._f32p))
            assert rc == 0
            np.testing.assert_array_equal(got.indices, idx.astype(np.int32))
            np.testing.assert_array_equal(got.is_weights, w.astype(np.float32))
            np.testing.assert_array_equal(got.transition.obs, obs)
            np.testing.assert_array_equal(got.transition.next_obs, nxt)
            np.testing.assert_array_equal(got.transition.action, act)

    def test_update_fanout_parity_and_duplicate_last_wins(self):
        """The port's fan-out against the JAX core's fan-out and the serial C
        ``rc_update``: later duplicates win, every slot's mass equal."""
        a, ja = TestStripedLaw()._striped_pair(capacity=256)
        b, _ = TestStripedLaw()._striped_pair(capacity=256)
        rng = np.random.default_rng(3)
        idx = rng.integers(0, 200, size=64).astype(np.int64)
        idx[10] = idx[40]
        prio = (np.abs(rng.normal(size=64)) + 0.05).astype(np.float32)
        a.update_priorities(idx, prio)
        ja.update_priorities(idx, prio)
        b._lib.rc_update(b._handle, 64, idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                         prio.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        np.testing.assert_array_equal(masses(a), masses(b))
        np.testing.assert_array_equal(masses(a), masses(ja))

    def test_stripe_calls_overlap_in_wall_clock(self):
        """Per-stripe sample calls overlap: the span intervals of one fan-out
        intersect.  Each stripe call gathers several ms of frames without the
        GIL; retried, since a scheduler may run short calls back to back."""
        big = (48, 48, 1)
        M = 256
        nat = NativeDedupReplay(2048, big, frame_ratio=2.0, n_stripes=2)
        rng = np.random.default_rng(0)
        for i in range(8):
            nat.add((np.abs(rng.normal(size=M)) + 0.1).astype(np.float32), DedupChunk(
                frames=rng.integers(0, 255, (M + 1, *big), dtype=np.uint8), source=1,
                chunk_seq=i, obs_ref=np.arange(M, dtype=np.int32),
                next_ref=np.arange(1, M + 1, dtype=np.int32),
                action=rng.integers(0, 4, M).astype(np.int32),
                reward=rng.normal(size=M).astype(np.float32),
                discount=np.full(M, 0.97, np.float32), prev_frames=M + 1))
        spans = []
        for trial in range(15):
            nat.sample(8192, rng=np.random.default_rng(trial))
            spans = nat.last_stripe_spans
            assert len(spans) == 2
            if max(s[0] for s in spans) < min(s[1] for s in spans):
                return
        raise AssertionError(f"stripe calls never overlapped in 15 tries: {spans}")


def test_library_builds_under_build_dir():
    path, _ = tnd.build_library()
    assert path.parent == tnd.BUILD_DIR
    assert path.parent.parts[-2:] == ("build", "native")
    assert path.name.startswith("libapex_replay_core_")
    assert tnd.SOURCE.parent.name == "_native" and tnd.SOURCE.name == "replay_core.cc"


@pytest.mark.parametrize("fault", ["no_compiler", "bad_source"])
def test_failed_build_raises_instead_of_falling_back(fault, tmp_path, monkeypatch):
    """No compiler, or a source that does not compile: the build raises, the
    replay raises, and no library is left behind; nothing picks the numpy
    replay instead."""
    monkeypatch.setattr(tnd, "BUILD_DIR", tmp_path / "native")
    if fault == "no_compiler":
        monkeypatch.setattr(tnd, "CXX", str(tmp_path / "no-such-g++"))
    else:
        broken = tmp_path / "replay_core.cc"
        broken.write_text("this is not C++\n")
        monkeypatch.setattr(tnd, "SOURCE", broken)
    tnd._library.cache_clear()
    try:
        with pytest.raises(RuntimeError):
            tnd.build_library()
        with pytest.raises(RuntimeError):
            NativeDedupReplay(8, OBS)
        assert not any((tmp_path / "native").glob("*.so"))
    finally:
        tnd._library.cache_clear()
    assert not hasattr(tnd, "native_dedup_available")


def test_native_core_stores_uint8_only():
    with pytest.raises(ValueError, match="uint8"):
        NativeDedupReplay(8, OBS, obs_dtype=np.float32)


def test_source_is_the_jax_core_below_its_header():
    """The port's ``replay_core.cc`` is its own copy of the JAX package's:
    everything from the first ``#include`` on is the same text."""
    import os

    jax_src = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                           "ape_x_dqn_tpu", "_native", "replay_core.cc")
    with open(jax_src) as f:
        theirs = f.read()
    mine = tnd.SOURCE.read_text()
    assert mine[mine.index("#include"):] == theirs[theirs.index("#include"):]
    assert "replay/native_dedup.py" in mine[:mine.index("#include")]
