"""The port's incremental replay checkpoints (``utils/checkpoint_inc``)
against ``ape_x_dqn_tpu/utils/checkpoint_inc.py``: twins of the JAX
package's ``tests/test_checkpoint_inc.py``.

* Chunk files: dtypes and values round trip, zlib, truncation, CRC and
  magic checks; the same dict gives the same bytes in both packages, and
  each package reads the other's chunks.
* The manifest is the commit: uncommitted tails are ignored, a corrupt
  referenced chunk raises, no manifest is no chain; a SIGKILL barrage of 3
  rounds always restores the last manifest.
* Base + deltas equal a full snapshot, bit for bit, for
  ``PrioritizedReplay`` (raw and compressed) and ``FusedDedupLearner``;
  delta bytes follow the interval; a chain discontinuity raises; a chain
  written by either package restores in the other, exactly.
* The async writer: backpressure, writer failure, full bases for a replay
  without deltas; npz first, then the chain.
* The host dedup replays (``DedupReplay``, ``NativeDedupReplay``) with
  sweeps, carry gaps and restamps, their chains read across the packages
  and the two implementations; the tiered base's cold-span refs
  (``cold_ref_bytes`` in the manifest) restore in place.
* Restore under corruption, for every flavour (the double-store, both host
  dedup replays, the tiered dedup replay, the fused dedup learner): exact
  prefix recovery or the previous generation, else a typed
  ``ChunkCorrupt``; a torn cold-span record is typed the same way; pruning
  keeps one earlier generation.

Every comparison here is exact (no tolerance): the chain copies bytes.
"""

from __future__ import annotations

import multiprocessing
import os
import signal
import time

import numpy as np
import pytest
import torch

from ape_x_dqn_tpu.replay import PrioritizedReplay as JPrioritizedReplay
from ape_x_dqn_tpu.utils import checkpoint_inc as jci
from ape_x_dqn_tpu_torch.learner import train_step as ttrain
from ape_x_dqn_tpu_torch.models import dueling as tdueling
from ape_x_dqn_tpu_torch.replay.buffer import PrioritizedReplay
from ape_x_dqn_tpu_torch.replay.dedup import DedupReplay
from ape_x_dqn_tpu_torch.replay.native_dedup import NativeDedupReplay
from ape_x_dqn_tpu_torch.runtime.fused_dedup import FusedDedupLearner
from ape_x_dqn_tpu_torch.types import DedupChunk, NStepTransition
from ape_x_dqn_tpu_torch.utils import checkpoint_inc as ci
from ape_x_dqn_tpu_torch.utils.checkpoint_inc import (
    ChunkCorrupt,
    IncrementalCheckpointer,
    load_incremental_replay,
    read_chunk,
    read_manifest,
    write_chunk,
)

from _torch_harness import port_deadline  # noqa: F401 — the per-test deadline, autouse

OBS = (6, 6, 1)


def np_chunk(M=8, seed=0, obs=OBS, cls=NStepTransition):
    r = np.random.default_rng(seed)
    return cls(
        obs=r.integers(0, 255, (M, *obs), dtype=np.uint8),
        action=r.integers(0, 3, (M,), dtype=np.int32),
        reward=r.normal(size=(M,)).astype(np.float32),
        discount=np.full((M,), 0.9, np.float32),
        next_obs=r.integers(0, 255, (M, *obs), dtype=np.uint8),
    )


def dchunk(M=8, src=1, seq=0, seed=0, carry=0, obs=OBS, cls=DedupChunk):
    """One dedup chunk; ``carry`` > 0 makes the first rows reference the
    previous chunk's frames."""
    r = np.random.default_rng(seed)
    obs_ref = np.arange(M, dtype=np.int32)
    obs_ref[:carry] = -np.arange(1, carry + 1, dtype=np.int32)
    return cls(
        frames=r.integers(0, 255, (M + 1, *obs), dtype=np.uint8),
        obs_ref=obs_ref,
        next_ref=np.arange(1, M + 1, dtype=np.int32),
        action=r.integers(0, 3, M).astype(np.int32),
        reward=r.normal(size=M).astype(np.float32),
        discount=np.full(M, 0.9, np.float32),
        source=src, chunk_seq=seq, prev_frames=M + 1,
    )


def prio(M=8, seed=0):
    r = np.random.default_rng(seed + 1000)
    return (np.abs(r.normal(size=M)) + 0.1).astype(np.float32)


def assert_same_state(s1: dict, s2: dict):
    assert set(s1) == set(s2), set(s1) ^ set(s2)
    for k in s1:
        a, b = np.asarray(s1[k]), np.asarray(s2[k])
        assert a.dtype == b.dtype, (k, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=k)


def churn(rep, seed=0, iters=4, B=4):
    """Sample and restamp: dirties sparse priorities between saves."""
    r = np.random.default_rng(seed)
    for _ in range(iters):
        batch = rep.sample(B, rng=r)
        rep.update_priorities(batch.indices,
                              (np.abs(r.normal(size=B)) + 0.1).astype(np.float32))


def _fused(seed=0):
    """The port's dedup learner of the JAX tests' shape (obs (8,), C 64)."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        net = tdueling.build_network("mlp", 3, (8,), hidden_sizes=(16,))
    opt = ttrain.make_optimizer("adam", learning_rate=1e-3)
    state = ttrain.init_train_state(net, opt, seed=seed, device="cpu")
    return FusedDedupLearner(net, opt, state, (8,), capacity=64, batch_size=4,
                             steps_per_call=2, ingest_block=8, target_sync_freq=4,
                             device="cpu")


def _jax_fused():
    import jax
    import jax.numpy as jnp

    from ape_x_dqn_tpu.learner.train_step import init_train_state, make_optimizer
    from ape_x_dqn_tpu.models.dueling import DuelingMLP
    from ape_x_dqn_tpu.runtime.fused_dedup import FusedDedupLearner as JFused

    net = DuelingMLP(num_actions=3, hidden_sizes=(16,))
    opt = make_optimizer("adam", learning_rate=1e-3)
    state = init_train_state(net, opt, jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.uint8))
    return JFused(net, opt, state, (8,), capacity=64, batch_size=4, steps_per_call=2,
                  ingest_block=8, target_sync_freq=4)


def _fused_feed(fused, k, cls=DedupChunk):
    fused.add_chunk(prio(seed=k), dchunk(src=1, seq=k, seed=k, carry=2 if k else 0,
                                         obs=(8,), cls=cls))
    fused.ingest_staged(drain=True)


def _np_feed(rep, k, cls=NStepTransition):
    rep.add(prio(16, seed=k), np_chunk(16, seed=k, cls=cls))
    churn(rep, seed=k)


def _dedup_feed(rep, k, cls=DedupChunk):
    rep.add(prio(seed=k), dchunk(src=1, seq=k, seed=k, carry=2 if k else 0, cls=cls))
    churn(rep, seed=k, B=2)


def _two_source_feed(rep, cls=DedupChunk):
    """JAX ``test_dedup_replay_with_sweep_and_carry_accounting``'s feed: two
    interleaved sources wrapping the 80-slot frame ring (liveness sweeps),
    one carry gap, restamps; a save after each round.  Yields the steps."""
    seq = {1: 0, 2: 0}
    k = 0

    def feed(src, gap=False):
        nonlocal k
        if gap:
            seq[src] += 2      # a skipped chunk_seq: the carry rows drop
        rep.add(prio(seed=k), dchunk(src=src, seq=seq[src], seed=k, carry=2, cls=cls))
        seq[src] += 1
        k += 1

    feed(1)
    feed(2)
    yield 1
    for i in range(6):
        feed(1, gap=(i == 2))
        feed(2)
        churn(rep, seed=i, B=2)
        yield 2 + i


# -- the chunk format ----------------------------------------------------------


class TestChunkFormat:
    def test_roundtrip_preserves_dtypes_and_values(self, tmp_path):
        arrays = {
            "a": np.arange(7, dtype=np.int64),
            "b": np.random.default_rng(0).normal(size=(3, 4)).astype(np.float32),
            "c": np.asarray(True),
            "d": np.zeros((0,), np.float64),
        }
        p = str(tmp_path / "c.ckpt")
        n = write_chunk(p, arrays)
        assert n == os.path.getsize(p)
        got = read_chunk(p)
        assert set(got) == set(arrays)
        for k in arrays:
            assert got[k].dtype == np.asarray(arrays[k]).dtype, k
            np.testing.assert_array_equal(got[k], arrays[k])

    def test_zlib_flag_roundtrip(self, tmp_path):
        arrays = {"x": np.zeros((1000,), np.int64)}
        raw, comp = str(tmp_path / "raw.ckpt"), str(tmp_path / "comp.ckpt")
        assert write_chunk(comp, arrays, compress=True) < write_chunk(raw, arrays)
        np.testing.assert_array_equal(read_chunk(comp)["x"], arrays["x"])

    def test_truncated_chunk_rejected(self, tmp_path):
        p = str(tmp_path / "c.ckpt")
        write_chunk(p, {"x": np.arange(100)})
        data = open(p, "rb").read()
        with open(p, "wb") as f:
            f.write(data[: len(data) - 7])
        with pytest.raises(ChunkCorrupt):
            read_chunk(p)

    def test_bitflip_fails_crc(self, tmp_path):
        p = str(tmp_path / "c.ckpt")
        write_chunk(p, {"x": np.arange(100)})
        data = bytearray(open(p, "rb").read())
        data[len(data) // 2] ^= 0x40
        open(p, "wb").write(bytes(data))
        with pytest.raises(ChunkCorrupt, match="crc"):
            read_chunk(p)

    def test_bad_magic_rejected(self, tmp_path):
        p = str(tmp_path / "c.ckpt")
        with open(p, "wb") as f:
            f.write(b"NOPE" + b"\0" * 64)
        with pytest.raises(ChunkCorrupt, match="magic"):
            read_chunk(p)

    @pytest.mark.parametrize("compress", [False, True])
    def test_same_dict_same_bytes_in_both_packages(self, tmp_path, compress):
        r = np.random.default_rng(1)
        arrays = {"frames": r.integers(0, 255, (5, 6, 6, 1), dtype=np.uint8),
                  "mass": r.random(9).astype(np.float32), "count": 17,
                  "tree": r.random(4), "delta": np.asarray(True),
                  "empty": np.zeros((0,))}
        a, b = str(tmp_path / "port.ckpt"), str(tmp_path / "jax.ckpt")
        assert write_chunk(a, arrays, compress) == jci.write_chunk(b, arrays, compress)
        assert open(a, "rb").read() == open(b, "rb").read()
        # Each package reads the other's chunk.
        assert_same_state(read_chunk(b), jci.read_chunk(a))


# -- the manifest commit -------------------------------------------------------


class TestManifestCommit:
    def _chain(self, tmp_path, saves=3):
        rep = PrioritizedReplay(256, OBS)
        ck = IncrementalCheckpointer(str(tmp_path), rep, sync=True)
        for k in range(saves):
            rep.add(prio(seed=k), np_chunk(seed=k))
            churn(rep, seed=k)
            ck.save(k + 1)
        return rep

    def test_uncommitted_tail_and_tmp_files_ignored(self, tmp_path):
        rep = self._chain(tmp_path)
        d = ci.inc_dir(str(tmp_path))
        with open(os.path.join(d, "chunk_0_99.ckpt"), "wb") as f:
            f.write(b"APXC" + b"\x01\0\0\0garbage")
        with open(os.path.join(d, "MANIFEST.json.tmp"), "w") as f:
            f.write('{"truncat')
        rep2 = PrioritizedReplay(256, OBS)
        assert load_incremental_replay(str(tmp_path), rep2) == 3
        assert_same_state(rep.state_dict(), rep2.state_dict())

    def test_corrupt_referenced_chunk_raises(self, tmp_path):
        self._chain(tmp_path)
        d = ci.inc_dir(str(tmp_path))
        name = read_manifest(d)["chunks"][-1]
        data = bytearray(open(os.path.join(d, name), "rb").read())
        data[-1] ^= 0x01
        open(os.path.join(d, name), "wb").write(bytes(data))
        with pytest.raises(ChunkCorrupt):
            load_incremental_replay(str(tmp_path), PrioritizedReplay(256, OBS))

    def test_no_manifest_means_no_chain(self, tmp_path):
        assert load_incremental_replay(str(tmp_path), PrioritizedReplay(256, OBS)) is None
        os.makedirs(ci.inc_dir(str(tmp_path)))
        write_chunk(os.path.join(ci.inc_dir(str(tmp_path)), "chunk_0_0.ckpt"),
                    {"x": np.arange(3)})
        assert load_incremental_replay(str(tmp_path), PrioritizedReplay(256, OBS)) is None


def _kill_victim(root: str) -> None:
    """Barrage child: add, churn and save as fast as it can until killed
    (or, orphaned, for at most 300 s)."""
    torch.set_num_threads(1)
    rep = PrioritizedReplay(512, OBS)
    ck = IncrementalCheckpointer(root, rep, sync=True, base_every=3)
    step = 0
    stop_at = time.monotonic() + 300.0
    while time.monotonic() < stop_at:
        rep.add(prio(seed=step), np_chunk(seed=step))
        if step % 2:
            churn(rep, seed=step)
        step += 1
        ck.save(step)


class TestSigkillBarrage:
    def test_kill_mid_write_always_restores_last_manifest(self, tmp_path):
        """3 rounds: a child SIGKILLed at a random moment of its chain; the
        newest committed manifest restores, counters equal to its
        ``chain_mark``."""
        ctx = multiprocessing.get_context("fork")
        rng = np.random.default_rng(0)
        for round_i in range(3):
            root = str(tmp_path / f"r{round_i}")
            proc = ctx.Process(target=_kill_victim, args=(root,), daemon=True)
            proc.start()
            try:
                deadline = time.monotonic() + 60.0
                while read_manifest(ci.inc_dir(root)) is None:
                    assert proc.is_alive(), "victim died on its own"
                    assert time.monotonic() < deadline, "no commit within 60s"
                    time.sleep(0.01)
                time.sleep(float(rng.uniform(0.02, 0.25)))
            finally:
                os.kill(proc.pid, signal.SIGKILL)
                proc.join(10.0)
            manifest = read_manifest(ci.inc_dir(root))
            rep = PrioritizedReplay(512, OBS)
            assert load_incremental_replay(root, rep) == manifest["step"]
            state = rep.state_dict()
            assert [int(state["count"])] == manifest["chain_mark"]
            assert int(state["count"]) >= 8


# -- delta chain == full snapshot ----------------------------------------------


class TestDeltaChainEqualsFull:
    @pytest.mark.parametrize("compressed", [False, True])
    def test_prioritized_replay(self, tmp_path, compressed):
        rep = PrioritizedReplay(64, OBS, frame_compression=compressed)
        ck = IncrementalCheckpointer(str(tmp_path), rep, sync=True)
        for k in range(5):  # wraps the 64-slot ring
            rep.add(prio(16, seed=k), np_chunk(16, seed=k))
            churn(rep, seed=k)
            ck.save(k + 1)
        assert ck.stats()["bases"] == 1 and ck.stats()["deltas"] == 4
        rep2 = PrioritizedReplay(64, OBS, frame_compression=compressed)
        assert load_incremental_replay(str(tmp_path), rep2) == 5
        assert_same_state(rep.state_dict(), rep2.state_dict())
        rep.add(prio(16, seed=9), np_chunk(16, seed=9))
        rep2.apply_delta_state_dict(rep.delta_state_dict())
        assert_same_state(rep.state_dict(), rep2.state_dict())

    def test_delta_bytes_track_interval_not_capacity(self, tmp_path):
        rep = PrioritizedReplay(4096, OBS)
        ck = IncrementalCheckpointer(str(tmp_path), rep, sync=True)
        for k in range(16):
            rep.add(prio(64, seed=100 + k), np_chunk(64, seed=100 + k))
        ck.save(1)
        base_bytes = ck.stats()["last_chunk_bytes"]
        rep.add(prio(64, seed=1), np_chunk(64, seed=1))
        ck.save(2)
        delta_one = ck.stats()["last_chunk_bytes"]
        for k in range(2, 4):
            rep.add(prio(64, seed=k), np_chunk(64, seed=k))
        ck.save(3)
        delta_two = ck.stats()["last_chunk_bytes"]
        assert delta_one < base_bytes
        assert 1.7 < delta_two / delta_one < 2.3

    def test_fused_dedup_single_shard(self, tmp_path):
        fused = _fused()
        for k in range(3):
            _fused_feed(fused, k)
        ck = IncrementalCheckpointer(str(tmp_path), fused, sync=True)
        ck.save(1)
        fused.train(0.5)
        _fused_feed(fused, 3)
        fused.train(0.5)
        ck.save(2)
        assert ck.stats()["deltas"] == 1
        fused2 = _fused(seed=5)
        assert load_incremental_replay(str(tmp_path), fused2) == 2
        assert_same_state(fused.state_dict(), fused2.state_dict())
        assert torch.isfinite(fused2.train(0.5).loss).all()

    def test_chain_discontinuity_raises(self, tmp_path):
        rep = PrioritizedReplay(64, OBS)
        rep.add(prio(seed=0), np_chunk(seed=0))
        rep.delta_state_dict()
        rep.add(prio(seed=1), np_chunk(seed=1))
        delta = rep.delta_state_dict()
        other = PrioritizedReplay(64, OBS)
        other.add(prio(16, seed=7), np_chunk(16, seed=7))
        with pytest.raises(ValueError, match="discontinuity"):
            other.apply_delta_state_dict(delta)
        with pytest.raises(ValueError, match="delta"):
            other.apply_delta_state_dict(other.state_dict())
        fused, fused2 = _fused(), _fused()
        _fused_feed(fused, 0)
        fused.delta_state_dict()
        _fused_feed(fused, 1)
        with pytest.raises(ValueError, match="discontinuity"):
            fused2.apply_delta_state_dict(fused.delta_state_dict())

    @pytest.mark.parametrize("writer", ["jax", "port"])
    def test_prioritized_chain_restores_across_packages(self, tmp_path, writer):
        from ape_x_dqn_tpu.replay.sum_tree import SumTree as JSumTree

        from ape_x_dqn_tpu.types import NStepTransition as JNStep

        mine, theirs = PrioritizedReplay(64, OBS), JPrioritizedReplay(
            64, OBS, sum_tree_cls=JSumTree)
        src, dst = (theirs, mine) if writer == "jax" else (mine, theirs)
        ck = (jci if writer == "jax" else ci).IncrementalCheckpointer(
            str(tmp_path), src, sync=True)
        for k in range(5):
            _np_feed(src, k, cls=JNStep if writer == "jax" else NStepTransition)
            ck.save(k + 1)
        assert ck.stats()["deltas"] == 4
        load = (ci if writer == "jax" else jci).load_incremental_replay
        assert load(str(tmp_path), dst) == 5
        assert_same_state(src.state_dict(), dst.state_dict())

    @pytest.mark.parametrize("writer", ["jax", "port"])
    def test_fused_dedup_chain_restores_across_packages(self, tmp_path, writer):
        from ape_x_dqn_tpu.types import DedupChunk as JDedupChunk

        src = _jax_fused() if writer == "jax" else _fused()
        dst = _fused() if writer == "jax" else _jax_fused()
        cls = JDedupChunk if writer == "jax" else DedupChunk
        ck = (jci if writer == "jax" else ci).IncrementalCheckpointer(
            str(tmp_path), src, sync=True)
        for k in range(4):
            _fused_feed(src, k, cls=cls)
            ck.save(k + 1)
        assert ck.stats()["bases"] == 1 and ck.stats()["deltas"] == 3
        load = (ci if writer == "jax" else jci).load_incremental_replay
        assert load(str(tmp_path), dst) == 4
        assert_same_state(src.state_dict(), dst.state_dict())


    @pytest.mark.parametrize("impl", ["numpy", "native"])
    def test_dedup_replay_with_sweep_and_carry_accounting(self, tmp_path, impl):
        """The host dedup replays' chains (JAX :277, :311): sweeps, a carry
        gap and restamps between saves; the chain restores bit for bit into
        both implementations of both packages."""
        from ape_x_dqn_tpu.replay.dedup import DedupReplay as JDedupReplay
        from ape_x_dqn_tpu.replay.native_dedup import NativeDedupReplay as JNative

        cls = DedupReplay if impl == "numpy" else NativeDedupReplay
        rep = cls(64, OBS, frame_ratio=1.25)
        ck = IncrementalCheckpointer(str(tmp_path), rep, sync=True)
        for step in _two_source_feed(rep):
            ck.save(step)
        state = rep.state_dict()
        assert int(state["frame_dead"]) > 0 and int(state["dropped_carry"]) > 0
        assert ck.stats()["bases"] == 1 and ck.stats()["deltas"] == 6
        for dst in (DedupReplay(64, OBS, frame_ratio=1.25),
                    NativeDedupReplay(64, OBS, frame_ratio=1.25)):
            assert load_incremental_replay(str(tmp_path), dst) == 7
            assert_same_state(state, dst.state_dict())
        for dst in (JDedupReplay(64, OBS, frame_ratio=1.25), JNative(64, OBS, frame_ratio=1.25)):
            assert jci.load_incremental_replay(str(tmp_path), dst) == 7
            assert_same_state(state, dst.state_dict())

    @pytest.mark.parametrize("writer", ["jax_numpy", "jax_native"])
    def test_jax_dedup_chain_restores_in_the_port(self, tmp_path, writer):
        from ape_x_dqn_tpu.replay.dedup import DedupReplay as JDedupReplay
        from ape_x_dqn_tpu.replay.native_dedup import NativeDedupReplay as JNative
        from ape_x_dqn_tpu.types import DedupChunk as JDedupChunk

        rep = (JDedupReplay if writer == "jax_numpy" else JNative)(64, OBS, frame_ratio=1.25)
        ck = jci.IncrementalCheckpointer(str(tmp_path), rep, sync=True)
        for step in _two_source_feed(rep, cls=JDedupChunk):
            ck.save(step)
        state = rep.state_dict()
        for dst in (DedupReplay(64, OBS, frame_ratio=1.25),
                    NativeDedupReplay(64, OBS, frame_ratio=1.25)):
            assert load_incremental_replay(str(tmp_path), dst) == 7
            assert_same_state(state, dst.state_dict())


# -- the async writer ----------------------------------------------------------


class _SlowLeaf:
    """Materializing it on the writer thread blocks: holds the writer busy."""

    def __init__(self, hold: float):
        self._hold = hold

    def __array__(self, dtype=None, copy=None):
        time.sleep(self._hold)
        return np.zeros((4,), np.float32)


class _PlainReplay:
    """state_dict / load_state_dict only: no delta protocol."""

    def __init__(self, hold: float = 0.0):
        self.hold = hold
        self.loaded = None

    def state_dict(self):
        leaf = _SlowLeaf(self.hold) if self.hold else np.arange(4.0)
        return {"x": leaf, "count": np.asarray([3], np.int64)}

    def load_state_dict(self, state):
        self.loaded = state


class TestAsyncWriter:
    def test_backpressure_counts_inflight_skips(self, tmp_path):
        ck = IncrementalCheckpointer(str(tmp_path), _PlainReplay(hold=0.4))
        try:
            assert ck.save(1)
            assert not ck.save(2)
            assert ck.stats()["inflight_skips"] == 1
            assert ck.flush(timeout=30.0)
            assert ck.save(3)
            assert ck.flush(timeout=30.0)
            assert ck.stats()["bases"] == 2
            m = read_manifest(ci.inc_dir(str(tmp_path)))
            assert m["step"] == 3 and len(m["chunks"]) == 1
        finally:
            ck.close()

    def test_writer_failure_surfaces_at_next_save(self, tmp_path):
        class Exploding:
            def __array__(self, dtype=None, copy=None):
                raise RuntimeError("disk on fire")

        class BadReplay:
            def state_dict(self):
                return {"x": Exploding()}

        ck = IncrementalCheckpointer(str(tmp_path), BadReplay())
        with pytest.raises(RuntimeError, match="checkpoint writer failed"):
            ck.save(1)
            ck.flush(timeout=30.0)
        with pytest.raises(RuntimeError, match="checkpoint writer failed"):
            ck.save(2)

    def test_plain_replay_roundtrip(self, tmp_path):
        ck = IncrementalCheckpointer(str(tmp_path), _PlainReplay(), sync=True)
        ck.save(5)
        dst = _PlainReplay()
        assert load_incremental_replay(str(tmp_path), dst) == 5
        np.testing.assert_array_equal(dst.loaded["x"], np.arange(4.0))

    def test_restore_prefers_npz_then_falls_back_to_chain(self, tmp_path):
        from ape_x_dqn_tpu_torch.utils.checkpoint import load_replay_leg

        rep = PrioritizedReplay(64, OBS)
        rep.add(prio(seed=0), np_chunk(seed=0))
        IncrementalCheckpointer(str(tmp_path), rep, sync=True).save(1)
        rep2 = PrioritizedReplay(64, OBS)
        assert load_replay_leg(str(tmp_path), rep2) == "incremental"
        assert_same_state(rep.state_dict(), rep2.state_dict())
        assert load_replay_leg(str(tmp_path / "nope"), PrioritizedReplay(64, OBS)) is None


# -- restore under corruption --------------------------------------------------


def _flavor(name, spill=None):
    """(make, feed) per replay flavour.  The tiered dedup replay's makes share
    one spill directory (``spill``), so restores adopt it in place, and a
    tiny hot budget keeps most spans cold through the whole matrix."""
    if name == "prioritized":
        return (lambda: PrioritizedReplay(64, OBS)), _np_feed
    if name == "dedup":
        return (lambda: DedupReplay(64, OBS, frame_ratio=1.25)), _dedup_feed
    if name == "native_dedup":
        return (lambda: NativeDedupReplay(64, OBS, frame_ratio=1.25)), _dedup_feed
    if name == "tiered_dedup":
        def make():
            return DedupReplay(64, OBS, frame_ratio=1.25, hot_frame_budget_bytes=512,
                               spill_dir=str(spill), spill_span_frames=4)

        def feed(rep, k):
            _dedup_feed(rep, k)
            rep.spill_cold()
        return make, feed
    return _fused, _fused_feed


FLAVORS = ["prioritized", "dedup", "native_dedup", "tiered_dedup", "fused_dedup"]


class TestRestoreUnderCorruption:
    def _chain(self, root, make, feed, saves=6, base_every=2):
        rep = make()
        ck = IncrementalCheckpointer(str(root), rep, base_every=base_every, sync=True)
        states = {}
        for k in range(saves):
            feed(rep, k)
            ck.save(k + 1)
            states[k + 1] = {key: np.array(np.asarray(v))
                             for key, v in rep.state_dict().items()}
        manifest = read_manifest(ci.inc_dir(str(root)))
        assert manifest["generation"] >= 1 and manifest["chunk_steps"]
        return states, manifest

    def _corrupt(self, root, chunk_name, mode):
        path = os.path.join(ci.inc_dir(str(root)), chunk_name)
        with open(path, "r+b") as f:
            if mode == "bitflip":
                f.seek(40)
                b = f.read(1)
                f.seek(40)
                f.write(bytes([b[0] ^ 0x20]))
            else:
                f.truncate(20)

    @pytest.mark.parametrize("flavor", FLAVORS)
    @pytest.mark.parametrize("mode", ["bitflip", "truncate"])
    def test_corrupt_delta_exact_prefix_recovery_or_typed(self, tmp_path, flavor, mode):
        make, feed = _flavor(flavor, spill=tmp_path / "spill")
        states, manifest = self._chain(tmp_path, make, feed)
        self._corrupt(tmp_path, manifest["chunks"][-1], mode)
        with pytest.raises(ChunkCorrupt) as ei:
            load_incremental_replay(str(tmp_path), make())
        assert ei.value.generation == manifest["generation"]
        rep2 = make()
        step = load_incremental_replay(str(tmp_path), rep2, fallback=True)
        assert step == manifest["chunk_steps"][-2]
        assert_same_state(states[step], rep2.state_dict())
        events = ci.consume_fallback_events()
        assert events and events[-1]["fallback"] == "partial_chain"

    @pytest.mark.parametrize("flavor", FLAVORS)
    @pytest.mark.parametrize("mode", ["bitflip", "truncate"])
    def test_corrupt_base_recovers_previous_generation_exactly(self, tmp_path, flavor, mode):
        make, feed = _flavor(flavor, spill=tmp_path / "spill")
        states, manifest = self._chain(tmp_path, make, feed)
        self._corrupt(tmp_path, manifest["chunks"][0], mode)
        with pytest.raises(ChunkCorrupt):
            load_incremental_replay(str(tmp_path), make())
        rep2 = make()
        step = load_incremental_replay(str(tmp_path), rep2, fallback=True)
        prev = ci.read_archived_manifest(ci.inc_dir(str(tmp_path)), manifest["generation"] - 1)
        assert step == prev["step"]
        assert_same_state(states[step], rep2.state_dict())
        events = ci.consume_fallback_events()
        assert events and events[-1]["fallback"] == "previous_generation"

    @pytest.mark.parametrize("flavor", FLAVORS)
    def test_manifest_missing_is_no_chain_not_wrong_data(self, tmp_path, flavor):
        make, feed = _flavor(flavor, spill=tmp_path / "spill")
        self._chain(tmp_path, make, feed)
        os.unlink(os.path.join(ci.inc_dir(str(tmp_path)), "MANIFEST.json"))
        assert load_incremental_replay(str(tmp_path), make()) is None
        assert load_incremental_replay(str(tmp_path), make(), fallback=True) is None

    def test_every_rung_corrupt_is_typed_failure(self, tmp_path):
        make, feed = _flavor("prioritized")
        _, manifest = self._chain(tmp_path, make, feed)
        prev = ci.read_archived_manifest(ci.inc_dir(str(tmp_path)), manifest["generation"] - 1)
        self._corrupt(tmp_path, manifest["chunks"][0], "bitflip")
        self._corrupt(tmp_path, prev["chunks"][0], "truncate")
        with pytest.raises(ChunkCorrupt):
            load_incremental_replay(str(tmp_path), make(), fallback=True)
        ci.consume_fallback_events()

    def test_pruning_retains_one_prior_generation(self, tmp_path):
        make, feed = _flavor("prioritized")
        rep = make()
        ck = IncrementalCheckpointer(str(tmp_path), rep, base_every=1, sync=True)
        for k in range(8):
            feed(rep, k)
            ck.save(k + 1)
        live = read_manifest(ci.inc_dir(str(tmp_path)))["generation"]
        gens = sorted({int(n.split("_")[1]) for n in os.listdir(ci.inc_dir(str(tmp_path)))
                       if n.startswith("chunk_")})
        assert gens == [live - 1, live]
        assert ci.read_archived_manifest(ci.inc_dir(str(tmp_path)), live - 1)

    def test_cold_span_refs_are_refused_by_name(self, tmp_path):
        """Cold-span refs are ported: a tiered base (``tier_cold_*`` arrays,
        ``cold_ref_bytes`` in the manifest) restores through the replay's
        ``adopt_cold_ref``, in place over the spill file, bit for bit; the
        JAX package writes the same chain for the same feed."""
        from ape_x_dqn_tpu.replay.dedup import DedupReplay as JDedupReplay
        from ape_x_dqn_tpu.types import DedupChunk as JDedupChunk

        make, feed = _flavor("tiered_dedup", spill=tmp_path / "spill")
        states, manifest = self._chain(tmp_path / "port", make, feed)
        d = ci.inc_dir(str(tmp_path / "port"))
        base = read_chunk(os.path.join(d, manifest["chunks"][0]))
        assert "tier_cold_offsets" in base and "frames" not in base
        assert manifest["cold_ref_bytes"] == int(base["tier_cold_lens"].sum()) * 36 > 0
        rep2 = make()
        assert load_incremental_replay(str(tmp_path / "port"), rep2) == manifest["step"]
        # O(hot): only the deltas' partly overwritten boundary spans fault.
        assert rep2.tier_stats()["fault_reads"] <= 2 * (len(manifest["chunks"]) - 1)
        assert_same_state(states[manifest["step"]], rep2.state_dict())
        jrep = JDedupReplay(64, OBS, frame_ratio=1.25, hot_frame_budget_bytes=512,
                            spill_dir=str(tmp_path / "jspill"), spill_span_frames=4)
        jck = jci.IncrementalCheckpointer(str(tmp_path / "jax"), jrep, base_every=2, sync=True)
        for k in range(6):
            _dedup_feed(jrep, k, cls=JDedupChunk)
            jrep.spill_cold()
            jck.save(k + 1)
        jman = jci.read_manifest(jci.inc_dir(str(tmp_path / "jax")))
        assert jman["cold_ref_bytes"] == manifest["cold_ref_bytes"]
        assert jman["chunks"] == manifest["chunks"]

    def test_corrupt_cold_span_record_is_typed_or_fallback(self, tmp_path):
        """JAX :857: every record of the spill file broken; a restore without
        the fallback raises the typed ``ChunkCorrupt``, with it lands on a
        rung whose refs still verify (exact state) or raises typed."""
        make, feed = _flavor("tiered_dedup", spill=tmp_path / "spill")
        states, manifest = self._chain(tmp_path / "cold-span", make, feed)
        assert manifest.get("cold_ref_bytes", 0) > 0
        with open(manifest["spill_file"], "r+b") as f:
            for off in range(0, os.fstat(f.fileno()).st_size, 128):
                f.seek(off)
                f.write(b"\xde\xad")
        with pytest.raises(ChunkCorrupt):
            load_incremental_replay(str(tmp_path / "cold-span"), make())
        rep2 = make()
        try:
            step = load_incremental_replay(str(tmp_path / "cold-span"), rep2, fallback=True)
        except ChunkCorrupt:
            ci.consume_fallback_events()
            return
        assert step in states
        assert_same_state(states[step], rep2.state_dict())
