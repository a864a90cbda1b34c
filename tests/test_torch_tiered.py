"""The port's tiered frame store (``replay/tiered.py``) against the JAX
package's, twin of ``tests/test_tiered_replay.py``.

* ``APXS`` cold records are byte for byte the JAX package's: a record (and
  a whole spill file) written by either package reads in the other.
* ``TieredFrameRing`` is bit-exact with a dense ndarray and with the JAX
  ring under one random interleaving of puts, gets, spills and faults;
  eviction is least-recently-sampled first, clean re-evictions write
  nothing, and a torn record is a typed ``ColdSpanCorrupt``.
* Tiered ``DedupReplay``, ``NativeDedupReplay`` and ``PrioritizedReplay``
  sample, update and snapshot bit-exactly like their dense twins and like
  the JAX package's tiered replays, with spills and fault reads > 0.
* Incremental bases reference cold spans by offset and restore O(hot) by
  adopting the spill file in place; chains with ``tier_cold_*`` refs
  restore across the packages both ways; torn records walk back or raise
  typed; the ``TierEvictor`` holds the budget; a SIGKILL mid-spill leaves
  only valid or detectably torn records.
"""

from __future__ import annotations

import multiprocessing
import os
import signal
import time

import numpy as np
import pytest

from ape_x_dqn_tpu.replay import tiered as jtiered
from ape_x_dqn_tpu.replay.buffer import PrioritizedReplay as JPrioritizedReplay
from ape_x_dqn_tpu.replay.dedup import DedupReplay as JDedupReplay
from ape_x_dqn_tpu.replay.native_dedup import NativeDedupReplay as JNativeDedupReplay
from ape_x_dqn_tpu.types import DedupChunk as JDedupChunk
from ape_x_dqn_tpu.types import NStepTransition as JTransition
from ape_x_dqn_tpu.utils import checkpoint_inc as jci
from ape_x_dqn_tpu_torch.replay.buffer import PrioritizedReplay
from ape_x_dqn_tpu_torch.replay.dedup import DedupReplay
from ape_x_dqn_tpu_torch.replay.native_dedup import NativeDedupReplay
from ape_x_dqn_tpu_torch.replay.tiered import (
    ColdSpanCorrupt,
    ColdSpanStore,
    TieredFrameRing,
    TierEvictor,
)
from ape_x_dqn_tpu_torch.types import DedupChunk, NStepTransition
from ape_x_dqn_tpu_torch.utils.checkpoint_inc import (
    ChunkCorrupt,
    IncrementalCheckpointer,
    inc_dir,
    load_incremental_replay,
    read_chunk,
    read_manifest,
)

OBS = (6, 6, 1)


def dfields(src=1, seq=0, seed=0, M=16):
    r = np.random.default_rng(seed * 7919 + src)
    return dict(
        frames=r.integers(0, 255, (M + 1, *OBS), dtype=np.uint8),
        obs_ref=np.arange(M, dtype=np.int32), next_ref=np.arange(1, M + 1, dtype=np.int32),
        action=r.integers(0, 3, M).astype(np.int32), reward=r.normal(size=M).astype(np.float32),
        discount=np.full(M, 0.9, np.float32), source=src, chunk_seq=seq, prev_frames=M + 1,
    )


def prio(M=16, seed=0):
    r = np.random.default_rng(seed + 1000)
    return (np.abs(r.normal(size=M)) + 0.1).astype(np.float32)


def _is_jax(r) -> bool:
    return type(r).__module__.startswith("ape_x_dqn_tpu.")


def add(r, k, p=None):
    f = dfields(seq=k, seed=k)
    return r.add(prio(seed=k) if p is None else p,
                 (JDedupChunk if _is_jax(r) else DedupChunk)(**f))


def assert_same_state(s1, s2):
    assert set(s1) == set(s2), set(s1) ^ set(s2)
    for k in s1:
        np.testing.assert_array_equal(np.asarray(s1[k]), np.asarray(s2[k]), err_msg=k)


def assert_same_batch(a, b):
    np.testing.assert_array_equal(a.indices, b.indices)
    np.testing.assert_array_equal(a.is_weights, b.is_weights)
    np.testing.assert_array_equal(a.transition.obs, b.transition.obs)
    np.testing.assert_array_equal(a.transition.next_obs, b.transition.next_obs)


CLASSES = {"dedup": (DedupReplay, JDedupReplay),
           "native": (NativeDedupReplay, JNativeDedupReplay)}


def tiered(cls, spill, cap=128, budget=2048, span=4):
    return cls(cap, OBS, hot_frame_budget_bytes=budget, spill_dir=str(spill),
               spill_span_frames=span)


class TestColdSpanStore:
    def test_roundtrip_and_offset_addressing(self, tmp_path):
        store = ColdSpanStore(str(tmp_path / "c.cold"), 4, 64)
        off_a, crc = store.write(2, 0, b"x" * 64)
        assert store.read(off_a, sid=2, want_crc=crc) == b"x" * 64
        off_b, crc_b = store.write(2, 1, b"y" * 64)
        assert off_b == off_a + store.record_size
        # The A slot survives the B write (checkpoint retention).
        assert store.read(off_a, sid=2, want_crc=crc) == b"x" * 64
        assert store.read(off_b, sid=2, want_crc=crc_b) == b"y" * 64

    @pytest.mark.parametrize("writer", ["port", "jax"])
    def test_records_byte_equal_and_read_across_packages(self, tmp_path, writer):
        """The same spans spilled by each package give byte-identical files,
        and each package reads the other's records."""
        payloads = [bytes(np.random.default_rng(s).integers(0, 256, 50, dtype=np.uint8))
                    for s in range(6)]
        files = {}
        for name, mod in (("port", ColdSpanStore), ("jax", jtiered.ColdSpanStore)):
            store = mod(str(tmp_path / f"{name}.cold"), 3, 64)
            refs = [store.write(s % 3, s // 3, p) for s, p in enumerate(payloads)]
            store.close()
            files[name] = ((tmp_path / f"{name}.cold").read_bytes(), refs)
        assert files["port"] == files["jax"]
        reader = (jtiered.ColdSpanStore if writer == "port" else ColdSpanStore)(
            str(tmp_path / f"{writer}.cold"), 3, 64)
        for s, ((off, crc), p) in enumerate(zip(files[writer][1], payloads)):
            assert reader.read(off, sid=s % 3, want_crc=crc) == p
        reader.close()

    def test_torn_record_is_typed_never_bytes(self, tmp_path):
        path = str(tmp_path / "c.cold")
        store = ColdSpanStore(path, 2, 64)
        off, crc = store.write(1, 0, b"z" * 64)
        with open(path, "r+b") as f:
            f.seek(off + 30)
            f.write(b"\xff\xfe")
        with pytest.raises(ColdSpanCorrupt):
            store.read(off, sid=1, want_crc=crc)
        with pytest.raises(jtiered.ColdSpanCorrupt):   # the JAX reader agrees
            jtiered.ColdSpanStore(path, 2, 64).read(off, sid=1, want_crc=crc)

    def test_never_written_slot_is_typed(self, tmp_path):
        store = ColdSpanStore(str(tmp_path / "c.cold"), 2, 64)
        with pytest.raises(ColdSpanCorrupt):
            store.read(store.offset(0, 0), sid=0)

    def test_span_id_mismatch_is_typed(self, tmp_path):
        store = ColdSpanStore(str(tmp_path / "c.cold"), 4, 64)
        off, _ = store.write(3, 0, b"q" * 64)
        with pytest.raises(ColdSpanCorrupt):
            store.read(off, sid=1)

    def test_content_drift_against_want_crc_is_typed(self, tmp_path):
        store = ColdSpanStore(str(tmp_path / "c.cold"), 2, 64)
        off, crc = store.write(0, 0, b"a" * 64)
        store.write(0, 0, b"b" * 64)
        with pytest.raises(ColdSpanCorrupt):
            store.read(off, sid=0, want_crc=crc)

    def test_typed_error_is_the_ports_chunk_corrupt(self, tmp_path):
        assert issubclass(ColdSpanCorrupt, ChunkCorrupt)
        e = ColdSpanCorrupt("x", path=str(tmp_path / "f.cold"), span=3)
        assert e.span == e.index == 3 and e.generation is None

    def test_reopen_never_truncates(self, tmp_path):
        path = str(tmp_path / "c.cold")
        store = ColdSpanStore(path, 8, 64)
        off, crc = store.write(7, 1, b"k" * 64)
        store.close()
        assert ColdSpanStore(path, 2, 64).read(off, sid=7, want_crc=crc) == b"k" * 64


class TestTieredFrameRing:
    def _rings(self, tmp_path, cap=64, budget=0, span=4, **kw):
        return [mod(cap, OBS, hot_budget_bytes=budget or 10 ** 9,
                    spill_path=str(tmp_path / f"{name}.cold"), span_frames=span, **kw)
                for name, mod in (("port", TieredFrameRing), ("jax", jtiered.TieredFrameRing))]

    def test_random_ops_match_dense_oracle_and_jax(self, tmp_path):
        rng = np.random.default_rng(0)
        cap = 64
        ring, jring = self._rings(tmp_path, cap=cap, budget=1)  # evict everything
        oracle = np.zeros((cap, *OBS), np.uint8)
        for _ in range(60):
            op = rng.integers(0, 3)
            if op == 0:
                idx = rng.choice(cap, size=rng.integers(1, 9), replace=False)
                frames = rng.integers(0, 255, (len(idx), *OBS), np.uint8)
                ring.put(idx, frames)
                jring.put(idx, frames)
                oracle[idx] = frames
            elif op == 1:
                start, n = int(rng.integers(0, cap)), int(rng.integers(1, 20))
                frames = rng.integers(0, 255, (n, *OBS), np.uint8)
                ring.put_span(start, n, frames)
                jring.put_span(start, n, frames)
                oracle[(start + np.arange(n)) % cap] = frames
            else:
                assert ring.spill() == jring.spill()
            idx = rng.choice(cap, size=8, replace=False)
            np.testing.assert_array_equal(ring.get(idx), oracle[idx])
            np.testing.assert_array_equal(jring.get(idx), oracle[idx])
            start, n = int(rng.integers(0, cap)), int(rng.integers(1, 20))
            np.testing.assert_array_equal(ring.get_span(start, n),
                                          oracle[(start + np.arange(n)) % cap])
            jring.get_span(start, n)
        assert ring.spill_writes > 0 and ring.fault_reads > 0
        s, j = ring.tier_stats(), jring.tier_stats()
        s.pop("fault_ms"), j.pop("fault_ms")
        assert s == j
        ring.close()
        jring.close()
        assert (tmp_path / "port.cold").read_bytes() == (tmp_path / "jax.cold").read_bytes()

    def test_never_written_reads_zeros(self, tmp_path):
        ring, _ = self._rings(tmp_path)
        np.testing.assert_array_equal(ring.get(np.asarray([0, 63])),
                                      np.zeros((2, *OBS), np.uint8))

    def test_eviction_is_lru_and_respects_budget(self, tmp_path):
        rings = self._rings(tmp_path, budget=6 * 4 * int(np.prod(OBS)), watermark_low=1.0)
        frames = np.arange(64 * np.prod(OBS), dtype=np.uint8).reshape(64, *OBS)
        for ring in rings:
            ring.put_span(0, 64, frames)       # 16 spans hot
            ring.get(np.asarray([0]))          # span 0 most recent
        (spilled, wrote), jres = (r.spill() for r in rings)
        assert (spilled, wrote) == jres
        ring = rings[0]
        assert ring.hot_bytes <= ring.hot_budget_bytes
        assert spilled == 10 and wrote > 0
        assert 0 in ring._hot
        assert sorted(ring._hot) == sorted(rings[1]._hot)

    def test_clean_re_eviction_writes_nothing(self, tmp_path):
        ring, _ = self._rings(tmp_path, budget=1)
        ring.put_span(0, 8, np.ones((8, *OBS), np.uint8))
        assert ring.spill()[1] > 0
        ring.get(np.asarray([0]))
        assert ring.spill()[1] == 0
        assert ring.fault_reads == 1

    def test_torn_cold_span_fault_is_typed(self, tmp_path):
        ring, _ = self._rings(tmp_path, budget=1)
        ring.put_span(0, 4, np.full((4, *OBS), 7, np.uint8))
        ring.spill()
        off = ring.store.offset(0, int(ring._cold_ab[0]))
        with open(ring.store.path, "r+b") as f:
            f.seek(off + 20)
            f.write(b"\x00\x01\x02")
        with pytest.raises(ColdSpanCorrupt):
            ring.get(np.asarray([0]))


class TestTieredReplayParity:
    """The tier moves bytes, never the law: each tiered replay is bit-exact
    with its dense twin and with the JAX package's tiered replay, with
    evictions forced between every operation."""

    @pytest.mark.parametrize("kind", ["dedup", "native"])
    def test_sample_update_snapshot_bit_exact(self, tmp_path, kind):
        cls, jcls = CLASSES[kind]
        dense = cls(128, OBS)
        tier = tiered(cls, tmp_path / "port")
        jtier = tiered(jcls, tmp_path / "jax")
        reps = (dense, tier, jtier)
        rng = np.random.default_rng(1)
        for k in range(16):  # wraps the rings
            slots = [add(r, k) for r in reps]
            np.testing.assert_array_equal(slots[0], slots[1])
            np.testing.assert_array_equal(slots[0], slots[2])
            tier.spill_cold()
            jtier.spill_cold()
        assert tier.tier_stats()["spill_writes"] > 0
        for k in range(12):
            b = [r.sample(16, rng=np.random.default_rng(50 + k)) for r in reps]
            assert_same_batch(b[0], b[1])
            assert_same_batch(b[1], b[2])
            up = (np.abs(rng.normal(size=16)) + 0.1).astype(np.float32)
            for r in reps:
                r.update_priorities(b[0].indices, up)
            tier.spill_cold()
            jtier.spill_cold()
        stats, jstats = tier.tier_stats(), jtier.tier_stats()
        assert stats["fault_reads"] > 0 and stats["spill_writes"] > 0
        # The numpy ring's counters are the JAX package's, move for move.  The
        # native index's differ by design: its inline trim spares every span
        # a fault batch reads (test_native_fault_batch_keeps_the_spans_it_reads).
        keys = ("hot_bytes", "hot_spans", "cold_spans", "spilled_bytes", "spill_writes",
                "fault_reads", "fault_bytes") if kind == "dedup" else ()
        for key in keys:
            assert stats[key] == jstats[key], key
        assert_same_state(dense.state_dict(), tier.state_dict())
        assert_same_state(tier.state_dict(), jtier.state_dict())

    def test_native_two_phase_equals_fused_call(self, tmp_path):
        """``rc_sample_idx`` + ``rc_gather_frames`` (the tiered path) equals the
        one-call ``rc_sample`` from the same uniforms, all hot (no faults)."""
        fused = NativeDedupReplay(128, OBS)
        two = NativeDedupReplay(128, OBS, hot_frame_budget_bytes=10 ** 9,
                                spill_dir=str(tmp_path / "s"), spill_span_frames=4)
        for k in range(6):
            add(fused, k)
            add(two, k)
        for k in range(8):
            u = np.random.default_rng(k).random(16)
            assert_same_batch(fused._sample_with_uniforms(u.copy(), 0.4),
                              two._sample_with_uniforms(u.copy(), 0.4))
        assert two.tier_stats()["fault_reads"] == 0

    def test_tiered_prioritized_replay_parity(self, tmp_path):
        """The tiered double-store (half the budget each for obs and
        next_obs) against its dense twin and the JAX tiered double-store."""
        dense = PrioritizedReplay(64, OBS)
        tier = PrioritizedReplay(64, OBS, hot_frame_budget_bytes=4096,
                                 spill_dir=str(tmp_path / "p"), spill_span_frames=4)
        jtier = JPrioritizedReplay(64, OBS, hot_frame_budget_bytes=4096,
                                   spill_dir=str(tmp_path / "j"), spill_span_frames=4)
        rng = np.random.default_rng(2)
        for k in range(8):
            M = 16
            fields = dict(obs=rng.integers(0, 255, (M, *OBS), np.uint8),
                          action=rng.integers(0, 3, M).astype(np.int32),
                          reward=rng.normal(size=M).astype(np.float32),
                          discount=np.full(M, 0.9, np.float32),
                          next_obs=rng.integers(0, 255, (M, *OBS), np.uint8))
            p = prio(M, seed=k)
            s = dense.add(p, NStepTransition(**fields))
            np.testing.assert_array_equal(s, tier.add(p, NStepTransition(**fields)))
            np.testing.assert_array_equal(s, jtier.add(p, JTransition(**fields)))
            tier.spill_cold()
            jtier.spill_cold()
        for k in range(6):
            b = [r.sample(8, rng=np.random.default_rng(k)) for r in (dense, tier, jtier)]
            assert_same_batch(b[0], b[1])
            assert_same_batch(b[1], b[2])
        stats = tier.tier_stats()
        assert stats["spill_writes"] > 0 and stats["fault_reads"] > 0
        assert {k: v for k, v in stats.items() if k != "fault_ms"} == \
            {k: v for k, v in jtier.tier_stats().items() if k != "fault_ms"}
        assert tier.frames_nbytes() == stats["hot_bytes"]
        tier.spill_cold()
        assert tier.frames_nbytes() <= 4096
        assert_same_state(dense.state_dict(), tier.state_dict())
        assert tier.tier is tier._obs.ring and dense.tier is None
        assert tier.tier_flush_dirty() >= 0 and dense.tier_stats() is None


def _page_frame_stream(cls, obs, sources=(1, 2), chunks=4, rows=16):
    """Two interleaved sources with 2-row carries over frames of one page
    each (a span drop releases real pages only at that size)."""
    rng = np.random.default_rng(0)
    prev = {s: 0 for s in sources}
    for k in range(chunks):
        for src in sources:
            carry = 2 if prev[src] else 0
            m = rows + carry
            yield (np.abs(rng.normal(size=m)) + 0.1).astype(np.float32), cls(
                frames=rng.integers(0, 256, (rows + 1, *obs), dtype=np.uint8),
                obs_ref=np.concatenate([-np.arange(carry, 0, -1, dtype=np.int32),
                                        np.arange(rows, dtype=np.int32)]),
                next_ref=np.concatenate([np.zeros(carry, np.int32),
                                         np.arange(1, rows + 1, dtype=np.int32)]),
                action=rng.integers(0, 4, m).astype(np.int32),
                reward=rng.normal(size=m).astype(np.float32),
                discount=np.full(m, 0.97, np.float32),
                source=src, chunk_seq=k, prev_frames=prev[src])
            prev[src] = rows + 1


@pytest.mark.parametrize("package", ["port", "jax"])
def test_native_fault_batch_keeps_the_spans_it_reads(tmp_path, package):
    """A native tiered sample faults its cold spans in one batch and then
    trims clean spans inline; the trim must spare every span the batch
    reads, resident ones included.  At page-sized frames (where a span drop
    really zero-fills pages) the port's samples equal the dense core's
    through restamps and spills; the JAX copy's trim spares only the spans
    it just faulted, and a sample there gathers zero-filled frames (the
    reference is not edited)."""
    obs, C, ratio = (32, 32, 4), 128, 0.75
    cls, ccls = ((NativeDedupReplay, DedupChunk) if package == "port"
                 else (JNativeDedupReplay, JDedupChunk))
    ring = int(round(C * ratio)) * int(np.prod(obs))
    dense = cls(C, obs, frame_ratio=ratio)
    tier = cls(C, obs, frame_ratio=ratio, hot_frame_budget_bytes=ring // 5,
               spill_dir=str(tmp_path), spill_span_frames=2)
    for p, c in _page_frame_stream(ccls, obs):
        dense.add(p, c)
        tier.add(p, c)
        tier.spill_cold()
    differs = 0
    for t in range(8):
        a = dense.sample(32, rng=np.random.default_rng(100 + t))
        b = tier.sample(32, rng=np.random.default_rng(100 + t))
        np.testing.assert_array_equal(a.indices, b.indices)
        differs += not np.array_equal(a.transition.obs, b.transition.obs)
        up = np.abs(np.random.default_rng(500 + t).normal(size=32)) + 0.05
        dense.update_priorities(a.indices, up)
        tier.update_priorities(a.indices, up)
        tier.spill_cold()
    assert tier.tier_stats()["fault_reads"] > 0
    assert differs == 0 if package == "port" else differs > 0


class TestTieredCheckpoint:
    """Cold-ref bases: bytes ∝ hot budget, O(hot) adopt restore, restores
    across the packages and into dense twins, torn cold records typed."""

    def _build_chain(self, root, spill, cls, saves=6):
        rep = cls(64, OBS, hot_frame_budget_bytes=2048, spill_dir=spill, spill_span_frames=4)
        ck = (jci if _is_jax(rep) else None)
        ck = (jci.IncrementalCheckpointer if ck else IncrementalCheckpointer)(
            root, rep, base_every=2, sync=True)
        for k in range(saves):
            add(rep, k)
            rep.spill_cold()
            b = rep.sample(8, rng=np.random.default_rng(k))
            rep.update_priorities(b.indices, prio(8, seed=100 + k))
            rep.spill_cold()
            ck.save(k + 1)
        return rep

    @pytest.mark.parametrize("kind", ["dedup", "native"])
    def test_base_references_cold_spans_and_adopt_restores(self, tmp_path, kind):
        cls = CLASSES[kind][0]
        root, spill = str(tmp_path), str(tmp_path / "spill")
        want = self._build_chain(root, spill, cls).state_dict()
        manifest = read_manifest(inc_dir(root))
        base = read_chunk(os.path.join(inc_dir(root), manifest["chunks"][0]))
        assert "tier_cold_sids" in base and "frames" not in base
        assert manifest["cold_ref_bytes"] > 0
        assert manifest["spill_file"] == os.path.join(spill, "frames.cold")
        r2 = cls(64, OBS, hot_frame_budget_bytes=2048, spill_dir=spill, spill_span_frames=4)
        assert load_incremental_replay(root, r2) == manifest["step"]
        # O(hot): the cold tier is adopted in place; only the deltas'
        # partially overwritten boundary spans fault.
        stats = r2.tier_stats()
        assert stats["fault_reads"] <= 2 * (len(manifest["chunks"]) - 1)
        assert stats["fault_bytes"] < manifest["cold_ref_bytes"]
        assert_same_state(want, r2.state_dict())

    @pytest.mark.parametrize("writer,reader", [
        ("port_dedup", "jax_dedup"), ("port_native", "jax_native"),
        ("jax_dedup", "port_dedup"), ("jax_native", "port_native"),
        ("jax_dedup", "port_native")])
    def test_cold_ref_chain_restores_across_packages(self, tmp_path, writer, reader):
        """A chain whose base holds ``tier_cold_*`` refs, written by one
        package, restores in the other: in place over the same spill file
        (adopt), bit-exact, with the manifest's ``cold_ref_bytes`` equal to
        what the other package writes for the same feed."""
        kinds = {"port_dedup": DedupReplay, "port_native": NativeDedupReplay,
                 "jax_dedup": JDedupReplay, "jax_native": JNativeDedupReplay}
        root, spill = str(tmp_path / "w"), str(tmp_path / "spill")
        want = self._build_chain(root, spill, kinds[writer]).state_dict()
        twin_root = str(tmp_path / "twin")
        twin_cls = kinds[writer.replace("port", "x").replace("jax", "port").replace("x", "jax")]
        self._build_chain(twin_root, str(tmp_path / "spill_twin"), twin_cls)
        m, m_twin = read_manifest(inc_dir(root)), read_manifest(inc_dir(twin_root))
        assert m["cold_ref_bytes"] == m_twin["cold_ref_bytes"] > 0
        assert m["chain_mark"] == m_twin["chain_mark"] and m["chunks"] == m_twin["chunks"]
        rcls = kinds[reader]
        r2 = rcls(64, OBS, hot_frame_budget_bytes=2048, spill_dir=spill, spill_span_frames=4)
        load = jci.load_incremental_replay if _is_jax(r2) else load_incremental_replay
        assert load(root, r2) == 6
        assert_same_state(want, r2.state_dict())

    @pytest.mark.parametrize("kind", ["dedup", "native"])
    def test_cross_restore_into_dense_twin(self, tmp_path, kind):
        """A tiered chain restores into the other dense twin (the numpy
        replay and the native core stay interchangeable through the tier)
        and into the JAX package's dense replay."""
        root, spill = str(tmp_path), str(tmp_path / "spill")
        want = self._build_chain(root, spill, CLASSES[kind][0]).state_dict()
        dense = NativeDedupReplay(64, OBS) if kind == "dedup" else DedupReplay(64, OBS)
        assert load_incremental_replay(root, dense) == 6
        assert_same_state(want, dense.state_dict())
        jdense = JDedupReplay(64, OBS)
        assert jci.load_incremental_replay(root, jdense) == 6
        assert_same_state(want, jdense.state_dict())

    @pytest.mark.parametrize("kind", ["dedup", "native"])
    def test_heavy_churn_between_saves_keeps_refs_valid(self, tmp_path, kind):
        """A small ring wrapping many times between saves re-spills every span
        again and again; the ``cold_refs`` pin keeps the committed base's
        records readable, so the chain restores bit-exactly."""
        cls = CLASSES[kind][0]
        root, spill = str(tmp_path), str(tmp_path / "spill")

        def make():
            return cls(32, OBS, hot_frame_budget_bytes=512, spill_dir=spill,
                       spill_span_frames=4)
        rep = make()
        ck = IncrementalCheckpointer(root, rep, base_every=8, sync=True)
        seq = 0
        for save in range(4):
            for _ in range(6):
                add(rep, seq)
                rep.spill_cold()
                rep.sample(8, rng=np.random.default_rng(seq))
                rep.spill_cold()
                seq += 1
            ck.save(save + 1)
        want = rep.state_dict()
        r2 = make()
        assert load_incremental_replay(root, r2) == 4
        assert_same_state(want, r2.state_dict())

    def test_dense_chain_restores_into_tiered(self, tmp_path):
        root = str(tmp_path)
        rep = DedupReplay(64, OBS)
        ck = IncrementalCheckpointer(root, rep, base_every=2, sync=True)
        for k in range(5):
            add(rep, k)
            ck.save(k + 1)
        want = rep.state_dict()
        r2 = DedupReplay(64, OBS, hot_frame_budget_bytes=2048,
                         spill_dir=str(tmp_path / "spill2"), spill_span_frames=4)
        assert load_incremental_replay(root, r2) == 5
        assert_same_state(want, r2.state_dict())

    @pytest.mark.parametrize("kind", ["dedup", "native"])
    def test_torn_cold_record_restore_is_fallback_or_typed(self, tmp_path, kind):
        """Every record header of the spill file scribbled: a plain restore
        raises the typed error, and the fallback walk either restores a
        verified rung or raises typed; never frames that are wrong."""
        root, spill = str(tmp_path), str(tmp_path / "spill")
        self._build_chain(root, spill, CLASSES[kind][0])
        path = os.path.join(spill, "frames.cold")
        with open(path, "r+b") as f:
            for off in range(0, os.fstat(f.fileno()).st_size, 256):
                f.seek(off)
                f.write(b"\xde\xad")
        with pytest.raises(ChunkCorrupt):
            load_incremental_replay(root, DedupReplay(64, OBS))
        try:
            step = load_incremental_replay(root, DedupReplay(64, OBS), fallback=True)
        except ChunkCorrupt:
            return
        assert step is not None


class TestTierEvictor:
    def test_background_evictor_holds_budget(self, tmp_path):
        rep = DedupReplay(128, OBS, hot_frame_budget_bytes=4096,
                          spill_dir=str(tmp_path / "s"), spill_span_frames=4)
        ev = TierEvictor(rep, poll_s=0.01)
        ev.start()
        try:
            for k in range(12):
                add(rep, k)
            deadline = time.monotonic() + 10.0
            while time.monotonic() < deadline and rep.tier.hot_bytes > 4096:
                time.sleep(0.01)
            assert rep.tier.hot_bytes <= 4096
            assert ev.error is None and ev.heartbeat > 0
        finally:
            ev.stop()
        assert not ev.is_alive()
        dense = DedupReplay(128, OBS)
        for k in range(12):
            add(dense, k)
        assert_same_batch(dense.sample(8, rng=np.random.default_rng(9)),
                          rep.sample(8, rng=np.random.default_rng(9)))

    def test_evictor_error_is_kept_for_the_owner(self, tmp_path):
        class Broken:
            def tier_over_watermark(self):
                raise OSError("disk gone")

        ev = TierEvictor(Broken(), poll_s=0.01)
        ev.start()
        ev.join(5.0)
        assert isinstance(ev.error, OSError)


def _spill_victim(root: str, mode: str) -> None:
    """Kill-barrage child: ingest + spill (+ fault, in ``fault`` mode) + sync
    checkpoint saves as fast as it can until SIGKILLed."""
    rep = DedupReplay(64, OBS, hot_frame_budget_bytes=1024,
                      spill_dir=os.path.join(root, "spill"), spill_span_frames=4)
    ck = IncrementalCheckpointer(root, rep, sync=True, base_every=2)
    step = 0
    while True:
        add(rep, step)
        rep.spill_cold()
        if mode == "fault":
            rep.sample(8, rng=np.random.default_rng(step))
            rep.spill_cold()
        step += 1
        ck.save(step)


class TestSigkillMidSpillAndFault:
    @pytest.mark.parametrize("mode", ["spill", "fault"])
    def test_kill_leaves_detectable_records_and_restorable_chain(self, tmp_path, mode):
        """SIGKILL a child mid-spill or mid-fault: every record slot of the
        spill file is valid or typed-torn (read by both packages alike), and
        the committed chain restores, exactly, or walks back typed."""
        ctx = multiprocessing.get_context("fork")
        rng = np.random.default_rng(0)
        for round_i in range(2):
            root = str(tmp_path / f"{mode}-{round_i}")
            os.makedirs(root, exist_ok=True)
            proc = ctx.Process(target=_spill_victim, args=(root, mode), daemon=True)
            proc.start()
            try:
                deadline = time.monotonic() + 60.0
                while read_manifest(inc_dir(root)) is None:
                    assert proc.is_alive(), "victim died on its own"
                    assert time.monotonic() < deadline, "no commit in 60 s"
                    time.sleep(0.01)
                time.sleep(float(rng.uniform(0.02, 0.2)))
            finally:
                os.kill(proc.pid, signal.SIGKILL)
                proc.join(10.0)
            path = os.path.join(root, "spill", "frames.cold")
            stores = (ColdSpanStore(path, 20, 4 * int(np.prod(OBS))),
                      jtiered.ColdSpanStore(path, 20, 4 * int(np.prod(OBS))))
            for sid in range(20):
                for ab in (0, 1):
                    verdicts = []
                    for store, err in zip(stores, (ColdSpanCorrupt, jtiered.ColdSpanCorrupt)):
                        try:
                            verdicts.append(store.read(store.offset(sid, ab), sid=sid))
                        except err:
                            verdicts.append(None)
                    assert verdicts[0] == verdicts[1]
            for store in stores:
                store.close()
            manifest = read_manifest(inc_dir(root))
            rep = DedupReplay(64, OBS, hot_frame_budget_bytes=1024,
                              spill_dir=os.path.join(root, "spill"), spill_span_frames=4)
            try:
                step = load_incremental_replay(root, rep, fallback=True)
            except ChunkCorrupt:
                continue
            assert step is not None and step >= 1
            if mode == "spill":   # ingest-only: the feed to `step` is the state
                twin = DedupReplay(64, OBS)
                for k in range(step):
                    add(twin, k)
                assert_same_state(twin.state_dict(), rep.state_dict())
            assert manifest["step"] >= step
