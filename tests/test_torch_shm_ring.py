"""The port's shared-memory ring, record envelope and param seqlock against
the JAX package's.

Records and snapshots are byte-identical between the packages, and a
segment written by one is read by the other in both directions.  The cases
of ``tests/test_shm_ring.py`` that apply to the dense ``XP`` path run here
on the port's ring: framing, wraparound, backpressure, torn tails, stale
laps, a SIGKILL barrage of real producer processes (numpy only, no
torch), the pool's salvage and its round-robin sweep.
"""

from __future__ import annotations

import struct
import threading
import time

import numpy as np
import pytest
import torch

from ape_x_dqn_tpu.runtime import process_actors as jpa
from ape_x_dqn_tpu.runtime import shm_ring as jring
from ape_x_dqn_tpu.utils import serialization as jser
from ape_x_dqn_tpu_torch.config import ApexConfig
from ape_x_dqn_tpu_torch.runtime import process_actors as tpa
from ape_x_dqn_tpu_torch.runtime import shm_ring as tring
from ape_x_dqn_tpu_torch.utils import serialization as tser


def _join(parts) -> bytes:
    return b"".join(p if isinstance(p, bytes) else bytes(memoryview(p).cast("B"))
                    for p in parts)


def _arrays(rows=3, seed=0, obs=(4, 4, 1)):
    r = np.random.default_rng(seed)
    return {
        "prio": r.random(rows).astype(np.float32),
        "obs": r.integers(0, 255, (rows, *obs), dtype=np.uint8),
        "action": r.integers(0, 4, rows).astype(np.int32),
        "reward": r.normal(size=rows).astype(np.float32),
        "discount": np.full(rows, 0.97, np.float32),
        "next_obs": r.integers(0, 255, (rows, *obs), dtype=np.uint8),
    }


def _pair(ring_mod_owner, ring_mod_writer, capacity):
    owner = ring_mod_owner.ShmRing(capacity)
    writer = ring_mod_writer.ShmRing(capacity, name=owner.name, create=False)
    return owner, writer


def _release(owner, writer):
    writer.close()
    owner.close()
    owner.unlink()


# -- cross-package ------------------------------------------------------------


def test_encode_chunk_parts_bytes_equal_jax():
    arrays = _arrays(5, seed=1)
    kw = dict(source=3, chunk_seq=17, prev_frames=9, sent_t=1234.5, trace_id=0x5EED)
    assert _join(tring.encode_chunk_parts(tring.XP, 42, 80, arrays, **kw)) == \
        _join(jring.encode_chunk_parts(jring.XP, 42, 80, arrays, **kw))
    assert _join(tring.pack_array_parts(arrays)) == jser.tree_to_bytes(arrays)


@pytest.mark.parametrize("owner_mod,writer_mod", [(jring, tring), (tring, jring)],
                         ids=["port-writes-jax-reads", "jax-writes-port-reads"])
def test_ring_records_cross_packages(owner_mod, writer_mod):
    owner, writer = _pair(owner_mod, writer_mod, 1 << 15)
    try:
        sent = [_arrays(3 + i, seed=i) for i in range(12)]   # several laps
        for i, arrays in enumerate(sent):
            assert writer.write(writer_mod.encode_chunk_parts(writer_mod.XP, i, 3, arrays),
                                timeout=1.0)
            kind, version, _, steps, _, _, _, tid, back = owner_mod.decode_chunk(
                owner.read_next())
            assert (kind, version, steps, tid) == (1, i, 3, 0)
            assert back.keys() == arrays.keys()
            for k, v in arrays.items():
                np.testing.assert_array_equal(back[k], v)
        assert owner.read_next() is None and not owner.torn_tail()
    finally:
        _release(owner, writer)


@pytest.mark.parametrize("writer_mod,reader_mod", [(tpa, jpa), (jpa, tpa)],
                         ids=["port-writes-jax-reads", "jax-writes-port-reads"])
def test_param_buffer_cross_packages(writer_mod, reader_mod):
    owner = writer_mod.SharedParamBuffer(1 << 12)
    reader = reader_mod.SharedParamBuffer(1 << 12, name=owner.name, create=False)
    try:
        assert reader.read(-1, timeout=0.05) is None
        assert owner.write(b"first") == 1
        assert reader.read(-1) == (b"first", 1)
        assert reader.read(1, timeout=0.05) is None
        snapshot = tser.tree_to_bytes({"w": torch.arange(12, dtype=torch.float32)})
        assert owner.write(snapshot) == 2
        payload, version = reader.read(1)
        assert version == 2 and payload == snapshot
        np.testing.assert_array_equal(jser.tree_from_bytes(payload)["w"], np.arange(12))
    finally:
        reader._shm.close()
        owner.close()


def test_param_store_to_worker_source_roundtrip():
    from ape_x_dqn_tpu_torch.models.dueling import build_network

    net = build_network("mlp", 3, (4,), hidden_sizes=(8,))
    params = {k: v.detach().clone() for k, v in net.state_dict().items()}
    buf = tpa.SharedParamBuffer(1 << 16)
    try:
        store = tpa.SharedMemoryParamStore(buf)
        assert store.get(-1) is None
        assert store.publish(params) == 1 and store.version == 1
        template = {k: torch.zeros_like(v) for k, v in params.items()}
        source = tpa.SharedBufferParamSource(buf, template)
        restored, version = source.get(-1)
        assert version == 1 and restored.keys() == params.keys()
        for k in params:
            assert torch.equal(restored[k], params[k])
        assert source.get(1) is None
        held, held_version = store.get(0)
        assert held_version == 1 and torch.equal(held["value.bias"], params["value.bias"])
        # A JAX worker's source reads the same snapshot into numpy leaves.
        jsource = jpa.SharedBufferParamSource(
            buf, {k: v.numpy() for k, v in template.items()})
        jrestored, _ = jsource.get(-1)
        for k in params:
            np.testing.assert_array_equal(np.asarray(jrestored[k]), params[k].numpy())
    finally:
        buf.close()


# -- the param seqlock (tests/test_process_actors.py's cases) -----------------


def test_param_buffer_capacity_guard():
    buf = tpa.SharedParamBuffer(8)
    try:
        with pytest.raises(ValueError, match="exceeds"):
            buf.write(b"123456789")
    finally:
        buf.close()


@pytest.mark.parametrize("writer_mod", [tpa, jpa], ids=["port-buffer", "jax-buffer"])
def test_param_buffer_torn_write_times_out_not_hangs(writer_mod):
    """A writer that died mid-write (odd version) must not hang readers."""
    owner = writer_mod.SharedParamBuffer(64)
    reader = tpa.SharedParamBuffer(64, name=owner.name, create=False)
    try:
        struct.Struct("<qq").pack_into(owner._shm.buf, 0, 1, 4)  # odd: in flight
        t0 = time.monotonic()
        assert reader.read(-1, timeout=0.1) is None
        assert time.monotonic() - t0 < 1.0
    finally:
        reader.close()
        owner.close()


def test_param_buffer_concurrent_reader_never_sees_torn_payload():
    buf = tpa.SharedParamBuffer(4096)
    stop = threading.Event()
    bad = []

    def reader():
        while not stop.is_set():
            got = buf.read(-1, timeout=0.05)
            if got is not None and len(set(got[0])) != 1:  # must be homogeneous
                bad.append(got[0])

    t = threading.Thread(target=reader, daemon=True)
    t.start()
    try:
        for i in range(200):
            buf.write(bytes([i % 251]) * 2048)
    finally:
        stop.set()
        t.join(5.0)
        buf.close()
    assert not t.is_alive()
    assert not bad, f"torn payloads observed: {len(bad)}"


# -- the ring (tests/test_shm_ring.py's dense-path cases) ---------------------


def test_roundtrip_and_order():
    reader, writer = _pair(tring, tring, 1 << 12)
    try:
        assert reader.read_next() is None  # fresh ring: no phantom
        for i in range(5):
            assert writer.try_write([bytes([i]) * 100])
        for i in range(5):
            assert reader.read_next() == bytes([i]) * 100
        assert reader.read_next() is None
    finally:
        _release(reader, writer)


def test_gathered_parts_concatenate():
    reader, writer = _pair(tring, tring, 1 << 12)
    try:
        arr = np.arange(64, dtype=np.uint8)
        assert writer.try_write([b"head", arr, b"tail"])
        assert reader.read_next() == b"head" + arr.tobytes() + b"tail"
    finally:
        _release(reader, writer)


def test_wraparound_many_laps():
    reader, writer = _pair(tring, tring, 1000)  # deliberately unaligned
    try:
        for i in range(200):
            payload = bytes([i % 251]) * (100 + i % 37)
            assert writer.try_write([payload])
            assert reader.read_next() == payload
    finally:
        _release(reader, writer)


def test_large_records_use_the_windowed_crc_across_packages():
    """Payloads above 2 × the crc window take the sampled-crc path."""
    reader, writer = _pair(jring, tring, 1 << 16)
    try:
        r = np.random.default_rng(4)
        for _ in range(6):
            payload = r.integers(0, 256, 20_000, dtype=np.uint8).tobytes()
            assert writer.write([payload], timeout=1.0)
            assert reader.read_next() == payload
    finally:
        _release(reader, writer)


def test_backpressure_blocks_the_writer_and_counts_full_waits():
    reader, writer = _pair(tring, tring, 2048)
    try:
        n = 0
        while writer.try_write([b"x" * 400]):
            n += 1
        assert 1 <= n <= 5
        assert not writer.try_write([b"x" * 400])
        t0 = time.monotonic()
        assert writer.write([b"x" * 400], timeout=0.05) is False
        assert time.monotonic() - t0 >= 0.05
        assert writer.full_waits > 0 and reader.full_waits == writer.full_waits
        stop = threading.Event()
        stop.set()
        assert writer.write([b"x" * 400], should_stop=stop.is_set) is False
        assert reader.read_next() is not None  # free one record
        assert writer.try_write([b"x" * 400])
    finally:
        _release(reader, writer)


def test_oversized_record_raises():
    reader, writer = _pair(tring, tring, 1 << 10)
    try:
        with pytest.raises(ValueError, match="xp_ring_bytes"):
            writer.try_write([b"y" * 4096])
    finally:
        _release(reader, writer)


@pytest.mark.parametrize("reader_mod", [tring, jring], ids=["port-reader", "jax-reader"])
def test_torn_tail_detected_not_delivered(reader_mod):
    """A writer that died between the intent mark and the commit word leaves
    a tail the reader detects as torn and never delivers, while every
    committed record is delivered."""
    reader, writer = _pair(reader_mod, tring, 1 << 12)
    try:
        assert writer.try_write([b"committed-record"])
        writer._set(32, writer.started + 1)          # intent mark, no commit
        writer._copy_in(writer._widx + 16, memoryview(b"half-writ"))
        assert reader.read_next() == b"committed-record"
        assert reader.read_next() is None
        assert reader.torn_tail()
        assert reader.records_read == 1
    finally:
        _release(reader, writer)


def test_stale_lap_bytes_never_alias():
    reader, writer = _pair(tring, tring, 512)
    try:
        for i in range(40):  # many laps over the same bytes
            assert writer.try_write([bytes([i]) * 64])
            assert reader.read_next() == bytes([i]) * 64
        assert reader.read_next() is None
        assert not reader.torn_tail()
    finally:
        _release(reader, writer)


def test_unpack_views_are_zero_copy_and_read_only():
    arrays = {"a": np.arange(12, dtype=np.int32).reshape(3, 4)}
    out = tring.unpack_arrays(_join(tring.pack_array_parts(arrays)))
    np.testing.assert_array_equal(out["a"], arrays["a"])
    assert not out["a"].flags.writeable and out["a"].base is not None


def test_chunk_envelope_roundtrip():
    arrays = _arrays(4, seed=2)
    payload = _join(tring.encode_chunk_parts(tring.XP, 42, 4, arrays, source=3,
                                             chunk_seq=17, prev_frames=9, trace_id=0x5EED))
    kind, ver, sent_t, steps, src, cs, pf, tid, back = tring.decode_chunk(payload)
    assert (kind, ver, steps, src, cs, pf, tid) == (tring.XP, 42, 4, 3, 17, 9, 0x5EED)
    assert sent_t > 0
    for k, v in arrays.items():
        np.testing.assert_array_equal(back[k], v)


def test_session_prefixed_segment_names(monkeypatch):
    monkeypatch.setenv("APEX_SHM_SESSION", "t0k")
    ring = tring.ShmRing(1 << 10)
    try:
        assert ring.name.startswith("apxt0k_ring_")
    finally:
        ring.close()
        ring.unlink()


def test_owner_segment_is_unlinked_when_collected():
    import gc
    import os

    ring = tring.ShmRing(1 << 10)
    buf = tpa.SharedParamBuffer(64)
    names = [ring.name, buf.name]
    del ring, buf
    gc.collect()
    for name in names:
        assert not os.path.exists(f"/dev/shm/{name}")


# A producer process that imports only the port's ring (numpy, no torch):
# it attaches by name, leaves the segment to its owner (its own resource
# tracker would otherwise unlink it when the producer dies), and writes
# chunks whose version field is its chunk sequence until it is killed.
_PRODUCER = """
import sys
from multiprocessing import resource_tracker
import numpy as np
from ape_x_dqn_tpu_torch.runtime.shm_ring import XP, ShmRing, encode_chunk_parts
name, cap, wid, rows = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4])
ring = ShmRing(cap, name=name, create=False)
resource_tracker.unregister(ring._shm._name, "shared_memory")
r = np.random.default_rng(wid)
arrays = {"prio": r.random(rows).astype(np.float32),
          "obs": r.integers(0, 255, (rows, 16, 16, 1), dtype=np.uint8),
          "action": np.zeros(rows, np.int32), "reward": np.zeros(rows, np.float32),
          "discount": np.ones(rows, np.float32),
          "next_obs": r.integers(0, 255, (rows, 16, 16, 1), dtype=np.uint8)}
seq = 0
while True:
    if ring.write(encode_chunk_parts(XP, seq, rows, arrays), timeout=1.0):
        seq += 1
"""


def test_sigkill_barrage_salvages_all_committed():
    """Producer processes SIGKILLed at random moments mid-stream: every
    committed record is drained intact and in order; a kill mid-record
    surfaces as a torn tail, never as a delivered record."""
    import os
    import signal
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    rng = np.random.default_rng(0)
    workers, rounds, cap = 3, 3, 1 << 18
    killed = committed = consumed_total = lost = seq_errors = 0
    for _ in range(rounds):
        rings = [tring.ShmRing(cap) for _ in range(workers)]
        procs = [subprocess.Popen([sys.executable, "-c", _PRODUCER, r.name, str(cap),
                                   str(w), "32"], cwd=repo)
                 for w, r in enumerate(rings)]
        consumed = [0] * workers
        try:
            def drain():
                nonlocal seq_errors
                for w, r in enumerate(rings):
                    while (rec := r.read_next()) is not None:
                        if tring.decode_chunk(rec)[1] != consumed[w]:
                            seq_errors += 1
                        consumed[w] += 1

            deadline = time.monotonic() + 120.0
            while any(r.committed == 0 for r in rings):   # every producer ran
                drain()
                assert time.monotonic() < deadline, "producers never delivered"
                time.sleep(0.001)
            for w in rng.permutation(workers):
                t_kill = time.monotonic() + float(rng.uniform(0.01, 0.15))
                while time.monotonic() < t_kill:
                    drain()
                os.kill(procs[w].pid, signal.SIGKILL)
                killed += 1
            for p in procs:
                p.wait(timeout=10.0)
            drain()                                    # salvage the dead
            for w, r in enumerate(rings):
                committed += r.committed
                consumed_total += consumed[w]
                lost += max(0, r.committed - consumed[w])
                # A kill between the commit word and the counter update
                # delivers one record more than the counter shows.
                assert consumed[w] - r.committed in (0, 1)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait(timeout=10.0)
            for r in rings:
                r.close()
                r.unlink()
    assert killed == workers * rounds
    assert committed > 0 and lost == 0 and seq_errors == 0
    assert consumed_total >= committed


# -- the pool without workers -------------------------------------------------


def _pool_cfg(num_workers=1):
    cfg = ApexConfig()
    cfg.network = "mlp"
    cfg.env.name = "chain:6"
    cfg.actor.mode = "process"
    cfg.actor.num_workers = num_workers
    cfg.actor.num_actors = 2
    cfg.actor.xp_ring_bytes = 1 << 16
    return cfg.validate()


def _attach_fake_incarnation(pool, wid):
    pool._queues[wid] = pool._ctx.Queue(maxsize=4)
    pool._rings[wid] = tring.ShmRing(1 << 16)
    return tring.ShmRing(1 << 16, name=pool._rings[wid].name, create=False)


def test_pool_salvage_gives_respawn_fresh_ring():
    """A dead incarnation's committed records salvage into poll(), its torn
    tail is counted, and its ring is released (a respawn makes a new one)."""
    pool = tpa.ProcessActorPool(_pool_cfg(), num_workers=1)
    try:
        w = _attach_fake_incarnation(pool, 0)
        arrays = _arrays(2, seed=3, obs=(3,))
        assert w.try_write(tring.encode_chunk_parts(tring.XP, 5, 2, arrays))
        assert w.try_write(tring.encode_chunk_parts(tring.XP, 6, 2, arrays))
        w._set(32, w.started + 1)  # torn tail: intent, no commit
        w.close()
        pool._salvage_incarnation(0)
        assert len(pool._salvaged) == 2
        stats = pool.transport_stats()
        assert stats["salvaged_records"] == 2 and stats["torn_records"] == 1
        items = pool.poll(max_items=8)
        assert len(items) == 2 and pool.last_versions[0] == 6
        prio, trans = items[0]
        np.testing.assert_array_equal(prio, arrays["prio"])
        np.testing.assert_array_equal(trans.next_obs, arrays["next_obs"])
        assert 0 not in pool._rings and 0 not in pool._queues
    finally:
        pool.stop(join_timeout=1.0)


def test_poll_round_robins_rings_with_budget():
    cfg = _pool_cfg(num_workers=2)
    pool = tpa.ProcessActorPool(cfg, num_workers=2)
    writers = []
    try:
        arrays = _arrays(1, seed=4, obs=(3,))
        for wid in range(2):
            w = _attach_fake_incarnation(pool, wid)
            writers.append(w)
            for _ in range(6):
                assert w.try_write(tring.encode_chunk_parts(tring.XP, wid + 1, 1, arrays))
        # Both rings contribute even with a small per-poll item cap.
        items = pool.poll(max_items=8)
        assert len(items) == 8 and set(pool.last_versions) == {0, 1}
        # The byte budget bounds one sweep; the rest arrives next poll.
        rest = pool.poll(max_items=64, max_bytes=1)
        assert len(rest) >= 1
        assert len(items) + len(rest) + len(pool.poll(max_items=64)) == 12
        assert pool.transport_stats()["chunks"] == 12
    finally:
        for w in writers:
            w.close()
        pool.stop(join_timeout=1.0)


def _jax_pool():
    from ape_x_dqn_tpu.config import ApexConfig as JApexConfig

    cfg = JApexConfig()
    cfg.network = "mlp"
    cfg.env.name = "chain:6"
    cfg.actor.mode = "process"
    cfg.actor.num_workers = 1
    cfg.actor.num_actors = 2
    cfg.actor.xp_ring_bytes = 1 << 16
    return jpa.ProcessActorPool(cfg.validate(), num_workers=1)


def _dedup_chunk(seed=4):
    from ape_x_dqn_tpu_torch.actors.pool import Chunk
    from ape_x_dqn_tpu_torch.types import DedupChunk

    r = np.random.default_rng(seed)
    return Chunk(r.random(5).astype(np.float32), DedupChunk(
        frames=r.integers(0, 255, (7, 6), dtype=np.uint8),
        obs_ref=np.array([-2, -1, 0, 1, 2], np.int32),
        next_ref=np.array([3, 4, 5, 6, 6], np.int32),
        action=r.integers(0, 3, 5).astype(np.int32),
        reward=r.normal(size=5).astype(np.float32),
        discount=np.full(5, 0.97, np.float32),
        source=(1 << 62) + 12345, chunk_seq=7, prev_frames=9,
    ), 10)


def _assert_dedup_equal(got, want):
    for f in ("frames", "obs_ref", "next_ref", "action", "reward", "discount"):
        np.testing.assert_array_equal(getattr(got, f), np.asarray(getattr(want, f)), err_msg=f)
        assert getattr(got, f).dtype == np.asarray(getattr(want, f)).dtype, f
    assert (got.source, got.chunk_seq, got.prev_frames) == (
        want.source, want.chunk_seq, want.prev_frames)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_pool_decodes_a_dedup_record_as_the_jax_pool_does(writer):
    """A ``DXP`` record, written by the JAX package's encoder or by the
    port's worker encoder, decodes in the port's pool to the
    ``DedupChunk`` the JAX pool decodes from the same bytes."""
    from ape_x_dqn_tpu_torch.types import DedupChunk

    chunk = _dedup_chunk()
    t = chunk.transitions
    if writer == "jax":
        parts = jring.encode_chunk_parts(
            jring.DXP, 3, chunk.actor_steps,
            {"prio": chunk.priorities, **{k: getattr(t, k) for k in (
                "frames", "obs_ref", "next_ref", "action", "reward", "discount")}},
            source=t.source, chunk_seq=t.chunk_seq, prev_frames=t.prev_frames)
    else:
        parts = tpa.encode_record(chunk, 3)
    jpool = _jax_pool()
    try:
        jprio, jchunk, _ = jpool._decode_record(0, _join(parts))
    finally:
        jpool.stop(join_timeout=1.0)
    pool = tpa.ProcessActorPool(_pool_cfg(), num_workers=1)
    try:
        w = _attach_fake_incarnation(pool, 0)
        assert w.try_write(parts)
        w.close()
        (prio, got), = pool.poll(max_items=4)
    finally:
        pool.stop(join_timeout=1.0)
    assert isinstance(got, DedupChunk)
    np.testing.assert_array_equal(prio, jprio)
    _assert_dedup_equal(got, jchunk)
    _assert_dedup_equal(got, t)
    assert pool.last_versions[0] == 3 and pool.actor_steps == chunk.actor_steps


def test_ring_knob_validation():
    cfg = ApexConfig()
    cfg.actor.xp_ring_bytes = 1024
    with pytest.raises(ValueError, match="xp_ring_bytes"):
        cfg.validate()
