"""The port's tcp experience transport (``ape_x_dqn_tpu_torch/runtime/net.py``
``NetChannel`` / ``NetTransport`` / ``NetWriter``, the param-delta codec,
``runtime/transport.py``, ``config.transport_budget``) against the JAX
package's, mirrored from ``tests/test_net_transport.py``.

* The param codec: the port's delta bytes equal the JAX package's, and each
  package applies the other's deltas; the full-when-everything-moved
  fallback and the crc check.
* Channels: handshake and routing, bad token / stale attempt / unknown
  worker rejected, a disconnect mid-payload torn and never delivered, a
  reconnect with a fresh seq stream, a writer that reconnects after the
  learner drops it, the param fan-out full then delta, retired-channel
  accounting.
* The batch layers on the wire: a truncated coalesced frame, a bit flip
  inside a compressed payload, an out-of-window ref, a codec-mismatch
  hello and a compressed batch on an off-negotiated connection are torn
  and never ingested; the full stack on is bit-exact; max-wait, quantum and
  close flushes; the auto codec.
* Across the packages: the hello bytes and the whole v1 wire of a port
  writer equal a JAX writer's, a JAX writer feeds a port transport and a
  port writer a JAX transport (every codec), and params fan out both ways.
* The pool: tcp salvage counts the torn tail and retires the channel, and
  the tcp ingest is byte-identical to the shm ingest for the same records.
* The budget arithmetic and the knob checks equal the JAX package's.

Every socket wait has its own deadline.
"""

from __future__ import annotations

import socket
import struct
import threading
import time

import numpy as np
import pytest

from ape_x_dqn_tpu import config as jconfig
from ape_x_dqn_tpu.runtime import net as jnet
from ape_x_dqn_tpu_torch import config as tconfig
from ape_x_dqn_tpu_torch.runtime import net as tnet
from ape_x_dqn_tpu_torch.runtime.net import (
    _HELLO,
    _HELLO_EXT,
    _NET_MAGIC,
    _NET_VERSION,
    _NET_VERSION_EXT,
    CODEC_OFF,
    CODEC_ZLIB,
    F_XP,
    F_XPB,
    NetTransport,
    NetWriter,
    apply_param_delta,
    build_param_delta,
    build_param_full,
    encode_xpb_payload,
    frame_bytes,
)
from ape_x_dqn_tpu_torch.runtime.shm_ring import XP, decode_chunk, encode_chunk_parts

DEADLINE_S = 10.0
_FRAME_SIZE = tnet.FRAME.size


def _join(parts) -> bytes:
    return b"".join(p if isinstance(p, bytes) else bytes(memoryview(p).cast("B"))
                    for p in parts)


def _chunk_record(rows=8, n_step=3, seed=0, shape=(32, 32, 1), version=1) -> bytes:
    """One dense XP record with the n-step frame overlap of a real fleet
    (obs[i + n] == next_obs[i])."""
    rng = np.random.default_rng(seed)
    frames = rng.integers(0, 255, (rows + n_step, *shape), dtype=np.uint8)
    arrays = {
        "prio": (np.abs(rng.normal(size=rows)) + 0.1).astype(np.float32),
        "obs": frames[:rows],
        "action": rng.integers(0, 4, (rows,), dtype=np.int32),
        "reward": rng.normal(size=(rows,)).astype(np.float32),
        "discount": np.full((rows,), 0.97, np.float32),
        "next_obs": frames[n_step:rows + n_step],
    }
    return _join(encode_chunk_parts(XP, version, rows, arrays))


def _frames(*payloads, start_seq=1):
    return b"".join(frame_bytes(F_XP, start_seq + i, [p]) for i, p in enumerate(payloads))


def _hello(tr, wid=0, attempt=0, token=None, version=_NET_VERSION, ext=b""):
    return _HELLO.pack(_NET_MAGIC, version, wid, attempt,
                       tr.token if token is None else token) + ext


def _connect_raw(tr, **kw):
    s = socket.create_connection(("127.0.0.1", tr.port), timeout=5)
    s.sendall(_hello(tr, **kw))
    return s


def _pump_until(tr, cond, timeout=DEADLINE_S):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        tr.pump()
        if cond():
            return
        time.sleep(0.01)
    raise TimeoutError("condition not reached")


def _read_n(tr, ch, n, timeout=DEADLINE_S):
    got = []
    deadline = time.monotonic() + timeout
    while len(got) < n and time.monotonic() < deadline:
        tr.pump()
        rec = ch.read_next()
        if rec is not None:
            got.append(bytes(rec))
        else:
            time.sleep(0.005)
    return got


def _spec(tr, **wire):
    return {"host": "127.0.0.1", "port": tr.port, "token": tr.token, "wid": 0,
            "attempt": 0, **wire}


# -- the param codec ------------------------------------------------------------


def _blobs(n=300_000, seed=0, dirty=((1000, 32),)):
    rng = np.random.default_rng(seed)
    prev = rng.integers(0, 255, n, dtype=np.uint8).tobytes()
    new = bytearray(prev)
    for off, ln in dirty:
        new[off:off + ln] = bytes([0x7F]) * ln
    return prev, bytes(new)


@pytest.mark.parametrize("n,dirty", [
    (300_000, ((1000, 32),)),
    (300_000, ((0, 1), (150_000, 70_000), (299_990, 10))),
    (2_000, ((5, 3),)),
    (5 << 20, ((65_530, 12), (3 << 20, 1))),
])
def test_param_delta_bytes_equal_jax_and_cross_apply(n, dirty):
    prev, new = _blobs(n, dirty=dirty)
    d = build_param_delta(7, 6, prev, new)
    assert d == jnet.build_param_delta(7, 6, prev, new)
    assert d is not None and len(d) < len(new) // 2
    for apply in (apply_param_delta, jnet.apply_param_delta):
        assert apply(prev, d) == (7, 6, new)
    assert build_param_full(9, new) == jnet.build_param_full(9, new)


def test_param_delta_falls_back_to_full_when_everything_moved():
    rng = np.random.default_rng(1)
    prev = rng.integers(0, 255, 100_000, dtype=np.uint8).tobytes()
    new = rng.integers(0, 255, 100_000, dtype=np.uint8).tobytes()
    assert build_param_delta(2, 1, prev, new) is None
    assert build_param_delta(2, 1, prev, prev + b"x") is None    # size changed


def test_param_delta_crc_mismatch_raises():
    prev = bytes(200_000)
    new = bytearray(prev)
    new[5] = 1
    d = bytearray(build_param_delta(3, 2, prev, bytes(new)))
    d[-1] ^= 0x01
    for apply in (apply_param_delta, jnet.apply_param_delta):
        with pytest.raises(ValueError, match="crc"):
            apply(prev, bytes(d))
        with pytest.raises(ValueError):
            apply(bytes(199_999), bytes(d))     # the wrong baseline


# -- channels ---------------------------------------------------------------------


class TestNetTransportChannel:
    def test_handshake_routes_and_reads(self):
        tr = NetTransport()
        try:
            ch = tr.make_channel(0, 0)
            s = _connect_raw(tr)
            _pump_until(tr, lambda: ch.connected)
            s.sendall(_frames(b"r1", b"r2"))
            assert _read_n(tr, ch, 2) == [b"r1", b"r2"]
            assert ch.committed == 2 and not ch.torn_tail()
            s.close()
        finally:
            tr.close()

    def test_bad_token_stale_attempt_and_unknown_worker_rejected(self):
        tr = NetTransport()
        try:
            ch = tr.make_channel(0, 1)
            socks = [_connect_raw(tr, token=12345), _connect_raw(tr, attempt=0),
                     _connect_raw(tr, wid=9)]
            _pump_until(tr, lambda: tr.rejects >= 3)
            assert not ch.connected
            for s in socks:
                s.close()
        finally:
            tr.close()

    def test_disconnect_mid_payload_is_torn_never_delivered(self):
        tr = NetTransport()
        try:
            ch = tr.make_channel(0, 0)
            s = _connect_raw(tr)
            _pump_until(tr, lambda: ch.connected)
            s.sendall(_frames(b"whole-record"))
            s.sendall(frame_bytes(F_XP, 2, [b"y" * 4096])[:200])
            time.sleep(0.2)
            s.close()
            got = []
            deadline = time.monotonic() + DEADLINE_S
            while time.monotonic() < deadline:
                rec = ch.read_next()
                if rec is not None:
                    got.append(rec)
                if not ch.connected and ch.read_next() is None:
                    break
                time.sleep(0.01)
            assert got == [b"whole-record"]
            assert ch.torn_tail() and ch.torn_live >= 1
        finally:
            tr.close()

    def test_interleaved_reconnect_fresh_seq_stream(self):
        tr = NetTransport()
        try:
            ch = tr.make_channel(3, 2)
            a = _connect_raw(tr, wid=3, attempt=2)
            _pump_until(tr, lambda: ch.connected)
            a.sendall(_frames(b"from-A-1", b"from-A-2"))
            a.sendall(frame_bytes(F_XP, 3, [b"A-torn" * 500])[:50])
            got = _read_n(tr, ch, 2)
            b = _connect_raw(tr, wid=3, attempt=2)
            _pump_until(tr, lambda: ch.reconnects >= 1)
            a.close()
            b.sendall(_frames(b"from-B-1"))        # seq restarts at 1
            got += _read_n(tr, ch, 1)
            assert got == [b"from-A-1", b"from-A-2", b"from-B-1"]
            assert ch.torn_frames >= 1
            b.close()
        finally:
            tr.close()

    def test_writer_reconnects_after_channel_drop(self):
        tr = NetTransport()
        w = NetWriter(_spec(tr))
        try:
            ch = tr.make_channel(0, 0)
            assert w.write([b"first"], timeout=5)
            assert _read_n(tr, ch, 1) == [b"first"]
            with ch._send_lock:
                ch._retire_conn_locked()
            got, i = [], 0
            deadline = time.monotonic() + 15
            while not got and time.monotonic() < deadline:
                assert w.write([b"resent-%d" % i], timeout=10)
                i += 1
                tr.pump()
                rec = ch.read_next()
                if rec is not None:
                    got.append(rec)
            assert got and got[0].startswith(b"resent-")
            assert w.reconnects >= 1
        finally:
            w.close()
            tr.close()

    def test_param_fanout_full_then_delta(self):
        tr = NetTransport()
        w = NetWriter(_spec(tr))
        try:
            tr.make_channel(0, 0)
            assert w.write([b"hello-record"], timeout=5)
            blob1, blob2 = _blobs(500_000, seed=2, dirty=((100, 32),))
            _pump_until(tr, lambda: tr.stats()["connections"] == 1)
            push1 = tr.set_params(blob1, 1)
            assert (push1["full"], push1["delta"]) == (1, 0)
            _wait_params(w, 1)
            assert w.latest_params() == (blob1, 1)
            push2 = tr.set_params(blob2, 2)
            assert (push2["full"], push2["delta"]) == (0, 1)
            assert push2["bytes"] < len(blob2) // 4
            _wait_params(w, 2)
            assert w.latest_params() == (blob2, 2)
            s = tr.stats()
            assert (s["param_pushes"], s["param_delta"], s["param_full"]) == (2, 1, 1)
        finally:
            w.close()
            tr.close()


def _wait_params(writer, version, timeout=DEADLINE_S):
    deadline = time.monotonic() + timeout
    while (writer.latest_params() or (None, -1))[1] < version:
        assert time.monotonic() < deadline, "params never arrived"
        writer.pump_params()
        time.sleep(0.01)


def test_stats_survive_channel_retirement_and_keys_equal_jax():
    tr = NetTransport()
    jtr = jnet.NetTransport()
    try:
        ch = tr.make_channel(0, 0)
        s = _connect_raw(tr)
        _pump_until(tr, lambda: ch.connected)
        s.sendall(_frames(b"a", b"b"))
        assert len(_read_n(tr, ch, 2)) == 2
        s.close()
        ch.close()
        tr.drop_channel(0, ch)
        stats = tr.stats()
        assert set(stats) == set(jtr.stats())
        assert stats["expected"] == 0 and stats["frames_in"] == 2 and stats["bytes_in"] > 0
    finally:
        tr.close()
        jtr.close()
    assert tr.stats()["frames_in"] == 2      # and survives close()


# -- the batch layers on the wire -------------------------------------------------


def _v2(tr, codec):
    return _connect_raw(tr, version=_NET_VERSION_EXT, ext=_HELLO_EXT.pack(codec, 1))


class TestBatchAdversarial:
    def test_truncated_coalesced_frame_mid_record_is_torn(self):
        tr = NetTransport(codec="zlib")
        try:
            ch = tr.make_channel(0, 0)
            s = _v2(tr, CODEC_ZLIB)
            _pump_until(tr, lambda: ch.connected)
            whole, _ = encode_xpb_payload([b"first-record"], dedup=False)
            s.sendall(frame_bytes(F_XPB, 1, [whole]))
            batch2, _ = encode_xpb_payload([b"second-record", b"third-record"], dedup=False)
            torn = frame_bytes(F_XPB, 2, [batch2])
            s.sendall(torn[:len(torn) - 7])
            time.sleep(0.2)
            s.close()
            got = []
            deadline = time.monotonic() + DEADLINE_S
            while time.monotonic() < deadline:
                rec = ch.read_next()
                if rec is not None:
                    got.append(bytes(rec))
                elif not ch.connected:
                    break
                time.sleep(0.01)
            assert got == [b"first-record"]
            assert ch.torn_tail() and tr.stats()["torn_frames"] >= 1
        finally:
            tr.close()

    def test_bitflip_inside_compressed_payload_torn_and_retired(self):
        tr = NetTransport(codec="zlib")
        try:
            ch = tr.make_channel(0, 0)
            s = _v2(tr, CODEC_ZLIB)
            _pump_until(tr, lambda: ch.connected)
            payload, st = encode_xpb_payload([bytes(8192) * 4, bytes(range(256)) * 64],
                                             dedup=False, codec=CODEC_ZLIB)
            assert st["compressed"]
            evil = None
            for pos in range(len(payload) // 2, len(payload)):
                cand = bytearray(payload)
                cand[pos] ^= 0x20
                try:
                    tnet.decode_xpb_payload(bytes(cand))
                except ValueError:
                    evil = bytes(cand)
                    break
            assert evil is not None
            s.sendall(frame_bytes(F_XPB, 1, [evil]))   # a correct crc over the flip
            deadline = time.monotonic() + DEADLINE_S
            while time.monotonic() < deadline and tr.stats()["torn_frames"] < 1:
                assert ch.read_next() is None
                time.sleep(0.01)
            assert tr.stats()["torn_frames"] >= 1
            assert ch.committed == 0 and not ch.connected
            s.close()
        finally:
            tr.close()

    @pytest.mark.parametrize("case", ["ref_out_of_window", "zlib_on_off_connection"])
    def test_protocol_violation_torn_never_ingested(self, case):
        tr = NetTransport(codec="zlib")
        try:
            ch = tr.make_channel(0, 0)
            s = _v2(tr, CODEC_OFF)
            _pump_until(tr, lambda: ch.connected)
            if case == "ref_out_of_window":
                payload = b"\x00" + (struct.pack("<I", 1) + struct.pack("<I", 64)
                                     + struct.pack("<BIQ", 1, 64, 0))
            else:
                payload, st = encode_xpb_payload([bytes(4096) * 8], codec=CODEC_ZLIB,
                                                 dedup=False)
                assert st["compressed"]
            s.sendall(frame_bytes(F_XPB, 1, [payload]))
            _pump_until(tr, lambda: (ch.read_next(), False)[1]
                        or tr.stats()["torn_frames"] >= 1)
            assert ch.committed == 0
            s.close()
        finally:
            tr.close()

    def test_codec_mismatch_hello_rejected(self):
        tr = NetTransport(codec="off")
        try:
            ch = tr.make_channel(0, 0)
            s = _v2(tr, CODEC_ZLIB)
            _pump_until(tr, lambda: tr.rejects >= 1)
            assert tr.codec_rejects == 1 and not ch.connected
            s2 = _v2(tr, CODEC_OFF)
            _pump_until(tr, lambda: ch.connected)
            assert tr.stats()["codec_rejects"] == 1
            s.close()
            s2.close()
        finally:
            tr.close()


class TestWireEfficiencyEndToEnd:
    def test_coalesced_dedup_zlib_bit_exact_and_ratio(self):
        tr = NetTransport(codec="zlib")
        w = NetWriter(_spec(tr, codec="zlib", coalesce=4 << 20, coalesce_wait_ms=10_000.0,
                            dedup=True))
        try:
            ch = tr.make_channel(0, 0)
            recs = [_chunk_record(seed=s) for s in range(4)]
            for r in recs:
                assert w.write([r], timeout=5)
            assert w.flush(timeout=5)
            assert _read_n(tr, ch, 4) == recs
            s = tr.stats()
            assert s["torn_frames"] == 0 and s["coalesced_frames_in"] == 1
            assert s["records_per_frame"] == 4.0
            assert s["logical_bytes_in"] == sum(len(r) for r in recs)
            assert s["wire_over_logical"] < 1.0
            assert w.records_written == 4 and w.flushes == 1 and w.dedup_ref_bytes > 0
        finally:
            w.close()
            tr.close()

    def test_quantum_flush_and_close_flush(self):
        tr = NetTransport(codec="zlib")
        w = NetWriter(_spec(tr, codec="zlib", coalesce=64 << 20, coalesce_wait_ms=10_000.0))
        try:
            ch = tr.make_channel(0, 0)
            assert w.write([b"sits-in-the-buffer"], timeout=5)
            assert ch.read_next() is None
            assert w.flush(timeout=5)
            assert _read_n(tr, ch, 1) == [b"sits-in-the-buffer"]
            assert w.write([b"flushed-at-close"], timeout=5)
            w.close()
            assert _read_n(tr, ch, 1) == [b"flushed-at-close"]
        finally:
            w.close()
            tr.close()

    def test_auto_codec_gates_on_backpressure(self):
        w = NetWriter({"host": "127.0.0.1", "port": 1, "token": 1, "wid": 0, "attempt": 0,
                       "codec": "auto", "coalesce": 1 << 20})
        assert w._effective_codec() == CODEC_OFF
        w.full_waits += 3
        w._auto_update()
        assert w._effective_codec() == CODEC_ZLIB
        for _ in range(tnet._AUTO_OFF_FLUSHES):
            w._auto_update()
        assert w._effective_codec() == CODEC_OFF
        w.close()

    def test_max_wait_flush_on_next_write(self):
        tr = NetTransport()
        w = NetWriter(_spec(tr, coalesce=64 << 20, coalesce_wait_ms=1.0))
        try:
            ch = tr.make_channel(0, 0)
            assert w.write([b"one"], timeout=5)
            time.sleep(0.05)
            assert w.write([b"two"], timeout=5)
            assert _read_n(tr, ch, 2) == [b"one", b"two"]
            assert tr.stats()["coalesced_frames_in"] == 1
        finally:
            w.close()
            tr.close()


# -- across the packages ----------------------------------------------------------


WIRES = {
    "v1": {},
    "coalesce": {"coalesce": 1 << 20, "coalesce_wait_ms": 10_000.0},
    "coalesce_zlib": {"coalesce": 1 << 20, "coalesce_wait_ms": 10_000.0, "codec": "zlib"},
    "zlib_only": {"codec": "zlib"},
    "coalesce_nodedup": {"coalesce": 1 << 20, "coalesce_wait_ms": 10_000.0, "dedup": False},
}


def _raw_wire(writer_cls, wire, payloads):
    """Every byte a writer puts on a socket for ``payloads`` (then a flush
    and a close), as one accepting peer reads it."""
    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)
    w = writer_cls({"host": "127.0.0.1", "port": srv.getsockname()[1], "token": 77,
                    "wid": 3, "attempt": 1, **wire})
    ok = []
    th = threading.Thread(target=lambda: ok.append(
        all(w.write([p], timeout=5) for p in payloads) and w.flush(timeout=5)))
    try:
        th.start()
        srv.settimeout(DEADLINE_S)
        conn, _ = srv.accept()
        conn.settimeout(DEADLINE_S)
        th.join(DEADLINE_S)
        assert not th.is_alive() and ok == [True]
        closer = threading.Thread(target=w.close)   # a port writer waits for our EOF
        closer.start()
        raw = b""
        while True:
            data = conn.recv(1 << 16)
            if not data:
                break
            raw += data
        conn.close()
        closer.join(DEADLINE_S)
        return raw
    finally:
        w.close()
        srv.close()


@pytest.mark.parametrize("wire", sorted(WIRES))
def test_port_writer_bytes_equal_jax_writer(wire):
    """Hello and frames, byte for byte (v1 and v2 hellos, coalesced, dedup,
    zlib)."""
    payloads = [_chunk_record(seed=1), b"alpha-record", _chunk_record(rows=4, seed=2)]
    got = _raw_wire(NetWriter, WIRES[wire], payloads)
    assert got == _raw_wire(jnet.NetWriter, WIRES[wire], payloads)
    hello = got[:_HELLO.size]
    magic, version, wid, attempt, token = _HELLO.unpack(hello)
    assert (magic, wid, attempt, token) == (_NET_MAGIC, 3, 1, 77)
    assert version == (_NET_VERSION if wire == "v1" else _NET_VERSION_EXT)


@pytest.mark.parametrize("writer", ["net_writer", "central_client"])
def test_close_delivers_every_written_byte_never_a_reset(writer):
    """A writer closed with an unread reply in its receive buffer and part
    of its last frame still in its send queue: a plain close resets the
    connection and the peer reads a frame cut short (a torn frame at the
    learner or the serving tier); the graceful close delivers it whole."""
    import select as select_mod

    from ape_x_dqn_tpu_torch.serving.central import CentralInferenceClient

    srv = socket.socket()
    srv.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 1 << 16)
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)
    srv.settimeout(DEADLINE_S)
    port = srv.getsockname()[1]
    payload = b"q" * (1 << 20)
    try:
        if writer == "net_writer":
            w = NetWriter({"host": "127.0.0.1", "port": port, "token": 7, "wid": 0,
                           "attempt": 0})
            assert w.write([payload], timeout=DEADLINE_S)   # handed to the kernel
            want = _HELLO.size + _FRAME_SIZE + len(payload)
        else:
            w = CentralInferenceClient("127.0.0.1", port, wid=0, attempt=0, token=0)
            assert w._ensure_connected()
            w._sock.sendall(payload)
            want = tnet.SERVE_HELLO.size + tnet.SERVE_HELLO_EXT.size + len(payload)
        conn, _ = srv.accept()
        conn.sendall(b"r" * 100)                 # never read by the writer
        deadline = time.monotonic() + DEADLINE_S
        while not select_mod.select([w._sock], [], [], 0.05)[0]:
            assert time.monotonic() < deadline
        w.close()
        conn.settimeout(DEADLINE_S)
        got = 0
        while True:
            data = conn.recv(1 << 16)            # a reset would raise here
            if not data:
                break
            got += len(data)
        conn.close()
        assert got == want
    finally:
        srv.close()


@pytest.mark.parametrize("direction", ["jax_writer_port_transport", "port_writer_jax_transport"])
@pytest.mark.parametrize("wire", ["v1", "coalesce_zlib"])
def test_cross_package_records_and_params(direction, wire):
    """A writer of one package feeds a transport of the other: the same
    records come out, and the transport's param pushes (full, then a
    delta) reach the writer bit for bit."""
    port_tr = direction == "jax_writer_port_transport"
    tr = (NetTransport if port_tr else jnet.NetTransport)(codec="zlib")
    writer_cls = jnet.NetWriter if port_tr else NetWriter
    w = writer_cls(_spec(tr, **WIRES[wire]))
    try:
        ch = tr.make_channel(0, 0)
        recs = [_chunk_record(seed=s) for s in range(3)] + [b"tail-record"]
        for r in recs:
            assert w.write([r], timeout=5)
        assert w.flush(timeout=5)
        assert _read_n(tr, ch, len(recs)) == recs
        assert tr.stats()["torn_frames"] == 0
        blob1, blob2 = _blobs(400_000, seed=4, dirty=((70_000, 100),))
        assert tr.set_params(blob1, 1)["full"] == 1
        _wait_params(w, 1)
        assert tr.set_params(blob2, 2)["delta"] == 1
        _wait_params(w, 2)
        assert w.latest_params() == (blob2, 2)
    finally:
        w.close()
        tr.close()


# -- the pool on the tcp backend --------------------------------------------------


def _pool_cfg(transport, **actor):
    cfg = tconfig.ApexConfig()
    cfg.network = "mlp"
    cfg.env.name = "chain:6"
    cfg.actor.mode = "process"
    cfg.actor.transport = transport
    cfg.actor.num_workers = 1
    cfg.actor.num_actors = 2
    cfg.actor.xp_ring_bytes = 1 << 16
    for k, v in actor.items():
        setattr(cfg.actor, k, v)
    return cfg.validate()


def _pool_channel(pool):
    """A channel of wid 0 with its writer, as a spawned worker would get."""
    from ape_x_dqn_tpu_torch.runtime.transport import connect_channel

    pool._queues[0] = pool._ctx.Queue(maxsize=4)
    pool._rings[0] = pool._transport.make_channel(0, 0)
    spec = pool._transport.endpoint(pool._rings[0], 0, 0)
    return spec, connect_channel(spec)


def _records(n=3, seed=11):
    rng = np.random.default_rng(seed)
    frames = rng.integers(0, 255, (7, 8, 8, 1), dtype=np.uint8)
    arrays = {"prio": rng.random(4).astype(np.float32), "obs": frames[:4],
              "action": np.arange(4, dtype=np.int32),
              "reward": rng.normal(size=4).astype(np.float32),
              "discount": np.full(4, 0.97, np.float32), "next_obs": frames[3:]}
    return [encode_chunk_parts(XP, 20 + k, 4, arrays, trace_id=0xF00 + k) for k in range(n)]


def test_pool_tcp_salvage_counts_torn_and_retires_channel():
    from ape_x_dqn_tpu_torch.runtime.process_actors import ProcessActorPool

    pool = ProcessActorPool(_pool_cfg("tcp"), num_workers=1)
    try:
        assert pool.buffer is None and pool.transport_kind == "tcp"
        assert pool.shm_accounting()["shm_segments"] == 0
        _, w = _pool_channel(pool)
        for parts in _records(2):
            assert w.write(parts, timeout=5)
        _pump_until(pool._transport, lambda: pool._rings[0].connected)
        time.sleep(0.3)
        w._sock.sendall(frame_bytes(F_XP, 3, [b"z" * 2048])[:100])
        time.sleep(0.2)
        w._sock.close()
        time.sleep(0.2)
        pool._salvage_incarnation(0)
        assert len(pool._salvaged) == 2
        stats = pool.transport_stats()
        assert stats["transport"] == "tcp" and stats["torn_records"] == 1
        assert len(pool.poll(max_items=8)) == 2
        assert pool.last_versions[0] == 21 and 0 not in pool._rings
        assert pool.net_stats()["expected"] == 0    # the channel left the registry
    finally:
        pool.stop(join_timeout=1.0)


@pytest.mark.parametrize("wire", [{}, {"net_codec": "zlib", "net_coalesce_bytes": 1 << 20}],
                         ids=["v1", "coalesce_zlib"])
def test_pool_tcp_ingest_byte_identical_to_shm(wire):
    """The same worker records through either backend decode to the same
    chunks; the tcp payload is the ring record byte for byte."""
    from ape_x_dqn_tpu_torch.runtime.process_actors import ProcessActorPool

    records = _records()
    out = {}
    for transport in ("shm", "tcp"):
        pool = ProcessActorPool(_pool_cfg(transport, **(wire if transport == "tcp" else {})),
                                num_workers=1)
        seen = []
        decode = pool._decode_record
        pool._decode_record = lambda wid, rec: (seen.append(bytes(rec)), decode(wid, rec))[1]
        try:
            _, w = _pool_channel(pool)
            for parts in records:
                assert w.write(parts, timeout=5)
            if transport == "tcp":
                assert w.flush(timeout=5)
            items = []
            deadline = time.monotonic() + DEADLINE_S
            while len(items) < len(records) and time.monotonic() < deadline:
                items.extend(pool.poll(max_items=8))
                time.sleep(0.01)
            out[transport] = (seen, items)
            w.close()
            if transport == "tcp":
                assert pool.net_stats()["torn_frames"] == 0
        finally:
            pool.stop(join_timeout=1.0)
    assert out["tcp"][0] == out["shm"][0] == [_join(p) for p in records]
    for (p_shm, t_shm), (p_tcp, t_tcp) in zip(out["shm"][1], out["tcp"][1]):
        np.testing.assert_array_equal(p_shm, p_tcp)
        for f in ("obs", "action", "reward", "discount", "next_obs"):
            np.testing.assert_array_equal(getattr(t_shm, f), getattr(t_tcp, f))
    kind, ver, _, steps, _, _, _, tid, _ = decode_chunk(out["tcp"][0][1])
    assert (kind, ver, steps, tid) == (XP, 21, 4, 0xF01)


# -- the budget and the knobs -------------------------------------------------------


@pytest.mark.parametrize("transport,hosts,w,codec,coal", [
    ("shm", 1, 256, "off", 0),
    ("tcp", 4, 64, "off", 0),
    ("tcp", 2, 8, "zlib", 2 << 20),
    ("tcp", 2, 8, "auto", 0),
    ("tcp", 3, 7, "off", 1 << 16),
])
def test_transport_budget_equals_jax(transport, hosts, w, codec, coal):
    def cfg(mod):
        c = mod.ApexConfig()
        c.actor.transport = transport
        c.actor.transport_hosts = hosts
        c.actor.net_codec = codec
        c.actor.net_coalesce_bytes = coal
        return c.validate()

    got = tconfig.transport_budget(cfg(tconfig), num_workers=w)
    assert got == jconfig.transport_budget(cfg(jconfig), num_workers=w)
    assert sum(h["workers"] for h in got["per_host"]) == w


@pytest.mark.parametrize("settings,message", [
    ({"transport": "bogus"}, "actor.transport"),
    ({"transport_hosts": 2}, "transport_hosts"),
    ({"transport": "tcp", "transport_port": 99999}, "transport_port"),
    ({"transport": "tcp", "net_conn_buf_bytes": 1024}, "net_conn_buf_bytes"),
    ({"transport": "tcp", "net_codec": "gzip9"}, "net_codec"),
    ({"transport": "tcp", "net_coalesce_bytes": 512}, "net_coalesce_bytes"),
    ({"transport": "tcp", "net_coalesce_wait_ms": -1.0}, "net_coalesce_wait_ms"),
    ({"net_codec": "zlib"}, "transport=tcp"),
])
def test_wire_knob_validation_equals_jax(settings, message):
    for mod in (tconfig, jconfig):
        cfg = mod.ApexConfig()
        for k, v in settings.items():
            setattr(cfg.actor, k, v)
        with pytest.raises(ValueError, match=message):
            cfg.validate()


def test_make_transport_per_connection_budget_and_endpoint():
    from ape_x_dqn_tpu_torch.runtime.transport import ShmTransport, TcpTransport, make_transport

    cfg = _pool_cfg("tcp", transport_host="0.0.0.0")
    tr = make_transport(cfg, 8, 1 << 16, 64 << 20)
    try:
        assert isinstance(tr, TcpTransport)
        assert tr.net._drain_budget == 8 << 20
        spec = tr.endpoint(tr.make_channel(2, 1), 2, 1)
        assert spec["host"] == "127.0.0.1" and spec["port"] == tr.port > 0
        assert (spec["wid"], spec["attempt"], spec["token"]) == (2, 1, tr.net.token)
    finally:
        tr.close()
    assert isinstance(make_transport(_pool_cfg("shm"), 8, 1 << 16, 64 << 20), ShmTransport)
    wide = make_transport(_pool_cfg("tcp"), 4096, 1 << 16, 64 << 20)
    try:
        assert wide.net._drain_budget == 64 << 10       # the floor
    finally:
        wide.close()
