"""The port's serving wire (``ape_x_dqn_tpu_torch/runtime/net.py``) and
socket front end (``serving/net_server.py``) against the JAX package's,
mirrored from ``tests/test_serving_net.py``.

Wire: every codec's bytes equal the JAX package's (request, reply, error,
``F_IREQ`` / ``F_IREP`` with codec off and zlib, dedup on and off, hellos
v1 and v2, trace prefix, ``frame_bytes`` below and above the crc window,
the xpb container), each package decodes the other's bytes, and the
``FrameParser`` yields the same frames and faults on the same streams.
Server: the adversarial decode matrix against a live port server (torn,
bit-flipped, oversize, out-of-sequence and wrong-kind frames counted and
never decoded; a bad hello refused before framing; a well-framed bad
request typed), the client's retry across a server restart, a JAX client
against a port server and a port client against a JAX server, and a port
server behind the JAX ``ServingRouter`` beside a JAX replica.
"""

from __future__ import annotations

import socket
import struct
import time
from concurrent.futures import Future

import numpy as np
import pytest

from ape_x_dqn_tpu.runtime import net as jnet
from ape_x_dqn_tpu.serving import net_server as jserver
from ape_x_dqn_tpu.serving.batcher import ServedAction as JServedAction
from ape_x_dqn_tpu.serving.router import ServingRouter
from ape_x_dqn_tpu_torch.runtime import net as tnet
from ape_x_dqn_tpu_torch.runtime.net import (
    E_BAD_REQUEST,
    E_OVERLOADED,
    F_SERR,
    F_SREP,
    F_SREQ,
    FRAME,
    FrameParser,
    decode_error,
    decode_reply,
    decode_request,
    encode_error,
    encode_reply,
    encode_request,
    frame_bytes,
    serve_hello_bytes,
)
from ape_x_dqn_tpu_torch.serving.batcher import ServedAction, ServerOverloaded
from ape_x_dqn_tpu_torch.serving.net_server import ServingClient, ServingNetServer


class StubPolicy:
    """PolicyServer stand-in: instant completed futures."""

    def __init__(self, num_actions: int = 4, version: int = 7, served_cls=ServedAction):
        self.param_version = version
        self.served = 0
        self.fail_with = None
        self._cls = served_cls

    def submit(self, obs) -> Future:
        if self.fail_with is not None:
            raise self.fail_with
        f = Future()
        self.served += 1
        f.set_result(self._cls(int(np.asarray(obs).sum()) % 4,
                               np.arange(4, dtype=np.float32), self.param_version, 0.0))
        return f


@pytest.fixture
def net_server():
    srv = ServingNetServer(StubPolicy()).start()
    yield srv
    srv.close()


def _raw_conn(port: int, hello: bytes = None) -> socket.socket:
    s = socket.create_connection(("127.0.0.1", port), timeout=5.0)
    s.sendall(serve_hello_bytes() if hello is None else hello)
    return s


def _wait(cond, timeout=5.0, msg="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.01)
    raise AssertionError(f"timeout waiting for {msg}")


def _obs(n=5, shape=(8, 8, 4), seed=0, repeat=True):
    o = np.random.default_rng(seed).integers(0, 256, (n, *shape), dtype=np.uint8)
    if repeat and n > 2:
        o[2] = o[1]            # a repeated row: in-request dedup has work
        o[0, 1] = o[0, 0]      # a repeated plane inside one row
    return o


# -- wire bytes ----------------------------------------------------------------


def test_wire_constants_equal_jax():
    names = [n for n in dir(jnet) if n.isupper() and not n.startswith("_")]
    assert names
    for n in names:
        want = getattr(jnet, n)
        got = getattr(tnet, n)
        if isinstance(want, struct.Struct):
            got, want = got.format, want.format
        assert got == want, n


@pytest.mark.parametrize("shape", [(84, 84, 1), (8,), (4, 4), (2, 3, 4, 5), ()])
def test_request_bytes_equal_jax(shape):
    obs = np.random.default_rng(1).integers(0, 255, shape, dtype=np.uint8)
    assert tnet.encode_request(123, obs) == jnet.encode_request(123, obs)
    rid, back = tnet.decode_request(jnet.encode_request(9, obs))
    assert rid == 9
    np.testing.assert_array_equal(back, obs)


def test_reply_and_error_bytes_equal_jax():
    q = np.arange(6, dtype=np.float32) * 0.5
    assert tnet.encode_reply(9, 3, 42, q) == jnet.encode_reply(9, 3, 42, q)
    assert tnet.decode_reply(jnet.encode_reply(9, 3, 42, q))[:3] == (9, 3, 42)
    for msg in ("queue full", "", "x" * 600, "ünïcode"):
        assert tnet.encode_error(5, E_OVERLOADED, msg) == jnet.encode_error(5, E_OVERLOADED, msg)
        assert tnet.decode_error(jnet.encode_error(5, 2, msg)) == jnet.decode_error(
            jnet.encode_error(5, 2, msg))


@pytest.mark.parametrize("codec", ["off", "zlib"])
@pytest.mark.parametrize("dedup", [True, False])
@pytest.mark.parametrize("shape", [(8, 8, 4), (84, 84, 1), (6,)])
def test_inference_request_bytes_equal_jax(codec, dedup, shape):
    c = {"off": tnet.CODEC_OFF, "zlib": tnet.CODEC_ZLIB}[codec]
    obs = _obs(5, shape)
    got, st = tnet.encode_inference_request(77, obs, codec=c, dedup=dedup)
    want, jst = jnet.encode_inference_request(77, obs, codec=c, dedup=dedup)
    assert got == want and st == jst
    for decode, payload in ((tnet.decode_inference_request, want),
                            (jnet.decode_inference_request, got)):
        rid, rows = decode(payload)
        assert rid == 77
        np.testing.assert_array_equal(np.stack(rows), obs)


def test_inference_reply_bytes_equal_jax():
    a = np.array([0, 3, 1, 2], np.int32)
    q = np.random.default_rng(2).standard_normal((4, 5)).astype(np.float32)
    got = tnet.encode_inference_reply(11, a, 6, q)
    assert got == jnet.encode_inference_reply(11, a, 6, q)
    rid, acts, version, qq = tnet.decode_inference_reply(got)
    assert (rid, version) == (11, 6)
    np.testing.assert_array_equal(acts, a)
    np.testing.assert_array_equal(qq, q)


@pytest.mark.parametrize("args", [(), (3, 2, 99), (3, 2, 99, 1), (3, 2, 99, 1, 1),
                                  (-1, 0, (1 << 62), 0, 0)])
def test_hello_bytes_equal_jax(args):
    if not args:
        assert tnet.serve_hello_bytes() == jnet.serve_hello_bytes()
        assert tnet.parse_serve_hello(jnet.serve_hello_bytes())
        assert not tnet.parse_serve_hello(b"GET / HT")
        return
    got = tnet.serve_hello_ext_bytes(*args)
    assert got == jnet.serve_hello_ext_bytes(*args)
    assert tnet.parse_serve_hello_ext(got[8:]) == jnet.parse_serve_hello_ext(got[8:])
    assert tnet.parse_serve_hello_ext(got[8:-1]) is None


def test_trace_prefix_equal_jax():
    payload = tnet.encode_request(1, np.zeros(4, np.uint8))
    got = tnet.wrap_trace(1 << 40, payload)
    assert got == jnet.wrap_trace(1 << 40, payload)
    tid, rest = tnet.split_trace(got)
    assert tid == 1 << 40 and bytes(rest) == payload
    with pytest.raises(ValueError):
        tnet.split_trace(b"abc")


@pytest.mark.parametrize("nbytes", [0, 100, 8192, 8193, 50_000])
@pytest.mark.parametrize("crc_full", [False, True])
def test_frame_bytes_equal_jax(nbytes, crc_full):
    payload = np.random.default_rng(nbytes).integers(0, 256, nbytes, dtype=np.uint8)
    parts = [payload[: nbytes // 3].tobytes(), memoryview(payload[nbytes // 3:])]
    got = tnet.frame_bytes(tnet.F_IREQ, 7, parts, crc_full=crc_full)
    assert got == jnet.frame_bytes(jnet.F_IREQ, 7, parts, crc_full=crc_full)


@pytest.mark.parametrize("codec", [0, 1])
def test_xpb_container_equal_jax(codec):
    rng = np.random.default_rng(3)
    frame = rng.integers(0, 256, 256, dtype=np.uint8).tobytes()
    records = [b"head" + frame + frame, rng.bytes(300), frame + b"tail"]
    spans = [[(4, 256), (260, 256)], [], [(0, 256)]]
    got = tnet.encode_xpb_payload(records, codec=codec, spans=spans)
    assert got == jnet.encode_xpb_payload(records, codec=codec, spans=spans)
    assert got[1]["dedup_hits"] == 2
    assert [bytes(r) for r in tnet.decode_xpb_payload(got[0])] == records
    with pytest.raises(ValueError):
        tnet.decode_xpb_payload(got[0][:-3])
    with pytest.raises(ValueError):
        tnet.decode_batch(b"\x01\x00\x00\x00\x05\x00\x00\x00\x01\x05\x00\x00\x00"
                          + struct.pack("<Q", 0))       # ref outside the window


def test_frame_parser_equals_jax_on_split_and_faulty_streams():
    rng = np.random.default_rng(5)
    frames = b"".join(tnet.frame_bytes(F_SREQ, i + 1, [rng.bytes(int(rng.integers(0, 9000)))])
                      for i in range(6))
    flipped = bytearray(frames)
    flipped[FRAME.size + 3] ^= 0x08
    skipped = frames + tnet.frame_bytes(F_SREQ, 9, [b"x"])
    oversize = FRAME.pack(1 << 20, 0, 1, F_SREQ)
    for stream, max_frame in ((frames, 1 << 30), (bytes(flipped), 1 << 30),
                              (skipped, 1 << 30), (oversize, 1 << 16)):
        results = []
        for mod in (tnet, jnet):
            p = mod.FrameParser(max_frame=max_frame)
            got, pos = [], 0
            for cut in sorted(rng.integers(0, len(stream) + 1, 7)) + [len(stream)]:
                p.feed(stream[pos:cut])
                pos = cut
                while (f := p.next()) is not None:
                    got.append(f)
            results.append((got, p.error, p.seq, p.frames, p.pending()))
        assert results[0] == results[1]


# -- the port's codecs alone -----------------------------------------------------


class TestCodec:
    def test_shape_mismatch_typed(self):
        payload = bytearray(encode_request(1, np.zeros((4, 4), np.uint8)))
        with pytest.raises(ValueError, match="shape"):
            decode_request(bytes(payload[:-1]))

    def test_bad_dtype_code_typed(self):
        payload = bytearray(encode_request(1, np.zeros(4, np.uint8)))
        payload[9] = 99
        with pytest.raises(ValueError, match="dtype"):
            decode_request(bytes(payload))

    def test_roundtrips(self):
        q = np.arange(6, dtype=np.float32) * 0.5
        rid, action, version, back = decode_reply(encode_reply(9, 3, 42, q))
        assert (rid, action, version) == (9, 3, 42)
        np.testing.assert_array_equal(back, q)
        assert decode_error(encode_error(5, E_OVERLOADED, "queue full")) == (
            5, E_OVERLOADED, "queue full")

    def test_backoff_doubles_and_resets(self):
        b = tnet.Backoff(base_s=0.05, max_s=0.2, jitter=0.0, seed=1)
        assert b.ready()
        delays = []
        for _ in range(4):
            t0 = time.monotonic()
            b.fail()
            delays.append(b._next_ok - t0)
        assert delays == pytest.approx([0.05, 0.1, 0.2, 0.2], abs=5e-3)
        assert not b.ready()
        b.reset()
        assert b.ready()


# -- the server's adversarial decode matrix ----------------------------------------


class TestServerAdversarial:
    def _req_frame(self, seq=1, rid=1):
        return frame_bytes(F_SREQ, seq, [encode_request(rid, np.zeros(8, np.uint8))])

    def test_truncation_mid_prefix(self, net_server):
        s = _raw_conn(net_server.port)
        s.sendall(self._req_frame()[:FRAME.size - 3])
        s.close()
        _wait(lambda: net_server.torn_frames == 1, msg="torn count")
        assert net_server.requests == 0

    def test_whole_frames_before_fin_are_not_torn(self, net_server):
        """Two whole requests and the FIN in one write (a client that stops
        with requests in flight): the server may read all of it in one
        wakeup; no frame was cut, so none counts torn."""
        s = _raw_conn(net_server.port)
        s.sendall(self._req_frame(seq=1, rid=1) + self._req_frame(seq=2, rid=2))
        s.shutdown(socket.SHUT_WR)
        s.settimeout(5.0)
        while s.recv(4096):
            pass
        s.close()
        _wait(lambda: net_server.stats()["connections"] == 0, msg="retired")
        assert net_server.torn_frames == 0

    def test_truncation_mid_payload(self, net_server):
        s = _raw_conn(net_server.port)
        s.sendall(self._req_frame()[:FRAME.size + 5])
        s.close()
        _wait(lambda: net_server.torn_frames == 1, msg="torn count")
        assert net_server.requests == 0

    def test_crc_bitflip_retires_connection(self, net_server):
        buf = bytearray(self._req_frame())
        buf[FRAME.size + 4] ^= 0x10
        s = _raw_conn(net_server.port)
        s.sendall(bytes(buf))
        _wait(lambda: net_server.torn_frames == 1, msg="torn count")
        assert net_server.requests == 0
        s.settimeout(5.0)
        assert s.recv(64) == b""
        s.close()

    def test_oversize_length_prefix_rejected(self, net_server):
        s = _raw_conn(net_server.port)
        s.sendall(FRAME.pack(64 << 20, 0, 1, F_SREQ))
        _wait(lambda: net_server.torn_frames == 1, msg="torn count")
        assert net_server.requests == 0
        s.settimeout(5.0)
        assert s.recv(64) == b""
        s.close()

    def test_wrong_kind_is_protocol_violation(self, net_server):
        s = _raw_conn(net_server.port)
        s.sendall(frame_bytes(F_SREP, 1, [b"client-sent-a-reply"]))
        _wait(lambda: net_server.torn_frames == 1, msg="torn count")
        assert net_server.requests == 0
        s.close()

    def test_bad_hello_rejected_before_framing(self, net_server):
        s = _raw_conn(net_server.port, hello=b"GET / HT")
        s.settimeout(5.0)
        assert s.recv(64) == b""
        _wait(lambda: net_server.bad_hellos == 1, msg="bad hello")
        assert net_server.torn_frames == 0
        s.close()

    def test_seq_skip_detected(self, net_server):
        s = _raw_conn(net_server.port)
        s.sendall(self._req_frame(seq=1, rid=1))
        s.sendall(self._req_frame(seq=3, rid=2))
        _wait(lambda: net_server.torn_frames == 1, msg="torn count")
        assert net_server.requests == 1
        s.close()

    def test_well_framed_bad_request_is_typed_not_torn(self, net_server):
        bad = bytearray(encode_request(7, np.zeros(8, np.uint8)))
        bad[9] = 99
        s = _raw_conn(net_server.port)
        s.sendall(frame_bytes(F_SREQ, 1, [bytes(bad)]))
        _wait(lambda: net_server.errors == 1, msg="typed error")
        assert net_server.torn_frames == 0
        p = FrameParser()
        s.settimeout(5.0)
        while (got := p.next()) is None:
            p.feed(s.recv(4096))
        kind, payload = got
        assert kind == F_SERR
        assert decode_error(payload)[1] == E_BAD_REQUEST
        s.sendall(self._req_frame(seq=2, rid=8))
        _wait(lambda: net_server.requests == 1, msg="follow-up served")
        s.close()

    def test_shed_is_typed_reply(self, net_server):
        net_server._server.fail_with = ServerOverloaded("full")
        c = ServingClient("127.0.0.1", net_server.port)
        with pytest.raises(ServerOverloaded):
            c.act(np.zeros(8, np.uint8), timeout=5.0)
        assert net_server.shed == 1
        c.close()

    def test_stats_keys_equal_jax(self, net_server):
        j = jserver.ServingNetServer(StubPolicy(served_cls=JServedAction))
        try:
            assert set(net_server.stats()) == set(j.stats())
        finally:
            j.close()


class TestClientRetry:
    def test_roundtrip_and_latency(self, net_server):
        c = ServingClient("127.0.0.1", net_server.port)
        r = c.act(np.ones((4, 4), np.uint8), timeout=5.0)
        assert r.param_version == 7 and r.action == 16 % 4
        assert r.latency_s < 5.0 and c.retries == 0
        c.close()

    def test_client_survives_server_restart(self):
        policy = StubPolicy()
        srv = ServingNetServer(policy).start()
        c = ServingClient("127.0.0.1", srv.port)
        assert c.act(np.zeros(4, np.uint8), timeout=5.0).action >= 0
        srv.close()
        srv2 = ServingNetServer(policy).start()
        c.port = srv2.port
        r = c.act(np.zeros(4, np.uint8), timeout=30.0)
        assert r.param_version == 7 and c.reconnects >= 1
        c.close()
        srv2.close()


# -- across the packages -----------------------------------------------------------


@pytest.mark.parametrize("trace", [False, True])
def test_jax_client_against_port_server(trace):
    srv = ServingNetServer(StubPolicy()).start()
    c = jserver.ServingClient("127.0.0.1", srv.port, trace=trace)
    try:
        for i in range(3):
            obs = np.full((3, 3), i + 1, np.uint8)
            r = c.act(obs, timeout=10.0, trace_id=100 + i)
            assert (r.action, r.param_version) == (int(obs.sum()) % 4, 7)
        assert srv.replies == 3 and srv.torn_frames == 0
        spans = srv.stats()["recent_spans"]
        assert spans["recorded"] == (3 if trace else 0)
    finally:
        c.close()
        srv.close()


def test_port_client_against_jax_server():
    srv = jserver.ServingNetServer(StubPolicy(served_cls=JServedAction)).start()
    c = ServingClient("127.0.0.1", srv.port, trace=True)
    try:
        for i in range(3):
            obs = np.full((5,), i + 2, np.uint8)
            r = c.act(obs, timeout=10.0, trace_id=7)
            assert (r.action, r.param_version) == (int(obs.sum()) % 4, 7)
        assert srv.replies == 3 and srv.torn_frames == 0
    finally:
        c.close()
        srv.close()


def test_port_replica_behind_the_jax_router():
    """The JAX ``ServingRouter`` fronts a port server and a JAX server
    (``set_endpoint``, no health probes): four clients land on both, and
    each reply carries its replica's version."""
    replicas = [ServingNetServer(StubPolicy(version=1)).start(),
                jserver.ServingNetServer(StubPolicy(version=2, served_cls=JServedAction)).start()]
    router = ServingRouter(port=0, probe_interval_s=30.0)
    for rid, srv in enumerate(replicas):
        router.set_endpoint(rid, "127.0.0.1", srv.port)
    router.start()
    clients = [jserver.ServingClient("127.0.0.1", router.port, seed=i) for i in range(2)]
    clients += [ServingClient("127.0.0.1", router.port, seed=i + 2) for i in range(2)]
    try:
        versions = {c.act(np.zeros(8, np.uint8), timeout=10.0).param_version for c in clients}
        assert versions == {1, 2}
        assert [srv.accepted for srv in replicas] == [2, 2]
        assert all(srv.torn_frames == 0 for srv in replicas)
    finally:
        for c in clients:
            c.close()
        router.close()
        for srv in replicas:
            srv.close()
