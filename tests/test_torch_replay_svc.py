"""Replay as a service in the port (``ape_x_dqn_tpu_torch/replay/service.py``)
against the JAX package's ``replay/service.py``.

* The body codec: ``encode_body`` bytes equal for raw, zlib and dedup
  bodies (the record's ``sent_t`` pinned in both packages).
* Wire interop both ways: a JAX ``ShardClient`` against a port
  ``ReplayShardServer`` and a port client against a JAX shard, with
  identical reply bytes for the same adds and sample seeds.
* The adversarial matrix on a port shard: torn, bitflipped, oversize,
  out-of-seq and wrong-kind frames counted and never applied; bad, garbage
  and stale hellos rejected before framing; well-framed garbage typed, not
  torn; a bitflipped reply torn client-side and retried.
* Retry and at-most-once adds under scripted drops and under ``RpcChaos``
  with the JAX package's seeded streams; survivor sampling and write-back
  flush; chain restore bit-exact by digest, crossing the packages both
  ways; membership adoption (grow, drain, retire); the ``replay_svc`` keys
  against ``docs/METRICS.md``; the restart-under-load barrage and the
  spill-backed shard over subprocess shards.
* The slice as a whole: two 2-shard fleets, one per package, fed the same
  chunks; each package's ``ShardedReplayClient.sample`` with the same
  ``rng`` draws identical global indices and IS weights within rtol 1e-6;
  each package's float32 train step on its batch gives loss and
  priorities within rtol 1e-4 (``test_torch_train_step.py``'s tolerance);
  the JAX priorities go back to both fleets, and the shard digests end
  equal (count, cursor and crc exact, total mass rtol 1e-6).  Then an
  ``AsyncPipeline(device="cpu")`` attached to a port fleet trains through
  a shard kill.
"""

from __future__ import annotations

import io
import json
import os
import socket
import struct
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ape_x_dqn_tpu.analysis.metrics_doc import doc_section_keys
from ape_x_dqn_tpu.config import ApexConfig as JApexConfig
from ape_x_dqn_tpu.learner import train_step as jtrain
from ape_x_dqn_tpu.models import dueling as jdueling
from ape_x_dqn_tpu.obs.chaos import RpcChaos as JRpcChaos
from ape_x_dqn_tpu.replay import service as jsvc
from ape_x_dqn_tpu.replay.buffer import PrioritizedReplay as JReplay
from ape_x_dqn_tpu.runtime import shm_ring as jshm
from ape_x_dqn_tpu.types import NStepTransition as JTransition
from ape_x_dqn_tpu.types import PrioritizedBatch as JBatch
from ape_x_dqn_tpu.utils import checkpoint_inc as jinc
from ape_x_dqn_tpu_torch.config import ApexConfig, ChaosConfig, apply_overrides
from ape_x_dqn_tpu_torch.fleet.registry import member_doc
from ape_x_dqn_tpu_torch.learner import train_step as ttrain
from ape_x_dqn_tpu_torch.models import dueling as tdueling
from ape_x_dqn_tpu_torch.obs.chaos import ChaosMonkey, RpcChaos
from ape_x_dqn_tpu_torch.replay import service as tsvc
from ape_x_dqn_tpu_torch.replay.buffer import PrioritizedReplay
from ape_x_dqn_tpu_torch.runtime import shm_ring as tshm
from ape_x_dqn_tpu_torch.runtime.net import CODEC_OFF, CODEC_ZLIB, F_RREP, F_RREQ, frame_bytes
from ape_x_dqn_tpu_torch.types import NStepTransition, PrioritizedBatch, TrainState
from ape_x_dqn_tpu_torch.utils import checkpoint_inc as tinc
from ape_x_dqn_tpu_torch.weights import params_from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OBS = (6,)
PKGS = {"jax": (jsvc, JReplay), "torch": (tsvc, PrioritizedReplay)}


def _chunk(n=8, seed=0, overlap=False, obs=OBS):
    r = np.random.default_rng(seed)
    o = r.integers(0, 255, (n, *obs), dtype=np.uint8)
    return {
        "prio": (np.abs(r.normal(size=n)) + 0.1).astype(np.float64),
        "obs": o,
        "action": r.integers(0, 2, n).astype(np.int32),
        "reward": r.normal(size=n).astype(np.float32),
        "discount": np.full(n, 0.99, np.float32),
        "next_obs": (np.roll(o, -1, axis=0) if overlap
                     else r.integers(0, 255, (n, *obs), dtype=np.uint8)),
    }


class _Batch:
    def __init__(self, arrays):
        for k, v in arrays.items():
            setattr(self, k, v)


def _add(client, seed, **kw):
    c = _chunk(seed=seed, **kw)
    return client.add(c["prio"], _Batch(c))


class _FixedClock:
    @staticmethod
    def monotonic():
        return 1.0


@pytest.fixture
def pinned_sent_t(monkeypatch):
    """Both packages' record prefix carries ``sent_t = time.monotonic()``;
    pin it (in the record codec only) so bodies compare byte for byte."""
    monkeypatch.setattr(jshm, "time", _FixedClock)
    monkeypatch.setattr(tshm, "time", _FixedClock)


def _wait(cond, timeout=10.0, msg="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {msg}")


@pytest.fixture
def shard():
    rep = PrioritizedReplay(256, OBS, priority_exponent=0.6)
    srv = tsvc.ReplayShardServer(rep, 0, incarnation=2, token=777, codec="zlib").start()
    yield rep, srv
    srv.close()


def _client_for(svc, srv, **kw):
    kw.setdefault("request_timeout_s", 5.0)
    return svc.ShardedReplayClient(
        [{"id": 0, "host": "127.0.0.1", "port": srv.port, "base": 0,
          "capacity": srv.replay.capacity, "incarnation": srv.incarnation}],
        token=srv.token, **kw)


def _raw_conn(srv, incarnation=None, token=None, codec=CODEC_ZLIB, client_id=9):
    """A raw socket past the ack, or None when the hello was refused."""
    s = socket.create_connection(("127.0.0.1", srv.port), timeout=5.0)
    s.sendall(tsvc.RSVC_HELLO.pack(
        tsvc.RSVC_MAGIC, tsvc.RSVC_VERSION, client_id, srv.shard_id,
        srv.incarnation if incarnation is None else incarnation,
        srv.token if token is None else token, codec, 0))
    s.settimeout(5.0)
    ack = b""
    while len(ack) < tsvc.RSVC_ACK.size:
        got = s.recv(tsvc.RSVC_ACK.size - len(ack))
        if not got:
            s.close()
            return None
        ack += got
    assert tsvc.RSVC_ACK.unpack(ack)[0] == tsvc.RSVC_ACK_MAGIC
    return s


# -- the wire: structs, constants, bodies ------------------------------------------


def test_wire_structs_and_constants_equal_jax():
    for name in ("RSVC_HELLO", "RSVC_ACK", "_RPC", "_RREP", "_RERR", "_SAMPLE_REQ",
                 "_SAMPLE_REP", "_DIGEST_REQ", "_DIGEST_REP"):
        assert getattr(tsvc, name).format == getattr(jsvc, name).format, name
    for name in ("RSVC_VERSION", "RSVC_MAGIC", "RSVC_ACK_MAGIC", "OP_SAMPLE", "OP_ADD",
                 "OP_UPDATE", "OP_DIGEST", "OP_STATS", "_OP_NAMES", "RE_BAD_REQUEST",
                 "RE_EMPTY", "RE_CLOSED", "RE_INTERNAL", "FLAG_DUP", "_CODEC_IDS",
                 "_RECV_CHUNK", "_DEFAULT_MAX_FRAME", "_AUTO_OFF_REPLIES"):
        assert getattr(tsvc, name) == getattr(jsvc, name), name


@pytest.mark.parametrize("codec", [CODEC_OFF, CODEC_ZLIB])
@pytest.mark.parametrize("dedup", [False, True])
def test_encode_body_bytes_equal_jax(codec, dedup, pinned_sent_t):
    """A frame-shaped chunk with n-step overlap (frames past the dedup
    span floor): the four raw/zlib × dense/dedup bodies are byte-equal, and
    each package decodes the other's."""
    arrays = _chunk(n=16, seed=3, overlap=True, obs=(12, 12, 1))
    t = tsvc.encode_body(arrays, codec=codec, dedup=dedup)
    j = jsvc.encode_body(arrays, codec=codec, dedup=dedup)
    assert t == j
    for out in (tsvc.decode_body(j), jsvc.decode_body(t)):
        for k, v in arrays.items():
            np.testing.assert_array_equal(out[k], v)
    assert all(a.flags.writeable for a in tsvc.decode_body(j).values())


def test_malformed_bodies_raise():
    body = tsvc.encode_body(_chunk(), codec=CODEC_OFF, dedup=False)
    with pytest.raises(ValueError):
        tsvc.decode_body(body[:len(body) // 2])
    with pytest.raises(ValueError):
        tsvc.decode_body(bytes((9,)) + body[1:])
    zbody = tsvc.encode_body(_chunk(n=64, overlap=True, obs=(12, 12, 1)), codec=CODEC_ZLIB)
    assert zbody[0] == CODEC_ZLIB
    with pytest.raises(ValueError):
        tsvc.decode_body(zbody, allow_zlib=False)


# -- interop: each package's client against the other's shard -----------------------


@pytest.mark.parametrize("client_pkg,server_pkg", [("jax", "torch"), ("torch", "jax")])
def test_cross_package_client_and_shard_reply_bytes(client_pkg, server_pkg, pinned_sent_t):
    """The same adds and sample seeds through a cross-package pair and a
    same-package pair of the server's package give byte-identical replies
    (add, sample, digest), and the typed empty-shard refusal crosses too."""
    csvc = PKGS[client_pkg][0]
    replies = {}
    for pair, (svc, Replay) in (("cross", PKGS[server_pkg]), ("same", PKGS[client_pkg])):
        srv = svc.ReplayShardServer(Replay(128, OBS), 0, incarnation=1, token=11,
                                    codec="zlib").start()
        cli = (csvc if pair == "cross" else svc).ShardClient(
            0, "127.0.0.1", srv.port, token=11, client_id=21, incarnation=-1)
        try:
            with pytest.raises(csvc.ReplayRpcError if pair == "cross" else svc.ReplayRpcError):
                cli.request(tsvc.OP_SAMPLE, tsvc._SAMPLE_REQ.pack(4, 0.4, 5), timeout=5.0)
            out = [cli.request(tsvc.OP_ADD, tsvc.encode_body(_chunk(seed=s), codec=CODEC_ZLIB),
                               timeout=5.0) for s in range(5)]
            out += [cli.request(tsvc.OP_SAMPLE, tsvc._SAMPLE_REQ.pack(8, 0.4, seed),
                                timeout=5.0) for seed in (1, 2, 3)]
            out.append(cli.digest(with_crc=True, timeout=5.0))
            replies[pair] = out
            assert cli.incarnation == 1 and cli.capacity == 128
        finally:
            cli.close()
            srv.close()
    assert replies["cross"] == replies["same"]


def test_port_fleet_subprocess_serves_a_jax_client(tmp_path):
    """A port shard process (the shard CLI under ``ReplayServiceFleet``)
    answers the JAX package's fleet client from the endpoints file the
    port wrote; the shard's spawn seconds are recorded."""
    fleet = tsvc.ReplayServiceFleet(1, 128, OBS, root_dir=str(tmp_path), save_every_s=0.2,
                                    auto_respawn=False).start(timeout=60.0)
    try:
        assert fleet.shards[0].spawn_s is not None and fleet.shards[0].spawn_s > 0
        with open(fleet.endpoints_path) as f:
            doc = json.load(f)
        assert set(doc) == {"token", "codec", "total_capacity", "shards"}
        assert set(doc["shards"][0]) == {"id", "host", "port", "base", "capacity",
                                         "incarnation"}
        cl = jsvc.ShardedReplayClient.from_endpoints_file(fleet.endpoints_path,
                                                          request_timeout_s=5.0)
        try:
            idx = _add(cl, 1)
            np.testing.assert_array_equal(idx, np.arange(8))
            b = cl.sample(4, rng=np.random.default_rng(0))
            assert b.indices.shape == (4,) and (b.indices < 8).all()
            assert cl.size() == 8
        finally:
            cl.close()
    finally:
        fleet.stop()
    stopped = [e for e in fleet.shards[0].events if e.get("event") == "replay_shard_stopped"]
    assert stopped and stopped[0]["torn_frames"] == 0


# -- the adversarial matrix on a port shard --------------------------------------------


def _frame_case(kind):
    payload = tsvc._RPC.pack(1, tsvc.OP_ADD) + tsvc.encode_body(_chunk())
    if kind == "truncated":
        f = frame_bytes(F_RREQ, 1, [payload])
        return f[:len(f) - 7], True
    if kind == "bitflip":
        f = bytearray(frame_bytes(F_RREQ, 1, [payload]))
        f[40] ^= 0x10
        return bytes(f), False
    if kind == "oversize":
        return struct.pack("<IIqB7x", (1 << 30) + 5, 0, 1, F_RREQ), False
    if kind == "out_of_seq":
        return frame_bytes(F_RREQ, 3, [tsvc._RPC.pack(1, tsvc.OP_DIGEST)]), False
    return frame_bytes(F_RREP, 1, [b"x"]), False     # replies never flow in


@pytest.mark.parametrize("kind", ["truncated", "bitflip", "oversize", "out_of_seq",
                                  "wrong_kind"])
def test_bad_frames_torn_never_applied(shard, kind):
    rep, srv = shard
    s = _raw_conn(srv)
    frame, close = _frame_case(kind)
    s.sendall(frame)
    if close:
        s.close()                        # disconnect mid-frame
    _wait(lambda: srv.torn_frames >= 1, msg=f"{kind} torn")
    assert rep.total_added == 0 and srv.ops["add"] == 0
    if not close:
        s.close()


def test_bad_hellos_rejected_before_framing(shard):
    _rep, srv = shard
    assert _raw_conn(srv, token=123456) is None
    _wait(lambda: srv.bad_hellos >= 1, msg="bad hello")
    assert _raw_conn(srv, codec=7) is None          # codec the shard does not speak
    _wait(lambda: srv.bad_hellos >= 2, msg="codec hello")
    s = socket.create_connection(("127.0.0.1", srv.port), timeout=5.0)
    s.sendall(b"GARBAGEGARBAGEGARBAGEGARBAGEGARBAGEGARBAGEJUNK!!")
    _wait(lambda: srv.bad_hellos >= 3, msg="garbage hello")
    s.close()
    assert srv.torn_frames == 0


def test_stale_incarnation_hello_rejected(shard):
    _rep, srv = shard
    assert _raw_conn(srv, incarnation=srv.incarnation - 1) is None
    _wait(lambda: srv.stale_rejects >= 1, msg="stale reject")
    s = _raw_conn(srv, incarnation=-1)
    assert s is not None
    s.close()


def test_well_framed_garbage_is_typed_not_torn(shard):
    rep, srv = shard
    s = _raw_conn(srv)
    s.sendall(frame_bytes(F_RREQ, 1, [tsvc._RPC.pack(7, tsvc.OP_ADD) + b"\x00garbage"]))
    buf, deadline = b"", time.monotonic() + 5.0
    while time.monotonic() < deadline and len(buf) < 24:
        buf += s.recv(1 << 16)
    assert srv.errors >= 1 and srv.torn_frames == 0 and rep.total_added == 0
    s.close()


def test_bitflipped_reply_frame_torn_client_side(shard):
    """A corrupted reply stream is dropped client-side and the request
    retries on a fresh connection."""
    _rep, srv = shard
    cl = _client_for(tsvc, srv)
    _add(cl, 5)
    cl.close()
    lsock = socket.socket()
    lsock.bind(("127.0.0.1", 0))
    lsock.listen(4)
    flipped = threading.Event()

    def pump(src, dst, corrupt):
        try:
            while True:
                d = src.recv(1 << 16)
                if not d:
                    break
                if corrupt and not flipped.is_set() and len(d) > tsvc.RSVC_ACK.size + 40:
                    d = bytearray(d)
                    d[tsvc.RSVC_ACK.size + 30] ^= 0x40
                    d = bytes(d)
                    flipped.set()
                dst.sendall(d)
        except OSError:
            pass
        for x in (src, dst):
            try:
                x.close()
            except OSError:
                pass

    def proxy():
        while True:
            try:
                a, _ = lsock.accept()
            except OSError:
                return
            b = socket.create_connection(("127.0.0.1", srv.port))
            threading.Thread(target=pump, args=(a, b, False), daemon=True).start()
            threading.Thread(target=pump, args=(b, a, True), daemon=True).start()

    threading.Thread(target=proxy, daemon=True).start()
    sc = tsvc.ShardClient(0, "127.0.0.1", lsock.getsockname()[1], token=srv.token,
                          client_id=31, incarnation=-1)
    try:
        _flags, body = sc.request(tsvc.OP_SAMPLE, tsvc._SAMPLE_REQ.pack(4, 0.4, 17),
                                  timeout=15.0)
        assert body and flipped.is_set()
        assert sc.torn >= 1 or sc.reconnects >= 1
    finally:
        sc.close()
        lsock.close()


# -- retry discipline and at-most-once adds -----------------------------------------


class _ScriptedChaos:
    def __init__(self, drops):
        self._drops = list(drops)

    def delay_s(self):
        return 0.0

    def drop(self):
        return self._drops.pop(0) if self._drops else False


def test_deadline_expiry_is_typed():
    cl = tsvc.ShardClient(0, "127.0.0.1", 1, token=1, client_id=1)
    t0 = time.monotonic()
    with pytest.raises(tsvc.ReplayShardUnavailable) as ei:
        cl.request(tsvc.OP_DIGEST, timeout=0.6)
    assert time.monotonic() - t0 < 5.0
    assert ei.value.shard_id == 0 and ei.value.op == "digest"
    cl.close()


def test_drop_then_retry_applies_exactly_once():
    rep = PrioritizedReplay(256, OBS)
    srv = tsvc.ReplayShardServer(rep, 0, token=5, chaos=_ScriptedChaos([True])).start()
    try:
        sc = tsvc.ShardClient(0, "127.0.0.1", srv.port, token=5, client_id=3, io_timeout_s=0.5)
        sc.request(tsvc.OP_ADD, tsvc.encode_body(_chunk(seed=9), codec=CODEC_ZLIB),
                   timeout=20.0)
        assert sc.retries >= 1 and rep.total_added == 8 and srv.chaos_dropped == 1
        sc.close()
    finally:
        srv.close()


def test_duplicate_add_served_from_cache(shard):
    rep, srv = shard
    sc = tsvc.ShardClient(0, "127.0.0.1", srv.port, token=srv.token, client_id=4)
    body = tsvc.encode_body(_chunk(seed=11), codec=CODEC_ZLIB)
    rid = sc.next_req_id()
    flags1, rep1 = sc.request(tsvc.OP_ADD, body, req_id=rid)
    flags2, rep2 = sc.request(tsvc.OP_ADD, body, req_id=rid)
    assert (flags1, flags2) == (0, tsvc.FLAG_DUP) and rep1 == rep2
    assert rep.total_added == 8 and srv.add_dups == 1
    sc.close()


def test_backoff_resets_only_on_verified_reply(shard):
    _rep, srv = shard
    sc = tsvc.ShardClient(0, "127.0.0.1", 1, token=srv.token, client_id=5)
    with pytest.raises(tsvc.ReplayShardUnavailable):
        sc.request(tsvc.OP_DIGEST, timeout=0.8)
    assert sc._backoff._fails >= 1
    sc.host, sc.port = "127.0.0.1", srv.port
    sc._backoff.reset()
    sc.request(tsvc.OP_DIGEST, timeout=5.0)
    assert sc._backoff._fails == 0
    sc.close()


def test_rpc_chaos_streams_equal_jax():
    a, b = RpcChaos(delay_ms=4.0, drop_rate=0.3, seed=11), JRpcChaos(delay_ms=4.0,
                                                                    drop_rate=0.3, seed=11)
    assert [(a.delay_s(), a.drop()) for _ in range(64)] \
        == [(b.delay_s(), b.drop()) for _ in range(64)]
    assert a.drops == b.drops > 0


def test_rpc_chaos_drops_retry_at_most_once_like_jax():
    """Each package's shard under ``RpcChaos(drop_rate=0.3)`` with one seed,
    the same adds through a short-timeout client: the same requests drop,
    every add applies exactly once, and the shards end bit-equal."""
    got = {}
    for name, (svc, Replay) in PKGS.items():
        rep = Replay(256, OBS)
        chaos = (RpcChaos if name == "torch" else JRpcChaos)(drop_rate=0.3, seed=23)
        srv = svc.ReplayShardServer(rep, 0, token=5, chaos=chaos).start()
        sc = svc.ShardClient(0, "127.0.0.1", srv.port, token=5, client_id=3,
                             io_timeout_s=0.2)
        try:
            for s in range(6):
                sc.request(svc.OP_ADD, svc.encode_body(_chunk(seed=s), codec=CODEC_ZLIB),
                           timeout=30.0)
            got[name] = (srv.chaos_dropped, srv.add_dups, rep.total_added,
                         rep.digest(with_crc=True))
        finally:
            sc.close()
            srv.close()
    assert got["torch"] == got["jax"]
    dropped, _dups, added, _ = got["torch"]
    assert dropped > 0 and added == 48


# -- the fleet client's degradation ----------------------------------------------------


def _two_shards(svc=tsvc, Replay=PrioritizedReplay, cap=128, token=99, **kw):
    reps = [Replay(cap, OBS) for _ in range(2)]
    srvs = [svc.ReplayShardServer(r, k, incarnation=0, token=token).start()
            for k, r in enumerate(reps)]
    kw.setdefault("request_timeout_s", 1.5)
    kw.setdefault("probe_interval_s", 0.2)
    cl = svc.ShardedReplayClient(
        [{"id": k, "host": "127.0.0.1", "port": s.port, "base": cap * k, "capacity": cap,
          "incarnation": 0} for k, s in enumerate(srvs)], token=token, **kw)
    return reps, srvs, cl


def test_survivor_keeps_serving_and_writebacks_flush():
    reps, srvs, cl = _two_shards()
    try:
        for seed in range(6):
            _add(cl, seed)
        cl.sample(8, rng=np.random.default_rng(0))
        assert cl.size() == reps[0].size() + reps[1].size()
        port1 = srvs[1].port
        srvs[1].close()
        cl.update_priorities(np.arange(130, 138), np.full(8, 9.0))
        _wait(lambda: 1 in cl._down or cl.stats()["writeback_pending"], msg="shard 1 down")
        st = cl.stats()
        assert st["writeback_pending"] >= 1 and st["degraded"] and st["shards_down"] == 1
        for _ in range(4):
            assert cl.sample(8, rng=np.random.default_rng(1)).indices.max() < 128
        assert _add(cl, 31).max() < 128
        srvs[1] = tsvc.ReplayShardServer(reps[1], 1, incarnation=1, token=99,
                                         port=port1).start()
        cl._clients[1].set_endpoint("127.0.0.1", port1, 1)
        _wait(lambda: not cl.degraded, msg="recovery")
        st = cl.stats()
        assert st["writeback_pending"] == 0 and st["writeback_flushed"] >= 8
        assert st["recoveries"] >= 1
        np.testing.assert_allclose(reps[1]._tree.get(np.arange(2, 10)), 9.0 ** 0.6, rtol=1e-9)
    finally:
        cl.close()
        for s in srvs:
            s.close()


def test_all_down_is_typed_and_empty_fleet_is_value_error():
    reps, srvs, cl = _two_shards()
    try:
        with pytest.raises(ValueError):
            cl.sample(4, rng=np.random.default_rng(0))
        _add(cl, 0)
        for s in srvs:
            s.close()
        with pytest.raises(tsvc.ReplayShardUnavailable):
            for _ in range(3):
                cl.sample(4, rng=np.random.default_rng(2))
        assert cl.degraded and cl.age_s() >= 0.0
    finally:
        cl.close()
        for s in srvs:
            s.close()


def test_stale_incarnation_reresolves_via_endpoints_file(tmp_path):
    rep = PrioritizedReplay(128, OBS)
    srv = tsvc.ReplayShardServer(rep, 0, incarnation=0, token=7).start()
    ep = str(tmp_path / "endpoints.json")

    def write_ep(port, inc):
        with open(ep + ".tmp", "w") as f:
            json.dump({"token": 7, "codec": "zlib", "total_capacity": 128,
                       "shards": [{"id": 0, "host": "127.0.0.1", "port": port, "base": 0,
                                   "capacity": 128, "incarnation": inc}]}, f)
        os.replace(ep + ".tmp", ep)

    write_ep(srv.port, 0)
    cl = tsvc.ShardedReplayClient.from_endpoints_file(ep, request_timeout_s=1.5,
                                                      probe_interval_s=0.15)
    try:
        _add(cl, 0)
        srv.close()
        srv = tsvc.ReplayShardServer(rep, 0, incarnation=1, token=7).start()
        with pytest.raises(tsvc.ReplayShardUnavailable):
            cl.sample(4, rng=np.random.default_rng(0))
        write_ep(srv.port, 1)
        _wait(lambda: not cl.degraded, msg="re-resolve + recovery")
        assert len(cl.sample(4, rng=np.random.default_rng(1)).indices) == 4
        assert cl._clients[0].incarnation == 1
    finally:
        cl.close()
        srv.close()


def test_endpoints_refresh_survives_same_mtime_rewrite(tmp_path):
    path = str(tmp_path / "endpoints.json")

    def write(port):
        with open(path + ".tmp", "w") as f:
            json.dump({"token": 5, "codec": "off", "total_capacity": 64,
                       "shards": [{"id": 0, "host": "127.0.0.1", "port": port, "base": 0,
                                   "capacity": 64, "incarnation": 2}]}, f)
        os.replace(path + ".tmp", path)
        os.utime(path, (1000.0, 1000.0))

    write(1111)
    client = tsvc.ShardedReplayClient(
        [{"id": 0, "host": "127.0.0.1", "port": 1111, "base": 0, "capacity": 64,
          "incarnation": 2}], token=5, endpoints_path=path, probe_interval_s=60.0)
    try:
        client._refresh_endpoints()
        assert client._clients[0].port == 1111
        write(2222)
        client._refresh_endpoints()
        assert client._clients[0].port == 2222
    finally:
        client.close()


# -- membership adoption ---------------------------------------------------------------


def _spec(sid, port, draining=False):
    return member_doc(f"replay/shard{sid}", "replay_shard", host="127.0.0.1", port=port,
                      incarnation=1, base=sid * 64, capacity=64, draining=draining)


def _snapshot(*docs, version=1):
    return {"token": 5, "version": version, "incarnation": 1,
            "members": {d["name"]: d for d in docs}}


@pytest.fixture
def member_client():
    client = tsvc.ShardedReplayClient(
        [{"id": k, "host": "127.0.0.1", "port": 1111 + k, "base": 64 * k, "capacity": 64,
          "incarnation": 1} for k in range(2)], token=5, probe_interval_s=60.0)
    yield client
    client.close()


def test_membership_grow_admits_new_shard(member_client):
    c = member_client
    c.adopt_membership(_snapshot(_spec(0, 1111), _spec(1, 1112), _spec(2, 1113), version=3))
    assert (c.num_shards, c.capacity, sorted(c._clients)) == (3, 192, [0, 1, 2])
    assert c.membership_version == 3 and c._addable() == [0, 1, 2]


def test_membership_draining_shard_leaves_the_add_path(member_client):
    c = member_client
    c.adopt_membership(_snapshot(_spec(0, 1111), _spec(1, 1112, draining=True)))
    assert c.num_shards == 2 and c._addable() == [0]
    assert c.stats()["shards_draining"] == [1]


def test_membership_retire_drops_parked_writebacks_counted(member_client):
    c = member_client
    with c._state:
        c._pending[1] = {70: 0.5, 71: 0.25}
    c.adopt_membership(_snapshot(_spec(0, 1111)))
    assert c.num_shards == 1 and 1 not in c._clients and c.updates_dropped == 2
    c.update_priorities(np.array([70], np.int64), np.array([0.9]))
    assert c.updates_dropped == 3
    c.adopt_membership({"version": 9, "members": {}})
    assert c.num_shards == 1      # an empty snapshot never strands the client


def test_membership_shards_from_docs_equal_jax():
    snap = _snapshot(_spec(1, 1112, draining=True), _spec(0, 1111))
    assert tsvc._membership_shards(snap) == jsvc._membership_shards(snap)


# -- persistence: chains restored across the packages ----------------------------------


@pytest.mark.parametrize("writer,reader", [("torch", "jax"), ("jax", "torch")])
def test_shard_chain_restore_bit_exact_across_packages(tmp_path, writer, reader):
    """A shard of one package saves its chain on its pump thread (deltas
    included, one with no new rows); the other package's shard CLI restore
    path (``load_incremental_replay``) rebuilds it bit-exactly by digest."""
    svc, Replay = PKGS[writer]
    rep = Replay(256, OBS)
    srv = svc.ReplayShardServer(rep, 0, token=5, ckpt_dir=str(tmp_path), save_every_s=0.05,
                                base_every=4).start()
    cl = _client_for(svc, srv)
    try:
        for s in range(5):
            _add(cl, s)
            _wait(lambda: srv.saves >= s + 1, msg="a save per add")
        cl.update_priorities(np.arange(4), np.full(4, 3.0))
        saves = srv.saves
        _wait(lambda: srv.saves >= saves + 2, msg="a save with no new rows")
    finally:
        cl.close()
        srv.close()            # the final committed snapshot
    want = rep.digest(with_crc=True)
    fresh = PKGS[reader][1](256, OBS)
    load = (jinc if reader == "jax" else tinc).load_incremental_replay
    assert load(str(tmp_path), fresh, fallback=True) == rep.total_added
    assert fresh.digest(with_crc=True) == want


def test_empty_delta_chunk_round_trips(tmp_path):
    """A delta with no changed rows has zero-size columns; the chunk writer
    must frame them (a zero-size array has no byte view to cast)."""
    path = str(tmp_path / "c.apxc")
    arrays = {"idx": np.zeros((0,), np.int64), "obs": np.zeros((0, 6), np.uint8),
              "count": np.asarray(3)}
    tinc.write_chunk(path, arrays)
    for read in (tinc.read_chunk, jinc.read_chunk):
        out = read(path)
        for k, v in arrays.items():
            np.testing.assert_array_equal(out[k], v)
            assert out[k].shape == v.shape and out[k].dtype == v.dtype


def test_corrupt_chain_recovery_is_typed_or_exact(tmp_path, shard):
    from ape_x_dqn_tpu_torch.obs.chaos import corrupt_chunk, pick_chunk

    rep, _srv = shard
    ck = tinc.IncrementalCheckpointer(str(tmp_path), rep, sync=True)
    digests = []
    for s in range(4):
        c = _chunk(seed=s)
        rep.add(c["prio"], _Batch(c))
        ck.save(rep.total_added)
        digests.append(rep.digest(with_crc=True))
    corrupt_chunk(pick_chunk(os.path.join(str(tmp_path), "replay_inc"), prefer="delta"),
                  "bitflip")
    events = []
    fresh = PrioritizedReplay(256, OBS)
    step = tinc.load_incremental_replay(str(tmp_path), fresh, fallback=True,
                                        on_event=events.append)
    assert any(e["event"] == "degraded_restore" for e in events)
    got = fresh.digest(with_crc=True)
    assert got in digests and got["count"] == step


# -- config and chaos ------------------------------------------------------------------


@pytest.mark.parametrize("sets", [
    {"replay.service_mode": "bogus"},
    {"replay.service_mode": "attach"},
    {"replay.service_codec": "lz4"},
    {"replay.service_request_timeout_s": 0.0},
    {"replay.service_probe_interval_s": -1.0},
    {"replay.service_shards": 0},
    {"replay.service_hot_frame_budget_bytes": -1},
    {"replay.service_mode": "attach", "replay.service_endpoints": "e.json",
     "replay.dedup": True},
    {"replay.service_mode": "attach", "replay.service_endpoints": "e.json",
     "learner.device_replay": True},
    {"replay.service_mode": "attach", "replay.service_endpoints": "e.json",
     "learner.checkpoint_incremental": True, "learner.checkpoint_every": 100},
    {"chaos.rpc_delay_ms": -1.0},
    {"chaos.rpc_drop_rate": 1.5},
    {"chaos.kill_shard_at_step": -1},
    {"chaos.kill_shard_interval_s": -1.0},
])
def test_service_and_rpc_chaos_validation_messages_equal_jax(sets):
    msgs = []
    for cfg in (ApexConfig(), JApexConfig()):
        for path, v in sets.items():
            section, field = path.split(".")
            setattr(getattr(cfg, section), field, v)
        with pytest.raises(ValueError) as ei:
            cfg.validate()
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]


def test_service_keys_accepted_with_jax_defaults():
    cfg = apply_overrides(ApexConfig(), [
        "replay.service_mode=attach", "replay.service_endpoints=e.json",
        "replay.service_codec=auto", "replay.service_dedup=false",
        "replay.service_request_timeout_s=3", "replay.service_probe_interval_s=0.25",
        "replay.service_shards=4", "replay.service_hot_frame_budget_bytes=4096"])
    r = cfg.validate().replay
    assert (r.service_mode, r.service_endpoints, r.service_codec, r.service_dedup,
            r.service_request_timeout_s, r.service_probe_interval_s, r.service_shards,
            r.service_hot_frame_budget_bytes) == ("attach", "e.json", "auto", False, 3.0,
                                                  0.25, 4, 4096)
    jr, tr = vars(JApexConfig().replay), vars(ApexConfig().replay)
    assert {k: v for k, v in jr.items() if k.startswith("service_")} \
        == {k: v for k, v in tr.items() if k.startswith("service_")}


def test_fleet_timeline_and_autopilot_still_refused_by_name():
    """The rest of ROADMAP item 7 is ported: these keys load now, with the
    JAX config's values, and no refusal cites the item any more."""
    from ape_x_dqn_tpu.config import apply_overrides as japply

    from ape_x_dqn_tpu_torch import config as tconfig

    keys = ("obs.fleet_port=1", "obs.timeline_dir=x", "autopilot.enabled=true")
    cfg, jcfg = apply_overrides(ApexConfig(), keys), japply(JApexConfig(), keys)
    assert (cfg.obs.fleet_port, cfg.obs.timeline_dir, cfg.autopilot.enabled) \
        == (jcfg.obs.fleet_port, jcfg.obs.timeline_dir, jcfg.autopilot.enabled) \
        == (1, "x", True)
    assert not any("item 7" in v for v in (*tconfig._NOT_PORTED.values(),
                                            *tconfig._NOT_PORTED_SECTIONS.values()))


def test_attach_capacity_mismatch_is_value_error(tmp_path):
    from ape_x_dqn_tpu_torch.runtime.components import build_components

    reps, srvs, cl = _two_shards()
    cl.close()
    ep = str(tmp_path / "endpoints.json")
    with open(ep, "w") as f:
        json.dump({"token": 99, "codec": "zlib", "total_capacity": 256,
                   "shards": [{"id": k, "host": "127.0.0.1", "port": s.port, "base": 128 * k,
                               "capacity": 128, "incarnation": 0}
                              for k, s in enumerate(srvs)]}, f)
    try:
        cfg = apply_overrides(ApexConfig(), [
            "network=mlp", "env.name=chain:6", "replay.capacity=4096",
            "learner.min_replay_mem_size=256",
            "replay.service_mode=attach", f"replay.service_endpoints={ep}"])
        with pytest.raises(ValueError, match="the service fleet's total 256"):
            build_components(cfg, device="cpu")
    finally:
        for s in srvs:
            s.close()


class _FakeFleet:
    def __init__(self):
        self.victims = []

    def kill_random(self, rng=None):
        live = [0, 1]
        sid = live[rng.randrange(len(live))]
        self.victims.append(sid)
        return {"fault": "kill_shard", "shard": sid, "pid": 0}


def test_monkey_kill_shard_victims_equal_jax():
    from ape_x_dqn_tpu.config import ChaosConfig as JChaosConfig
    from ape_x_dqn_tpu.obs.chaos import ChaosMonkey as JChaosMonkey

    fleets = []
    for Monkey, Cfg in ((ChaosMonkey, ChaosConfig), (JChaosMonkey, JChaosConfig)):
        m = Monkey(Cfg(enabled=True, seed=4, kill_shard_interval_s=5.0))
        assert {k for _, k in m.schedule} == {"kill_shard"}
        assert m.execute("kill_shard")["skipped"]        # no fleet attached
        fleet = _FakeFleet()
        m.attach(replay_fleet=fleet)
        for _ in range(6):
            assert m.execute("kill_shard")["fault"] == "kill_shard"
        fleets.append((m.schedule, fleet.victims))
    assert fleets[0] == fleets[1]


# -- the schema pin --------------------------------------------------------------------


def test_client_stats_match_doc(shard):
    _rep, srv = shard
    doc = doc_section_keys("## Replay service schema", os.path.join(REPO, "docs", "METRICS.md"))
    assert doc
    cl = _client_for(tsvc, srv)
    try:
        assert set(doc) == set(cl.stats())
    finally:
        cl.close()


# -- subprocess shards: the barrage and the spill-backed shard --------------------------


def test_restart_under_load_barrage(tmp_path):
    fleet = tsvc.ReplayServiceFleet(2, 512, OBS, root_dir=str(tmp_path), save_every_s=0.5,
                                    respawn_base_s=0.1, respawn_max_s=0.5).start(timeout=60.0)
    cl = tsvc.ShardedReplayClient.from_endpoints_file(fleet.endpoints_path,
                                                      request_timeout_s=3.0,
                                                      probe_interval_s=0.15)
    errors, stop = [], threading.Event()

    def traffic():
        r = np.random.default_rng(0)
        seed = 0
        while not stop.is_set():
            seed += 1
            try:
                _add(cl, seed)
                b = cl.sample(8, rng=r)
                cl.update_priorities(b.indices, np.abs(r.normal(size=8)) + 0.1)
            except (tsvc.ReplayShardUnavailable, ValueError):
                time.sleep(0.01)
            except Exception as e:  # noqa: BLE001 — anything else fails the test
                errors.append(e)
                return

    t = threading.Thread(target=traffic, daemon=True)
    t.start()
    try:
        _wait(lambda: cl.adds >= 5, timeout=30.0, msg="traffic flowing")
        for victim in (0, 1):
            fleet.kill(victim)
            _wait(lambda: fleet.shards[victim].alive() and fleet.shards[victim].port is not None,
                  timeout=60.0, msg="respawn")
            _wait(lambda: not cl.degraded, timeout=60.0, msg="client recovery")
        adds = cl.adds
        _wait(lambda: cl.adds >= adds + 5, timeout=30.0, msg="traffic resumed")
    finally:
        stop.set()
        t.join(timeout=30.0)
        st = cl.stats()
        cl.close()
        fleet.stop()
    assert not errors, errors
    assert st["rpc_torn"] == 0 and fleet.respawns >= 2 and st["recoveries"] >= 1
    for sid in (0, 1):
        assert any(e.get("event") == "replay_shard_listen" and e.get("incarnation", 0) >= 1
                   for e in fleet.shards[sid].events), sid


def test_train_sync_mode_runs_over_the_service(tmp_path, capsys):
    """``train --mode sync`` over an attached 2-shard replay: the
    single-process loop samples, writes back and saves through the client (the state
    leg only: the shards own their chains), and its final record carries
    the ``replay_svc`` section."""
    from ape_x_dqn_tpu_torch import train

    reps, srvs, cl = _two_shards(cap=2048, token=13)
    cl.close()
    ep = str(tmp_path / "endpoints.json")
    with open(ep, "w") as f:
        json.dump({"token": 13, "codec": "zlib", "total_capacity": 4096,
                   "shards": [{"id": k, "host": "127.0.0.1", "port": s.port, "base": 2048 * k,
                               "capacity": 2048, "incarnation": 0}
                              for k, s in enumerate(srvs)]}, f)
    try:
        rc = train.main(["--device", "cpu", "--mode", "sync", "--steps", "24", "--log-every",
                         "1000", "--set", "env.name=chain:6", "--set", "network=mlp",
                         "--set", "learner.min_replay_mem_size=128",
                         "--set", "replay.capacity=4096", "--set", "replay.service_mode=attach",
                         "--set", f"replay.service_endpoints={ep}",
                         "--set", "learner.checkpoint_every=12",
                         "--set", f"learner.checkpoint_dir={tmp_path / 'ckpt'}"])
    finally:
        for s in srvs:
            s.close()
    assert rc == 0
    final = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert final["final"] and final["step"] == 24
    svc = final["replay_svc"]
    assert svc["samples"] == 24 and svc["updates"] >= 24 and svc["adds"] > 0
    assert reps[0].total_added > 0 and reps[1].total_added > 0   # adds round-robin
    assert os.listdir(tmp_path / "ckpt") and not os.path.isdir(tmp_path / "ckpt" / "replay_inc")


def test_fleet_grow_then_retire_hands_off_bit_exact(tmp_path):
    """``grow`` appends an empty shard at the next slot range (endpoints
    and capacity follow); ``retire`` drains the highest shard, proves its
    committed chain against the live digest and re-adds every transition
    into the survivor: nothing lost, the retired chain parked."""
    events = []
    fleet = tsvc.ReplayServiceFleet(
        1, 128, OBS, root_dir=str(tmp_path), save_every_s=0.2, auto_respawn=False,
        on_event=lambda name, **f: events.append({"event": name, **f})).start(timeout=60.0)

    def shard_client(sid):
        s = fleet.shards[sid]
        return tsvc.ShardClient(sid, "127.0.0.1", s.port, token=fleet.token,
                                client_id=40 + sid, incarnation=s.incarnation)

    try:
        assert fleet.grow(timeout=60.0) == 1
        assert (fleet.num_shards, fleet.capacity) == (2, 256)
        with open(fleet.endpoints_path) as f:
            assert [s["base"] for s in json.load(f)["shards"]] == [0, 128]
        for sid in (0, 1):
            cli = shard_client(sid)
            for seed in range(3):
                cli.request(tsvc.OP_ADD, tsvc.encode_body(_chunk(seed=10 * sid + seed)),
                            timeout=10.0)
            cli.close()
        before = [shard_client(sid).digest(with_crc=True) for sid in (0, 1)]
        assert fleet.retire(drain_grace_s=0.1, timeout=60.0) == 1
        assert (fleet.num_shards, fleet.capacity, fleet.retires) == (1, 128, 1)
        done = [e for e in events if e["event"] == "reshard_done" and e["kind"] == "retire"]
        assert done and done[0]["transferred"] == before[1]["size"] and done[0]["lost"] == 0
        assert done[0]["crc"] == before[1]["crc"]
        after = shard_client(0).digest(with_crc=True)
        assert after["count"] == before[0]["count"] + before[1]["size"]
        assert os.path.isdir(os.path.join(str(tmp_path), "shard1.retired"))
    finally:
        fleet.stop()


def test_registry_driven_client_follows_grow_and_retire(tmp_path):
    """``registry_addr``: the fleet announces its shards (kind
    ``replay_shard``) to a port registry; a client built ``from_registry``
    routes by that membership alone and follows a grow and a retire."""
    from ape_x_dqn_tpu_torch.fleet.registry import FleetRegistry

    reg = FleetRegistry(token=77).serve()
    fleet = tsvc.ReplayServiceFleet(1, 128, OBS, root_dir=str(tmp_path), token=reg.token,
                                    registry_addr=(reg.host, reg.port), heartbeat_s=0.2,
                                    save_every_s=0.2, auto_respawn=False).start(timeout=60.0)
    cl = None
    try:
        cl = tsvc.ShardedReplayClient.from_registry(reg.host, reg.port, token=reg.token,
                                                    probe_interval_s=0.2, wait_timeout_s=30.0)
        assert cl.num_shards == 1
        _add(cl, 1)
        assert fleet.grow(timeout=60.0) == 1
        _wait(lambda: cl.num_shards == 2 and cl._addable() == [0, 1], msg="grow adopted")
        idx = np.concatenate([_add(cl, s) for s in range(2, 5)])
        assert idx.max() >= 128              # the grown range takes adds
        assert fleet.retire(drain_grace_s=0.3, timeout=60.0) == 1
        _wait(lambda: cl.num_shards == 1, msg="retire adopted")
        assert cl.membership_adopts >= 2
        assert cl.sample(8, rng=np.random.default_rng(0)).indices.max() < 128
    finally:
        if cl is not None:
            cl.close()
        fleet.stop()
        reg.close()


def test_spill_backed_shard_digest_matches_dense_twin(tmp_path):
    """A tiered (spill-backed) port shard answers digest bit-exactly against
    a dense twin fed the same stream, with spans really spilled."""
    dense = PrioritizedReplay(64, OBS, priority_exponent=0.6)
    tiered = PrioritizedReplay(64, OBS, priority_exponent=0.6,
                               hot_frame_budget_bytes=8 * int(np.prod(OBS)),
                               spill_dir=str(tmp_path / "spill"))
    servers = [tsvc.ReplayShardServer(rep, 0, incarnation=1, token=9, codec="zlib").start()
               for rep in (dense, tiered)]
    try:
        for chunk in range(6):
            body = tsvc.encode_body(_chunk(n=16, seed=40 + chunk, overlap=True),
                                    codec=CODEC_ZLIB)
            for srv in servers:
                cli = tsvc.ShardClient(0, "127.0.0.1", srv.port, token=9,
                                       client_id=100 + chunk, incarnation=1)
                cli.request(tsvc.OP_ADD, body, timeout=10.0)
                cli.close()
        # An add lands hot and its reply goes out before the pump's next
        # spill sweep: wait for the sweep after the last add (under the
        # watermark again), not just for the first spill of the run.
        _wait(lambda: servers[1].spill_spans > 0 and not tiered.tier_over_watermark(),
              msg="the spill sweep after the last add")
        assert tiered.frames_nbytes() < dense.frames_nbytes()
        digests = []
        for srv in servers:
            cli = tsvc.ShardClient(0, "127.0.0.1", srv.port, token=9, client_id=55,
                                   incarnation=1)
            digests.append(cli.digest(with_crc=True, timeout=10.0))
            cli.close()
        for key in ("count", "cursor", "size", "crc"):
            assert int(digests[0][key]) == int(digests[1][key]), key
        assert abs(digests[0]["total_mass"] - digests[1]["total_mass"]) <= 1e-9
        assert servers[1].stats()["spill_bytes"] > 0
    finally:
        for srv in servers:
            srv.close()


# -- the slice as a whole, across the packages -------------------------------------------

SLICE_OBS, SLICE_A, SLICE_B = (36, 36, 1), 3, 8


def _slice_chunk(seed):
    r = np.random.default_rng(seed)
    o = r.integers(0, 256, (16, *SLICE_OBS), dtype=np.uint8)
    return {
        "prio": (np.abs(r.normal(size=16)) + 0.1).astype(np.float64),
        "obs": o, "action": r.integers(0, SLICE_A, 16).astype(np.int32),
        "reward": r.normal(size=16).astype(np.float32),
        "discount": (np.full(16, 0.97, np.float32) * (r.random(16) > 0.2)).astype(np.float32),
        "next_obs": np.roll(o, -1, axis=0),
    }


def test_slice_sample_train_writeback_matches_jax():
    fleets = {}
    for name, (svc, Replay) in PKGS.items():
        reps = [Replay(64, SLICE_OBS) for _ in range(2)]
        srvs = [svc.ReplayShardServer(r, k, token=3).start() for k, r in enumerate(reps)]
        cl = svc.ShardedReplayClient(
            [{"id": k, "host": "127.0.0.1", "port": s.port, "base": 64 * k, "capacity": 64}
             for k, s in enumerate(srvs)], token=3, request_timeout_s=10.0)
        fleets[name] = (reps, srvs, cl)
    jnet = jdueling.build_network("conv", SLICE_A, channels=(8, 8, 8), hidden=32,
                                  compute_dtype=jnp.float32)
    jopt = jtrain.make_optimizer("rmsprop")
    jstate = jtrain.init_train_state(jnet, jopt, jax.random.PRNGKey(0),
                                     jnp.zeros((1, *SLICE_OBS), jnp.uint8))
    tnet = tdueling.build_network("conv", SLICE_A, SLICE_OBS, channels=(8, 8, 8), hidden=32,
                                  compute_dtype=torch.float32)
    topt = ttrain.make_optimizer("rmsprop")
    params = params_from_jax(tnet, jax.device_get(jstate.params))
    tstate = TrainState(params=params, target_params={k: v.clone() for k, v in params.items()},
                        opt_state=topt.init(params), step=0, seed=0)
    jstep = jtrain.build_train_step(jnet, jopt, target_sync_freq=2)
    tstep = ttrain.build_train_step(tnet, topt, target_sync_freq=2)
    try:
        for seed in range(6):
            c = _slice_chunk(seed)
            idx = [fleets[n][2].add(c["prio"], _Batch(c)) for n in PKGS]
            np.testing.assert_array_equal(idx[0], idx[1])
        rngs = {n: np.random.default_rng(77) for n in PKGS}
        for _ in range(5):
            b = {n: fleets[n][2].sample(SLICE_B, beta=0.4, rng=rngs[n]) for n in PKGS}
            jb, tb = b["jax"], b["torch"]
            np.testing.assert_array_equal(tb.indices, np.asarray(jb.indices))
            np.testing.assert_allclose(tb.is_weights, np.asarray(jb.is_weights), rtol=1e-6)
            for f in ("obs", "action", "reward", "discount", "next_obs"):
                np.testing.assert_array_equal(getattr(tb.transition, f),
                                              np.asarray(getattr(jb.transition, f)))
            jstate, jm = jstep(jstate, JBatch(
                transition=JTransition(**{f: jnp.asarray(getattr(jb.transition, f)) for f in
                                          ("obs", "action", "reward", "discount", "next_obs")}),
                indices=jnp.asarray(jb.indices), is_weights=jnp.asarray(jb.is_weights)))
            tstate, tm = tstep(tstate, PrioritizedBatch(
                transition=NStepTransition(**{f: torch.from_numpy(getattr(tb.transition, f))
                                              for f in ("obs", "action", "reward", "discount",
                                                        "next_obs")}),
                indices=torch.from_numpy(tb.indices), is_weights=torch.from_numpy(tb.is_weights)))
            np.testing.assert_allclose(float(tm.loss), float(jm.loss), rtol=1e-4)
            jprio = np.asarray(jm.priorities)
            np.testing.assert_allclose(tm.priorities.numpy(), jprio, rtol=1e-4, atol=1e-6)
            for n in PKGS:       # the JAX priorities to both: indices stay comparable
                fleets[n][2].update_priorities(np.asarray(jb.indices), jprio)
        for k in range(2):
            d = [fleets[n][0][k].digest(with_crc=True) for n in PKGS]
            for key in ("count", "cursor", "size", "crc"):
                assert d[0][key] == d[1][key], (k, key)
            np.testing.assert_allclose(d[1]["total_mass"], d[0]["total_mass"], rtol=1e-6)
    finally:
        for _reps, srvs, cl in fleets.values():
            cl.close()
            for s in srvs:
                s.close()


def _get(url):
    import urllib.error
    import urllib.request

    try:
        return urllib.request.urlopen(url, timeout=10).read()
    except urllib.error.HTTPError as e:   # /healthz answers 503 when degraded
        return e.read()


def test_async_pipeline_attached_trains_through_a_shard_kill(tmp_path):
    """``AsyncPipeline(device="cpu")`` with ``replay.service_mode=attach``
    over a 2-shard port fleet: a shard SIGKILLed mid-run is a DEGRADED
    ``replay_svc`` component with buffered write-backs, the learner trains
    on, the shard respawns from its chain, and the final record shows the
    fleet whole with every parked write-back flushed."""
    from ape_x_dqn_tpu_torch.runtime.async_pipeline import AsyncPipeline
    from ape_x_dqn_tpu_torch.utils.metrics import MetricLogger

    # The test owns the respawn, so the scrapes land while the shard is down.
    fleet = tsvc.ReplayServiceFleet(2, 4096, OBS, root_dir=str(tmp_path / "fleet"),
                                    save_every_s=0.5, auto_respawn=False,
                                    kill_shard_at_step=60, chaos_seed=3).start(timeout=60.0)
    try:
        cfg = apply_overrides(ApexConfig(), [
            "network=mlp", "env.name=chain:6", "actor.num_actors=4", "actor.flush_every=8",
            "learner.min_replay_mem_size=256", "replay.capacity=4096",
            "replay.service_mode=attach", f"replay.service_endpoints={fleet.endpoints_path}",
            "replay.service_request_timeout_s=2", "replay.service_probe_interval_s=0.2",
            "obs.trace_sample_rate=1.0", "obs.export_port=0"])
        pipe = AsyncPipeline(cfg, logger=MetricLogger(stream=io.StringIO()), log_every=1000,
                             device="cpu")
        seen, err, out = [], [], {}

        def run():
            try:
                out["final"] = pipe.run(learner_steps=10**9)
            except BaseException as e:  # noqa: BLE001 — asserted below
                err.append(e)

        t = threading.Thread(target=run, daemon=True)
        t.start()
        deadline = time.monotonic() + 120.0
        url = None
        while time.monotonic() < deadline and not err:
            url = url or (pipe.obs_server.url if pipe.obs_server else None)
            kill = fleet.maybe_kill_at_step(pipe.learner_step)
            if kill:
                kill_rec, kill_step = kill, pipe.learner_step
            st = pipe.comps.replay.stats()
            if st["shards_down"] and not seen:
                time.sleep(0.3)
                out["varz"] = json.loads(_get(f"{url}/varz"))
                out["healthz"] = json.loads(_get(f"{url}/healthz"))
                seen.append(("down", pipe.learner_step))
                fleet.respawn(kill_rec["shard"], timeout=60.0)
            if (fleet.respawns and not st["shards_down"] and st["writeback_flushed"]
                    and seen and pipe.learner_step > seen[0][1] + 50):
                break
            time.sleep(0.05)
        pipe.stop_event.set()
        t.join(timeout=60)
        assert not t.is_alive() and not err, err
    finally:
        fleet.stop()
    assert seen, "the shard kill was never seen as a down shard"
    assert kill_step >= 60
    # While the shard was down: the replay_svc section says so, and the
    # /healthz component reports how long the fleet has been degraded.
    down = out["varz"]["replay_svc"]
    assert down["shards_down"] == 1 and down["degraded"], down
    assert out["healthz"]["components"]["replay_svc"]["age_s"] > 0, out["healthz"]
    svc = out["final"]["replay_svc"]
    assert svc["shards_down"] == 0 and svc["writeback_pending"] == 0
    assert svc["writeback_flushed"] > 0 and svc["recoveries"] >= 1 and svc["rpc_torn"] == 0
    assert out["final"]["step"] > seen[0][1] + 50
    assert fleet.respawns == 1 and fleet.kills == 1

