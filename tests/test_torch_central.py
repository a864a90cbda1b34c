"""Central inference in the port (``ape_x_dqn_tpu_torch/serving/central.py``,
the fleet's selector seam, central process workers and the runtime's
in-process serving tier) against the JAX package's, mirrored from
``tests/test_central_inference.py``.

Covers: the v2 hello's run token; batched selects against a live port
server (stub policy: greedy action = obs sum mod A), zlib negotiated, shed
typed and retried, a bad body typed, torn request frames never decoded; a
bit-flipped reply stream dropped and retried, a lost reply retried exactly
once, an outage typed; JAX clients against a port server and port clients
against a JAX server (same actions); ``CentralSelector`` against JAX's on
the same replies and seed (bit-identical actions); the ε-ladder slice; the
fleet's paramless collect; ``aggregate_inference_stats`` equal to JAX's;
config and the not-ported knobs; and central runs of ``AsyncPipeline`` on
the CPU (thread fleet, and one process worker with 2 actors that maps no
param buffer), whose ``inference`` section has the JAX keys.
"""

from __future__ import annotations

import io
import json
import os
import socket
import struct
import threading
import time
from concurrent.futures import Future

import numpy as np
import pytest

from ape_x_dqn_tpu.ops.exploration import epsilon_ladder as jax_epsilon_ladder
from ape_x_dqn_tpu.serving import central as jcentral
from ape_x_dqn_tpu.serving import net_server as jserver
from ape_x_dqn_tpu.serving.batcher import ServedAction as JServedAction
from ape_x_dqn_tpu_torch.config import ApexConfig, apply_overrides, load_config
from ape_x_dqn_tpu_torch.runtime.net import (
    CODEC_OFF,
    CODEC_ZLIB,
    E_BAD_REQUEST,
    F_IREQ,
    F_SERR,
    FRAME,
    FrameParser,
    decode_error,
    encode_inference_request,
    frame_bytes,
    parse_serve_hello_ext,
    serve_hello_bytes,
    serve_hello_ext_bytes,
)
from ape_x_dqn_tpu_torch.serving.batcher import ServedAction, ServerOverloaded
from ape_x_dqn_tpu_torch.serving.central import (
    CentralInferenceClient,
    CentralSelector,
    InferenceUnavailable,
    aggregate_inference_stats,
    merge_rtt_state,
    split_groups,
)
from ape_x_dqn_tpu_torch.serving.net_server import ServingNetServer
from ape_x_dqn_tpu_torch.utils.metrics import LatencyHistogram, MetricLogger

from _torch_harness import joined, port_deadline  # noqa: F401 — port_deadline is autouse

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class StubPolicy:
    """PolicyServer stand-in: greedy action = obs sum mod A, one-hot q."""

    def __init__(self, num_actions: int = 4, version: int = 7, served_cls=ServedAction):
        self.num_actions = num_actions
        self.param_version = version
        self.served = 0
        self.fail_with = None
        self._cls = served_cls

    def q_row(self, obs) -> np.ndarray:
        q = np.zeros(self.num_actions, np.float32)
        q[int(np.asarray(obs, np.uint64).sum()) % self.num_actions] = 1.0
        return q

    def submit(self, obs) -> Future:
        if self.fail_with is not None:
            raise self.fail_with
        f = Future()
        self.served += 1
        q = self.q_row(obs)
        f.set_result(self._cls(int(q.argmax()), q, self.param_version, 0.0))
        return f


@pytest.fixture
def net_server():
    srv = ServingNetServer(StubPolicy(), run_token=4242).start()
    yield srv
    srv.close()


def _client(srv, **kw):
    kw.setdefault("token", 4242)
    kw.setdefault("seed", 1)
    return CentralInferenceClient("127.0.0.1", srv.port, **kw)


def _obs(n=6, shape=(8, 8, 1), seed=0):
    return np.random.default_rng(seed).integers(0, 255, (n, *shape), dtype=np.uint8)


def _want(obs):
    stub = StubPolicy()
    return np.array([stub.q_row(o).argmax() for o in obs], np.int32)


def _wait(cond, timeout=5.0, msg="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.01)
    raise AssertionError(f"timeout waiting for {msg}")


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


class TestHelloToken:
    def test_ext_hello_roundtrip(self):
        h = serve_hello_ext_bytes(3, 2, 99, CODEC_ZLIB)
        assert parse_serve_hello_ext(h[8:]) == {"wid": 3, "attempt": 2, "token": 99,
                                                "codec": CODEC_ZLIB, "flags": 0}

    def test_wrong_token_rejected_before_framing(self, net_server):
        s = socket.create_connection(("127.0.0.1", net_server.port), 5.0)
        s.sendall(serve_hello_ext_bytes(0, 0, 1, CODEC_OFF))
        _wait(lambda: net_server.token_rejects == 1, msg="token reject")
        assert net_server.stats()["requests"] == 0
        s.close()

    def test_anonymous_v1_hello_still_accepted(self, net_server):
        from ape_x_dqn_tpu_torch.runtime.net import F_SREQ, encode_request

        s = socket.create_connection(("127.0.0.1", net_server.port), 5.0)
        s.sendall(serve_hello_bytes())
        s.sendall(frame_bytes(F_SREQ, 1, [encode_request(1, np.zeros(8, np.uint8))]))
        _wait(lambda: net_server.replies == 1, msg="v1 reply")
        s.close()

    def test_good_token_lands_per_source_stats(self, net_server):
        cl = _client(net_server, wid=11)
        try:
            cl.select(_obs(4), timeout_s=10)
        finally:
            cl.close()
        src = net_server.stats()["sources"]
        assert src["11"]["rows"] == 4 and src["11"]["replies"] >= 1


class TestServerInference:
    def test_batched_select_matches_stub(self, net_server):
        obs = _obs(7)
        cl = _client(net_server, inflight=3)
        try:
            actions, q, version = cl.select(obs, timeout_s=10)
        finally:
            cl.close()
        np.testing.assert_array_equal(actions, _want(obs))
        assert version == 7 and q.shape == (7, 4)
        st = net_server.stats()
        assert (st["inference_requests"], st["inference_rows"], st["torn_frames"]) == (3, 7, 0)

    def test_zlib_negotiated_end_to_end(self, net_server):
        cl = _client(net_server, codec="zlib", inflight=1)
        try:
            obs = np.zeros((6, 32, 32, 1), np.uint8)
            cl.select(obs, timeout_s=10)
        finally:
            cl.close()
        assert cl.compressed_frames >= 1 and cl.wire_bytes_out < obs.nbytes
        assert net_server.stats()["torn_frames"] == 0

    def test_shed_is_typed_and_retried(self, net_server):
        stub = net_server._server
        stub.fail_with = ServerOverloaded("full")
        cl = _client(net_server)
        t = threading.Timer(0.3, lambda: setattr(stub, "fail_with", None))
        t.start()
        try:
            actions, _q, _v = cl.select(_obs(4), timeout_s=15)
            assert actions.shape == (4,)
            assert cl.shed_seen >= 1 and cl.torn_replies == 0
        finally:
            joined(t, 10.0, "the timer that ends the shed")
            cl.close()

    def test_bad_body_typed_not_torn(self, net_server):
        s = socket.create_connection(("127.0.0.1", net_server.port), 5.0)
        s.sendall(serve_hello_ext_bytes(0, 0, 4242, CODEC_OFF))
        s.sendall(frame_bytes(F_IREQ, 1, [b"\x99" * 64]))
        parser = FrameParser()
        deadline = time.monotonic() + 5.0
        got = None
        while got is None and time.monotonic() < deadline:
            parser.feed(s.recv(4096))
            got = parser.next()
        kind, payload = got
        assert kind == F_SERR and decode_error(payload)[1] == E_BAD_REQUEST
        assert net_server.torn_frames == 0
        s.close()

    def test_torn_request_frames_never_decoded(self, net_server):
        stub = net_server._server
        good = frame_bytes(F_IREQ, 1, [encode_inference_request(1, _obs(4))[0]])
        flipped = bytearray(good)
        flipped[FRAME.size + 4] ^= 0x40
        huge = bytearray(good)
        struct.pack_into("<I", huge, 0, 1 << 29)
        before = stub.served
        for i, wire in enumerate((good[: FRAME.size + 10], bytes(flipped), bytes(huge))):
            torn0 = net_server.torn_frames
            s = socket.create_connection(("127.0.0.1", net_server.port), 5.0)
            s.sendall(serve_hello_ext_bytes(0, 0, 4242, CODEC_OFF))
            s.sendall(wire)
            s.shutdown(socket.SHUT_WR)
            _wait(lambda: net_server.torn_frames > torn0, msg=f"torn case {i}")
            s.close()
        assert stub.served == before


class _FlippingProxy:
    """TCP proxy that XORs one byte of the server→client stream."""

    def __init__(self, dst_port: int, flip_at: int = 60):
        self._dst, self._flip_at, self._flipped, self._stop = dst_port, flip_at, False, False
        self._lsock = socket.socket()
        self._lsock.bind(("127.0.0.1", 0))
        self._lsock.listen(8)
        self._lsock.settimeout(0.2)   # polls _stop: a close does not wake accept()
        self.port = self._lsock.getsockname()[1]
        threading.Thread(target=self._accept, daemon=True).start()

    def _accept(self):
        while not self._stop:
            try:
                c, _ = self._lsock.accept()
            except TimeoutError:
                continue
            except OSError:
                return
            c.settimeout(30.0)
            u = socket.create_connection(("127.0.0.1", self._dst), 5.0)
            u.settimeout(30.0)
            for src, dst, flip in ((c, u, False), (u, c, True)):
                threading.Thread(target=self._pump, args=(src, dst, flip), daemon=True).start()

    def _pump(self, src, dst, flip):
        seen = 0
        while not self._stop:
            try:
                data = src.recv(4096)
            except OSError:
                break
            if not data:
                break
            if flip and not self._flipped and seen + len(data) > self._flip_at:
                b = bytearray(data)
                b[self._flip_at - seen] ^= 0x10
                data = bytes(b)
                self._flipped = True
            seen += len(data)
            try:
                dst.sendall(data)
            except OSError:
                break
        for s in (src, dst):
            try:
                s.close()
            except OSError:
                pass

    def close(self):
        self._stop = True
        try:
            self._lsock.close()
        except OSError:
            pass


class TestClientAdversarial:
    def test_bitflipped_reply_dropped_and_retried(self, net_server):
        proxy = _FlippingProxy(net_server.port, flip_at=40)
        cl = CentralInferenceClient("127.0.0.1", proxy.port, token=4242, seed=2, inflight=1)
        try:
            obs = _obs(4)
            actions, _q, _v = cl.select(obs, timeout_s=20)
            np.testing.assert_array_equal(actions, _want(obs))
            assert cl.torn_replies >= 1 and cl.retries >= 1
        finally:
            cl.close()
            proxy.close()

    def test_lost_reply_retried_exactly_once(self):
        srv = ServingNetServer(StubPolicy(), run_token=4242).start()
        orig = srv._handle_inference
        dropped = {"n": 0}

        def dropping(conn, payload):
            if dropped["n"] == 0:
                dropped["n"] += 1
                return
            orig(conn, payload)

        srv._handle_inference = dropping
        cl = CentralInferenceClient("127.0.0.1", srv.port, token=4242, seed=3, inflight=1,
                                    io_timeout_s=0.5)
        try:
            cl.select(_obs(3), timeout_s=20)
            assert dropped["n"] == 1 and cl.retries == 1
        finally:
            cl.close()
            srv.close()

    def test_outage_is_typed(self):
        cl = CentralInferenceClient("127.0.0.1", _free_port(), seed=4)
        try:
            with pytest.raises(InferenceUnavailable):
                cl.select(_obs(2), timeout_s=1.0)
            assert cl.stall_s > 0
        finally:
            cl.close()


class TestAcrossPackages:
    @pytest.mark.parametrize("codec", ["off", "zlib"])
    def test_jax_client_against_port_server(self, net_server, codec):
        obs = _obs(9, (8, 8, 4), seed=5)
        obs[3] = obs[2]
        cl = jcentral.CentralInferenceClient("127.0.0.1", net_server.port, token=4242,
                                             codec=codec, inflight=3, wid=5)
        try:
            actions, q, version = cl.select(obs, timeout_s=10)
        finally:
            cl.close()
        np.testing.assert_array_equal(actions, _want(obs))
        assert version == 7 and q.shape == (9, 4)
        assert net_server.stats()["sources"]["5"]["rows"] == 9
        assert net_server.torn_frames == 0

    @pytest.mark.parametrize("codec", ["off", "zlib"])
    def test_port_client_against_jax_server(self, codec):
        srv = jserver.ServingNetServer(StubPolicy(served_cls=JServedAction),
                                       run_token=4242).start()
        obs = _obs(9, (8, 8, 4), seed=6)
        cl = CentralInferenceClient("127.0.0.1", srv.port, token=4242, codec=codec,
                                    inflight=4, wid=2)
        try:
            actions, q, version = cl.select(obs, timeout_s=10)
        finally:
            cl.close()
            srv.close()
        np.testing.assert_array_equal(actions, _want(obs))
        assert version == 7 and srv.stats()["inference_rows"] == 9
        assert srv.torn_frames == 0

    def test_stats_keys_equal_jax(self, net_server):
        cl, jcl = _client(net_server), jcentral.CentralInferenceClient(
            "127.0.0.1", net_server.port, token=4242)
        try:
            cl.select(_obs(3), timeout_s=10)
            jcl.select(_obs(3), timeout_s=10)
            assert set(cl.stats(include_hist=True)) == set(jcl.stats(include_hist=True))
            assert cl.stats()["rtt"].keys() == jcl.stats()["rtt"].keys()
        finally:
            cl.close()
            jcl.close()


class _ScriptedClient:
    """Replies from a script: the same greedy rows for both packages."""

    def __init__(self, replies):
        self._replies = list(replies)
        self.fallback_steps = 0
        self.trace = False

    def select(self, obs, **_kw):
        return self._replies.pop(0)

    def stats(self, include_hist=False):
        return {}

    def close(self):
        pass


class TestSelector:
    @pytest.mark.parametrize("seed", [0, 9, 12345])
    def test_actions_bit_identical_to_jax(self, seed):
        """The same replies, ε slice and seed: the same actions, select by
        select (numpy ``default_rng`` draws in both packages)."""
        from ape_x_dqn_tpu_torch.ops.exploration import epsilon_ladder

        n, A = 8, 6
        eps = epsilon_ladder(0.4, 7.0, 16)[4:4 + n].numpy()
        rng = np.random.default_rng(seed + 1)
        replies = [(rng.integers(0, A, n).astype(np.int32),
                    rng.standard_normal((n, A)).astype(np.float32), v) for v in range(20)]
        sel = CentralSelector(_ScriptedClient(replies), eps, A, seed=seed)
        jsel = jcentral.CentralSelector(_ScriptedClient(replies), eps, A, seed=seed)
        for step in range(20):
            a, q, v = sel.select(np.zeros((n, 2), np.uint8), step)
            ja, jq, jv = jsel.select(np.zeros((n, 2), np.uint8), step)
            np.testing.assert_array_equal(a, ja)
            assert a.dtype == ja.dtype == np.int32
            np.testing.assert_array_equal(q, jq)
            assert v == jv == step

    def test_epsilon_ladder_slice_identity(self):
        from ape_x_dqn_tpu_torch.ops.exploration import epsilon_ladder
        from ape_x_dqn_tpu_torch.runtime.process_actors import worker_slice

        N, W = 16, 4
        ladder = epsilon_ladder(0.4, 7.0, N).numpy()
        np.testing.assert_array_equal(ladder, np.asarray(jax_epsilon_ladder(0.4, 7.0, N)))
        for wid in range(W):
            lo, hi = worker_slice(wid, N, W)
            sel = CentralSelector(CentralInferenceClient("127.0.0.1", 1, seed=0),
                                  ladder[lo:hi], 4)
            np.testing.assert_allclose(sel.epsilons, ladder[lo:hi])
            sel.close()

    def test_epsilon_zero_is_server_greedy(self, net_server):
        obs = _obs(5)
        sel = CentralSelector(_client(net_server), np.zeros(5), 4, seed=9)
        try:
            actions, q, _v = sel.select(obs, 0)
        finally:
            sel.close()
        np.testing.assert_array_equal(actions, _want(obs))
        np.testing.assert_array_equal(actions, np.asarray(q).argmax(axis=1))

    def test_epsilon_one_is_seeded_uniform(self, net_server):
        obs = _obs(64)
        sel = CentralSelector(_client(net_server), np.ones(64), 4, seed=9)
        sel2 = CentralSelector(_client(net_server), np.ones(64), 4, seed=9)
        try:
            a1, _, _ = sel.select(obs, 0)
            a2, _, _ = sel2.select(obs, 0)
        finally:
            sel.close()
            sel2.close()
        np.testing.assert_array_equal(a1, a2)
        assert len(np.unique(a1)) == 4

    def test_outage_uses_local_fallback(self):
        calls = []

        def fallback(obs, step):
            calls.append(step)
            return (np.zeros(obs.shape[0], np.int32),
                    np.zeros((obs.shape[0], 4), np.float32), 3)

        cl = CentralInferenceClient("127.0.0.1", _free_port(), seed=5)
        sel = CentralSelector(cl, np.zeros(2), 4, timeout_s=0.5, fallback=fallback)
        try:
            _actions, _q, version = sel.select(_obs(2), 17)
        finally:
            sel.close()
        assert calls == [17] and version == 3
        assert sel.outages == 1 and cl.fallback_steps == 1

    def test_outage_without_fallback_blocks_until_stop(self):
        stop = threading.Event()
        cl = CentralInferenceClient("127.0.0.1", _free_port(), seed=6)
        sel = CentralSelector(cl, np.zeros(2), 4, timeout_s=0.3, should_stop=stop.is_set)
        timer = threading.Timer(1.0, stop.set)
        timer.start()
        t0 = time.monotonic()
        try:
            with pytest.raises(InferenceUnavailable):
                sel.select(_obs(2), 0)
        finally:
            joined(timer, 10.0, "the timer that sets stop")
            sel.close()
        assert time.monotonic() - t0 >= 0.9
        assert sel.outages >= 1 and cl.stall_s > 0

    def test_split_groups_equal_jax(self):
        for n in range(1, 40):
            for k in range(0, 10):
                assert split_groups(n, k) == jcentral.split_groups(n, k)
        assert split_groups(7, 3) == [(0, 2), (2, 4), (4, 7)]


class TestFleetSeam:
    def _fleet(self):
        from ape_x_dqn_tpu_torch.actors.pool import ActorFleet
        from ape_x_dqn_tpu_torch.envs import make_env
        from ape_x_dqn_tpu_torch.models.dueling import build_network

        return ActorFleet([(lambda i=i: make_env("chain:6", seed=100 + i)) for i in range(4)],
                          build_network("mlp", 2, (6,)), n_step=3, flush_every=8, seed=0,
                          device="cpu")

    def test_collect_with_selector_is_paramless(self, net_server):
        fleet = self._fleet()
        sel = CentralSelector(_client(net_server), fleet._epsilons.numpy(), 2, seed=1)
        try:
            chunks, _stats = fleet.collect(24, selector=sel)
        finally:
            sel.close()
        assert fleet.params is None and fleet.param_version == 7
        assert chunks and all(np.isfinite(c.priorities).all() for c in chunks)
        assert sel.selects == 24

    def test_collect_without_selector_still_requires_params(self):
        with pytest.raises(RuntimeError, match="no params"):
            self._fleet().collect(4)


class TestAggregation:
    def test_aggregate_equals_jax(self):
        dicts = []
        for reqs, v, samples in ((3, 5, (0.01, 0.02)), (4, 9, (0.1,)), (0, 11, ())):
            h = LatencyHistogram()
            for s in samples:
                h.record(s)
            dicts.append({
                "requests": reqs, "rows": reqs, "replies": reqs, "retries": 1,
                "reconnects": 0, "shed_seen": 0, "torn_replies": 0, "errors": 0,
                "fallback_steps": 0, "selects": reqs, "outages": 0, "stall_ms": 1.5,
                "param_version": v, "wire_bytes_out": 10, "logical_bytes_out": 20,
                "rtt_state": {k: h.state_dict()[k] for k in ("counts", "count", "sum", "max")},
                "rtt_exemplars": {"0.01": reqs} if reqs else {},
            })
        out = aggregate_inference_stats(dicts)
        assert out == jcentral.aggregate_inference_stats(dicts)
        assert out["requests"] == 7 and out["param_version"] == 5
        assert out["stall_ms"] == 4.5 and out["rtt"]["count"] == 3
        assert out["wire_over_logical"] == 0.5
        assert aggregate_inference_stats([]) == jcentral.aggregate_inference_stats([])

    def test_merge_rtt_state_ignores_other_layouts(self):
        h = LatencyHistogram()
        merge_rtt_state(h, {"counts": [1, 2], "count": 3})
        assert h.count == 0
        other = LatencyHistogram()
        other.record(0.5)
        merge_rtt_state(h, other.state_dict())
        assert h.count == 1


class TestConfig:
    def test_central_fields_and_serving_section_load(self):
        cfg = apply_overrides(ApexConfig(), [
            "actor.inference=central", "actor.inference_port=1234",
            "actor.inference_codec=zlib", "actor.inference_inflight=2",
            "actor.inference_fallback=local", "serving.max_batch=16",
            "serving.max_wait_ms=2.5", "serving.queue_capacity=99"])
        assert (cfg.actor.inference, cfg.actor.inference_port) == ("central", 1234)
        assert cfg.serving.max_batch == 16 and cfg.serving.queue_capacity == 99

    def test_serving_profile_loads_unchanged(self):
        cfg = load_config(os.path.join(REPO, "configs", "config6_serving_cpu.json"))
        assert cfg.env.name == "random:84x84x1" and cfg.network == "conv"
        assert (cfg.serving.max_batch, cfg.serving.max_wait_ms,
                cfg.serving.queue_capacity, cfg.serving.reload_poll_s) == (32, 5.0, 256, 0.25)

    @pytest.mark.parametrize("override,message", [
        ("actor.inference=remote", "unknown actor.inference"),
        ("actor.inference_port=70000", "inference_port"),
        ("actor.inference_inflight=0", "inference_inflight"),
        ("actor.inference_codec=lz4", "unknown actor.inference_codec"),
        ("actor.inference_timeout_s=0", "inference_timeout_s"),
        ("actor.inference_fallback=cpu", "unknown actor.inference_fallback"),
        ("serving.queue_capacity=8", "queue_capacity"),
        ("serving.max_request_bytes=1024", "max_request_bytes"),
        ("serving.param_stale_s=-2", "param_stale_s"),
        # The serving delay is ported: a negative one is refused by name.
        pytest.param("chaos.serving_delay_ms=-5", "chaos.serving_delay_ms must be >= 0",
                     id="chaos.serving_delay_ms=5-serving delay"),
    ])
    def test_invalid_or_unported_knobs_raise_by_name(self, override, message):
        with pytest.raises(ValueError, match=message):
            apply_overrides(ApexConfig(), ["serving.max_batch=16", override])

    def test_unported_chaos_section_refused_in_json(self, tmp_path):
        """The chaos section loads whole: its replay-service keys, refused
        by name until the replay service was ported, load beside
        serving_delay_ms; an out-of-range one is refused with the JAX
        package's message."""
        path = tmp_path / "cfg.json"
        path.write_text(json.dumps({"chaos": {"serving_delay_ms": 5.0}}))
        assert load_config(str(path)).chaos.serving_delay_ms == 5.0
        path.write_text(json.dumps({"chaos": {"serving_delay_ms": 5.0, "rpc_drop_rate": 0.1}}))
        chaos = load_config(str(path)).chaos
        assert (chaos.serving_delay_ms, chaos.rpc_drop_rate) == (5.0, 0.1)
        path.write_text(json.dumps({"chaos": {"serving_delay_ms": 5.0, "rpc_drop_rate": 1.5}}))
        with pytest.raises(ValueError, match=r"chaos\.rpc_drop_rate must be in \[0, 1\]"):
            load_config(str(path))


# -- central runs of the runtime on the CPU -----------------------------------------


def _central_cfg(mode: str, **extra) -> ApexConfig:
    cfg = ApexConfig()
    cfg.network = "mlp"
    cfg.env.name = "chain:6"
    cfg.actor.num_actors = 2 if mode == "process" else 4
    cfg.actor.num_workers = 1
    cfg.actor.mode = mode
    cfg.actor.T = 100_000
    cfg.actor.flush_every = 8
    cfg.actor.sync_every = 16
    cfg.actor.inference = "central"
    cfg.actor.inference_inflight = 2
    cfg.actor.inference_codec = "zlib"
    cfg.serving.max_batch = 8
    cfg.serving.max_wait_ms = 2.0
    cfg.learner.min_replay_mem_size = 256
    cfg.learner.publish_every = 5
    cfg.learner.total_steps = 80
    cfg.learner.optimizer = "adam"
    cfg.replay.capacity = 4096
    for path, value in extra.items():
        section, field = path.split("__")
        setattr(getattr(cfg, section), field, value)
    return cfg.validate()


def _jax_inference_keys() -> set:
    keys = set(jcentral.aggregate_inference_stats([]))
    return keys | {"version_lag", "batch_occupancy_mean"}


def _run(cfg):
    from ape_x_dqn_tpu_torch.runtime.async_pipeline import AsyncPipeline

    pipe = AsyncPipeline(cfg, logger=MetricLogger(stream=io.StringIO()), log_every=40,
                         device="cpu")
    return pipe, pipe.run(learner_steps=80)


def test_central_thread_run_on_cpu():
    """The thread fleet acts through the in-process server: fresh replies,
    no torn replies, real batching, the JAX section keys."""
    pipe, final = _run(_central_cfg("thread"))
    inf = final["inference"]
    assert set(inf) == _jax_inference_keys()
    assert inf["mode"] == "central" and inf["replies"] > 0 and inf["torn_replies"] == 0
    assert inf["param_version"] >= 1
    assert inf["version_lag"] is not None and inf["version_lag"] <= 5
    assert inf["rtt"]["count"] > 0 and inf["batch_occupancy_mean"] is not None
    assert inf["fallback_steps"] == 0
    net = pipe._central_net.stats()
    assert net["torn_frames"] == 0 and net["inference_rows"] >= inf["replies"]


def test_central_process_run_on_cpu():
    """One process worker with 2 actors, paramless: no param buffer in the
    pool, none mapped by the worker, no params held, no CUDA; every fleet
    step's actions came from the server; /dev/shm clean after."""
    pipe, final = _run(_central_cfg("process"))
    pool = pipe.worker.pool
    assert pool.buffer is None and pool.store is None
    report = pool.worker_reports[0]
    assert not report["param_buffer"] and not report["held_params"]
    assert not report["cuda_initialized"]
    steps = report["env_steps"] // 2
    inf_w = report["inference"]
    assert inf_w["selects"] - inf_w["outages"] == steps and inf_w["fallback_steps"] == 0
    inf = final["inference"]
    assert set(inf) == _jax_inference_keys()
    assert inf["mode"] == "central" and inf["workers_reporting"] == 1
    assert inf["torn_replies"] == 0 and inf["replies"] > 0
    assert pipe._central_net.stats()["sources"]["0"]["rows"] >= steps * 2
    assert not [n for n in os.listdir("/dev/shm") if f"_{os.getpid()}_" in n]
