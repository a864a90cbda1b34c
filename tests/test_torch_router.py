"""The port's router and replica fleet (``ape_x_dqn_tpu_torch/serving/
router.py``, ``serve --replicas``) against the JAX package's, mirrored
from ``tests/test_serving_net.py`` (TestRouter).

* Routing over in-process stub replicas (real sockets, real ``/healthz``
  probes): round robin, a 503 drains a replica and a 200 brings it back, a
  dead replica fails over with the client's retry, no healthy replica
  fails fast and recovers, the stats key set.
* Across the packages: a port router fronts a JAX ``ServingNetServer`` and
  a port one; the router's and the fleet's stats carry the JAX key sets.
* A port ``ServingFleet`` of 2 CPU replica processes (``--device cpu``,
  1 intra-op thread each) whose hub publishes params carried from the
  JAX package (``weights.py``): every reply's q equals the JAX policy's on
  the same numpy obs within 1e-5 (float32 on both sides); the next publish
  reaches both replicas as a delta; a SIGKILLed replica drains, the
  client retries with nothing dropped, and the respawn full-syncs.
* ``serve --replicas 2 --checkpoint`` on the CPU, end to end: served q
  equals a CPU forward of the checkpoint's params, a newer step fans out
  as deltas, the exporter shows both replicas healthy.

Every socket wait has its own deadline.
"""

from __future__ import annotations

import io
import json
import os
import threading
import time
import urllib.request
from concurrent.futures import Future
from contextlib import redirect_stdout
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest
import torch

from ape_x_dqn_tpu.serving import net_server as jserver
from ape_x_dqn_tpu.serving import router as jrouter
from ape_x_dqn_tpu.serving.batcher import ServedAction as JServedAction
from ape_x_dqn_tpu_torch.serving.batcher import ServedAction
from ape_x_dqn_tpu_torch.serving.net_server import ServingClient, ServingNetServer
from ape_x_dqn_tpu_torch.serving.router import ServingFleet, ServingRouter

DEADLINE_S = 30.0
# The replicas' config: a float32 mlp over chain:6 (2 actions, 6 inputs).
FLEET_CFG = ["network=mlp", "env.name=chain:6", "serving.max_wait_ms=1.0",
             "serving.reload_poll_s=0.05", "replay.capacity=1024",
             "learner.min_replay_mem_size=64"]


class StubPolicy:
    """PolicyServer stand-in: instant completed futures."""

    def __init__(self, version: int = 7, served_cls=ServedAction):
        self.param_version = version
        self._cls = served_cls

    def submit(self, obs) -> Future:
        f = Future()
        f.set_result(self._cls(int(np.asarray(obs).sum()) % 4,
                               np.arange(4, dtype=np.float32), self.param_version, 0.0))
        return f


class _HealthStub:
    """A toggleable ``/healthz`` (the exporter's stand-in)."""

    def __init__(self):
        stub = self

        class H(BaseHTTPRequestHandler):
            def log_message(self, *a):  # noqa: N802 — http.server API
                pass

            def do_GET(self):  # noqa: N802 — http.server API
                body = json.dumps({"status": "ok" if stub.ok else "bad"})
                self.send_response(200 if stub.ok else 503)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body.encode())

        self.ok = True
        self._httpd = ThreadingHTTPServer(("127.0.0.1", 0), H)
        self._httpd.daemon_threads = True
        threading.Thread(target=self._httpd.serve_forever, daemon=True).start()
        self.url = f"http://127.0.0.1:{self._httpd.server_address[1]}/healthz"

    def close(self):
        self._httpd.shutdown()
        self._httpd.server_close()


def _fleet(n=2):
    replicas = []
    for i in range(n):
        srv = ServingNetServer(StubPolicy(version=i + 1)).start()
        replicas.append((srv, _HealthStub()))
    router = ServingRouter(port=0, probe_interval_s=30.0)   # probes driven by hand
    for rid, (srv, health) in enumerate(replicas):
        router.set_endpoint(rid, "127.0.0.1", srv.port, health_url=health.url)
    router.start()
    return router, replicas


def _teardown(router, replicas):
    router.close()
    for srv, health in replicas:
        srv.close()
        health.close()


# -- routing (TestRouter) -----------------------------------------------------------


def test_round_robin_spreads_connections():
    router, replicas = _fleet(2)
    clients = [ServingClient("127.0.0.1", router.port, seed=i) for i in range(4)]
    try:
        for c in clients:
            c.act(np.zeros(8, np.uint8), timeout=10.0)
        served = [srv.accepted for srv, _ in replicas]
        assert sum(served) == 4 and all(s > 0 for s in served), served
    finally:
        for c in clients:
            c.close()
        _teardown(router, replicas)


def test_unhealthy_replica_drains_and_reenters():
    router, replicas = _fleet(2)
    clients = []
    try:
        replicas[0][1].ok = False          # replica 0 reads 503: one probe drains it
        router.probe_once()
        assert router.stats()["healthy"] == 1
        before = replicas[0][0].accepted
        clients = [ServingClient("127.0.0.1", router.port, seed=i) for i in range(4)]
        for c in clients:
            c.act(np.zeros(8, np.uint8), timeout=10.0)
        assert replicas[0][0].accepted == before    # no new connection to the drained one
        assert replicas[1][0].stats()["requests"] >= 4
        replicas[0][1].ok = True            # 200 again: back in rotation
        router.probe_once()
        assert router.stats()["healthy"] == 2
        after = [ServingClient("127.0.0.1", router.port, seed=10 + i) for i in range(4)]
        clients += after
        for c in after:
            c.act(np.zeros(8, np.uint8), timeout=10.0)
        assert replicas[0][0].accepted > before
    finally:
        for c in clients:
            c.close()
        _teardown(router, replicas)


def test_dead_replica_failover_client_retries():
    """A replica dies mid-stream (its listener and sockets closed): the
    client's next request rides a reconnect to the live replica."""
    router, replicas = _fleet(2)
    c = ServingClient("127.0.0.1", router.port, seed=0)
    try:
        first = c.act(np.zeros(8, np.uint8), timeout=10.0)
        victim = first.param_version - 1       # rid == version - 1
        replicas[victim][0].close()
        replicas[victim][1].ok = False
        router.probe_once()
        r = c.act(np.zeros(8, np.uint8), timeout=DEADLINE_S)
        assert r.param_version == (1 - victim) + 1
        assert c.reconnects >= 1
    finally:
        c.close()
        _teardown(router, replicas)


def test_no_healthy_replicas_fails_fast_then_recovers():
    router, replicas = _fleet(1)
    c = ServingClient("127.0.0.1", router.port, seed=0)
    try:
        replicas[0][1].ok = False
        router.probe_once()
        with pytest.raises(TimeoutError):
            c.act(np.zeros(8, np.uint8), timeout=1.5)
        assert router.stats()["route_fails"] >= 1
        replicas[0][1].ok = True
        router.probe_once()
        assert c.act(np.zeros(8, np.uint8), timeout=10.0) is not None
    finally:
        c.close()
        _teardown(router, replicas)


def test_stats_schema_stable():
    router = ServingRouter(port=0)
    try:
        assert set(router.stats()) == {"port", "replicas", "healthy", "active",
                                       "routed_total", "route_fails", "splices_broken",
                                       "probe_failures", "endpoints"}
    finally:
        router.close()


# -- across the packages ----------------------------------------------------------


def test_port_router_fronts_a_jax_server_and_a_port_server():
    """The port router in front of a JAX replica and a port replica (the
    other way round from ``test_torch_serving_net.py``): JAX and port
    clients land on both, each reply carrying its replica's version, with
    a 503 draining the JAX one."""
    health = [_HealthStub(), _HealthStub()]
    replicas = [jserver.ServingNetServer(StubPolicy(version=1, served_cls=JServedAction)).start(),
                ServingNetServer(StubPolicy(version=2)).start()]
    router = ServingRouter(port=0, probe_interval_s=30.0)
    for rid, srv in enumerate(replicas):
        router.set_endpoint(rid, "127.0.0.1", srv.port, health_url=health[rid].url)
    router.start()
    clients = [jserver.ServingClient("127.0.0.1", router.port, seed=i) for i in range(2)]
    clients += [ServingClient("127.0.0.1", router.port, seed=i + 2) for i in range(2)]
    try:
        versions = {c.act(np.zeros(8, np.uint8), timeout=10.0).param_version for c in clients}
        assert versions == {1, 2}
        assert [srv.accepted for srv in replicas] == [2, 2]
        health[0].ok = False
        router.probe_once()
        late = jserver.ServingClient("127.0.0.1", router.port, seed=9)
        clients.append(late)
        assert late.act(np.zeros(8, np.uint8), timeout=10.0).param_version == 2
        assert all(srv.torn_frames == 0 for srv in replicas)
        assert router.stats()["splices_broken"] == 0
    finally:
        for c in clients:
            c.close()
        router.close()
        for srv in replicas:
            srv.close()
        for h in health:
            h.close()


def _key_tree(d):
    return {k: _key_tree(v) if isinstance(v, dict) and k != "endpoints" else None
            for k, v in d.items()}


def test_router_and_fleet_stats_keys_equal_jax():
    """An unstarted fleet of each package (hub and router bound, no child):
    ``stats()`` has the same keys, nested; the router's the same."""
    got = {}
    for mod, cls in (("port", ServingFleet), ("jax", jrouter.ServingFleet)):
        fleet = cls(replicas=2)
        try:
            got[mod] = _key_tree(fleet.stats())
        finally:
            fleet.router.close()
            fleet.hub.close()
    assert got["port"] == got["jax"]
    assert set(got["port"]["replicas"]) == {"0", "1"}


# -- a fleet of CPU replica processes --------------------------------------------------


def _replica_env() -> dict:
    env = dict(os.environ)
    env["OMP_NUM_THREADS"] = "1"        # 2 replicas × 1 intra-op thread
    return env


def _jax_mlp(seed: int, bias_shift: float = 0.0):
    """A JAX float32 mlp for chain:6 (the replicas' network), its q function
    and its params carried into the port; ``bias_shift`` is added to every
    bias (a publish that changes a few pages of the snapshot)."""
    import jax
    import jax.numpy as jnp

    from ape_x_dqn_tpu.models import dueling as jdueling
    from ape_x_dqn_tpu_torch.config import ApexConfig, apply_overrides
    from ape_x_dqn_tpu_torch.runtime.process_actors import network_and_template
    from ape_x_dqn_tpu_torch.weights import params_from_jax

    cfg = apply_overrides(ApexConfig(), FLEET_CFG)
    obs_shape, tnet, _ = network_and_template(cfg)
    jnet = jdueling.build_network("mlp", tnet.num_actions)
    jparams = jnet.init(jax.random.PRNGKey(seed), jnp.zeros((1, *obs_shape), jnp.uint8))
    jparams = jax.tree_util.tree_map_with_path(
        lambda path, v: v + bias_shift if jax.tree_util.keystr(path).endswith("['bias']")
        else v, jparams)

    def q(obs):
        return np.asarray(jnet.apply(jparams, jnp.asarray(obs)).q)

    return params_from_jax(tnet, jax.device_get(jparams)), q, obs_shape


def _act_all(clients, obs):
    return [c.act(o, timeout=DEADLINE_S) for c in clients for o in obs]


def test_cpu_replica_fleet_serves_jax_weights_and_survives_a_kill():
    params1, q1, obs_shape = _jax_mlp(1)
    params2, q2, _ = _jax_mlp(1, bias_shift=0.25)
    obs = np.random.default_rng(0).integers(0, 255, (4, *obs_shape), dtype=np.uint8)
    events = []
    fleet = ServingFleet(replicas=2, probe_interval_s=0.25,
                         replica_args=["--device", "cpu",
                                       *(a for ov in FLEET_CFG for a in ("--set", ov))],
                         env=_replica_env(),
                         on_event=lambda kind, **f: events.append((kind, f)))
    clients = []
    try:
        assert fleet.publish(params1)["subscribers"] == 0    # held for the first connect
        fleet.start(timeout=120.0)
        clients = [ServingClient("127.0.0.1", fleet.port, seed=i) for i in range(4)]
        replies = _act_all(clients, obs)
        assert {r.param_version for r in replies} == {1}
        np.testing.assert_allclose(np.stack([r.q_values for r in replies]),
                                   np.concatenate([q1(obs)] * 4), atol=1e-5, rtol=0)
        assert all(s["routed_total"] > 0
                   for s in fleet.router.stats()["endpoints"].values())
        # The next version reaches both replicas as a delta.
        push = fleet.publish(params2)
        assert (push["delta"], push["full"]) == (2, 0)
        assert push["bytes"] == 2 * push["delta_bytes"]
        deadline = time.monotonic() + DEADLINE_S
        while time.monotonic() < deadline and not all(
                (v or {}).get("serving", {}).get("param_version") == 2
                for v in fleet.replica_varz().values()):
            time.sleep(0.05)
        replies = _act_all(clients, obs)
        assert {r.param_version for r in replies} == {2}
        np.testing.assert_allclose(np.stack([r.q_values for r in replies]),
                                   np.concatenate([q2(obs)] * 4), atol=1e-5, rtol=0)
        # SIGKILL replica 0: it drains, every request is answered by a
        # retry, and the respawn full-syncs version 2.
        fleet.replicas[0].kill()
        replies = _act_all(clients, obs)
        assert len(replies) == 16 and {r.param_version for r in replies} == {2}
        deadline = time.monotonic() + 120.0
        while time.monotonic() < deadline and not any(k == "replica_respawned"
                                                      for k, _ in events):
            time.sleep(0.05)
        kinds = [k for k, _ in events]
        assert "replica_drained" in kinds and "replica_respawned" in kinds, kinds
        varz = fleet.replicas[0].varz()
        assert varz["serving"]["param_version"] == 2
        assert varz["serving"]["net"]["torn_frames"] == 0
        st = fleet.stats()
        assert st["respawns"] == 1 and st["replicas"]["0"]["attempt"] == 1
        assert st["param"]["param_full"] >= 3 and st["param"]["param_delta"] == 2
    finally:
        for c in clients:
            c.close()
        fleet.stop()
    assert all(not rep.alive() for rep in fleet.replicas.values())


def test_serve_replicas_from_a_checkpoint_on_the_cpu(tmp_path, monkeypatch):
    """``serve --replicas 2 --checkpoint DIR --listen 0 --obs-port 0``: the
    router serves the checkpoint's params (q equal to a CPU forward), a
    newer step reaches both replicas as a delta, ``/healthz`` is 200 with
    both replicas healthy, and the run ends with rc 0."""
    from ape_x_dqn_tpu_torch import serve
    from ape_x_dqn_tpu_torch.config import ApexConfig, apply_overrides
    from ape_x_dqn_tpu_torch.runtime.components import build_components
    from ape_x_dqn_tpu_torch.utils.checkpoint import save_checkpoint

    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    cfg = apply_overrides(ApexConfig(), FLEET_CFG)
    comps = build_components(cfg, device="cpu")
    state = comps.state
    state.step = 100
    save_checkpoint(str(tmp_path), state)
    net = comps.network
    obs = np.random.default_rng(1).integers(0, 255, (3, *comps.obs_shape), dtype=np.uint8)

    def cpu_q(params):
        with torch.no_grad():
            return net.apply_params(params, torch.from_numpy(obs)).q.numpy()

    want1 = cpu_q(state.params)
    out, result = io.StringIO(), {}

    def run():
        with redirect_stdout(out):
            result["rc"] = serve.main([
                "--checkpoint", str(tmp_path), "--replicas", "2", "--listen", "0",
                "--obs-port", "0", "--duration", "8", "--metrics-every", "0.5",
                "--device", "cpu", *(a for ov in FLEET_CFG for a in ("--set", ov))])

    th = threading.Thread(target=run)
    th.start()
    try:
        port = url = None
        deadline = time.monotonic() + 180.0
        while (port is None or url is None) and time.monotonic() < deadline and th.is_alive():
            for rec in _records(out):
                if rec.get("event") == "serving_listen" and rec.get("mode") == "router":
                    port = rec["port"]
                elif rec.get("event") == "obs_exporter":
                    url = rec["url"]
            time.sleep(0.05)
        assert port is not None and url is not None, out.getvalue()[-2000:]
        client = ServingClient("127.0.0.1", port)
        got = [client.act(o, timeout=DEADLINE_S) for o in obs]
        assert {r.param_version for r in got} == {1}
        np.testing.assert_allclose(np.stack([r.q_values for r in got]), want1, atol=1e-5,
                                   rtol=0)
        with urllib.request.urlopen(f"{url}/healthz", timeout=10) as r:
            assert r.status == 200
        with urllib.request.urlopen(f"{url}/varz", timeout=10) as r:
            varz = json.loads(r.read())
        assert varz["serving_router"]["healthy"] == 2
        # A newer step lands (its biases moved): one push, a delta to each
        # replica.
        for k, v in state.params.items():
            if k.endswith("bias"):
                v.add_(0.25)
        state.step = 200
        save_checkpoint(str(tmp_path), state)
        want2 = cpu_q(state.params)
        deadline = time.monotonic() + DEADLINE_S
        while time.monotonic() < deadline:
            r = client.act(obs[0], timeout=DEADLINE_S)
            if r.param_version == 2:
                break
            time.sleep(0.05)
        got = [client.act(o, timeout=DEADLINE_S) for o in obs]
        assert {r.param_version for r in got} == {2}
        np.testing.assert_allclose(np.stack([r.q_values for r in got]), want2, atol=1e-5,
                                   rtol=0)
        client.close()
    finally:
        th.join(timeout=120.0)
    assert not th.is_alive() and result["rc"] == 0
    recs = _records(out)
    pushes = [r for r in recs if r.get("event") == "fleet_param_push"]
    assert [p["step"] for p in pushes] == [100, 200]
    assert (pushes[1]["delta"], pushes[1]["full"]) == (2, 0)
    final = [r for r in recs if r.get("final")][-1]
    assert final["serving_fleet"]["param_version"] == 2
    assert final["serving_router"]["replicas"] == 2


def _records(out: io.StringIO) -> list:
    recs = []
    for ln in out.getvalue().splitlines():
        if ln.startswith("{"):
            try:
                recs.append(json.loads(ln))
            except ValueError:
                pass   # a line still being written
    return recs
