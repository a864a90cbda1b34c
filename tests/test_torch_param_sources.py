"""The serving tier's param hub and param tail
(``ape_x_dqn_tpu_torch/serving/sources.py``: ``parse_hub_spec``,
``SocketParamSource``, ``ParamTailWriter``, ``ParamTailSource``) and the
``serve --param-hub`` / ``--param-tail`` modes with the staleness policy,
against the JAX package's, mirrored from ``tests/test_serving_net.py``
(TestHubSpec, TestSocketParamSource, TestParamTail).

* The hub spec parses as the JAX package's does.
* A socket source syncs a full snapshot, then a page-delta, from a port
  hub and from a JAX hub, and resyncs after the hub drops it.
* A tail chain: full then deltas, ``base_every``, a corrupt delta walks
  back to the last good rung, a corrupt full to the previous generation,
  pruning bounds the directory; the port writer's files equal the JAX
  writer's byte for byte, and each package's source reads the other's
  chain.
* ``serve --param-tail`` and ``--param-hub`` serve the published
  versions on the CPU; with ``serving.param_stale_s`` a quiet source makes
  the server shed with the typed ``E_OVERLOADED`` on the socket, and the
  next publish recovers it.

Every socket wait has its own deadline.
"""

from __future__ import annotations

import io
import json
import os
import threading
import time
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from ape_x_dqn_tpu.runtime import net as jnet
from ape_x_dqn_tpu.serving import sources as jsources
from ape_x_dqn_tpu_torch.runtime.net import NetTransport
from ape_x_dqn_tpu_torch.serving.sources import (
    ParamTailSource,
    ParamTailWriter,
    SocketParamSource,
    parse_hub_spec,
)
from ape_x_dqn_tpu_torch.utils.serialization import tree_to_bytes

DEADLINE_S = 10.0


def _tree(fill, b=0.0):
    return {"w": torch.full((128, 32), float(fill)), "b": torch.full((32,), float(b))}


def _np(tree):
    return {k: v.numpy().copy() for k, v in tree.items()}


@pytest.mark.parametrize("spec", ["10.0.0.5:9100:12345:3:2", "::1:9:7:0:1",
                                  "host.example:65535:1:2:3"])
def test_hub_spec_parses_as_jax(spec):
    assert parse_hub_spec(spec) == jsources.parse_hub_spec(spec)


@pytest.mark.parametrize("spec", ["localhost:9100", "h:p:1:2:3", ""])
def test_hub_spec_rejects_malformed(spec):
    with pytest.raises(ValueError):
        parse_hub_spec(spec)


def _poll(hub, src, have, timeout=DEADLINE_S):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        hub.pump()
        got = src.get(have)
        if got is not None:
            return got
        time.sleep(0.01)
    raise TimeoutError("nothing arrived over the hub")


@pytest.mark.parametrize("hub_cls", [NetTransport, jnet.NetTransport], ids=["port_hub", "jax_hub"])
def test_socket_source_full_then_delta_then_resync(hub_cls):
    hub = hub_cls(port=0)
    ch = hub.make_channel(0, 0)
    src = None
    try:
        p1 = _tree(1.0)
        hub.set_params(tree_to_bytes(p1), 1)
        src = SocketParamSource(f"127.0.0.1:{hub.port}:{hub.token}:0:0", _tree(0.0))
        params, version = _poll(hub, src, -1)
        assert version == 1 and torch.equal(params["w"], p1["w"])
        p2 = _tree(1.0, b=3.0)
        push = hub.set_params(tree_to_bytes(p2), 2)
        assert push["delta"] == 1 and push["bytes"] < len(tree_to_bytes(p2)) / 4
        params, version = _poll(hub, src, 1)
        assert version == 2 and torch.equal(params["b"], p2["b"]) and src.version == 2
        # The hub drops the connection: the source reconnects and gets a
        # full snapshot of the next version.
        with ch._send_lock:
            ch._retire_conn_locked()
        p3 = _tree(2.0, b=3.0)
        hub.set_params(tree_to_bytes(p3), 3)
        params, version = _poll(hub, src, 2, timeout=15.0)
        assert version == 3 and torch.equal(params["w"], p3["w"])
        assert ch.reconnects >= 1
    finally:
        if src is not None:
            src.close()
        hub.close()


# -- the tail -------------------------------------------------------------------------


def test_tail_full_then_delta_chain(tmp_path):
    w = ParamTailWriter(str(tmp_path), base_every=8)
    src = ParamTailSource(str(tmp_path), _tree(0.0))
    w.publish(_tree(1.0))
    params, v = src.get(-1)
    assert v == 1 and torch.equal(params["w"], _tree(1.0)["w"])
    for i in range(3):
        w.publish(_tree(1.0, b=i + 1))
    assert (w.delta_writes, w.full_writes) == (3, 1)
    params, v = src.get(1)
    assert v == 4 and torch.equal(params["b"], _tree(1.0, b=3)["b"])
    assert src.get(4) is None


def test_tail_base_every_forces_full(tmp_path):
    w = ParamTailWriter(str(tmp_path), base_every=2)
    for i in range(4):
        w.publish(_tree(1.0, b=i))
    assert w.full_writes >= 2


def _flip(path, offset, data=None):
    with open(path, "r+b") as f:
        f.seek(offset)
        b = f.read(len(data) if data else 1)
        f.seek(offset)
        f.write(data if data else bytes([b[0] ^ 0xFF]))


def test_tail_corrupt_delta_walks_back(tmp_path):
    w = ParamTailWriter(str(tmp_path), base_every=16)
    w.publish(_tree(1.0))
    w.publish(_tree(1.0, b=2.0))
    path3 = w.publish(_tree(1.0, b=3.0))
    _flip(path3, 40)
    src = ParamTailSource(str(tmp_path), _tree(0.0))
    params, v = src.get(-1)
    assert v == 2 and src.corrupt_skips >= 1
    assert torch.equal(params["b"], torch.full((32,), 2.0))


def test_tail_corrupt_full_uses_previous_generation(tmp_path):
    w = ParamTailWriter(str(tmp_path), base_every=2)
    for i in range(4):                   # fulls at v1 and v3
        w.publish(_tree(1.0, b=i + 1))
    newest_full = sorted(n for n in os.listdir(tmp_path) if n.endswith("_full.apxc"))[-1]
    _flip(tmp_path / newest_full, 30, b"\xde\xad")
    src = ParamTailSource(str(tmp_path), _tree(0.0))
    got = src.get(-1)
    assert got is not None and got[1] < 4 and src.corrupt_skips >= 1


def test_tail_pruning_bounds_directory(tmp_path):
    w = ParamTailWriter(str(tmp_path), base_every=4)
    for i in range(20):
        w.publish(_tree(1.0, b=i))
    assert len(list(tmp_path.iterdir())) <= 2 * 4 + 1


def _publish_sequence():
    """Versions 1..6 with base_every 3: fulls at 1 and 4, an everything-moved
    publish (full) at 6."""
    seq = [_tree(1.0), _tree(1.0, b=1), _tree(1.0, b=2), _tree(1.0, b=3), _tree(1.0, b=4)]
    rng = np.random.default_rng(0)
    seq.append({"w": torch.from_numpy(rng.normal(size=(128, 32)).astype(np.float32)),
                "b": torch.from_numpy(rng.normal(size=32).astype(np.float32))})
    return seq


def test_tail_files_equal_jax_writer(tmp_path):
    port, jax_dir = tmp_path / "port", tmp_path / "jax"
    pw = ParamTailWriter(str(port), base_every=3)
    jw = jsources.ParamTailWriter(str(jax_dir), base_every=3)
    for t in _publish_sequence():
        pw.publish(t)
        jw.publish(_np(t))
    assert sorted(os.listdir(port)) == sorted(os.listdir(jax_dir))
    for name in os.listdir(port):
        assert (port / name).read_bytes() == (jax_dir / name).read_bytes(), name
    assert (pw.full_writes, pw.delta_writes, pw.bytes_written) == \
        (jw.full_writes, jw.delta_writes, jw.bytes_written)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_tail_chain_read_across_packages(tmp_path, writer):
    seq = _publish_sequence()[:5]
    if writer == "jax":
        w = jsources.ParamTailWriter(str(tmp_path), base_every=16)
        publish = (lambda t: w.publish(_np(t)))
    else:
        w = ParamTailWriter(str(tmp_path), base_every=16)
        publish = w.publish
    port_src = ParamTailSource(str(tmp_path), _tree(0.0))
    jax_src = jsources.ParamTailSource(str(tmp_path), _np(_tree(0.0)))
    for i, t in enumerate(seq, start=1):
        publish(t)
        got, v = port_src.get(i - 1)
        jgot, jv = jax_src.get(i - 1)
        assert v == jv == i
        for k in t:
            assert torch.equal(got[k], t[k])
            np.testing.assert_array_equal(np.asarray(jgot[k]), t[k].numpy())


# -- serve --param-tail / --param-hub on the CPU ----------------------------------------


SERVE_CFG = ["--set", "env.name=chain:6", "--set", "network=mlp",
             "--set", "learner.min_replay_mem_size=200", "--set", "replay.capacity=5000",
             "--set", "serving.reload_poll_s=0.05"]


def _served_params(seed):
    from ape_x_dqn_tpu_torch.config import ApexConfig, apply_overrides
    from ape_x_dqn_tpu_torch.runtime.process_actors import network_and_template

    cfg = apply_overrides(ApexConfig(), [a for a in SERVE_CFG if a != "--set"])
    _, _, template = network_and_template(cfg)
    g = torch.Generator().manual_seed(seed)
    return {k: torch.randn(v.shape, generator=g).to(v.dtype) for k, v in template.items()}


def _serve(argv):
    from ape_x_dqn_tpu_torch import serve

    out = io.StringIO()
    with redirect_stdout(out):
        rc = serve.main([*argv, "--device", "cpu", *SERVE_CFG])
    recs = [json.loads(ln) for ln in out.getvalue().splitlines() if ln.startswith("{")]
    return rc, recs


def test_serve_param_tail_serves_the_chain(tmp_path):
    w = ParamTailWriter(str(tmp_path), base_every=4)
    w.publish(_served_params(1))
    stop = threading.Event()

    def publisher():
        v = 2
        while not stop.wait(0.3) and v <= 4:
            w.publish(_served_params(v))
            v += 1

    th = threading.Thread(target=publisher)
    th.start()
    try:
        rc, recs = _serve(["--param-tail", str(tmp_path), "--clients", "2",
                           "--duration", "2.5", "--metrics-every", "0.5"])
    finally:
        stop.set()
        th.join(DEADLINE_S)
    final = [r for r in recs if r.get("final")][-1]
    assert rc == 0 and final["serve/served_total"] > 0
    assert final["serve/reloads"] >= 1 and final["serve/param_version"] >= 2


def test_serve_param_tail_empty_dir_exits_2(tmp_path):
    assert _serve(["--param-tail", str(tmp_path), "--duration", "1"])[0] == 2


def test_serve_param_hub_with_staleness_sheds_typed_and_recovers():
    """``serve --param-hub --listen`` with ``serving.param_stale_s``: the hub
    publishes, goes quiet (clients see E_OVERLOADED on the socket), then
    publishes again (served again, at the new version)."""
    from ape_x_dqn_tpu_torch.serving.batcher import ServerOverloaded
    from ape_x_dqn_tpu_torch.serving.net_server import ServingClient

    hub = NetTransport(port=0)
    hub.make_channel(0, 0)
    hub.set_params(tree_to_bytes(_served_params(1)), 1)
    stop = threading.Event()

    def pump_hub():
        while not stop.wait(0.01):
            hub.pump()

    pump = threading.Thread(target=pump_hub)
    pump.start()
    result: dict = {}
    out = io.StringIO()

    def serve_thread():
        from ape_x_dqn_tpu_torch import serve

        with redirect_stdout(out):
            result["rc"] = serve.main([
                "--param-hub", f"127.0.0.1:{hub.port}:{hub.token}:0:0", "--listen", "0",
                "--duration", "12", "--metrics-every", "0.1", "--device", "cpu", *SERVE_CFG,
                "--set", "serving.param_stale_s=1.0"])

    th = threading.Thread(target=serve_thread)
    th.start()
    try:
        port = None
        deadline = time.monotonic() + 60.0
        while port is None and time.monotonic() < deadline:
            for ln in out.getvalue().splitlines():
                if '"serving_listen"' in ln:
                    port = json.loads(ln)["port"]
            time.sleep(0.05)
        assert port is not None, "serve never listened"
        client = ServingClient("127.0.0.1", port, io_timeout_s=5.0)
        obs = np.zeros(6, np.uint8)
        assert client.act(obs, timeout=DEADLINE_S).param_version == 1
        shed = 0
        deadline = time.monotonic() + DEADLINE_S
        while not shed and time.monotonic() < deadline:
            try:
                client.act(obs, timeout=DEADLINE_S)
            except ServerOverloaded:
                shed += 1
            time.sleep(0.05)
        assert shed and client.shed_seen >= 1
        hub.set_params(tree_to_bytes(_served_params(2)), 2)
        served = None
        deadline = time.monotonic() + DEADLINE_S
        while served is None and time.monotonic() < deadline:
            try:
                served = client.act(obs, timeout=DEADLINE_S)
            except ServerOverloaded:
                time.sleep(0.05)
        assert served is not None and served.param_version == 2
        client.close()
    finally:
        th.join(60.0)
        stop.set()
        pump.join(DEADLINE_S)
        hub.close()
    assert not th.is_alive() and result["rc"] == 0
    events = [json.loads(ln).get("event") for ln in out.getvalue().splitlines()
              if ln.startswith("{")]
    assert "serving_degraded" in events and "serving_recovered" in events
