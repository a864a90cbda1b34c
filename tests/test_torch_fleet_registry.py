"""The port's fleet registry (``ape_x_dqn_tpu_torch/fleet/registry.py``)
against the JAX package's, mirrored from ``tests/test_fleet.py``
(TestAnnounceWireAdversarial, TestMembershipLifecycle).

* The adversarial announce wire on a live port registry: wrong token,
  magic and version rejected by close; torn, bit-flipped, unknown-kind and
  garbage announces counted and never applied; a stale incarnation
  refused.
* The lifecycle: join, heartbeat (no version bump), leave; the lease sweep
  (live and under an explicit clock); ``sync`` a pure read; the announcer.
* Across the packages: the bytes a client sends (hello, announce) and a
  registry answers (ack, snapshot) are equal; a port announcer joins a JAX
  registry and a JAX announcer a port registry, with equal snapshots;
  ``member_doc`` and ``member_id_for`` agree.
* The ``fleet`` config section's checks give JAX's messages; autopilot
  keys are refused by name; ``fleet.discovery=registry`` makes the
  trainer host a registry (a ``fleet_registry_listen`` event and the
  ``fleet_membership`` provider).

Every socket wait has its own deadline.
"""

from __future__ import annotations

import io
import json
import socket
import threading
import time

import pytest

from ape_x_dqn_tpu import config as jconfig
from ape_x_dqn_tpu.fleet import registry as jreg
from ape_x_dqn_tpu_torch import config as tconfig
from ape_x_dqn_tpu_torch.fleet.registry import (
    FleetAnnouncer,
    FleetClient,
    FleetRegistry,
    member_doc,
    member_id_for,
)
from ape_x_dqn_tpu_torch.runtime.net import (
    F_FANN,
    F_FREP,
    FLEET_ACK,
    FLEET_ACK_MAGIC,
    FLEET_HELLO,
    FLEET_HELLO_VERSION,
    FLEET_MAGIC,
    FrameParser,
    frame_bytes,
)

TOKEN = 4242


def _wait(cond, timeout=10.0, msg="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.01)
    raise AssertionError(f"timed out waiting for {msg}")


@pytest.fixture
def registry():
    events = []
    lock = threading.Lock()

    def on_event(name, **fields):
        with lock:
            events.append((name, fields))

    reg = FleetRegistry(token=TOKEN, ttl_s=0.5, on_event=on_event).serve()
    reg.test_events = events
    yield reg
    reg.close()


def _hello_bytes(token=TOKEN, version=FLEET_HELLO_VERSION, magic=FLEET_MAGIC,
                 member_id=7, incarnation=1):
    return FLEET_HELLO.pack(magic, version, member_id, incarnation, token)


def _raw_conn(reg, **hello_kw):
    """Dial + hello; the socket past the ack, or None when the registry
    rejected by close."""
    s = socket.create_connection(("127.0.0.1", reg.port), timeout=5.0)
    s.settimeout(5.0)
    s.sendall(_hello_bytes(**hello_kw))
    ack = b""
    while len(ack) < FLEET_ACK.size:
        try:
            got = s.recv(FLEET_ACK.size - len(ack))
        except (ConnectionError, socket.timeout):
            got = b""
        if not got:
            s.close()
            return None
        ack += got
    assert FLEET_ACK.unpack(ack)[0] == FLEET_ACK_MAGIC
    return s


def _announce_bytes(op="join", member=None, seq=1):
    body = json.dumps({"op": op, "member": member}).encode()
    return frame_bytes(F_FANN, seq, (body,))


# -- the adversarial announce wire (TestAnnounceWireAdversarial) ---------------


def test_wrong_token_hello_rejected_by_close(registry):
    assert _raw_conn(registry, token=TOKEN + 1) is None
    _wait(lambda: registry.stats()["bad_hellos"] >= 1, msg="bad_hellos")
    assert registry.stats()["members"] == 0


def test_wrong_magic_and_version_rejected(registry):
    assert _raw_conn(registry, magic=b"NOPE") is None
    assert _raw_conn(registry, version=FLEET_HELLO_VERSION + 9) is None
    _wait(lambda: registry.stats()["bad_hellos"] >= 2, msg="bad_hellos")
    assert registry.stats()["accepted"] == 0


def test_torn_frame_counted_never_applied(registry):
    s = _raw_conn(registry)
    doc = member_doc("replay/shard9", "replay_shard", port=1, capacity=4)
    frame = _announce_bytes(member=doc)
    s.sendall(frame[: len(frame) - 3])   # truncated mid-frame
    s.close()
    _wait(lambda: registry.stats()["torn_frames"] >= 1, msg="torn_frames")
    assert registry.stats()["members"] == 0
    assert registry.stats()["joins"] == 0


def test_bitflipped_frame_torn(registry):
    s = _raw_conn(registry)
    frame = bytearray(_announce_bytes(member=member_doc("x", "observer")))
    frame[-1] ^= 0x40                    # payload bit under the crc
    s.sendall(bytes(frame))
    _wait(lambda: registry.stats()["torn_frames"] >= 1, msg="torn_frames")
    assert registry.stats()["members"] == 0
    s.close()


def test_unknown_kind_counted_and_retired(registry):
    s = _raw_conn(registry)
    s.sendall(frame_bytes(F_FANN + 1, 1, (b"{}",)))
    _wait(lambda: registry.stats()["unexpected_kinds"] >= 1, msg="unexpected_kinds")
    assert registry.stats()["members"] == 0
    s.close()


def test_well_framed_garbage_announce_counted(registry):
    for body in (b"not json", b'{"op": "invade"}', b'{"op": "join"}'):   # join without a member
        s = _raw_conn(registry)
        s.sendall(frame_bytes(F_FANN, 1, (body,)))
        s.close()
    _wait(lambda: registry.stats()["bad_announces"] >= 3, msg="bad_announces")
    assert registry.stats()["members"] == 0


def test_stale_incarnation_announce_refused(registry):
    cli = FleetClient("127.0.0.1", registry.port, token=TOKEN)
    cli.announce("join", member_doc("replay/shard0", "replay_shard", port=9001,
                                    incarnation=3))
    snap = cli.announce("heartbeat", member_doc("replay/shard0", "replay_shard",
                                                port=6666, incarnation=2))
    cli.close()
    assert registry.stats()["stale_rejects"] == 1
    member = snap["members"]["replay/shard0"]
    assert member["incarnation"] == 3
    assert member["port"] == 9001       # the stale doc never landed


# -- the lifecycle (TestMembershipLifecycle) -------------------------------------


def test_join_heartbeat_leave_versions(registry):
    cli = FleetClient("127.0.0.1", registry.port, token=TOKEN, member_id=member_id_for("w"))
    doc = member_doc("worker/host0", "worker_host", varz_url="http://x/varz")
    snap = cli.announce("join", doc)
    v_join = snap["version"]
    assert snap["members"]["worker/host0"]["kind"] == "worker_host"
    # An unchanged heartbeat refreshes the lease without a version bump.
    snap = cli.announce("heartbeat", doc)
    assert snap["version"] == v_join
    snap = cli.announce("leave", doc)
    assert "worker/host0" not in snap["members"]
    assert snap["version"] > v_join
    cli.close()
    names = [n for n, _f in registry.test_events]
    assert "member_join" in names and "member_lost" in names
    lost = [f for n, f in registry.test_events if n == "member_lost"]
    assert lost[0]["reason"] == "leave"


def test_ttl_sweep_expires_silent_member(registry):
    cli = FleetClient("127.0.0.1", registry.port, token=TOKEN)
    cli.announce("join", member_doc("serving/replica0", "serving_replica", port=8080))
    cli.close()
    _wait(lambda: registry.stats()["members"] == 0, timeout=5.0, msg="ttl expiry")
    assert registry.stats()["expired"] == 1
    lost = [f for n, f in registry.test_events if n == "member_lost"]
    assert lost and lost[-1]["reason"] == "ttl"


def test_sweep_is_deterministic_under_explicit_now():
    reg = FleetRegistry(token=1, ttl_s=5.0)     # never served: no clock
    reg._apply("join", member_doc("a", "observer"))
    assert reg.sweep(time.monotonic() + 4.0) == []
    assert reg.sweep(time.monotonic() + 6.0) == ["a"]
    assert reg.stats()["members"] == 0


def test_sync_is_a_pure_read(registry):
    cli = FleetClient("127.0.0.1", registry.port, token=TOKEN)
    snap = cli.sync()
    assert snap["token"] == TOKEN and snap["members"] == {}
    assert registry.stats()["joins"] == 0
    cli.close()


def test_announcer_lifecycle_and_watch(registry):
    seen = []
    ann = FleetAnnouncer("127.0.0.1", registry.port, token=TOKEN,
                         member_id=member_id_for("fleet"), heartbeat_s=0.05,
                         on_membership=seen.append).start()
    ann.set_member(member_doc("replay/shard0", "replay_shard", port=7001, capacity=64,
                              incarnation=1))
    ann.poke()
    _wait(lambda: registry.members("replay_shard"), msg="join")
    ann.remove_member("replay/shard0")
    ann.poke()
    _wait(lambda: not registry.members("replay_shard"), msg="leave")
    ann.close(leave=True)
    assert seen and any("replay/shard0" in s.get("members", {}) for s in seen)


# -- across the packages ----------------------------------------------------------


DOCS = [("serving/replica0", "serving_replica", dict(host="127.0.0.1", port=9100,
                                                     incarnation=2,
                                                     varz_url="http://127.0.0.1:9/varz")),
        ("replay/shard3", "replay_shard", dict(port=7003, base=4096, capacity=1024,
                                               draining=True)),
        ("obs", "observer", {})]


@pytest.mark.parametrize("name,kind,kw", DOCS)
def test_member_doc_and_id_equal_jax(name, kind, kw):
    assert member_doc(name, kind, **kw) == jreg.member_doc(name, kind, **kw)
    assert member_id_for(name) == jreg.member_id_for(name)
    with pytest.raises(ValueError, match="unknown member kind"):
        member_doc(name, "router")


class _Recorder:
    """A registry stand-in that acks any hello, answers each frame with a
    fixed ``F_FREP`` and records every byte a client sent."""

    REPLY = {"token": TOKEN, "version": 3, "incarnation": 1, "members": {}}

    def __init__(self):
        self.received = bytearray()
        self._sock = socket.socket()
        self._sock.bind(("127.0.0.1", 0))
        self._sock.listen(4)
        self.port = self._sock.getsockname()[1]
        self._thread = threading.Thread(target=self._serve, daemon=True)
        self._thread.start()

    def _serve(self):
        conn, _ = self._sock.accept()
        conn.settimeout(5.0)
        try:
            hello = conn.recv(FLEET_HELLO.size)
            self.received += hello
            conn.sendall(FLEET_ACK.pack(FLEET_ACK_MAGIC, FLEET_HELLO_VERSION, TOKEN, 1))
            parser = FrameParser(max_frame=1 << 20)
            seq = 0
            while True:
                data = conn.recv(1 << 16)
                if not data:
                    return
                self.received += data
                parser.feed(data)
                while parser.next() is not None:
                    seq += 1
                    conn.sendall(frame_bytes(F_FREP, seq,
                                             (json.dumps(self.REPLY).encode(),)))
        except OSError:
            return
        finally:
            conn.close()

    def close(self):
        self._thread.join(timeout=5.0)
        self._sock.close()


@pytest.mark.parametrize("client_mod", ["port", "jax"])
def test_client_bytes_equal_jax(client_mod):
    """The same announces from each package's client: the bytes on the
    wire (hello, three framed announces) are equal."""
    sent = {}
    for mod in ("port", "jax"):
        rec = _Recorder()
        cls = FleetClient if mod == "port" else jreg.FleetClient
        doc_fn = member_doc if mod == "port" else jreg.member_doc
        cli = cls("127.0.0.1", rec.port, token=TOKEN, member_id=member_id_for("m"),
                  incarnation=5)
        doc = doc_fn("serving/replica1", "serving_replica", port=9101, incarnation=5)
        assert cli.announce("join", doc) == _Recorder.REPLY
        cli.announce("heartbeat", doc)
        cli.announce("sync")
        cli.close()
        rec.close()
        sent[mod] = bytes(rec.received)
    assert sent["port"] == sent["jax"]
    assert sent[client_mod][:4] == FLEET_MAGIC


def _registry_replies(reg, announces) -> bytes:
    """Every byte a registry answers to one hello and ``announces`` (one
    reply per announce, read before the next is sent)."""
    s = socket.create_connection(("127.0.0.1", reg.port), timeout=5.0)
    s.settimeout(5.0)
    s.sendall(_hello_bytes(member_id=9, incarnation=2))
    out = bytearray()
    while len(out) < FLEET_ACK.size:
        data = s.recv(FLEET_ACK.size - len(out))
        assert data, "the registry closed"
        out += data
    parser = FrameParser(max_frame=1 << 20)
    for i, (op, member) in enumerate(announces):
        s.sendall(_announce_bytes(op, member, seq=i + 1))
        while parser.next() is None:
            data = s.recv(1 << 16)
            assert data, "the registry closed"
            out += data
            parser.feed(data)
    s.close()
    return bytes(out)


def test_registry_replies_equal_jax():
    """One hello and the same announces to each package's registry (same
    token and incarnation): the ack and every snapshot reply are equal."""
    announces = [("join", member_doc(*DOCS[0][:2], **DOCS[0][2])),
                 ("join", member_doc(*DOCS[1][:2], **DOCS[1][2])),
                 ("heartbeat", member_doc(*DOCS[0][:2], **DOCS[0][2])),
                 ("sync", None),
                 ("leave", member_doc(*DOCS[1][:2], **DOCS[1][2]))]
    got = {}
    for mod, cls in (("port", FleetRegistry), ("jax", jreg.FleetRegistry)):
        reg = cls(token=TOKEN, ttl_s=30.0, incarnation=3).serve()
        try:
            got[mod] = _registry_replies(reg, announces)
        finally:
            reg.close()
    assert got["port"] == got["jax"]
    assert got["port"][:4] == FLEET_ACK_MAGIC


@pytest.mark.parametrize("direction", ["port_into_jax", "jax_into_port"])
def test_announcers_and_registries_interoperate(direction):
    """A port announcer joins a JAX registry, a JAX announcer a port one;
    both registries hold equal snapshots of the same members."""
    reg_cls, ann_cls, doc_fn = ((jreg.FleetRegistry, FleetAnnouncer, member_doc)
                                if direction == "port_into_jax" else
                                (FleetRegistry, jreg.FleetAnnouncer, jreg.member_doc))
    twin_cls = FleetRegistry if reg_cls is jreg.FleetRegistry else jreg.FleetRegistry
    reg = reg_cls(token=TOKEN, ttl_s=30.0).serve()
    seen = []
    ann = ann_cls("127.0.0.1", reg.port, token=TOKEN, member_id=member_id_for("fleet"),
                  heartbeat_s=0.05, on_membership=seen.append).start()
    try:
        for name, kind, kw in DOCS:
            ann.set_member(doc_fn(name, kind, **kw))
        ann.poke()
        _wait(lambda: len(reg.members()) == len(DOCS), msg="joins")
        snap = reg.snapshot()
        # The same docs applied to the other package's registry.
        twin = twin_cls(token=TOKEN, ttl_s=30.0)
        for doc in snap["members"].values():
            twin._apply("join", doc)
        assert twin.snapshot() == snap
        assert snap["members"] == {n: member_doc(n, k, **kw) for n, k, kw in DOCS}
        _wait(lambda: seen and len(seen[-1]["members"]) == len(DOCS), msg="the watch")
        ann.remove_member("obs")
        ann.poke()
        _wait(lambda: "obs" not in reg.members(), msg="leave")
    finally:
        ann.close(leave=True)
        reg.close()
    assert reg.stats()["torn_frames"] == 0 and reg.stats()["bad_announces"] == 0


# -- config and the runtime ---------------------------------------------------------


FLEET_OVERRIDES = [
    [],
    ["fleet.discovery=registry"],
    ["fleet.discovery=gossip"],
    ["fleet.registry_port=70000"],
    ["fleet.registry_port=-1"],
    ["fleet.heartbeat_s=0"],
    ["fleet.heartbeat_s=2.0", "fleet.ttl_s=1.0"],
    ["fleet.ttl_s=1.0"],
    ["fleet.registry_host=0.0.0.0", "fleet.registry_port=9300", "fleet.ttl_s=3.0"],
]


def _outcome(mod, overrides):
    try:
        cfg = mod.apply_overrides(mod.ApexConfig(), overrides)
    except ValueError as e:
        return ("error", str(e))
    return ("ok", {k: getattr(cfg.fleet, k) for k in (
        "discovery", "registry_host", "registry_port", "heartbeat_s", "ttl_s")})


@pytest.mark.parametrize("overrides", FLEET_OVERRIDES)
def test_fleet_section_checks_equal_jax(overrides):
    assert _outcome(tconfig, overrides) == _outcome(jconfig, overrides)


def test_fleet_section_loads_from_native_json(tmp_path):
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps({"fleet": {"discovery": "registry", "ttl_s": 2.0}}))
    cfg = tconfig.load_config(str(path))
    assert cfg.fleet.discovery == "registry" and cfg.fleet.ttl_s == 2.0
    path.write_text(json.dumps({"fleet": {"gossip": 1}}))
    with pytest.raises(ValueError, match="gossip"):
        tconfig.load_config(str(path))


@pytest.mark.parametrize("override", ["autopilot.enabled=true",
                                      "autopilot.serving_max_replicas=4"])
def test_autopilot_keys_refused_by_name(override, tmp_path):
    """The autopilot section loads now (``autopilot/`` is ported), from an
    override and from a native JSON file, with the JAX config's value; a
    misspelt key of the section is still refused by its name."""
    from ape_x_dqn_tpu import config as jconfig

    name, value = override.split("=")
    field = name.split(".")[1]
    want = getattr(jconfig.apply_overrides(jconfig.ApexConfig(), [override]).autopilot,
                   field)
    cfg = tconfig.apply_overrides(tconfig.ApexConfig(), [override])
    assert getattr(cfg.autopilot, field) == want
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps({"autopilot": {field: want}}))
    assert getattr(tconfig.load_config(str(path)).autopilot, field) == want
    with pytest.raises(ValueError, match=f"{name}x"):
        tconfig.apply_overrides(tconfig.ApexConfig(), [f"{name}x={value}"])
    path.write_text(json.dumps({"autopilot": {f"{field}x": 1}}))
    with pytest.raises(ValueError, match=f"{field}x"):
        tconfig.load_config(str(path))


def test_trainer_hosts_the_registry():
    """``fleet.discovery=registry``: the runtime hosts a registry, announces
    it as ``fleet_registry_listen`` and serves its snapshot as the
    ``fleet_membership`` provider; a member joins with the event's token;
    the run's end closes it."""
    import torch

    from ape_x_dqn_tpu_torch.runtime.async_pipeline import AsyncPipeline
    from ape_x_dqn_tpu_torch.utils.metrics import MetricLogger

    cfg = tconfig.apply_overrides(tconfig.ApexConfig(), [
        "network=mlp", "env.name=chain:6", "actor.num_actors=2", "replay.capacity=1024",
        "learner.min_replay_mem_size=64", "fleet.discovery=registry", "fleet.ttl_s=30"])
    buf = io.StringIO()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        pipe = AsyncPipeline(cfg, logger=MetricLogger(stream=buf), device="cpu")
        event = next(json.loads(ln) for ln in buf.getvalue().splitlines()
                     if '"fleet_registry_listen"' in ln)
        assert event["port"] == pipe.fleet_registry.port > 0
        cli = FleetClient("127.0.0.1", event["port"], token=event["token"])
        cli.announce("join", member_doc("serving/replica0", "serving_replica", port=9))
        cli.close()
        members = pipe.obs_registry.snapshot()["fleet_membership"]["members"]
        assert set(members) == {"serving/replica0"}
        pipe.run(learner_steps=8)
    finally:
        torch.set_num_threads(threads)
    assert pipe.fleet_registry is None
    assert any('"member_join"' in ln for ln in buf.getvalue().splitlines())
