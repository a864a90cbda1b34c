"""Elastic process actors and remote workers of the port
(``runtime/process_actors.ProcessActorPool``: ``grow`` / ``retire`` /
``live_workers`` / ``grow_candidates`` / ``set_drain_budget``,
``register_remote_workers`` and the join spec; ``python -m
ape_x_dqn_tpu_torch.host_join``), against the JAX package's, mirrored from
``tests/test_autopilot.py`` (TestPoolElasticArithmetic,
TestPoolGrowRetireE2E, test_max_workers_validation) and the JAX package's
``tools/host_join.py``.

* The partition is carved over the local capacity plus the remote slots,
  as the JAX pool carves it; the pool's capacity, candidates and drain
  budget arithmetic equal the JAX pool's; the knob checks equal the JAX
  package's.
* The join spec: remote wids above the local capacity, attempt 0, the
  run's token and port, channels reserved on the transport; refused
  without tcp.
* Real workers (2 at most, one intra-op thread each): a grown worker feeds
  its own slice, a retired one exits through "done" with its channel
  drained and reclaimed, on either transport; a ``host_join`` process
  claims a remote slot, feeds the learner over tcp, and its SIGKILLed
  child is respawned on the same attempt and feeds again; the trainer runs
  end to end over tcp on both learner paths.

Every spawning test has its own deadline and stops its pool in
``finally``.
"""

from __future__ import annotations

import io
import json
import os
import signal
import subprocess
import sys
import threading
import time
from contextlib import redirect_stdout

import numpy as np
import pytest
from _torch_harness import pinned_cores, port_deadline  # noqa: F401 — port_deadline is autouse

from ape_x_dqn_tpu import config as jconfig
from ape_x_dqn_tpu.runtime import process_actors as jpa
from ape_x_dqn_tpu_torch import config as tconfig
from ape_x_dqn_tpu_torch import train
from ape_x_dqn_tpu_torch.runtime.process_actors import (
    ProcessActorPool,
    network_and_template,
    worker_slice,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def two_cores():
    """Two usable cores: spawned workers inherit them and take one intra-op
    thread each (process_actors.worker_threads)."""
    with pinned_cores(2):   # this xdist worker's own pair (_torch_harness)
        yield


def _cfg(mod=tconfig, num_workers=1, max_workers=0, num_actors=4, **actor):
    cfg = mod.ApexConfig()
    cfg.network = "mlp"
    cfg.env.name = "chain:6"
    cfg.actor.mode = "process"
    cfg.actor.num_workers = num_workers
    cfg.actor.max_workers = max_workers
    cfg.actor.num_actors = num_actors
    cfg.actor.T = 100_000
    cfg.actor.flush_every = 8
    cfg.actor.sync_every = 32
    cfg.actor.respawn_min_interval_s = 0.05
    for k, v in actor.items():
        setattr(cfg.actor, k, v)
    return cfg.validate()


def _drain_until(pool, cond, what, timeout_s=120.0):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        pool.supervise()
        pool.poll(max_items=64, timeout=0.05)
        if cond():
            return
    raise TimeoutError(what)


# -- arithmetic (no processes) -----------------------------------------------------


@pytest.mark.parametrize("cap,actors", [(3, 6), (4, 10), (7, 256)])
def test_partition_carved_over_capacity_equals_jax(cap, actors):
    slices = [worker_slice(w, actors, cap) for w in range(cap)]
    assert slices == [jpa.worker_slice(w, actors, cap) for w in range(cap)]
    assert sorted(x for lo, hi in slices for x in range(lo, hi)) == list(range(actors))


@pytest.mark.parametrize("transport,num_workers,max_workers,remote", [
    ("shm", 1, 3, 0), ("tcp", 1, 3, 0), ("tcp", 2, 0, 2), ("tcp", 1, 2, 1)])
def test_pool_capacity_candidates_and_budget_equal_jax(tmp_path, transport, num_workers,
                                                       max_workers, remote):
    knobs = dict(num_workers=num_workers, max_workers=max_workers, num_actors=6,
                 transport=transport, remote_workers=remote,
                 remote_join_path=str(tmp_path / "join.json") if remote else "")
    pools = [ProcessActorPool(_cfg(**knobs), num_workers=num_workers),
             jpa.ProcessActorPool(_cfg(jconfig, **knobs), num_workers=num_workers)]
    try:
        facts = [(p.local_capacity, p.total_workers, p.live_workers(), p.grow_candidates(),
                  p.finished, p.transport_kind, p.drain_budget_bytes,
                  p.set_drain_budget(p.drain_budget_bytes * 2), p.set_drain_budget(1))
                 for p in pools]
        assert facts[0] == facts[1]
        assert facts[0][3] == list(range(max(num_workers, max_workers)))
        assert facts[0][-1] == 64 << 10
        acc = pools[0].shm_accounting()
        assert acc["transport"] == transport and acc["ring_bytes_total"] == 0
    finally:
        for p in pools:
            p.stop()


@pytest.mark.parametrize("settings,message", [
    ({"num_workers": 2, "max_workers": 1}, "max_workers"),
    ({"mode": "thread", "max_workers": 3}, "mode=process"),
    ({"max_workers": 3, "num_actors": 2}, "reserved worker capacity"),
])
def test_max_workers_validation_equals_jax(settings, message):
    for mod in (tconfig, jconfig):
        cfg = mod.ApexConfig()
        cfg.actor.mode = "process"
        cfg.actor.num_actors = 4
        cfg.actor.num_workers = 1
        for k, v in settings.items():
            setattr(cfg.actor, k, v)
        with pytest.raises(ValueError, match=message):
            cfg.validate()


@pytest.mark.parametrize("settings,message", [
    ({"remote_workers": 1}, "actor.transport=tcp"),
    ({"remote_workers": 1, "transport": "tcp"}, "remote_join_path"),
    ({"remote_workers": -1, "transport": "tcp"}, "remote_workers"),
])
def test_remote_workers_validation(settings, message):
    cfg = tconfig.ApexConfig()
    for k, v in settings.items():
        setattr(cfg.actor, k, v)
    with pytest.raises(ValueError, match=message):
        cfg.validate()


def test_join_spec_reserves_remote_channels(tmp_path):
    path = str(tmp_path / "join.json")
    cfg = _cfg(num_workers=1, max_workers=2, num_actors=6, transport="tcp",
               remote_workers=2, remote_join_path=path, net_coalesce_bytes=1 << 16)
    pool = ProcessActorPool(cfg, num_workers=1)
    try:
        assert pool.register_remote_workers() == path
        with open(path) as f:
            doc = json.load(f)
        assert not os.path.exists(path + ".tmp")
        assert doc["num_workers_total"] == 4 and doc["num_local_workers"] == 1
        assert doc["budget"] == cfg.actor.T and doc["quantum"] == cfg.actor.flush_every
        assert [s["wid"] for s in doc["specs"]] == [2, 3]       # above the local capacity
        for s in doc["specs"]:
            assert (s["kind"], s["attempt"], s["host"]) == ("tcp", 0, "127.0.0.1")
            assert (s["token"], s["port"]) == (pool._transport.net.token,
                                               pool._transport.port)
            assert s["coalesce"] == 1 << 16
        assert pool.net_stats()["expected"] == 2
        assert pool._attempt[2] == 1            # a local respawn could never reuse 0
    finally:
        pool.stop()
    shm = ProcessActorPool(_cfg(num_actors=4), num_workers=1)
    try:
        with pytest.raises(RuntimeError, match="transport=tcp"):
            shm.register_remote_workers(str(tmp_path / "x.json"))
    finally:
        shm.stop()


# -- real workers --------------------------------------------------------------------


@pytest.mark.parametrize("transport", ["shm", "tcp"])
def test_grow_then_clean_retire(two_cores, transport):
    cfg = _cfg(num_workers=1, max_workers=2, num_actors=4, transport=transport)
    pool = ProcessActorPool(cfg, num_workers=1, quantum=8)
    _, _, template = network_and_template(cfg)
    try:
        pool.publish(template)
        pool.start()
        _drain_until(pool, lambda: 0 in pool.last_versions, "wid 0 first chunk")
        assert pool.grow(1) == [1]
        assert pool.live_workers() == [0, 1] and pool.grows == 1
        _drain_until(pool, lambda: 1 in pool.last_versions, "grown wid 1 first chunk")
        steps_before = pool._steps_by_worker[1]
        assert steps_before > 0
        assert pool.retire() == 1
        _drain_until(pool, lambda: 1 in pool.finished_workers and 1 not in pool._rings,
                     "retired wid 1 clean done and channel reclaimed")
        assert pool.live_workers() == [0] and pool.retired == {1}
        assert not pool.worker_errors and pool.restarts == 0
        assert pool.transport_stats()["torn_records"] == 0
        assert pool.worker_reports[1]["retired"] is True
        assert pool.worker_reports[1]["param_source"] == ("net" if transport == "tcp"
                                                          else "shm")
        assert pool.grow_candidates() == [1]
        assert pool._steps_by_worker[1] >= steps_before
        if transport == "tcp":
            net = pool.net_stats()
            assert net["torn_frames"] == 0 and net["expected"] == 1
    finally:
        pool.stop()


def _spawn_events(proc_out: list, event: str) -> list:
    return [r for r in proc_out if r.get("event") == event]


def test_host_join_claims_slot_respawns_and_feeds(two_cores, tmp_path):
    path = str(tmp_path / "join.json")
    cfg = _cfg(num_workers=1, num_actors=4, transport="tcp", remote_workers=1,
               remote_join_path=path)
    pool = ProcessActorPool(cfg, num_workers=1, quantum=8)
    _, _, template = network_and_template(cfg)
    lines: list = []
    proc = None
    try:
        pool.publish(template)
        pool.start()
        assert os.path.exists(path)
        proc = subprocess.Popen(
            [sys.executable, "-m", "ape_x_dqn_tpu_torch.host_join", "--join", path,
             "--host", "127.0.0.1", "--duration", "170"],
            cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)

        def read():
            for ln in proc.stdout:
                if ln.startswith("{"):
                    lines.append(json.loads(ln))

        reader = threading.Thread(target=read, daemon=True)
        reader.start()
        _drain_until(pool, lambda: 1 in pool.last_versions and 0 in pool.last_versions,
                     "chunks from the local and the remote worker")
        spawned = _spawn_events(lines, "host_join_spawn")
        assert [e["wid"] for e in spawned] == [1]
        os.kill(spawned[0]["pid"], signal.SIGKILL)
        chunks = pool.chunks_by_worker[1]
        _drain_until(pool, lambda: len(_spawn_events(lines, "host_join_spawn")) == 2
                     and pool.chunks_by_worker[1] > chunks + 2,
                     "the respawned remote child feeding again")
        assert _spawn_events(lines, "host_join_respawn")[0]["wid"] == 1
        net = pool.net_stats()
        assert net["reconnects"] >= 1 and net["rejects"] == 0
        assert pool.restarts == 0 and not pool.worker_errors    # never the pool's to respawn
    finally:
        if proc is not None and proc.poll() is None:
            proc.send_signal(signal.SIGTERM)
            try:
                proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=10)
        pool.stop()
    assert proc.returncode == 0
    assert _spawn_events(lines, "host_join_exit")


def test_host_join_without_spec_or_slots_fails(tmp_path):
    from ape_x_dqn_tpu_torch import host_join

    out = io.StringIO()
    with redirect_stdout(out):
        assert host_join.main(["--join", str(tmp_path / "none.json"), "--wait-s", "0"]) == 1
        path = tmp_path / "empty.json"
        path.write_text(json.dumps({"specs": []}))
        assert host_join.main(["--join", str(path)]) == 1
    events = [json.loads(ln)["event"] for ln in out.getvalue().splitlines()]
    assert events == ["host_join_error", "host_join_error"]


@pytest.mark.parametrize("device_replay", [False, True], ids=["host_replay", "device_replay"])
def test_cli_trains_over_tcp_on_cpu(two_cores, capsys, device_replay):
    args = ["--device", "cpu", "--steps", "32", "--log-every", "1000",
            "--set", "actor.mode=process", "--set", "actor.transport=tcp",
            "--set", "actor.num_workers=2", "--set", "actor.num_actors=4",
            "--set", "actor.net_coalesce_bytes=65536", "--set", "env.name=chain:6",
            "--set", "network=mlp", "--set", "learner.min_replay_mem_size=200",
            "--set", "replay.capacity=2000", "--set", "learner.publish_every=4"]
    if device_replay:
        args += ["--set", "learner.device_replay=true", "--set", "learner.steps_per_call=8"]
    assert train.main(args) == 0
    recs = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("{")]
    final = recs[-1]
    assert final["final"] and final["step"] >= 32 and np.isfinite(final["learner/loss"])
    net, xp = final["net"], final["xp_transport"]
    assert xp["transport"] == "tcp" and xp["torn_records"] == 0
    assert net["torn_frames"] == 0 and net["frames_in"] == xp["chunks"]
    assert net["coalesced_frames_in"] >= 1 and net["param_pushes"] >= 1
    assert final["supervisor"]["watchdog"] == "ok"
