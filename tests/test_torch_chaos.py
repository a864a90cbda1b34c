"""The port's chaos injector (``obs/chaos.py``) against the JAX package's.

* Seeded streams: ``ChaosMonkey.schedule`` for several seeds and interval
  mixes, the victims a run of ``execute`` picks over the same fake pool,
  ``SlowEnv``'s sleeps, ``RpcChaos``'s delays and drops, and the
  ``PolicyServer``'s serving delays are **equal** to the JAX package's
  (the same ``random.Random`` draws; tolerance: exact).
* ``inject_torn_record`` on the port's ``ShmRing``: committed records
  survive, the torn tail is never delivered and is reported at salvage.
* ``corrupt_chunk``'s modes raise the port's ``ChunkCorrupt``;
  ``pick_chunk`` follows the manifest; ``ShmFiller`` leaves nothing.
* The ``chaos/<kind>`` counters and the ``chaos`` provider on the port's
  registry, under the JAX package's names on ``/metrics`` and ``/varz``.
* Config: the chaos section round-trips; the replay service's keys are
  refused by name.
* The stager gate: a stall held past a lowered ``obs.heartbeat_stale_s``
  turns ``/healthz`` 503 naming only ``ingest_stager``, then 200 again.
"""

from __future__ import annotations

import dataclasses
import json
import os
import random
import signal
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from ape_x_dqn_tpu.config import ChaosConfig as JChaosConfig
from ape_x_dqn_tpu.obs import chaos as jchaos
from ape_x_dqn_tpu_torch.config import ApexConfig, ChaosConfig, apply_overrides, load_config
from ape_x_dqn_tpu_torch.obs import chaos as tchaos

from _torch_harness import joined, port_deadline  # noqa: F401 — port_deadline is autouse

KINDS_CFG = ("kill_interval_s", "sigstop_interval_s", "torn_record_interval_s",
             "corrupt_chunk_interval_s", "stuck_stager_interval_s", "shm_fill_interval_s")


def _cfgs(seed, **intervals):
    return (JChaosConfig(enabled=True, seed=seed, **intervals),
            ChaosConfig(enabled=True, seed=seed, **intervals))


@pytest.mark.parametrize("seed,intervals,horizon", [
    (0, dict(kill_interval_s=2.0, torn_record_interval_s=5.0), 60.0),
    (13, dict(kill_interval_s=2.0, torn_record_interval_s=5.0), 60.0),
    (7, {k: 1.0 + i for i, k in enumerate(KINDS_CFG)}, 120.0),
    (12345, dict(stuck_stager_interval_s=0.7, shm_fill_interval_s=3.3), 30.0),
    (99, dict(sigstop_interval_s=0.25, corrupt_chunk_interval_s=11.0), 3600.0),
    (5, {}, 60.0),
])
def test_schedule_equals_jax(seed, intervals, horizon):
    jcfg, tcfg = _cfgs(seed, **intervals)
    j = jchaos.ChaosMonkey(jcfg, horizon_s=horizon)
    t = tchaos.ChaosMonkey(tcfg, horizon_s=horizon)
    assert t.schedule == j.schedule
    assert bool(t.schedule) == bool(intervals)
    assert [x for x, _ in t.schedule] == sorted(x for x, _ in t.schedule)


class _Proc:
    def __init__(self, pid):
        self.pid = pid

    def is_alive(self):
        return True

    def join(self, timeout=None):
        pass


class _Pool:
    def __init__(self, n):
        self._procs = [_Proc(10_000 + i) for i in range(n)]
        self._rings = {}


@pytest.mark.parametrize("seed", [0, 3, 41])
def test_victims_equal_jax_over_fake_pools(monkeypatch, seed):
    """The same mix of kills, torn kills and stops over a fake pool of 5
    workers: the same victims, in order (signals recorded, not sent)."""
    sent = []
    monkeypatch.setattr(os, "kill", lambda pid, sig: sent.append((pid, sig)))
    kinds = ["kill", "sigstop", "torn_record", "kill", "kill", "sigstop"] * 4
    logs = []
    for mod, cfg in zip((jchaos, tchaos), _cfgs(seed, sigstop_hold_s=0.0)):
        sent.clear()
        monkey = mod.ChaosMonkey(cfg, horizon_s=10.0).attach(pool=_Pool(5))
        for k in kinds:
            monkey.execute(k)
        logs.append(([{k: v for k, v in rec.items() if k != "t"} for rec in monkey.log],
                     list(sent)))
    assert logs[1] == logs[0]
    assert {rec["worker"] for rec in logs[1][0]} == set(range(5))
    assert (10_000, signal.SIGSTOP) in logs[1][1] or (10_001, signal.SIGSTOP) in logs[1][1]


def test_slow_env_and_rpc_streams_equal_jax(monkeypatch):
    slept = []
    monkeypatch.setattr(time, "sleep", lambda s: slept.append(s))

    class Env:
        observation_shape, num_actions = (4,), 2

        def reset(self, seed=None):
            return np.zeros(4, np.uint8)

        def step(self, a):
            return a

    streams = []
    for mod in (jchaos, tchaos):
        slept.clear()
        for i in range(4):   # a worker's actors: seed + 71 * i
            env = mod.SlowEnv(Env(), 0.002, seed=3 + 71 * i)
            assert env.num_actions == 2 and env.observation_shape == (4,)
            assert [env.step(a) for a in range(20)] == list(range(20))
        rpc = mod.RpcChaos(delay_ms=4.0, drop_rate=0.3, seed=9)
        rpc_stream = [(rpc.delay_s(), rpc.drop()) for _ in range(50)]
        streams.append((list(slept), rpc_stream, rpc.delays, rpc.drops))
    assert streams[1] == streams[0]
    assert all(0.001 <= s <= 0.003 for s in streams[1][0])


def test_serving_delay_stream_equals_jax(monkeypatch):
    """Both packages' ``PolicyServer`` sleep the same seeded ±25 % stream
    before each batch (their batch path called directly)."""
    import jax
    import jax.numpy as jnp

    from ape_x_dqn_tpu.models import dueling as jdueling
    from ape_x_dqn_tpu.serving.server import PolicyServer as JServer
    from ape_x_dqn_tpu_torch.models import dueling as tdueling
    from ape_x_dqn_tpu_torch.serving.server import PolicyServer as TServer

    jnet = jdueling.build_network("mlp", 2, hidden_sizes=(8,))
    jparams = jnet.init(jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.uint8))
    tnet = tdueling.build_network("mlp", 2, (4,), hidden_sizes=(8,))
    tparams = {k: v.detach().clone() for k, v in tnet.state_dict().items()}
    servers = [JServer(jnet, jparams, apply_delay_ms=5.0, delay_seed=17),
               TServer(tnet, tparams, apply_delay_ms=5.0, delay_seed=17, device="cpu"),
               TServer(tnet, tparams, device="cpu")]
    obs = np.zeros((3, 4), np.uint8)
    streams = []
    try:
        for server in servers:
            slept = []
            with monkeypatch.context() as mp:
                mp.setattr(time, "sleep", slept.append)
                for _ in range(12):
                    server._run_batch(obs)
            streams.append(slept)
    finally:
        for server in servers:
            server.close()
    assert len(streams[1]) == 12 and streams[1] == streams[0]
    assert all(0.00375 <= s <= 0.00625 for s in streams[1])
    assert streams[2] == []     # no delay configured: no sleep


class TestTornRecord:
    def _ring(self):
        from ape_x_dqn_tpu_torch.runtime.shm_ring import ShmRing

        return ShmRing(1 << 16)

    def test_committed_records_survive_torn_tail_never_delivered(self):
        ring = self._ring()
        try:
            payloads = [bytes([i]) * 100 for i in range(3)]
            for p in payloads:
                assert ring.try_write([p])
            rec = tchaos.inject_torn_record(ring, rng=random.Random(1))
            assert rec["fault"] == "torn_record" and rec["garbage_bytes"] == 64
            assert [ring.read_next() for _ in payloads] == payloads
            for _ in range(3):   # the torn tail is never read as data
                assert ring.read_next() is None
            assert ring.torn_tail()
        finally:
            ring.close()
            ring.unlink()

    def test_injection_draws_the_jax_garbage(self):
        """The same rng gives the same scribbled header and payload bytes."""
        from ape_x_dqn_tpu.runtime.shm_ring import ShmRing as JRing
        from ape_x_dqn_tpu_torch.runtime.shm_ring import _HEADER_SIZE, _REC

        rings = [self._ring(), JRing(1 << 16)]
        try:
            recs = [mod.inject_torn_record(r, garbage_bytes=48, rng=random.Random(8))
                    for mod, r in zip((tchaos, jchaos), rings)]
            assert [{k: v for k, v in r.items() if k != "ring"} for r in recs] \
                == [{"fault": "torn_record", "started": 1, "garbage_bytes": 48}] * 2
            span = slice(_HEADER_SIZE, _HEADER_SIZE + _REC.size + 48)
            assert bytes(rings[0]._shm.buf[span]) == bytes(rings[1]._shm.buf[span])
            assert any(rings[0]._shm.buf[span])
        finally:
            for r in rings:
                r.close()
                r.unlink()


class TestCorruptChunk:
    def _write(self, directory, name="chunk_3_1.ckpt"):
        from ape_x_dqn_tpu_torch.utils.checkpoint_inc import write_chunk

        path = os.path.join(str(directory), name)
        write_chunk(path, {"a": np.arange(64, dtype=np.int64),
                           "b": np.ones((8, 8), np.float32)})
        return path

    @pytest.mark.parametrize("mode", ["bitflip", "truncate", "zero"])
    def test_modes_raise_the_ports_chunk_corrupt(self, tmp_path, mode):
        from ape_x_dqn_tpu_torch.utils.checkpoint_inc import ChunkCorrupt, read_chunk

        path = self._write(tmp_path)
        rec = tchaos.corrupt_chunk(path, mode, rng=random.Random(5))
        assert rec["mode"] == mode
        with pytest.raises(ChunkCorrupt) as ei:
            read_chunk(path)
        assert (ei.value.path, ei.value.generation, ei.value.index) == (path, 3, 1)

    def test_bitflip_damages_the_jax_byte(self, tmp_path):
        paths = [self._write(tmp_path, f"chunk_{g}_0.ckpt") for g in (1, 2)]
        tchaos.corrupt_chunk(paths[0], rng=random.Random(11))
        jchaos.corrupt_chunk(paths[1], rng=random.Random(11))
        with open(paths[0], "rb") as f0, open(paths[1], "rb") as f1:
            a, b = f0.read(), f1.read()
        assert len(a) == len(b) and a[20:] == b[20:]

    def test_unknown_mode_rejected(self, tmp_path):
        with pytest.raises(ValueError, match="unknown corruption mode"):
            tchaos.corrupt_chunk(self._write(tmp_path), "melt")

    def test_pick_chunk_follows_the_manifest(self, tmp_path):
        inc = tmp_path / "replay_inc"
        inc.mkdir()
        for name in ("chunk_0_0.ckpt", "chunk_0_1.ckpt", "chunk_0_2.ckpt"):
            self._write(inc, name)
        assert tchaos.pick_chunk(str(inc)) is None
        (inc / "MANIFEST.json").write_text(json.dumps(
            {"chunks": ["chunk_0_0.ckpt", "chunk_0_1.ckpt", "chunk_0_2.ckpt", "gone.ckpt"]}))
        assert tchaos.pick_chunk(str(inc), prefer="base").endswith("chunk_0_0.ckpt")
        picks = [os.path.basename(tchaos.pick_chunk(str(inc), rng=random.Random(s),
                                                    prefer="delta")) for s in range(8)]
        jpicks = [os.path.basename(jchaos.pick_chunk(str(inc), rng=random.Random(s),
                                                     prefer="delta")) for s in range(8)]
        assert picks == jpicks and set(picks) <= {"chunk_0_1.ckpt", "chunk_0_2.ckpt"}

    def test_monkey_corrupts_a_chunk_of_its_checkpoint_dir(self, tmp_path):
        from ape_x_dqn_tpu_torch.utils.checkpoint_inc import ChunkCorrupt, read_chunk

        inc = tmp_path / "replay_inc"
        inc.mkdir()
        path = self._write(inc, "chunk_0_0.ckpt")
        (inc / "MANIFEST.json").write_text(json.dumps({"chunks": ["chunk_0_0.ckpt"]}))
        monkey = tchaos.ChaosMonkey(ChaosConfig(enabled=True)).attach(ckpt_dirs=[str(tmp_path)])
        rec = monkey.execute("corrupt_chunk")
        assert rec["path"] == path
        with pytest.raises(ChunkCorrupt):
            read_chunk(path)
        empty = tchaos.ChaosMonkey(ChaosConfig(enabled=True)).attach(
            ckpt_dirs=[str(tmp_path / "none")])
        assert empty.execute("corrupt_chunk")["skipped"] == "no committed chunks"


def _shm_names():
    return {n for n in os.listdir("/dev/shm") if f"_{os.getpid()}_" in n}


class TestShmFiller:
    def test_fill_and_release_leave_nothing(self):
        before = _shm_names()
        f = tchaos.ShmFiller()
        rec = f.fill(1 << 20)
        assert rec["fault"] == "shm_fill" and rec["bytes"] == 1 << 20
        assert _shm_names() - before
        f.release()
        f.release()
        assert _shm_names() == before

    def test_concurrent_fills_and_releases_never_fail_or_leak(self):
        """The monkey's thread, a caller's ``execute`` and ``stop`` may fill
        and release one filler at once (met on the card: a fill read back
        the segment another thread had just released, and recorded
        ``AttributeError: 'NoneType' object has no attribute 'name'``).
        Eight threads interleave fills and releases under a shortened
        switch interval: every fill names its segment, and nothing is left."""
        import sys

        before = _shm_names()
        f = tchaos.ShmFiller()
        recs, errors = [], []

        def churn():
            try:
                for _ in range(40):
                    recs.append(f.fill(1 << 16))
                    f.release()
            except Exception as e:  # noqa: BLE001 — asserted below
                errors.append(e)

        interval = sys.getswitchinterval()
        sys.setswitchinterval(1e-6)
        try:
            threads = [threading.Thread(target=churn) for _ in range(8)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(60)
        finally:
            sys.setswitchinterval(interval)
        assert not any(t.is_alive() for t in threads) and not errors
        assert len(recs) == 320 and all("name" in r and "failed" not in r for r in recs)
        f.release()
        assert _shm_names() == before

    def test_monkey_fill_is_released_by_stop(self):
        before = _shm_names()
        monkey = tchaos.ChaosMonkey(ChaosConfig(enabled=True, shm_fill_bytes=1 << 16,
                                                shm_fill_hold_s=30.0))
        t = threading.Thread(target=monkey.execute, args=("shm_fill",))
        t.start()
        deadline = time.monotonic() + 10
        while not (_shm_names() - before) and time.monotonic() < deadline:
            time.sleep(0.01)
        assert _shm_names() - before
        monkey.stop()      # cuts the hold short and releases at once
        t.join(10)
        assert not t.is_alive() and _shm_names() == before
        assert monkey.counts() == {"shm_fill": 1}


def test_counters_and_provider_carry_the_jax_names():
    from ape_x_dqn_tpu.obs.registry import MetricsRegistry as JRegistry
    from ape_x_dqn_tpu_torch.obs.registry import MetricsRegistry

    texts, snaps = [], []
    for mod, reg, cfg in zip((jchaos, tchaos), (JRegistry(), MetricsRegistry()),
                             _cfgs(1, kill_interval_s=2.0)):
        m = mod.ChaosMonkey(cfg, registry=reg, horizon_s=10.0)
        m.execute("kill")         # no pool: a recorded skip, still counted
        m.execute("kill_shard")   # no replay fleet
        texts.append(sorted(ln for ln in reg.prometheus_text().splitlines() if "chaos" in ln))
        snap = reg.snapshot()
        # A counter's rate_s is events over the wall time since it was made
        # (clamped at 1 ms): it differs between two registries made apart,
        # so the twins compare its presence, and every other value.
        snaps.append({k: {f: (f if f == "rate_s" else x) for f, x in v.items()}
                      for k, v in snap.items() if k.startswith("chaos")})
        assert m.counts() == {"kill": 1, "kill_shard": 1}
        assert snap["chaos/kill"]["total"] == 1.0 and snap["chaos"]["executed"] == 2
        assert m.log[1]["skipped"] == "no replay fleet attached"
    assert texts[1] == texts[0]
    assert snaps[1] == snaps[0]
    assert "apex_chaos_kill_total 1" in texts[1]


class TestConfig:
    def test_chaos_section_round_trips(self, tmp_path):
        over = ["chaos.enabled=true", "chaos.seed=7", "chaos.kill_interval_s=3.5",
                "chaos.env_latency_ms=2", "chaos.serving_delay_ms=5",
                "chaos.shm_fill_bytes=4096", "env.name=fake-atari", "env.frame_stack=4"]
        cfg = apply_overrides(ApexConfig(), over)
        assert cfg.chaos.enabled and cfg.chaos.seed == 7 and cfg.chaos.serving_delay_ms == 5.0
        from ape_x_dqn_tpu_torch.config import to_dict

        path = tmp_path / "cfg.json"
        path.write_text(json.dumps(to_dict(cfg)))
        assert load_config(str(path)) == cfg
        assert set(vars(cfg.chaos)) <= set(vars(JChaosConfig()))
        assert {k: v for k, v in vars(JChaosConfig()).items() if k in vars(cfg.chaos)} \
            == vars(ChaosConfig())

    @pytest.mark.parametrize("key", ["rpc_delay_ms", "rpc_drop_rate", "kill_shard_at_step",
                                     "kill_shard_interval_s"])
    def test_replay_service_keys_refused_by_name(self, key, tmp_path):
        """Refused by name until the replay service was ported; now each
        key is accepted from an override and from JSON and reaches its
        target: the shard's ``RpcChaos`` flags, the fleet's kill drill,
        the monkey's schedule."""
        from ape_x_dqn_tpu_torch.replay.service import ReplayServiceFleet

        cfg = apply_overrides(ApexConfig(), [f"chaos.{key}=0.5" if key == "rpc_drop_rate"
                                             else f"chaos.{key}=3"])
        path = tmp_path / "cfg.json"
        path.write_text(json.dumps({"chaos": {"enabled": True, key: getattr(cfg.chaos, key)}}))
        assert load_config(str(path)).chaos == dataclasses.replace(cfg.chaos, enabled=True)
        c = cfg.chaos
        fleet = ReplayServiceFleet(1, 64, (6,), root_dir=str(tmp_path / "fleet"),
                                   rpc_delay_ms=c.rpc_delay_ms, rpc_drop_rate=c.rpc_drop_rate,
                                   kill_shard_at_step=c.kill_shard_at_step)
        shard = fleet.shards[0]
        assert (shard.rpc_delay_ms, shard.rpc_drop_rate) == (c.rpc_delay_ms, c.rpc_drop_rate)
        if key == "kill_shard_at_step":
            fleet.kill_random = lambda rng=None: {"fault": "kill_shard", "shard": 0}
            assert fleet.maybe_kill_at_step(2) is None
            assert fleet.maybe_kill_at_step(3) == {"fault": "kill_shard", "shard": 0}
            assert fleet.maybe_kill_at_step(4) is None       # fires once
        if key == "kill_shard_interval_s":
            monkey = tchaos.ChaosMonkey(dataclasses.replace(c, enabled=True), horizon_s=30.0)
            assert monkey.schedule and {k for _, k in monkey.schedule} == {"kill_shard"}

    @pytest.mark.parametrize("over,message", [
        ("chaos.kill_interval_s=-1", "chaos.kill_interval_s must be >= 0"),
        ("chaos.env_latency_ms=-2", "chaos.env_latency_ms must be >= 0"),
        ("chaos.shm_fill_bytes=-1", "chaos.shm_fill_bytes must be >= 0"),
    ])
    def test_negative_values_refused(self, over, message):
        with pytest.raises(ValueError, match=message):
            apply_overrides(ApexConfig(), [over])

    def test_worker_config_carries_chaos(self):
        from ape_x_dqn_tpu_torch.config import to_dict
        from ape_x_dqn_tpu_torch.runtime.process_actors import _cfg_from_dict

        cfg = apply_overrides(ApexConfig(), ["chaos.enabled=true", "chaos.env_latency_ms=3",
                                             "env.frame_skip=2"])
        back = _cfg_from_dict(to_dict(cfg))
        assert back.chaos == cfg.chaos and back.env == cfg.env


def _health(url):
    try:
        with urllib.request.urlopen(f"{url}/healthz", timeout=10) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_stuck_stager_turns_healthz_503_naming_only_the_stager():
    """The overlapped pipeline with the exporter and ``obs.heartbeat_stale_s``
    lowered to 0.4 s: a 2.5 s stuck-stager fault turns ``/healthz`` 503 with
    only ``ingest_stager`` failing, and 200 again after it."""
    import io

    import torch

    from ape_x_dqn_tpu_torch.runtime.async_pipeline import AsyncPipeline
    from ape_x_dqn_tpu_torch.utils.metrics import MetricLogger

    cfg = apply_overrides(ApexConfig(), [
        "env.name=chain:6", "network=mlp", "actor.num_actors=2", "actor.flush_every=4",
        "learner.device_replay=true", "learner.steps_per_call=2", "learner.ingest_block=16",
        "learner.replay_sample_size=8", "learner.min_replay_mem_size=64",
        "learner.pipeline_depth=2", "learner.sync_every=8", "replay.capacity=1024",
        "obs.export_port=0", "obs.heartbeat_stale_s=0.4",
        "chaos.enabled=true", "chaos.seed=4", "chaos.stuck_stager_hold_s=2.5"])
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    pipe = AsyncPipeline(cfg, logger=MetricLogger(stream=io.StringIO()), log_every=10_000,
                         device="cpu")
    err, out = [], {}

    def run():
        try:
            out["final"] = pipe.run(learner_steps=1_000_000)
        except BaseException as e:  # noqa: BLE001 — asserted below
            err.append(e)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    try:
        url = pipe.obs_server.url
        deadline = time.monotonic() + 60
        while pipe.learner_step < 8 and time.monotonic() < deadline and not err:
            time.sleep(0.02)
        before = _health(url)
        monkey = pipe._chaos
        stall = threading.Thread(target=monkey.execute, args=("stuck_stager",))
        stall.start()
        during = []
        deadline = time.monotonic() + 30   # the stall holds 2.5 s
        while stall.is_alive():
            assert time.monotonic() < deadline, "the stuck_stager fault never released"
            during.append(_health(url))
            time.sleep(0.1)
        joined(stall, 10.0, "the stuck_stager fault")
        after = None
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            after = _health(url)
            if after[0] == 200:
                break
            time.sleep(0.05)
        snap = pipe.obs_registry.snapshot()
        with urllib.request.urlopen(f"{url}/varz", timeout=10) as r:
            varz = json.loads(r.read())
        with urllib.request.urlopen(f"{url}/metrics", timeout=10) as r:
            metrics = r.read().decode()
    finally:
        pipe.stop_event.set()
        t.join(60)
        torch.set_num_threads(threads)
    assert not t.is_alive() and not err, err
    assert before[0] == 200, before
    bad = [(code, sorted(n for n, c in body["components"].items() if not c["ok"]))
           for code, body in during if code != 200]
    assert bad, during
    assert all(names == ["ingest_stager"] for code, names in bad), bad
    assert all(code == 503 for code, _ in bad)
    assert after[0] == 200, after
    assert monkey.counts() == {"stuck_stager": 1} and not monkey.stager_stalled()
    assert snap["chaos/stuck_stager"]["total"] == 1.0 and snap["chaos"]["executed"] == 1
    assert varz["chaos"]["by_kind"] == {"stuck_stager": 1}
    assert varz["chaos/stuck_stager"]["total"] == 1.0
    assert "apex_chaos_stuck_stager_total 1" in metrics
