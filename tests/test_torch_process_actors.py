"""Process actors of the port (``actor.mode=process``) against the JAX
package's layout, on the CPU.

* The ε-ladder partition: the workers' slices, concatenated, are the
  global ladder (the port's exactly; the JAX package's within rtol 1e-6,
  one float32 ulp of ``pow``).
* Real worker processes (spawn, CPU-only torch): both workers deliver
  chunks, a worker lands on ``actor.T`` exactly, a SIGKILLed worker
  respawns with its remaining budget and feeds again, an exhausted restart
  budget is fatal, and nothing of a pool is left in ``/dev/shm`` after
  ``stop()`` or after the learner raises mid-run.
* Transport fidelity: with params published once and ``actor.sync_every``
  beyond the run, worker *w*'s chunks equal, array by array and exactly,
  those of an ``ActorFleet`` built here with the same slice, seed
  ``cfg.seed + 9000 + w`` and ε offset.
* ``AsyncPipeline`` runs end to end with two worker processes on both
  learner paths, and the fused loop's publishes through ``_AsyncPublisher``
  equal the inline publishes they replace.

Every spawning test has its own deadline and stops its pool in
``finally``.
"""

from __future__ import annotations

import io
import os
import signal
import time

import numpy as np
import pytest
import torch

from ape_x_dqn_tpu.actors import pool as jpool
from ape_x_dqn_tpu.ops.exploration import epsilon_ladder as jax_epsilon_ladder
from ape_x_dqn_tpu_torch import train
from ape_x_dqn_tpu_torch.actors.pool import ActorFleet, LocalParamSource
from ape_x_dqn_tpu_torch.config import ApexConfig, apply_overrides
from ape_x_dqn_tpu_torch.envs import make_env
from ape_x_dqn_tpu_torch.ops.exploration import epsilon_ladder
from ape_x_dqn_tpu_torch.runtime.async_pipeline import AsyncPipeline
from ape_x_dqn_tpu_torch.runtime.process_actors import (
    ProcessActorPool,
    network_and_template,
    worker_slice,
    worker_threads,
)
from ape_x_dqn_tpu_torch.runtime.supervisor import (
    QUARANTINE,
    RESPAWN,
    WAIT,
    RespawnPolicy,
)
from ape_x_dqn_tpu_torch.utils.metrics import MetricLogger


def _cfg(num_workers=2, num_actors=4, T=100_000, **actor):
    cfg = ApexConfig()
    cfg.network = "mlp"
    cfg.env.name = "chain:6"
    cfg.actor.mode = "process"
    cfg.actor.num_workers = num_workers
    cfg.actor.num_actors = num_actors
    cfg.actor.T = T
    cfg.actor.flush_every = 8
    cfg.actor.sync_every = 32
    cfg.actor.respawn_min_interval_s = 0.05
    for k, v in actor.items():
        setattr(cfg.actor, k, v)
    return cfg.validate()


def _segments(pool):
    """The pool's segment names: its param buffer now, and every ring it
    creates from here on (appended as they are made)."""
    names = [pool.buffer.name, *(r.name for r in pool._rings.values())]
    make = pool._transport.make_channel

    def make_and_record(wid, attempt):
        ring = make(wid, attempt)
        names.append(ring.name)
        return ring

    pool._transport.make_channel = make_and_record
    return names


def _assert_released(names):
    left = [n for n in names if os.path.exists(f"/dev/shm/{n}")]
    assert not left, f"segments left in /dev/shm: {left}"


def _drain_until(pool, cond, timeout_s):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        pool.supervise()
        pool.poll(max_items=64, timeout=0.05)
        if cond():
            return True
    return False


def _started_pool(cfg, **kw):
    pool = ProcessActorPool(cfg, num_workers=cfg.actor.num_workers, **kw)
    _, _, params = network_and_template(cfg)
    pool.publish(params)
    pool.start()
    return pool, params


# -- the ε partition ----------------------------------------------------------


@pytest.mark.parametrize("N,W", [(256, 8), (10, 3)])
def test_worker_slices_partition_the_global_ladder(N, W):
    slices = [worker_slice(w, N, W) for w in range(W)]
    assert slices[0][0] == 0 and slices[-1][1] == N
    assert all(a[1] == b[0] for a, b in zip(slices, slices[1:]))
    eps = []
    for w, (lo, hi) in enumerate(slices):
        fleet = ActorFleet([lambda: make_env("chain:6")] * (hi - lo), _mlp(),
                           device="cpu", epsilon_index_offset=lo, epsilon_total=N)
        eps.append(fleet._epsilons)
    got = torch.cat(eps)
    assert torch.equal(got, epsilon_ladder(0.4, 7.0, N))
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_epsilon_ladder(0.4, 7.0, N)),
                               rtol=1e-6)
    # The JAX fleet takes the same slice for the same offset.
    lo, hi = slices[-1]
    jfleet = jpool.ActorFleet([lambda: make_env("chain:6")] * (hi - lo), _jax_mlp(),
                              epsilon_index_offset=lo, epsilon_total=N)
    np.testing.assert_allclose(eps[-1].numpy(), np.asarray(jfleet._epsilons), rtol=1e-6)


def test_epsilon_slice_out_of_range_raises():
    with pytest.raises(ValueError, match="exceeds total"):
        ActorFleet([lambda: make_env("chain:6")] * 3, _mlp(), device="cpu",
                   epsilon_index_offset=2, epsilon_total=4)


def test_worker_threads_share_the_usable_cores():
    cores = len(os.sched_getaffinity(0))
    assert worker_threads(1) == cores
    assert worker_threads(2) == max(1, cores // 2)
    assert worker_threads(10 * cores) == 1


def _mlp():
    from ape_x_dqn_tpu_torch.models.dueling import build_network

    return build_network("mlp", 2, (6,), hidden_sizes=(8,))


def _jax_mlp():
    from ape_x_dqn_tpu.models.dueling import build_network

    return build_network("mlp", 2, hidden_sizes=(8,))


# -- the respawn policy (no processes) ----------------------------------------


def test_respawn_policy_backs_off_then_quarantines():
    p = RespawnPolicy(base_s=1.0, max_s=3.0, jitter=0.0, window_s=100.0, budget=3)
    assert p.decide(0, now=0.0) == RESPAWN
    assert p.on_death(0, now=0.0) == WAIT
    assert p.decide(0, now=0.5) == WAIT and p.decide(0, now=1.0) == RESPAWN
    assert p.on_death(0, now=10.0) == WAIT and p.backoff_remaining(0, now=10.0) == 2.0
    assert p.on_death(0, now=20.0) == WAIT and p.backoff_remaining(0, now=20.0) == 3.0
    assert p.on_death(0, now=30.0) == QUARANTINE
    assert p.decide(0, now=99.0) == QUARANTINE
    assert p.decide(1, now=30.0) == RESPAWN      # per worker


def test_respawn_policy_window_forgets_old_deaths_and_jitters():
    p = RespawnPolicy(base_s=1.0, max_s=30.0, jitter=0.25, window_s=10.0, budget=1, seed=3)
    assert p.on_death(0, now=0.0) == WAIT
    assert 0.75 <= p.backoff_remaining(0, now=0.0) <= 1.25
    assert p.on_death(0, now=20.0) == WAIT       # the first death left the window
    cfg = ApexConfig().supervisor
    q = RespawnPolicy.from_config(cfg)
    assert (q.base_s, q.max_s, q.budget) == (0.5, 30.0, 5)


# -- real worker processes ----------------------------------------------------


def test_both_workers_deliver_chunks():
    pool, _ = _started_pool(_cfg())
    names = _segments(pool)
    try:
        assert _drain_until(pool, lambda: set(pool.last_versions) == {0, 1}, 120)
        assert not pool.worker_errors and pool.restarts == 0
        assert pool.transport_stats()["chunks"] >= 2
    finally:
        pool.stop()
    _assert_released(names)
    # Each worker ran on the CPU and reported so when it finished.
    assert set(pool.worker_reports) == {0, 1}
    for rep in pool.worker_reports.values():
        assert rep["cuda_initialized"] is False
        assert rep["threads"] == worker_threads(2)


def test_worker_lands_on_T_exactly():
    """A quantum that does not divide actor.T must not overshoot it."""
    cfg = _cfg(num_workers=1, num_actors=2, T=53)  # 53 % 8 != 0
    pool, _ = _started_pool(cfg, quantum=8)
    try:
        assert _drain_until(pool, lambda: pool.finished, 120)
        assert not pool.worker_errors
        assert pool.final_steps == {0: 53}
    finally:
        pool.stop()


@pytest.mark.parametrize("policy", [False, True], ids=["legacy", "respawn-policy"])
def test_sigkilled_worker_respawns_and_feeds_again(policy):
    """A worker killed mid-run (no error message: the OOM-kill shape)
    respawns with its remaining budget and feeds experience again."""
    pool, _ = _started_pool(_cfg(num_actors=2))
    if policy:
        pool.respawn_policy = RespawnPolicy(base_s=0.05, jitter=0.0)
    try:
        assert _drain_until(pool, lambda: set(pool.last_versions) == {0, 1}, 120)
        victim = pool._procs[0]
        old_ring = pool._rings[0].name
        os.kill(victim.pid, signal.SIGKILL)
        victim.join(10.0)
        assert not victim.is_alive()
        steps_before = pool._steps_by_worker.get(0, 0)
        assert _drain_until(pool, lambda: pool.restarts >= 1, 60)
        assert not pool.worker_errors
        assert pool._rings[0].name != old_ring        # a fresh ring
        assert not os.path.exists(f"/dev/shm/{old_ring}")
        assert _drain_until(pool, lambda: pool._steps_by_worker.get(0, 0) > steps_before, 120)
    finally:
        pool.stop()


def test_restart_budget_exhaustion_is_fatal():
    pool, _ = _started_pool(_cfg(num_actors=2), max_restarts=1)
    try:
        deadline = time.monotonic() + 180
        last_seen = -1  # kill only after progress, so each incarnation ran
        while time.monotonic() < deadline and not pool.worker_errors:
            pool.supervise()
            pool.poll(max_items=64, timeout=0.05)
            p = pool._procs[0]
            steps = pool._steps_by_worker.get(0, 0)
            if p.is_alive() and steps > last_seen and 0 in pool.last_versions:
                last_seen = steps
                os.kill(p.pid, signal.SIGKILL)
                p.join(10.0)
        assert 0 in pool.worker_errors
        assert pool.restarts == 1
        pool.supervise()                      # a fatal worker is not respawned
        assert pool.restarts == 1 and not pool._procs[0].is_alive()
    finally:
        pool.stop()


def test_transport_delivers_the_fleet_chunks_exactly():
    T = 40
    cfg = _cfg(T=T, sync_every=10**6)
    pool, params = _started_pool(cfg, quantum=8)
    by_worker = {0: [], 1: []}
    decode = pool._decode_record

    def record(wid, payload):
        out = decode(wid, payload)
        by_worker[wid].append(out)
        return out

    pool._decode_record = record
    try:
        assert _drain_until(pool, lambda: pool.finished, 120)
        assert not pool.worker_errors
    finally:
        pool.stop()
    _, network, _ = network_and_template(cfg)
    threads = torch.get_num_threads()
    torch.set_num_threads(worker_threads(2))
    try:
        for w in (0, 1):
            lo, hi = worker_slice(w, cfg.actor.num_actors, 2)
            fleet = ActorFleet(
                [(lambda i=i: make_env(cfg.env.name, seed=cfg.seed + 1000 + i))
                 for i in range(lo, hi)],
                network, n_step=cfg.actor.num_steps, gamma=cfg.actor.gamma,
                epsilon=cfg.actor.epsilon, epsilon_alpha=cfg.actor.alpha,
                flush_every=cfg.actor.flush_every, sync_every=cfg.actor.sync_every,
                seed=cfg.seed + 9000 + w, emission=cfg.actor.emission, device="cpu",
                epsilon_index_offset=lo, epsilon_total=cfg.actor.num_actors,
            )
            fleet.sync_params(LocalParamSource(params))
            want = []
            while fleet.step_count < T:
                want += fleet.collect(min(8, T - fleet.step_count))[0]
            got = by_worker[w]
            assert len(got) == len(want) > 0
            for (prio, trans, _meta), chunk in zip(got, want):
                np.testing.assert_array_equal(prio, chunk.priorities)
                for f in ("obs", "action", "reward", "discount", "next_obs"):
                    np.testing.assert_array_equal(getattr(trans, f),
                                                  getattr(chunk.transitions, f), err_msg=f)
    finally:
        torch.set_num_threads(threads)
    assert pool.final_steps == {0: T, 1: T}
    assert set(pool.last_versions.values()) == {1}


# -- the pipeline -------------------------------------------------------------


def _pipe_cfg(device_replay: bool) -> ApexConfig:
    cfg = _cfg(sync_every=16)
    cfg.learner.min_replay_mem_size = 200
    cfg.learner.replay_sample_size = 32
    cfg.learner.publish_every = 5
    cfg.learner.optimizer = "adam"
    cfg.learner.learning_rate = 1e-3
    cfg.replay.capacity = 4096
    if device_replay:
        cfg.learner.device_replay = True
        cfg.learner.steps_per_call = 4
        cfg.learner.ingest_block = 64
    return cfg.validate()


@pytest.mark.parametrize("device_replay", [False, True], ids=["host-replay", "device-replay"])
def test_async_pipeline_with_process_actors(device_replay):
    cfg = _pipe_cfg(device_replay)
    pipe = AsyncPipeline(cfg, logger=MetricLogger(stream=io.StringIO()), log_every=100,
                         device="cpu")
    names = _segments(pipe.worker.pool)
    final = pipe.run(learner_steps=200)
    pool = pipe.worker.pool
    assert final["final"] and final["step"] >= 200
    assert np.isfinite(final["learner/loss"])
    assert final["actor_steps"] > 0 and final["actor_restarts"] == 0
    assert set(pool.last_versions) == {0, 1}
    # Workers re-pulled through the shared buffer: ingested chunks carry a
    # version beyond the initial publish.
    assert pipe.store.version > 1 and max(pool.last_versions.values()) > 1
    assert not pool.worker_errors
    assert all(not r["cuda_initialized"] for r in pool.worker_reports.values())
    _assert_released(names)


def test_learner_failure_releases_every_segment():
    cfg = _pipe_cfg(device_replay=True)
    pipe = AsyncPipeline(cfg, logger=MetricLogger(stream=io.StringIO()), log_every=100,
                         device="cpu")
    pool = pipe.worker.pool
    names = _segments(pool)
    calls = []
    train_call = pipe.fused.train

    def failing_train(beta, **kwargs):   # kwargs: the tracer's per-replay hook
        calls.append(beta)
        if len(calls) == 3:
            raise RuntimeError("learner failure")
        return train_call(beta, **kwargs)

    pipe.fused.train = failing_train
    with pytest.raises(RuntimeError, match="learner failure"):
        pipe.run(learner_steps=200)
    assert len(names) == 3        # the param buffer and both rings
    assert not any(p.is_alive() for p in pool._procs)
    _assert_released(names)


def test_fused_publish_through_the_publisher_equals_inline():
    """Thread actors and a ParamStore: each publish the fused loop hands to
    ``_AsyncPublisher`` lands with the version and values an inline
    ``store.publish`` would have given."""
    cfg = _pipe_cfg(device_replay=True)
    cfg.actor.mode = "thread"
    cfg.actor.T = 200
    pipe = AsyncPipeline(cfg, logger=MetricLogger(stream=io.StringIO()), log_every=1000,
                         device="cpu")
    published = []
    submit = pipe._publisher.submit

    def submit_and_wait(params):
        want = {k: v.detach().clone() for k, v in params.items()}
        submit(params)
        assert pipe._publisher.flush(timeout=30.0)
        published.append((want, *pipe.store.get(-1)))

    pipe._publisher.submit = submit_and_wait
    final = pipe.run(learner_steps=20)
    assert final["step"] == 20
    # K = 4, publish_every = 5: the calls ending at steps 8, 12, 16, 20.
    assert [v for _, _, v in published] == [1, 2, 3, 4] == list(range(1, 5))
    assert final["param_version"] == 4
    for want, got, _ in published:
        for k in want:
            assert torch.equal(got[k], want[k]), k
    for k, v in pipe.fused.params_for_publish().items():
        assert torch.equal(published[-1][1][k], v), k


# -- config and CLI -----------------------------------------------------------


@pytest.mark.parametrize("override,message", [
    ("actor.transport=udp", "unknown actor.transport"),
    ("serving.param_stale_s=-1", "param_stale_s"),
    ("actor.max_workers=1", "max_workers must be 0"),
    ("actor.remote_workers=1", "remote_workers requires actor.transport=tcp"),
    ("actor.mode=fork", "unknown actor.mode"),
    ("actor.num_workers=9", "num_actors must be >= actor.num_workers"),
    ("supervisor.crash_loop_budget=0", "crash_loop_budget"),
])
def test_not_ported_process_options_raise_by_name(override, message):
    with pytest.raises(ValueError, match=message):
        apply_overrides(ApexConfig(), ["actor.mode=process", "actor.num_actors=8", override])


def test_native_json_with_process_keys_loads_and_refuses_central(tmp_path):
    import json

    from ape_x_dqn_tpu_torch.config import load_config

    path = tmp_path / "cfg.json"
    path.write_text(json.dumps({
        "actor": {"mode": "process", "num_workers": 2, "num_actors": 4, "worker_nice": 5},
        "supervisor": {"enabled": False, "crash_loop_budget": 2},
    }))
    cfg = load_config(str(path))
    assert cfg.actor.mode == "process" and cfg.actor.worker_nice == 5
    assert not cfg.supervisor.enabled and cfg.supervisor.crash_loop_budget == 2
    # Central inference loads, and so does the serving staleness bound.
    path.write_text(json.dumps({"actor": {"mode": "process", "inference": "central"}}))
    assert load_config(str(path)).actor.inference == "central"
    path.write_text(json.dumps({"actor": {"mode": "process", "inference": "central"},
                                "serving": {"param_stale_s": 5.0}}))
    assert load_config(str(path)).serving.param_stale_s == 5.0


def test_cli_process_mode_needs_the_card_or_cpu():
    args = ["--set", "actor.mode=process", "--set", "env.name=chain:5", "--steps", "1"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train.main(args)
    with pytest.raises(ValueError, match="--mode async"):
        train.main(["--device", "cpu", "--mode", "sync", *args])


def test_cli_runs_process_actors_on_cpu(capsys):
    rc = train.main(["--device", "cpu", "--steps", "30", "--log-every", "1000",
                     "--set", "actor.mode=process", "--set", "actor.num_workers=2",
                     "--set", "actor.num_actors=4", "--set", "env.name=chain:6",
                     "--set", "network=mlp", "--set", "learner.min_replay_mem_size=200",
                     "--set", "replay.capacity=2000"])
    assert rc == 0
    import json

    final = [json.loads(line) for line in capsys.readouterr().out.splitlines()
             if line.startswith("{")][-1]
    assert final["final"] and final["step"] == 30 and np.isfinite(final["learner/loss"])
