"""The port's host-replay golden path against the JAX package's.

* **Driver parity.**  ``SingleProcessDriver`` of both packages with ε = 0,
  the float32 mlp and the JAX weights carried by ``params_from_jax``: the
  replay after the first iterations holds the same columns (frames,
  actions, rewards, discounts exactly; masses rtol 1e-5, since the actors'
  priorities are float32 forwards).  After the port loads the JAX replay's
  state, one learner step samples identical indices and IS weights (numpy
  float64 in both) and gives updates and written-back priorities within
  the tolerances of ``test_torch_train_step.py`` (rtol 1e-4).
* **Learning twins**, port only: the chain MDP learns its optimal policy and
  the loop env's value fixed point is unbiased, with the configs and
  assertions of ``tests/test_end_to_end.py``.
* **``PrefetchQueue``**: order, feeder errors, the deadline of ``get``,
  ``stop``; ``DevicePlacer`` on the CPU.
* **Deferred write-back**: a seeded async run at ``pipeline_depth`` 1 and 4
  leaves the replay exactly as sequential per-step updates would, with
  each flush at the step the order (flush, then append) puts it.
* The CLI's ``--metrics-file`` holds the records printed to stdout;
  evaluation matches the JAX evaluator.
"""

from __future__ import annotations

import io
import json
import threading
import time

import jax
import numpy as np
import pytest
import torch

from ape_x_dqn_tpu import evaluation as jeval
from ape_x_dqn_tpu.config import ApexConfig as JConfig
from ape_x_dqn_tpu.runtime.single_process import SingleProcessDriver as JDriver
from ape_x_dqn_tpu_torch import evaluation as teval
from ape_x_dqn_tpu_torch import train
from ape_x_dqn_tpu_torch.config import ApexConfig
from ape_x_dqn_tpu_torch.replay import PrioritizedReplay
from ape_x_dqn_tpu_torch.runtime.async_pipeline import AsyncPipeline
from ape_x_dqn_tpu_torch.runtime.infeed import DevicePlacer, PrefetchQueue
from ape_x_dqn_tpu_torch.runtime.single_process import SingleProcessDriver
from ape_x_dqn_tpu_torch.types import NStepTransition, PrioritizedBatch
from ape_x_dqn_tpu_torch.weights import params_from_jax

from _torch_harness import port_deadline  # noqa: F401 — the per-test deadline, autouse


@pytest.fixture(autouse=True)
def one_torch_thread():
    """These runs are tiny and multi-threaded in Python already (actors,
    prefetch, publisher); one intra-op thread keeps parallel test workers
    from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def tiny_config(cfg=None, **kw):
    """``tests/test_end_to_end.py::tiny_config`` for either package."""
    cfg = cfg if cfg is not None else ApexConfig()
    cfg.env.name = kw.pop("env_name", "chain:6")
    cfg.network = "mlp"
    cfg.actor.num_actors = 4
    cfg.actor.num_steps = 3
    cfg.actor.flush_every = 8
    cfg.actor.sync_every = 32
    cfg.actor.gamma = 0.9
    cfg.learner.min_replay_mem_size = 200
    cfg.learner.replay_sample_size = 32
    cfg.learner.total_steps = 1000
    cfg.learner.q_target_sync_freq = 50
    cfg.learner.publish_every = 5
    cfg.learner.learning_rate = 3e-3
    cfg.learner.optimizer = "adam"
    cfg.replay.capacity = 5000
    for k, v in kw.items():
        setattr(cfg, k, v)
    return cfg.validate()


# -- driver parity -------------------------------------------------------------


def _parity_pair(env_name):
    drivers = []
    for cfg, cls, kw in ((JConfig(), JDriver, {}), (ApexConfig(), SingleProcessDriver,
                                                      {"device": "cpu"})):
        tiny_config(cfg, env_name=env_name)
        cfg.actor.epsilon = 0.0
        cfg.learner.optimizer = "rmsprop"
        cfg.learner.learning_rate = 0.00025 / 4
        cfg.learner.min_replay_mem_size = 4000       # collect only, no learning
        drivers.append(cls(cfg.validate(), **kw))
    jd, td = drivers
    params = params_from_jax(td.network, jax.device_get(jd.state.params))
    for k, v in params.items():
        td.state.params[k].copy_(v)
        td.state.target_params[k].copy_(v)
    td.param_source.publish(td.state.params)
    assert td.fleet.sync_params(td.param_source)
    return jd, td


@pytest.mark.parametrize("env_name", ["chain:6", "loop:5"])
def test_driver_fills_the_jax_replay_then_steps_like_it(env_name):
    jd, td = _parity_pair(env_name)
    for _ in range(4):
        jr, tr = jd.run_iteration(), td.run_iteration()
        assert (tr.actor_steps, tr.replay_size, tr.learner_step) == \
            (jr.actor_steps, jr.replay_size, jr.learner_step)
        assert tr.episodes == jr.episodes
    assert td.replay.size() == 96
    js, ts = jd.replay.state_dict(), td.replay.state_dict()
    for f in ("obs", "next_obs", "action", "reward", "discount", "cursor", "count"):
        got, want = np.asarray(ts[f]), np.asarray(js[f])
        assert got.dtype == want.dtype and np.array_equal(got, want), f
    np.testing.assert_allclose(ts["tree_priorities"], js["tree_priorities"], rtol=1e-5)

    # The same replay state, then one learner step on each side.
    td.replay.load_state_dict(js)
    assert td.replay.digest() == jd.replay.digest()
    init = {k: v.clone() for k, v in td.state.params.items()}
    jb = jd._sample()
    jd.state, jm = jd.train_step(jd.state, jb)
    jd.replay.update_priorities(np.asarray(jb.indices), np.asarray(jm.priorities))
    tb, tm = td.learn_step()
    assert td.learner_step == 1
    np.testing.assert_array_equal(tb.indices, np.asarray(jb.indices))
    assert tb.is_weights.tobytes() == np.asarray(jb.is_weights).tobytes()
    np.testing.assert_allclose(float(tm.loss), float(jm.loss), rtol=1e-4)
    np.testing.assert_allclose(tm.priorities.numpy(), np.asarray(jm.priorities),
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(td.replay.state_dict()["tree_priorities"],
                               jd.replay.state_dict()["tree_priorities"], rtol=1e-4)
    want = params_from_jax(td.network, jax.device_get(jd.state.params))
    for k, w in want.items():
        d_want = (w - init[k]).numpy()
        d_got = (td.state.params[k] - init[k]).numpy()
        np.testing.assert_allclose(d_got, d_want, rtol=1e-4,
                                   atol=1e-4 * max(np.abs(d_want).max(), 1e-12), err_msg=k)


def test_driver_rejects_device_replay():
    cfg = tiny_config()
    cfg.learner.device_replay = True
    with pytest.raises(ValueError, match="host-replay"):
        SingleProcessDriver(cfg, device="cpu")


def test_host_sync_frequency_is_not_rounded_to_k():
    cfg = tiny_config()
    cfg.learner.q_target_sync_freq = 3
    cfg.learner.steps_per_call = 128
    cfg.learner.min_replay_mem_size = 100
    driver = SingleProcessDriver(cfg, device="cpu")
    driver.run(learner_steps=3)
    assert driver.learner_step == 3
    for k, v in driver.state.params.items():
        assert torch.equal(driver.state.target_params[k], v), k


# -- learning twins of tests/test_end_to_end.py --------------------------------


def test_chain_mdp_learns_optimal_policy():
    cfg = tiny_config()
    cfg.actor.gamma = 0.8
    cfg.learner.q_target_sync_freq = 25
    driver = SingleProcessDriver(cfg, learner_steps_per_iter=4, device="cpu")
    driver.run(learner_steps=1500)
    n = 6
    states = np.eye(n, dtype=np.uint8) * 255
    q = driver.greedy_q_values(states)
    assert (q[: n - 1].argmax(axis=1) == 1).all(), f"greedy actions: {q.argmax(1)}"
    expected = 0.8 ** (n - 2)
    assert q[0, 1] == pytest.approx(expected, abs=0.15), q[0]


def test_truncation_unbiased_value_sync():
    cfg = tiny_config(env_name="loop:10")
    cfg.actor.gamma = 0.9
    cfg.learner.loss = "squared"
    cfg.learner.q_target_sync_freq = 25
    driver = SingleProcessDriver(cfg, learner_steps_per_iter=4, device="cpu")
    driver.run(learner_steps=2000)
    q = driver.greedy_q_values(np.full((1, 4), 255, np.uint8))
    assert q.max() > 8.5, f"Q biased toward truncation cutoff: {q}"
    assert q.max() < 12.0, f"Q diverged: {q}"


# -- PrefetchQueue ---------------------------------------------------------------


def test_prefetch_keeps_order():
    counter = iter(range(10**6))
    with PrefetchQueue(lambda: next(counter), place_fn=lambda x: ("placed", x),
                       depth=2) as q:
        got = [q.get(timeout=5.0) for _ in range(50)]
    assert got == [("placed", i) for i in range(50)]


def test_prefetch_feeder_error_surfaces_in_get():
    def boom():
        raise KeyError("sampler broke")

    q = PrefetchQueue(boom, place_fn=lambda x: x)
    try:
        with pytest.raises(RuntimeError, match="feeder failed") as info:
            q.get(timeout=5.0)
        assert isinstance(info.value.__cause__, KeyError)
    finally:
        q.stop()


@pytest.mark.parametrize("timeout", [0.05, 0.3])
def test_prefetch_get_deadline_holds(timeout):
    release = threading.Event()

    def slow():
        release.wait(5.0)
        return 1

    q = PrefetchQueue(slow, place_fn=lambda x: x)
    try:
        t0 = time.monotonic()
        with pytest.raises(TimeoutError):
            q.get(timeout=timeout)
        elapsed = time.monotonic() - t0
        assert timeout <= elapsed < timeout + 0.15, elapsed
    finally:
        release.set()
        q.stop()


def test_prefetch_stop_joins_and_rejects_zero_depth():
    q = PrefetchQueue(lambda: 0, place_fn=lambda x: x, depth=1)
    q.get(timeout=5.0)
    q.stop()
    assert not q._thread.is_alive()
    with pytest.raises(ValueError):
        PrefetchQueue(lambda: 0, place_fn=lambda x: x, depth=0)


def test_device_placer_on_cpu_keeps_host_indices_and_values():
    r = np.random.default_rng(0)
    host = PrioritizedBatch(
        transition=NStepTransition(
            obs=r.integers(0, 256, (4, 3, 3, 1), dtype=np.uint8),
            action=np.arange(4, dtype=np.int32), reward=r.random(4).astype(np.float32),
            discount=np.full(4, 0.9, np.float32),
            next_obs=r.integers(0, 256, (4, 3, 3, 1), dtype=np.uint8)),
        indices=np.array([7, 1, 7, 3], np.int32), is_weights=np.ones(4, np.float32))
    placed = DevicePlacer("cpu")(host)
    assert placed.ready is None
    batch = placed.wait()
    np.testing.assert_array_equal(placed.indices, host.indices)
    assert batch.transition.obs.dtype == torch.uint8
    np.testing.assert_array_equal(batch.transition.obs.numpy(), host.transition.obs)
    np.testing.assert_array_equal(batch.is_weights.numpy(), host.is_weights)


# -- deferred priority write-back -------------------------------------------------


def _flush_plan(depth, steps, B):
    """(learner step at the call, rows) of every write-back: flush when
    len(pending) >= depth after a step is dispatched, then append; the rest
    at the end."""
    plan, pending = [], 0
    for s in range(1, steps + 1):
        if pending >= depth:
            plan.append((s, pending * B))
            pending = 0
        pending += 1
    plan.append((steps, pending * B))
    return plan


@pytest.mark.parametrize("depth,steps", [(1, 40), (4, 42)])
def test_deferred_writeback_equals_sequential_updates(depth, steps):
    cfg = tiny_config()
    cfg.actor.T = 11 + 8 * 9                    # 10 flushes of 8 steps × 4 actors
    cfg.learner.min_replay_mem_size = 320       # = everything the actors emit
    cfg.learner.pipeline_depth = depth
    pipe = AsyncPipeline(cfg, logger=_quiet_logger(), log_every=10**6, device="cpu")
    replay = pipe.comps.replay
    snapshot, per_step, calls = [], [], []
    step_fn, update_fn = pipe.train_step, replay.update_priorities

    def train_step(state, batch):
        if not snapshot:
            snapshot.append(replay.state_dict())   # no write-back has run yet
        state, metrics = step_fn(state, batch)
        per_step.append((batch.indices.numpy().copy(), metrics.priorities.clone()))
        return state, metrics

    def update_priorities(idx, prio):
        calls.append((pipe.learner_step, len(idx)))
        update_fn(idx, prio)

    pipe.train_step = train_step
    replay.update_priorities = update_priorities
    final = pipe.run(learner_steps=steps)
    assert final["step"] == steps and pipe.worker.finished
    assert replay.total_added == 320
    assert calls == _flush_plan(depth, steps, cfg.learner.replay_sample_size)
    sequential = PrioritizedReplay(cfg.replay.capacity, pipe.comps.obs_shape,
                                   priority_exponent=cfg.replay.priority_exponent)
    sequential.load_state_dict(snapshot[0])
    for idx, prio in per_step:
        sequential.update_priorities(idx, prio.numpy())
    assert sequential.digest() == replay.digest()
    assert set(final["stage_us"]) == {"sample+place", "step_dispatch",
                                      "priority_writeback", "publish"}


def _quiet_logger():
    from ape_x_dqn_tpu_torch.utils.metrics import MetricLogger

    return MetricLogger(stream=io.StringIO())


def test_async_host_path_evaluates_and_publishes():
    cfg = tiny_config()
    cfg.learner.min_replay_mem_size = 100
    pipe = AsyncPipeline(cfg, logger=_quiet_logger(), log_every=1000, device="cpu",
                         eval_every=10, eval_episodes=4)
    final = pipe.run(learner_steps=20)
    assert final["final"] and final["step"] == 20
    assert np.isfinite(final["learner/loss"])
    assert len(pipe.eval_scores) == 2 and final["eval/score/n"] == 2
    assert final["param_version"] == 20 // cfg.learner.publish_every
    got, version = pipe.store.get(-1)
    assert version == final["param_version"]
    for k, v in pipe.comps.state.params.items():
        assert torch.equal(got[k], v), k        # the last publish is the final params


# -- CLI and evaluation -------------------------------------------------------------


def test_metrics_file_holds_the_stdout_records(tmp_path, capsys):
    path = tmp_path / "metrics.jsonl"
    path.write_text('{"earlier": true}\n')        # appended to, not truncated
    rc = train.main(["--device", "cpu", "--mode", "sync", "--steps", "6",
                     "--log-every", "2", "--metrics-file", str(path),
                     "--set", "env.name=chain:6", "--set", "network=mlp",
                     "--set", "learner.min_replay_mem_size=100",
                     "--set", "replay.capacity=1000"])
    assert rc == 0
    out = [json.loads(line) for line in capsys.readouterr().out.splitlines()
           if line.startswith("{")]
    lines = path.read_text().splitlines()
    assert json.loads(lines[0]) == {"earlier": True}
    assert [json.loads(line) for line in lines[1:]] == out
    assert len(out) == 4 and out[-1]["final"] and out[-1]["step"] == 6


def test_score_normalization_matches_jax():
    for name in ("PongNoFrameskip-v4", "ALE/Breakout-v5", "gym:ALE/Pong-v5", "pong",
                 "chain:6", "random:84x84x1"):
        assert teval.canonical_game(name) == jeval.canonical_game(name)
        for score in (-21.0, 0.0, 17.5):
            assert teval.human_normalized(name, score) == \
                jeval.human_normalized(name, score)
    scores = {"Pong": 3.0, "Breakout": 20.0, "Seaquest": 900.0, "chain:6": 1.0}
    assert teval.median_human_normalized(scores) == jeval.median_human_normalized(scores)
    assert teval.median_human_normalized({"chain:6": 1.0}) is None
    assert teval.ATARI_HUMAN_RANDOM == jeval.ATARI_HUMAN_RANDOM


def test_greedy_evaluator_matches_jax():
    jd, td = _parity_pair("chain:6")
    kw = dict(env_name="chain:6", epsilon=0.0, seed=3)
    jres = jeval.GreedyEvaluator(jd.comps.env_fns[:3], jd.network, **kw).evaluate(
        jd.state.params, episodes=7)
    tev = teval.GreedyEvaluator(td.comps.env_fns[:3], td.network, device="cpu", **kw)
    tres = tev.evaluate(td.state.params, episodes=7)
    assert tres == jres
    assert len(tres.episodes) == 7 and tres.hns is None


@pytest.mark.parametrize("overrides,message", [
    (["learner.pipeline_depth=0"], "pipeline_depth must be >= 1"),
    (["learner.sync_every=64"], "overlapped fused"),
    (["learner.device_replay=true", "replay.frame_compression=true"], "host replay only"),
    (["learner.device_replay=true", "replay.hot_frame_budget_bytes=1000000"],
     "hot_frame_budget_bytes requires device_replay=False"),
])
def test_config_host_knobs_validate(overrides, message):
    from ape_x_dqn_tpu_torch.config import apply_overrides

    with pytest.raises(ValueError, match=message):
        apply_overrides(ApexConfig(), overrides)
    cfg = apply_overrides(ApexConfig(), ["learner.pipeline_depth=4",
                                         "replay.frame_compression=true"])
    assert cfg.learner.pipeline_depth == 4 and cfg.replay.frame_compression
    assert not cfg.learner.device_replay
