"""The slice as a whole: config3's learner on the fake-atari wrapper stack
under the chaos monkey, on the CPU.

* Parity: both packages' ``ActorFleet`` at ε = 0, with carried conv weights
  (small width, float32 compute), roll the full DQN stack over each
  package's fake emulator (frame skip 4, episodic life with its no-op
  resets, reward clip): the dense chunks and the dedup chunks equal in
  every field (priorities rtol 1e-5), and ``CarryResolver`` resolves the
  dedup stream identically.  One train step of the conv network from the
  same params on a batch of those transitions: loss, priorities and mean Q
  rtol 1e-4, parameter updates rtol 1e-4 with atol 1e-4 of the largest
  (the tolerances of ``tests/test_torch_train_step.py``).
* The pipeline: ``AsyncPipeline`` on ``--device cpu`` with 2 worker
  processes on fake-atari (the conv network at full width: the config has
  no width knob), the overlapped fused dedup learner and the chaos monkey
  with ``kill``, ``torn_record`` and ``stuck_stager`` forced: the learner
  advances, the torn record is detected at salvage and never delivered,
  and the killed workers are respawned.
"""

from __future__ import annotations

import io
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from _torch_harness import pinned_cores, port_deadline  # noqa: F401 — port_deadline is autouse
import torch

from ape_x_dqn_tpu.actors import pool as jpool
from ape_x_dqn_tpu.envs import make_env as jmake_env
from ape_x_dqn_tpu.learner import train_step as jtrain
from ape_x_dqn_tpu.models import dueling as jdueling
from ape_x_dqn_tpu.replay.dedup import CarryResolver as JCarryResolver
from ape_x_dqn_tpu.types import DedupChunk as JDedupChunk
from ape_x_dqn_tpu.types import NStepTransition as JTransition
from ape_x_dqn_tpu.types import PrioritizedBatch as JBatch
from ape_x_dqn_tpu_torch.actors import pool as tpool
from ape_x_dqn_tpu_torch.envs import make_env as tmake_env
from ape_x_dqn_tpu_torch.learner import train_step as ttrain
from ape_x_dqn_tpu_torch.models import dueling as tdueling
from ape_x_dqn_tpu_torch.replay.dedup import CarryResolver
from ape_x_dqn_tpu_torch.types import DedupChunk, NStepTransition, PrioritizedBatch, TrainState
from ape_x_dqn_tpu_torch.weights import params_from_jax

OBS, A = (84, 84, 1), 4
FIELDS = ("obs", "action", "reward", "discount", "next_obs")
DEDUP_FIELDS = ("frames", "obs_ref", "next_ref", "action", "reward", "discount")


def _nets():
    jnet = jdueling.build_network("conv", A, channels=(8, 8, 8), hidden=32,
                                  compute_dtype=jnp.float32)
    jparams = jnet.init(jax.random.PRNGKey(5), jnp.zeros((1, *OBS), jnp.uint8))
    tnet = tdueling.build_network("conv", A, OBS, channels=(8, 8, 8), hidden=32,
                                  compute_dtype=torch.float32)
    return jnet, jparams, tnet, params_from_jax(tnet, jax.device_get(jparams))


def _fleets(dedup: bool, **env_kw):
    jnet, jparams, tnet, tparams = _nets()
    kw = dict(n_step=3, gamma=0.99, epsilon=0.0, flush_every=8, emit_dedup=dedup)
    jfleet = jpool.ActorFleet([lambda: jmake_env("fake-atari", **env_kw)] * 3, jnet, **kw)
    tfleet = tpool.ActorFleet([lambda: tmake_env("fake-atari", **env_kw)] * 3, tnet,
                              device="cpu", **kw)
    jfleet.sync_params(jpool.LocalParamSource(jparams))
    tfleet.sync_params(tpool.LocalParamSource(tparams))
    return jfleet, tfleet


@pytest.mark.parametrize("episodic_life", [True, False])
def test_fake_atari_dense_chunks_and_one_train_step_match_jax(episodic_life):
    jfleet, tfleet = _fleets(dedup=False, episodic_life=episodic_life)
    jchunks, jstats = jfleet.collect(40)
    tchunks, tstats = tfleet.collect(40)
    assert tstats == jstats and tstats, "episodes end on fake-atari (game over)"
    assert len(tchunks) == len(jchunks) >= 4
    for tc, jc in zip(tchunks, jchunks):
        assert tc.actor_steps == jc.actor_steps
        np.testing.assert_allclose(tc.priorities, jc.priorities, rtol=1e-5, atol=1e-6)
        for f in FIELDS:
            np.testing.assert_array_equal(getattr(tc.transitions, f),
                                          np.asarray(getattr(jc.transitions, f)), err_msg=f)
    rows = {f: np.concatenate([np.asarray(getattr(c.transitions, f)) for c in tchunks])
            for f in FIELDS}
    # A life goes every 3 agent steps (12 raw frames, frame skip 4), so with
    # n = 3 every window holds a life loss: EpisodicLife cuts every
    # bootstrap.  Without it only game over (agent step 9) does.  Rewards
    # (7 every 5 raw frames) arrive clipped to 1 in each n-step sum.
    if episodic_life:
        assert (rows["discount"] == 0).all()
    else:
        assert (rows["discount"] == 0).any() and (rows["discount"] > 0).any()
    assert (rows["reward"] > 0).any() and rows["reward"].max() <= 3.0
    assert rows["obs"].shape[1:] == OBS and rows["obs"].dtype == np.uint8
    # One train step of both packages from the same params.
    r = np.random.default_rng(0)
    pick = r.choice(len(rows["action"]), 32, replace=False)
    batch = {f: rows[f][pick] for f in FIELDS}
    batch["indices"] = np.arange(32, dtype=np.int32)
    batch["is_weights"] = (r.random(32) * 0.9 + 0.1).astype(np.float32)
    jnet, jparams, tnet, tparams = _nets()
    jopt, topt = jtrain.make_optimizer("rmsprop"), ttrain.make_optimizer("rmsprop")
    jstate = jtrain.init_train_state(jnet, jopt, jax.random.PRNGKey(5),
                                     jnp.zeros((1, *OBS), jnp.uint8))
    tparams = params_from_jax(tnet, jax.device_get(jstate.params))
    init = {k: v.clone() for k, v in tparams.items()}
    tstate = TrainState(params=tparams, target_params={k: v.clone() for k, v in tparams.items()},
                        opt_state=topt.init(tparams), step=0, seed=0)
    jstate, jm = jtrain.build_train_step(jnet, jopt)(jstate, JBatch(
        transition=JTransition(**{f: jnp.asarray(batch[f]) for f in FIELDS}),
        indices=jnp.asarray(batch["indices"]), is_weights=jnp.asarray(batch["is_weights"])))
    tstate, tm = ttrain.build_train_step(tnet, topt)(tstate, PrioritizedBatch(
        transition=NStepTransition(**{f: torch.from_numpy(batch[f]) for f in FIELDS}),
        indices=torch.from_numpy(batch["indices"]),
        is_weights=torch.from_numpy(batch["is_weights"])))
    np.testing.assert_allclose(float(tm.loss), float(jm.loss), rtol=1e-4)
    np.testing.assert_allclose(tm.priorities.numpy(), np.asarray(jm.priorities),
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(float(tm.mean_q), float(jm.mean_q), rtol=1e-4, atol=1e-6)
    want = params_from_jax(tnet, jax.device_get(jstate.params))
    for k in want:
        d_want, d_got = (want[k] - init[k]).numpy(), (tstate.params[k] - init[k]).numpy()
        np.testing.assert_allclose(d_got, d_want, rtol=1e-4,
                                   atol=1e-4 * max(np.abs(d_want).max(), 1e-12), err_msg=k)


def test_fake_atari_dedup_chunks_and_carry_resolution_match_jax():
    """EpisodicLife's no-op reset hands the fleet a stepped frame as the new
    episode's first: the dedup chunks reference it exactly as the JAX
    fleet's do, and both resolvers place every carry alike."""
    jfleet, tfleet = _fleets(dedup=True)
    jchunks, _ = jfleet.collect(40)
    tchunks, _ = tfleet.collect(40)
    assert len(tchunks) == len(jchunks) >= 4
    jres, tres = JCarryResolver(64), CarryResolver(64)
    base = 0
    for tc, jc in zip(tchunks, jchunks):
        t, j = tc.transitions, jc.transitions
        assert isinstance(t, DedupChunk)
        np.testing.assert_allclose(tc.priorities, jc.priorities, rtol=1e-5, atol=1e-6)
        for f in DEDUP_FIELDS:
            np.testing.assert_array_equal(getattr(t, f), np.asarray(getattr(j, f)), err_msg=f)
        assert (t.chunk_seq, t.prev_frames) == (j.chunk_seq, j.prev_frames)
        got = tres.resolve(t, base)
        want = jres.resolve(JDedupChunk(**{**j._asdict(), "source": t.source}), base)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
        base += t.frames.shape[0]
    assert tres.dropped_carry == jres.dropped_carry == 0
    assert any(int(c.transitions.obs_ref.min()) < 0 for c in tchunks)   # carries


def _segments():
    return {n for n in os.listdir("/dev/shm") if f"_{os.getpid()}_" in n}


@pytest.fixture
def two_cores():
    """Two usable cores: spawned workers inherit them and take one intra-op
    thread each (process_actors.worker_threads)."""
    with pinned_cores(2):   # this xdist worker's own pair (_torch_harness)
        yield


def test_pipeline_on_fake_atari_under_forced_chaos(two_cores):
    from ape_x_dqn_tpu_torch.config import ApexConfig, apply_overrides
    from ape_x_dqn_tpu_torch.runtime.async_pipeline import AsyncPipeline
    from ape_x_dqn_tpu_torch.utils.metrics import MetricLogger

    cfg = apply_overrides(ApexConfig(), [
        "env.name=fake-atari", "network=conv", "seed=3",
        "actor.mode=process", "actor.num_workers=2", "actor.num_actors=2",
        "actor.flush_every=8", "actor.sync_every=50",
        "learner.device_replay=true", "replay.dedup=true", "learner.sample_ahead=true",
        "learner.steps_per_call=4", "learner.ingest_block=32",
        "learner.replay_sample_size=8", "learner.min_replay_mem_size=64",
        "learner.pipeline_depth=2", "learner.sync_every=8", "replay.capacity=2048",
        "supervisor.enabled=true", "supervisor.respawn_backoff_base_s=0.05",
        "supervisor.respawn_backoff_max_s=0.2",
        "chaos.enabled=true", "chaos.seed=11", "chaos.stuck_stager_hold_s=0.5"])
    before = _segments()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    pipe = AsyncPipeline(cfg, logger=MetricLogger(stream=io.StringIO()), log_every=10_000,
                         device="cpu")
    monkey, pool = pipe._chaos, pipe.worker.pool
    fired = {}

    def on_train(step):
        # Between fused calls (learner thread): one fault per milestone.
        for at, kind in ((8, "kill"), (16, "torn_record"), (24, "stuck_stager")):
            if step >= at and kind not in fired:
                fired[kind] = monkey.execute(kind)

    train = pipe.fused.train

    def observed(*args, **kwargs):
        on_train(pipe.learner_step)
        return train(*args, **kwargs)

    pipe.fused.train = observed
    t0 = time.monotonic()
    try:
        final = pipe.run(learner_steps=48)
    finally:
        torch.set_num_threads(threads)
    wall = time.monotonic() - t0
    assert final["step"] >= 48 and np.isfinite(final["learner/loss"])
    assert set(fired) == {"kill", "torn_record", "stuck_stager"}
    assert all("failed" not in rec and "skipped" not in rec for rec in fired.values()), fired
    assert "garbage_bytes" in fired["torn_record"], fired["torn_record"]
    assert monkey.counts() == {"kill": 1, "torn_record": 1, "stuck_stager": 1}
    xp = pool.transport_stats()
    assert xp["torn_records"] >= 1, xp          # detected at salvage
    assert pool.restarts >= 2 and final["supervisor"]["respawns"] >= 2
    assert final["supervisor"]["quarantines"] == 0
    assert not pool.worker_errors
    assert _segments() == before
    assert wall < 120, wall
