"""The port's device-replay learner slice against the JAX package's.

* ``FusedDeviceLearner``: both get the same chunks and the same weights; the
  port gets JAX's uniforms, rebuilt here the way the JAX learner draws them
  (``fold_in(state.rng, 0x5EED)``, one split per ``train()``, then per step
  in strict mode).  C ≤ 1024 keeps the ring inside one sampler chunk, so
  JAX's two-level sampler equals the flat one.  Tolerances: sampled
  indices exact (checked through the restamped masses, rtol 1e-4), losses
  rtol 1e-4, parameter updates rtol 1e-4 with atol 1e-4 of the largest.
* ``ActorFleet`` with ε = 0 and carried weights emits the same chunks:
  transitions exact, priorities rtol 1e-5.
* ``python -m ape_x_dqn_tpu_torch.train --device cpu`` runs end to end, on
  the device-replay learner and on the default host-replay path (async and
  ``--mode sync``); without ``--device`` it asks for the card.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ape_x_dqn_tpu.actors import pool as jpool
from ape_x_dqn_tpu.envs import make_env as jmake_env
from ape_x_dqn_tpu.learner import train_step as jtrain
from ape_x_dqn_tpu.models import dueling as jdueling
from ape_x_dqn_tpu.runtime.fused_learner import FusedDeviceLearner as JLearner
from ape_x_dqn_tpu.types import NStepTransition as JTransition
from ape_x_dqn_tpu_torch.actors import pool as tpool
from ape_x_dqn_tpu_torch.envs import make_env as tmake_env
from ape_x_dqn_tpu_torch.learner import train_step as ttrain
from ape_x_dqn_tpu_torch.models import dueling as tdueling
from ape_x_dqn_tpu_torch.runtime.fused_learner import FusedDeviceLearner as TLearner
from ape_x_dqn_tpu_torch.types import NStepTransition, TrainState
from ape_x_dqn_tpu_torch.weights import params_from_jax

from _torch_harness import port_deadline  # noqa: F401 — the per-test deadline, autouse

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OBS, A, C, B, K = (36, 36, 1), 3, 1000, 8, 4


def _chunks(n, M, seed=0):
    r = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        fields = dict(
            obs=r.integers(0, 256, (M, *OBS), dtype=np.uint8),
            action=r.integers(0, A, M).astype(np.int32),
            reward=r.normal(size=M).astype(np.float32),
            discount=(0.97 * (r.random(M) > 0.1)).astype(np.float32),
            next_obs=r.integers(0, 256, (M, *OBS), dtype=np.uint8),
        )
        out.append(((r.random(M) + 0.05).astype(np.float32), fields))
    return out


def _jax_call_uniforms(key, sample_ahead):
    """One train() call's uniforms and the advanced key, as the JAX learner
    draws them (fused_learner.py:397, device.py:282 and :149)."""
    key, sub = jax.random.split(key)
    if sample_ahead:
        u = np.array(jax.random.uniform(sub, (K, B)))
    else:
        u = np.stack([np.asarray(jax.random.uniform(k, (1, B)))[0]
                      for k in jax.random.split(sub, K)])
    return key, torch.from_numpy(u)


@pytest.mark.parametrize("sample_ahead", [False, True])
def test_fused_learner_matches_jax(sample_ahead):
    jnet = jdueling.build_network("conv", A, channels=(8, 8, 8), hidden=32,
                                  compute_dtype=jnp.float32)
    jopt = jtrain.make_optimizer("rmsprop")
    jstate = jtrain.init_train_state(jnet, jopt, jax.random.PRNGKey(0),
                                     jnp.zeros((1, *OBS), jnp.uint8))
    tnet = tdueling.build_network("conv", A, OBS, channels=(8, 8, 8), hidden=32,
                                  compute_dtype=torch.float32)
    topt = ttrain.make_optimizer("rmsprop")
    params = params_from_jax(tnet, jax.device_get(jstate.params))
    init = {k: v.clone() for k, v in params.items()}
    tstate = TrainState(params=params, target_params={k: v.clone() for k, v in params.items()},
                        opt_state=topt.init(params), step=0, seed=0)
    key = jax.random.fold_in(jstate.rng, 0x5EED)
    knobs = dict(capacity=C, batch_size=B, steps_per_call=K, ingest_block=128,
                 priority_exponent=0.6, target_sync_freq=4, sample_ahead=sample_ahead)
    jl = JLearner(jnet, jopt, jstate, OBS, **knobs)
    tl = TLearner(tnet, topt, tstate, OBS, device="cpu", **knobs)
    for prio, fields in _chunks(3, 200):
        jl.add_chunk(prio, JTransition(**fields))
        tl.add_chunk(prio, NStepTransition(**fields))
    assert jl.ingest_staged(drain=True) == tl.ingest_staged(drain=True) == 600
    for _ in range(2):
        jm = jl.train(0.4)
        key, u = _jax_call_uniforms(key, sample_ahead)
        tm = tl.train(0.4, u=u)
        np.testing.assert_allclose(tm.loss.numpy(), np.asarray(jm.loss), rtol=1e-4)
        np.testing.assert_allclose(tl.replay.mass.numpy(), np.asarray(jl._replay.mass),
                                   rtol=1e-4, atol=1e-6)
    assert tl.step == jl.step == 2 * K
    want = params_from_jax(tnet, jax.device_get(jl.state.params))
    for k, w in want.items():
        d_want = (w - init[k]).numpy()
        d_got = (tl.state.params[k] - init[k]).numpy()
        np.testing.assert_allclose(d_got, d_want, rtol=1e-4,
                                   atol=1e-4 * max(np.abs(d_want).max(), 1e-12), err_msg=k)
        assert torch.equal(tl.state.target_params[k], tl.state.params[k])  # synced at 8


def test_train_with_ingest_equals_add_block_then_train():
    tnet = tdueling.build_network("mlp", A, (4,), hidden_sizes=(8,))
    opt = ttrain.make_optimizer()
    r = np.random.default_rng(1)
    M = 64
    fields = dict(obs=r.integers(0, 256, (M, 4), dtype=np.uint8),
                  action=r.integers(0, A, M).astype(np.int32),
                  reward=r.normal(size=M).astype(np.float32),
                  discount=np.full(M, 0.9, np.float32),
                  next_obs=r.integers(0, 256, (M, 4), dtype=np.uint8))
    prio = (r.random(M) + 0.1).astype(np.float32)
    u = torch.rand((K, B), generator=torch.Generator().manual_seed(2))
    out = []
    for fold in (True, False):
        torch.manual_seed(0)
        state = ttrain.init_train_state(tnet, opt, device="cpu")
        tl = TLearner(tnet, opt, state, (4,), capacity=128, batch_size=B,
                      steps_per_call=K, ingest_block=M, device="cpu")
        if fold:
            m = tl.train_with_ingest(0.4, prio, NStepTransition(**fields), u=u)
        else:
            tl.add_block(prio, NStepTransition(**fields))
            m = tl.train(0.4, u=u)
        out.append((m.loss, tl.replay.mass.clone(), tl.size))
    torch.testing.assert_close(out[0][0], out[1][0], rtol=0, atol=0)
    torch.testing.assert_close(out[0][1], out[1][1], rtol=0, atol=0)
    assert out[0][2] == out[1][2] == M
    with pytest.raises(ValueError, match="full ingest_block"):
        tl.train_with_ingest(0.4, prio[:8], NStepTransition(**{k: v[:8] for k, v in fields.items()}))


def test_prepare_staged_drains_power_of_two_blocks():
    tnet = tdueling.build_network("mlp", A, (4,), hidden_sizes=(8,))
    opt = ttrain.make_optimizer()
    tl = TLearner(tnet, opt, ttrain.init_train_state(tnet, opt, device="cpu"), (4,),
                  capacity=256, ingest_block=64, device="cpu")
    r = np.random.default_rng(0)
    M = 64 + 37
    fields = dict(obs=r.integers(0, 256, (M, 4), dtype=np.uint8),
                  action=np.zeros(M, np.int32), reward=np.zeros(M, np.float32),
                  discount=np.zeros(M, np.float32),
                  next_obs=r.integers(0, 256, (M, 4), dtype=np.uint8))
    tl.add_chunk(np.ones(M, np.float32), NStepTransition(**fields))
    assert tl.ingest_staged() == 64 and tl.staged_rows == 37
    assert tl.ingest_staged(drain=True) == 37 and tl.staged_rows == 0  # 32+4+1
    np.testing.assert_array_equal(tl.replay.obs[:M].numpy(), fields["obs"])
    assert tl.size == M


@pytest.mark.parametrize("env,emission", [
    ("chain:10", "overlapping"),
    ("loop:5", "overlapping"),      # truncations re-target next_obs
    ("chain:10", "strided"),
])
def test_actor_fleet_emits_jax_chunks(env, emission):
    jnet = jdueling.build_network("mlp", 2, hidden_sizes=(16,))
    obs_dim = jmake_env(env).observation_shape
    jparams = jnet.init(jax.random.PRNGKey(3), jnp.zeros((1, *obs_dim), jnp.uint8))
    tnet = tdueling.build_network("mlp", 2, obs_dim, hidden_sizes=(16,))
    tparams = params_from_jax(tnet, jax.device_get(jparams))
    kw = dict(n_step=3, gamma=0.9, epsilon=0.0, flush_every=4, emission=emission)
    jfleet = jpool.ActorFleet([lambda: jmake_env(env)] * 3, jnet, **kw)
    tfleet = tpool.ActorFleet([lambda: tmake_env(env)] * 3, tnet, device="cpu", **kw)
    jfleet.sync_params(jpool.LocalParamSource(jparams))
    tfleet.sync_params(tpool.LocalParamSource(tparams))
    jchunks, jstats = jfleet.collect(15)
    tchunks, tstats = tfleet.collect(15)
    assert len(tchunks) == len(jchunks) == 3
    assert tstats == jstats
    for tc, jc in zip(tchunks, jchunks):
        assert tc.actor_steps == jc.actor_steps
        np.testing.assert_allclose(tc.priorities, jc.priorities, rtol=1e-5, atol=1e-6)
        for f in ("obs", "action", "reward", "discount", "next_obs"):
            np.testing.assert_array_equal(getattr(tc.transitions, f),
                                          np.asarray(getattr(jc.transitions, f)), err_msg=f)


def test_published_params_are_host_copies():
    p = {"w": torch.zeros(3)}
    src = tpool.LocalParamSource(p)
    p["w"].add_(1.0)  # the learner updates in place
    got, version = src.get(-1)
    assert version == 0 and float(got["w"].sum()) == 0.0


def test_cli_runs_end_to_end_on_cpu():
    cmd = [
        sys.executable, "-m", "ape_x_dqn_tpu_torch.train", "--device", "cpu",
        "--steps", "12", "--log-every", "4",
        "--set", "learner.device_replay=true", "--set", "env.name=catch:36",
        "--set", "replay.capacity=1024", "--set", "learner.min_replay_mem_size=128",
        "--set", "learner.steps_per_call=4", "--set", "learner.ingest_block=64",
        "--set", "learner.replay_sample_size=8", "--set", "actor.num_actors=4",
    ]
    res = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    records = [json.loads(line) for line in res.stdout.splitlines()
               if line.startswith("{")]
    final = records[-1]
    assert final["final"] and final["step"] == 12
    assert np.isfinite(final["learner/loss"]) and final["replay_size"] >= 128


def test_cli_defaults_to_cuda():
    from ape_x_dqn_tpu_torch import train

    assert train.build_argparser().parse_args([]).device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train.main(["--set", "env.name=chain:5", "--steps", "1"])


@pytest.mark.parametrize("mode", ["async", "sync"])
def test_cli_runs_host_path_on_cpu(mode):
    """The default learner.device_replay=false: host replay, host sum-tree."""
    cmd = [
        sys.executable, "-m", "ape_x_dqn_tpu_torch.train", "--device", "cpu",
        "--mode", mode, "--steps", "50",
        "--set", "env.name=chain:6", "--set", "network=mlp",
        "--set", "learner.min_replay_mem_size=200", "--set", "replay.capacity=5000",
    ]
    res = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    records = [json.loads(line) for line in res.stdout.splitlines()
               if line.startswith("{")]
    final = records[-1]
    assert final["final"] and final["step"] == 50
    assert np.isfinite(final["learner/loss"]) and final["replay_size"] >= 200
