"""The port's checkpoints (``utils/checkpoint``) against
``ape_x_dqn_tpu/utils/checkpoint.py``: twins of the JAX package's
``tests/test_checkpoint.py:47-330``, resume-equals-uninterrupted for the
host step and both fused layouts, and checkpoints carried across packages.

Tolerances:
* within the port, a resumed learner equals the uninterrupted one exactly
  (sampled indices, params, ν, target, ring masses, cursors): the CPU is
  deterministic and the restore copies bits;
* across packages, one host step on the same batch after the carry: params
  within 1e-5 of the largest |param| at float32, and 2e-2 relative where a
  bf16 knob is on (the bf16 tolerance of ``test_torch_lowp.py``);
* replay legs across packages: integer arrays and sampled indices
  identical on integer priorities, frames byte-equal.
"""

from __future__ import annotations

import io
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ape_x_dqn_tpu.learner import train_step as jtrain
from ape_x_dqn_tpu.models import dueling as jdueling
from ape_x_dqn_tpu.replay import PrioritizedReplay as JPrioritizedReplay
from ape_x_dqn_tpu.types import NStepTransition as JTransition
from ape_x_dqn_tpu.utils import checkpoint as jckpt
from ape_x_dqn_tpu_torch.config import ApexConfig
from ape_x_dqn_tpu_torch.learner import train_step as ttrain
from ape_x_dqn_tpu_torch.models import dueling as tdueling
from ape_x_dqn_tpu_torch.replay.buffer import PrioritizedReplay
from ape_x_dqn_tpu_torch.runtime.fused_dedup import FusedDedupLearner
from ape_x_dqn_tpu_torch.runtime.fused_learner import FusedDeviceLearner
from ape_x_dqn_tpu_torch.types import DedupChunk, NStepTransition
from ape_x_dqn_tpu_torch.utils.checkpoint import (
    ForeignCheckpointError,
    latest_step,
    load_replay_leg,
    load_replay_snapshot,
    restore_checkpoint,
    save_checkpoint,
)
from ape_x_dqn_tpu_torch.utils.checkpoint_inc import IncrementalCheckpointer
from ape_x_dqn_tpu_torch.utils.metrics import MetricLogger
from ape_x_dqn_tpu_torch.weights import train_state_from_jax, train_state_to_jax
from test_torch_train_step import _jbatch, _np_batches, _tbatch

BF16_RTOL = 2e-2


def _mlp_state(seed=0, kind="adam"):
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        net = tdueling.build_network("mlp", 3, (8,), hidden_sizes=(16,))
    opt = ttrain.make_optimizer(kind, learning_rate=1e-3)
    return net, opt, ttrain.init_train_state(net, opt, seed=seed, device="cpu")


def _mlp_batch(B=16, seed=0):
    r = np.random.default_rng(seed)
    return dict(obs=r.integers(0, 255, (B, 8), dtype=np.uint8),
                action=r.integers(0, 3, (B,), dtype=np.int32),
                reward=r.normal(size=(B,)).astype(np.float32),
                discount=np.full((B,), 0.9, np.float32),
                next_obs=r.integers(0, 255, (B, 8), dtype=np.uint8),
                indices=np.arange(B, dtype=np.int32),
                is_weights=np.ones((B,), np.float32))


def _leaves(state):
    out = [("step", torch.tensor(state.step))]
    for key in ("params", "target_params"):
        out += [(f"{key}.{k}", v) for k, v in sorted(getattr(state, key).items())]

    def walk(prefix, tree):
        for k in sorted(tree):
            if isinstance(tree[k], dict):
                walk(f"{prefix}{k}.", tree[k])
            else:
                out.append((f"{prefix}{k}", tree[k]))

    walk("opt.", state.opt_state)
    return out


def _assert_states_equal(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert [n for n, _ in la] == [n for n, _ in lb]
    for (name, x), (_, y) in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y), name


# -- twins of tests/test_checkpoint.py ------------------------------------------


def test_roundtrip_full_state(tmp_path):
    net, opt, state = _mlp_state()
    step_fn = ttrain.build_train_step(net, opt)
    for i in range(3):
        state, _ = step_fn(state, _tbatch(_mlp_batch(seed=i)))
    save_checkpoint(str(tmp_path), state)
    assert latest_step(str(tmp_path)) == 3
    _, _, template = _mlp_state(seed=99)
    restored, step = restore_checkpoint(str(tmp_path), template)
    assert step == 3 and restored is template
    _assert_states_equal(state, restored)


def test_resume_training_continues(tmp_path):
    """One more host step after the restore equals the uninterrupted step."""
    net, opt, s = _mlp_state()
    step_fn = ttrain.build_train_step(net, opt)
    for i in range(2):
        s, _ = step_fn(s, _tbatch(_mlp_batch(seed=i)))
    save_checkpoint(str(tmp_path), s)
    s_cont, _ = step_fn(s, _tbatch(_mlp_batch(seed=7)))
    _, _, template = _mlp_state(seed=5)
    restored, _ = restore_checkpoint(str(tmp_path), template)
    s_rest, _ = step_fn(restored, _tbatch(_mlp_batch(seed=7)))
    _assert_states_equal(s_cont, s_rest)


def test_replay_snapshot_roundtrip(tmp_path):
    _, _, state = _mlp_state()
    rep = PrioritizedReplay(64, (8,))
    b = _mlp_batch(20)
    rep.add(np.abs(np.random.default_rng(0).normal(size=20)) + 0.1,
            NStepTransition(*(b[f] for f in ("obs", "action", "reward", "discount",
                                             "next_obs"))))
    save_checkpoint(str(tmp_path), state, replay=rep)
    rep2 = PrioritizedReplay(64, (8,))
    restore_checkpoint(str(tmp_path), _mlp_state(seed=1)[2], replay=rep2)
    assert rep2.size() == 20 and rep2.digest() == rep.digest()


def test_keep_prunes_old(tmp_path):
    net, opt, state = _mlp_state()
    step_fn = ttrain.build_train_step(net, opt)
    for i in range(5):
        state, _ = step_fn(state, _tbatch(_mlp_batch(seed=i)))
        save_checkpoint(str(tmp_path), state, keep=2)
    os.makedirs(tmp_path / "step_9")   # uncommitted: counts for nothing
    save_checkpoint(str(tmp_path), state, keep=2)
    kept = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert kept == ["step_4", "step_5", "step_9"]
    assert latest_step(str(tmp_path)) == 5


def test_replay_only_save_commits_with_the_state_leg(tmp_path):
    """``save_replay_snapshot`` writes a step's replay leg alone; the step
    counts only once its state leg lands."""
    from ape_x_dqn_tpu_torch.utils.checkpoint import save_replay_snapshot

    _, _, state = _mlp_state()
    tr, _ = _replay_pair()
    state.step = 4
    save_replay_snapshot(str(tmp_path), 4, tr)
    assert latest_step(str(tmp_path)) is None
    save_checkpoint(str(tmp_path), state)
    dst = PrioritizedReplay(64, (6, 6, 1))
    assert latest_step(str(tmp_path)) == 4 and load_replay_snapshot(str(tmp_path), dst)
    assert dst.digest() == tr.digest()


def test_missing_checkpoint_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path / "nope"), _mlp_state()[2])


def test_load_replay_snapshot_absent_returns_false(tmp_path):
    save_checkpoint(str(tmp_path), _mlp_state()[2])

    class Sink:
        def load_state_dict(self, d):
            raise AssertionError("must not be called")

    assert load_replay_snapshot(str(tmp_path), Sink()) is False


def test_restore_missing_replay_emits_event(tmp_path, capsys):
    _, _, state = _mlp_state()
    save_checkpoint(str(tmp_path), state)
    capsys.readouterr()
    restore_checkpoint(str(tmp_path), state, replay=PrioritizedReplay(64, (8,)))
    events = [json.loads(line) for line in capsys.readouterr().err.splitlines()
              if line.startswith("{")]
    assert any(e["event"] == "checkpoint_restore_missing_replay" for e in events)


def _driver_cfg(tmp_path):
    c = ApexConfig()
    c.env.name = "chain:6"
    c.network = "mlp"
    c.actor.num_actors = 2
    c.actor.flush_every = 4
    c.learner.min_replay_mem_size = 64
    c.replay.capacity = 1000
    c.learner.checkpoint_every = 10
    c.learner.checkpoint_dir = str(tmp_path)
    return c.validate()


def test_driver_restore_gate(tmp_path, capsys):
    """The config's resume gate (the reference's load_saved_state)."""
    from ape_x_dqn_tpu_torch.runtime.single_process import SingleProcessDriver

    d1 = SingleProcessDriver(_driver_cfg(tmp_path), device="cpu")
    d1.run(learner_steps=10)
    assert latest_step(str(tmp_path)) == 10
    c2 = _driver_cfg(tmp_path)
    c2.learner.restore_from = str(tmp_path)
    d2 = SingleProcessDriver(c2, device="cpu")
    assert d2.learner_step == 10 and d2.state.step == 10
    assert d2.replay.digest() == d1.replay.digest()
    c3 = _driver_cfg(tmp_path)
    c3.learner.restore_from = str(tmp_path / "missing")
    assert SingleProcessDriver(c3, device="cpu").learner_step == 0
    assert "starting from scratch" in capsys.readouterr().err


def test_restore_from_config_keys():
    from ape_x_dqn_tpu_torch.config import apply_overrides, from_reference_json

    cfg = apply_overrides(ApexConfig(), ["learner.restore_from=true"])
    assert cfg.learner.restore_from is True
    cfg = apply_overrides(ApexConfig(), ["learner.restore_from=/ckpt/run1",
                                         "learner.checkpoint_every=500",
                                         "learner.checkpoint_incremental=yes"])
    assert cfg.learner.restore_from == "/ckpt/run1" and cfg.learner.checkpoint_incremental
    assert from_reference_json({"Learner": {"load_saved_state": True}}).learner.restore_from
    with pytest.raises(ValueError, match="checkpoint_base_every"):
        apply_overrides(ApexConfig(), ["learner.checkpoint_base_every=0"])


def _pipe_cfg(tmp_path, device_replay=False):
    cfg = ApexConfig()
    cfg.network = "mlp"
    cfg.env.name = "chain:6"
    cfg.actor.num_actors = 2
    cfg.actor.T = 100_000
    cfg.actor.flush_every = 8
    cfg.actor.sync_every = 16
    cfg.learner.min_replay_mem_size = 128
    cfg.learner.optimizer = "adam"
    cfg.learner.checkpoint_every = 50
    cfg.learner.checkpoint_dir = str(tmp_path / "ckpt")
    cfg.replay.capacity = 4096
    if device_replay:
        cfg.learner.device_replay = True
        cfg.learner.steps_per_call = 25
        cfg.learner.ingest_block = 32
    return cfg


@pytest.mark.parametrize("device_replay", [False, True])
def test_async_pipeline_kill_and_resume(tmp_path, device_replay):
    """A new pipeline resumes the learner step and the replay."""
    from ape_x_dqn_tpu_torch.runtime.async_pipeline import AsyncPipeline

    quiet = MetricLogger(stream=io.StringIO())
    pipe1 = AsyncPipeline(_pipe_cfg(tmp_path, device_replay), logger=quiet,
                          log_every=100, device="cpu")
    pipe1.run(learner_steps=100)
    assert latest_step(str(tmp_path / "ckpt")) == 100
    cfg2 = _pipe_cfg(tmp_path, device_replay)
    cfg2.learner.restore_from = True
    pipe2 = AsyncPipeline(cfg2, logger=quiet, log_every=100, device="cpu")
    assert pipe2.learner_step == 100 == pipe2.comps.learner_step
    assert pipe2._replay_size() > 0
    assert pipe2.run(learner_steps=150)["step"] >= 150


def _fused_learner(layout, sample_ahead=False, seed=0):
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        net = tdueling.build_network("mlp", 3, (8,), hidden_sizes=(16,))
    opt = ttrain.make_optimizer("rmsprop", learning_rate=1e-3,
                                second_moment_dtype=torch.bfloat16)
    state = ttrain.init_train_state(net, opt, seed=seed, device="cpu",
                                    target_dtype=torch.bfloat16)
    kw = dict(capacity=128, batch_size=8, steps_per_call=4, ingest_block=16,
              target_sync_freq=8, sample_ahead=sample_ahead, device="cpu")
    if layout == "dedup":
        return FusedDedupLearner(net, opt, state, (8,), frame_ratio=1.5, **kw)
    return FusedDeviceLearner(net, opt, state, (8,), **kw)


def _feed(learner, layout, k, rows=24):
    r = np.random.default_rng(k)
    p = r.integers(1, 5, rows).astype(np.float32)     # integer priorities
    if layout == "dedup":
        obs_ref = np.arange(rows, dtype=np.int32)
        obs_ref[:2] = [-2, -1] if k else [0, 1]
        learner.add_chunk(p, DedupChunk(
            frames=r.integers(0, 255, (rows + 1, 8), dtype=np.uint8), obs_ref=obs_ref,
            next_ref=np.arange(1, rows + 1, dtype=np.int32),
            action=r.integers(0, 3, rows).astype(np.int32),
            reward=r.normal(size=rows).astype(np.float32),
            discount=np.full(rows, 0.9, np.float32), source=1, chunk_seq=k,
            prev_frames=rows + 1))
    else:
        learner.add_chunk(p, NStepTransition(
            obs=r.integers(0, 255, (rows, 8), dtype=np.uint8),
            action=r.integers(0, 3, rows).astype(np.int32),
            reward=r.normal(size=rows).astype(np.float32),
            discount=np.full(rows, 0.9, np.float32),
            next_obs=r.integers(0, 255, (rows, 8), dtype=np.uint8)))
    learner.ingest_staged()   # leaves a partial tail staged


def _ring(learner):
    r = learner.replay
    out = {k: v.clone() for k, v in vars(r).items() if isinstance(v, torch.Tensor)}
    keys = ("cursor", "count", "fcount")
    return out, tuple(getattr(r, k, None) for k in keys), learner.size, learner.staged_rows


@pytest.mark.parametrize("layout,incremental", [("double", False), ("dedup", False),
                                                ("dedup", True)])
@pytest.mark.parametrize("sample_ahead", [False, True])
def test_fused_resume_equals_uninterrupted(tmp_path, layout, incremental, sample_ahead):
    """Two fused calls, a save (npz, or an APXC base plus one delta), a
    third call: a fresh learner restored from the directory runs the same
    third call, with its uniforms drawn from the restored generator.  The
    sampled indices, the train state and the ring are identical, and the
    staged tail rides along."""
    a = _fused_learner(layout, sample_ahead)
    ck = IncrementalCheckpointer(str(tmp_path), a, sync=True) if incremental else None
    for k in range(2):
        _feed(a, layout, k)
        if ck is not None and k == 0:
            ck.save(a.step)     # the base; the save after call 2 is a delta
        a.train(0.5)
    if ck is not None:
        ck.save(a.step)
        assert ck.stats()["deltas"] == (0 if layout == "double" else 1)
    save_checkpoint(str(tmp_path), a.state, replay=None if incremental else a,
                    generator=a.generator)
    b = _fused_learner(layout, sample_ahead, seed=7)
    restore_checkpoint(str(tmp_path), b.state, generator=b.generator)
    assert load_replay_leg(str(tmp_path), b) == ("incremental" if incremental else "snapshot")
    assert b.step == a.step == 8
    for learner in (a, b):
        learner.ingest_staged(drain=True)
        learner.train(0.5)
    assert torch.equal(a.graphed_call.body.sampled_indices(),
                       b.graphed_call.body.sampled_indices())
    _assert_states_equal(a.state, b.state)
    ring_a, ring_b = _ring(a), _ring(b)
    assert ring_a[1:] == ring_b[1:]
    for k, v in ring_a[0].items():
        assert torch.equal(v, ring_b[0][k]), k


def test_periodic_fused_checkpoint_includes_staged_rows(tmp_path):
    from ape_x_dqn_tpu_torch.runtime.async_pipeline import AsyncPipeline

    cfg = ApexConfig()
    cfg.env.name = "chain:6"
    cfg.network = "mlp"
    cfg.learner.device_replay = True
    cfg.learner.steps_per_call = 4
    cfg.learner.replay_sample_size = 16
    cfg.learner.checkpoint_every = 4
    cfg.learner.checkpoint_dir = str(tmp_path)
    cfg.learner.min_replay_mem_size = 64
    cfg.replay.capacity = 256
    pipe = AsyncPipeline(cfg.validate(), logger=MetricLogger(stream=io.StringIO()),
                         device="cpu")   # actors never started: driven by hand
    r = np.random.default_rng(1)
    pipe.fused.add_chunk(np.ones(40, np.float32), NStepTransition(
        obs=r.integers(0, 255, (40, 6), dtype=np.uint8),
        action=r.integers(0, 2, (40,), dtype=np.int32),
        reward=r.normal(size=(40,)).astype(np.float32),
        discount=np.full((40,), 0.9, np.float32),
        next_obs=r.integers(0, 255, (40, 6), dtype=np.uint8)))
    pipe.fused.ingest_staged()   # no full block of 256: nothing lands
    assert pipe.fused.staged_rows == 40 and pipe.fused.size == 0
    path = pipe._save_checkpoint()
    fused2 = FusedDeviceLearner(pipe.comps.network, pipe.comps.optimizer,
                                ttrain.init_train_state(pipe.comps.network,
                                                        pipe.comps.optimizer, device="cpu"),
                                (6,), capacity=256, batch_size=16, steps_per_call=4,
                                device="cpu")
    assert load_replay_snapshot(path, fused2)
    assert fused2.size == 40
    pipe.worker.join()
    pipe._publisher.close()


def test_fused_snapshot_shape_mismatch_is_a_config_error():
    a, b = _fused_learner("double"), _fused_learner("double")
    snap = a.state_dict()
    snap["obs"] = snap["obs"][:64]
    with pytest.raises(ValueError, match="configured ring"):
        b.load_state_dict(snap)


def test_lowp_state_leg_keeps_bf16_bits(tmp_path):
    """config3's knobs: bf16 params over a float32 master, bf16 ν and
    target.  The state leg carries each leaf in its own dtype, bit for bit."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        net = tdueling.build_network("mlp", 3, (8,), hidden_sizes=(16,),
                                     param_dtype=torch.bfloat16)
    opt = ttrain.make_optimizer("rmsprop", second_moment_dtype=torch.bfloat16,
                                float32_master=True)
    state = ttrain.init_train_state(net, opt, device="cpu", target_dtype=torch.bfloat16)
    step_fn = ttrain.build_train_step(net, opt)
    state, _ = step_fn(state, _tbatch(_mlp_batch()))
    save_checkpoint(str(tmp_path), state)
    template = ttrain.init_train_state(net, opt, seed=3, device="cpu",
                                       target_dtype=torch.bfloat16)
    restore_checkpoint(str(tmp_path), template)
    _assert_states_equal(state, template)
    assert template.opt_state["master"]["value.weight"].dtype == torch.float32
    assert template.opt_state["nu"]["value.weight"].dtype == torch.bfloat16


# -- across the packages --------------------------------------------------------


def _conv_pair(lowp: bool):
    kw_j = dict(channels=(8, 8, 8), hidden=32, compute_dtype=jnp.float32)
    kw_t = dict(channels=(8, 8, 8), hidden=32, compute_dtype=torch.float32)
    if lowp:
        kw_j["param_dtype"] = jnp.bfloat16
        kw_t["param_dtype"] = torch.bfloat16
        jopt = jtrain.with_float32_master(
            jtrain.make_optimizer("rmsprop", second_moment_dtype=jnp.bfloat16))
        topt = ttrain.make_optimizer("rmsprop", second_moment_dtype=torch.bfloat16,
                                     float32_master=True)
    else:
        jopt = jtrain.make_optimizer("adam", learning_rate=1e-3)
        topt = ttrain.make_optimizer("adam", learning_rate=1e-3)
    obs = (36, 36, 1)
    jnet = jdueling.build_network("conv", 3, **kw_j)
    tnet = tdueling.build_network("conv", 3, obs, **kw_t)
    jstate = jtrain.init_train_state(jnet, jopt, jax.random.PRNGKey(0),
                                     jnp.zeros((1, *obs), jnp.uint8),
                                     target_dtype=jnp.bfloat16 if lowp else None)
    return jnet, jopt, tnet, topt, jstate


def _assert_params_close(tparams, jparams_tree, tnet, lowp):
    from ape_x_dqn_tpu_torch.weights import params_from_jax

    want = params_from_jax(tnet, jax.device_get(jparams_tree))
    top = max(float(v.float().abs().max()) for v in want.values())
    for k, w in want.items():
        got = tparams[k].float().numpy()
        if lowp:
            np.testing.assert_allclose(got, w.float().numpy(), rtol=BF16_RTOL,
                                       atol=1e-6, err_msg=k)
        else:
            np.testing.assert_allclose(got, w.numpy(), rtol=0, atol=1e-5 * top, err_msg=k)


@pytest.mark.parametrize("lowp", [False, True])
def test_jax_checkpoint_resumes_in_the_port(tmp_path, lowp):
    """A JAX checkpoint (orbax state + npz), restored by JAX, carried through
    ``train_state_from_jax``, saved by the port and resumed: one host step
    on the same batch agrees with JAX's step."""
    jnet, jopt, tnet, topt, jstate = _conv_pair(lowp)
    jstep = jtrain.build_train_step(jnet, jopt, target_sync_freq=2)
    b0, b1 = _np_batches(n=2)
    jstate, _ = jstep(jstate, _jbatch(b0))
    _, jr = _replay_pair()
    jpath = jckpt.save_checkpoint(str(tmp_path / "jax"), jstate, replay=jr)
    # The npz leg of a JAX step loads in the port as it is.
    tr = PrioritizedReplay(64, (6, 6, 1))
    assert load_replay_snapshot(jpath, tr) and tr.digest() == jr.digest()
    with pytest.raises(ForeignCheckpointError, match="train_state_from_jax"):
        restore_checkpoint(str(tmp_path / "jax"), ttrain.init_train_state(
            tnet, topt, device="cpu", target_dtype=torch.bfloat16 if lowp else None))
    jrest, step = jckpt.restore_checkpoint(str(tmp_path / "jax"), jstate)
    carried = train_state_from_jax(tnet, topt, jax.device_get(jrest), seed=3)
    assert carried.step == step == 1 and carried.seed == 3
    save_checkpoint(str(tmp_path / "port"), carried)
    assert jckpt.latest_step(str(tmp_path / "port")) is None   # not JAX's
    tstate = ttrain.init_train_state(tnet, topt, device="cpu",
                                     target_dtype=torch.bfloat16 if lowp else None)
    restore_checkpoint(str(tmp_path / "port"), tstate)
    jnext, _ = jstep(jrest, _jbatch(b1))
    tnext, _ = ttrain.build_train_step(tnet, topt, target_sync_freq=2)(tstate, _tbatch(b1))
    assert tnext.step == int(jnext.step) == 2
    _assert_params_close(tnext.params, jnext.params, tnet, lowp)
    _assert_params_close(tnext.target_params, jnext.target_params, tnet, lowp)


@pytest.mark.parametrize("lowp", [False, True])
def test_port_checkpoint_resumes_in_jax(tmp_path, lowp):
    """The port's checkpoint carried back through ``train_state_to_jax``:
    one JAX host step agrees with the port's."""
    jnet, jopt, tnet, topt, jstate = _conv_pair(lowp)
    tstate = train_state_from_jax(tnet, topt, jax.device_get(jstate))
    tstep = ttrain.build_train_step(tnet, topt, target_sync_freq=2)
    b0, b1 = _np_batches(n=2)
    tstate, _ = tstep(tstate, _tbatch(b0))
    save_checkpoint(str(tmp_path), tstate)
    back = ttrain.init_train_state(tnet, topt, device="cpu",
                                   target_dtype=torch.bfloat16 if lowp else None)
    restore_checkpoint(str(tmp_path), back)
    jback = jax.device_put(train_state_to_jax(tnet, back, jstate))
    assert int(jback.step) == 1
    assert jax.tree_util.tree_structure(jback) == jax.tree_util.tree_structure(jstate)
    for x, y in zip(jax.tree_util.tree_leaves(jback), jax.tree_util.tree_leaves(jstate)):
        assert x.dtype == y.dtype and x.shape == y.shape
    jnext, _ = jtrain.build_train_step(jnet, jopt, target_sync_freq=2)(jback, _jbatch(b1))
    tnext, _ = tstep(back, _tbatch(b1))
    _assert_params_close(tnext.params, jnext.params, tnet, lowp)


def _replay_pair(n=48, seed=0):
    r = np.random.default_rng(seed)
    fields = dict(obs=r.integers(0, 255, (n, 6, 6, 1), dtype=np.uint8),
                  action=r.integers(0, 3, n).astype(np.int32),
                  reward=r.normal(size=n).astype(np.float32),
                  discount=np.full(n, 0.9, np.float32),
                  next_obs=r.integers(0, 255, (n, 6, 6, 1), dtype=np.uint8))
    prio = r.integers(1, 6, n).astype(np.float64)     # integer priorities
    tr, jr = PrioritizedReplay(64, (6, 6, 1)), JPrioritizedReplay(64, (6, 6, 1))
    tr.add(prio, NStepTransition(**fields))
    jr.add(prio, JTransition(**fields))
    return tr, jr


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_replay_npz_loads_across_packages(tmp_path, writer):
    tr, jr = _replay_pair()
    _, _, tstate = _mlp_state()
    if writer == "port":
        path = save_checkpoint(str(tmp_path), tstate, replay=tr)
        dst = JPrioritizedReplay(64, (6, 6, 1))
        assert jckpt.load_replay_snapshot(path, dst)
        src = tr
    else:
        from ape_x_dqn_tpu.learner.train_step import init_train_state, make_optimizer
        from ape_x_dqn_tpu.models.dueling import DuelingMLP

        net = DuelingMLP(num_actions=3, hidden_sizes=(16,))
        jstate = init_train_state(net, make_optimizer("adam"), jax.random.PRNGKey(0),
                                  jnp.zeros((1, 8), jnp.uint8))
        path = jckpt.save_checkpoint(str(tmp_path), jstate, replay=jr)
        dst = PrioritizedReplay(64, (6, 6, 1))
        assert load_replay_snapshot(path, dst)
        src = jr
    s, d = src.state_dict(), dst.state_dict()
    assert set(s) == set(d)
    for k in s:
        a, b = np.asarray(s[k]), np.asarray(d[k])
        np.testing.assert_array_equal(a, b, err_msg=k)
        if a.dtype.kind in "iu":
            assert a.dtype == b.dtype, k
    assert s["obs"].tobytes() == d["obs"].tobytes()
    ia = src.sample(16, rng=np.random.default_rng(5)).indices
    ib = dst.sample(16, rng=np.random.default_rng(5)).indices
    np.testing.assert_array_equal(np.asarray(ia), np.asarray(ib))


# -- serving a checkpoint (twins of tests/test_serving.py:247-330,405-440) -----


def _serve_parts():
    from ape_x_dqn_tpu_torch.runtime.components import build_components

    cfg = ApexConfig()
    cfg.env.name = "chain:6"
    cfg.network = "mlp"
    return build_components(cfg.validate(), device="cpu")


def test_checkpoint_source_versions(tmp_path):
    from ape_x_dqn_tpu_torch.serving.sources import CheckpointParamSource

    state = _serve_parts().state
    source = CheckpointParamSource(str(tmp_path), state.params)
    assert source.version == -1 and source.get(-1) is None
    save_checkpoint(str(tmp_path), state)                    # step 0
    params, version = source.get(-1)
    assert version == 0
    for k, v in state.params.items():
        assert torch.equal(params[k], v), k
    assert source.get(0) is None
    state.step += 7
    with torch.no_grad():
        state.params["value.bias"].add_(1.0)
    save_checkpoint(str(tmp_path), state)                    # step 7 commits
    params, version = source.get(0)
    assert version == 7 == source.version
    assert torch.equal(params["value.bias"], state.params["value.bias"])


def test_in_progress_saves_are_never_observed(tmp_path):
    """Chunks and a torn manifest of an incremental save, and a step dir
    whose state leg has not landed, move neither the version nor what is
    served: the state leg is the commit."""
    from ape_x_dqn_tpu_torch.serving.sources import CheckpointParamSource
    from ape_x_dqn_tpu_torch.utils import checkpoint_inc as ci

    state = _serve_parts().state
    save_checkpoint(str(tmp_path), state)
    source = CheckpointParamSource(str(tmp_path), state.params)
    inc = ci.inc_dir(str(tmp_path))
    os.makedirs(inc)
    ci.write_chunk(os.path.join(inc, "chunk_0_0.ckpt"), {"x": np.arange(8)})
    with open(os.path.join(inc, "MANIFEST.json.tmp"), "w") as f:
        f.write('{"half')
    os.makedirs(tmp_path / "step_9" / "torch_state.tmp-1")
    assert source.version == 0 and source.get(0) is None
    assert source.get(-1)[1] == 0
    state.step = 9
    save_checkpoint(str(tmp_path), state)
    assert source.get(0)[1] == 9


def _serve(argv):
    from contextlib import redirect_stdout

    from ape_x_dqn_tpu_torch import serve

    out = io.StringIO()
    with redirect_stdout(out):
        rc = serve.main([*argv, "--device", "cpu", "--set", "env.name=chain:6",
                         "--set", "network=mlp"])
    return rc, [json.loads(line) for line in out.getvalue().splitlines()
                if line.startswith("{")]


def test_checkpoint_serve_hot_reloads_over_the_socket(tmp_path):
    """``serve --checkpoint DIR --listen 0 --clients 2`` on the CPU: a newer
    step committed mid-run is reloaded, and the replies carry its version."""
    import threading

    comps = _serve_parts()
    save_checkpoint(str(tmp_path), comps.state)
    state = comps.state

    def commit_later():
        import time

        time.sleep(1.0)
        state.step = 5
        save_checkpoint(str(tmp_path), state)

    t = threading.Thread(target=commit_later)
    t.start()
    rc, recs = _serve(["--checkpoint", str(tmp_path), "--listen", "0", "--clients", "2",
                       "--duration", "3", "--metrics-every", "0.5",
                       "--set", "serving.reload_poll_s=0.05"])
    t.join()
    assert rc == 0
    assert [r for r in recs if r.get("event") == "serving_listen"][0]["port"] > 0
    final = [r for r in recs if "serve/served_total" in r][-1]
    assert final["final"] and final["serve/served_total"] > 0
    assert final["serve/shed_total"] == 0 and final["serve/reloads"] >= 1
    assert final["serve/param_version"] == 5


def test_empty_checkpoint_dir_is_an_error(tmp_path, capsys):
    rc, _ = _serve(["--checkpoint", str(tmp_path / "none"), "--duration", "0.2"])
    assert rc == 2
    assert "no checkpoint under" in capsys.readouterr().err
