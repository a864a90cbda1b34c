"""The port's mesh and data-parallel learner step against the JAX package's
(twins of ``tests/test_parallel.py``).

JAX runs on the conftest's 8 virtual CPU devices; the port on a mesh of
``[cpu] * n`` slots at the same n, each slot its own replica.  Identical
params (carried with ``weights.params_from_jax``) and identical numpy
batches go through both.  Tolerances are ``test_torch_train_step.py``'s,
float32 compute throughout: losses and priorities rtol 1e-4 (atol 1e-6);
parameter UPDATES (after minus before) rtol 1e-4 with atol 1e-4 of the
largest update (1e-3 under Adam, whose step divides a gradient by its own
magnitude), plus one float32 ulp of the parameter the update was read
from.  The 512-wide model-axis twin steps RMSProp, the repo's default:
Adam's first step, ±lr at the gradient's noise floor, is the train-step
test's subject, not this one's.  The port's mesh step against the port's single-device step
on the concatenated batch: loss rtol 1e-5, priorities rtol 1e-4 atol
1e-5, params rtol 1e-4 atol 1e-6 (the JAX test's own).  Replicas are held
bit-identical (``torch.equal``).
"""

from __future__ import annotations

import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from ape_x_dqn_tpu.learner import train_step as jtrain
from ape_x_dqn_tpu.models import dueling as jdueling
from ape_x_dqn_tpu.parallel import build_sharded_train_step as jbuild_sharded
from ape_x_dqn_tpu.parallel import infer_param_sharding as jinfer
from ape_x_dqn_tpu.parallel import make_mesh as jmake_mesh
from ape_x_dqn_tpu.parallel import place_batch as jplace_batch
from ape_x_dqn_tpu.types import NStepTransition as JTransition
from ape_x_dqn_tpu.types import PrioritizedBatch as JBatch
from ape_x_dqn_tpu_torch.learner import train_step as ttrain
from ape_x_dqn_tpu_torch.models import dueling as tdueling
from ape_x_dqn_tpu_torch.parallel import (
    build_sharded_train_step,
    infer_param_sharding,
    make_mesh,
    place_batch,
    place_state,
    shard_train_state,
)
from ape_x_dqn_tpu_torch.types import NStepTransition, PrioritizedBatch, TrainState
from ape_x_dqn_tpu_torch.weights import _layer_map, params_from_jax

from _torch_harness import port_deadline  # noqa: F401 — the per-test deadline, autouse

OBS, A = (12,), 3


def cpu_mesh(n, model_parallel=1):
    return make_mesh(model_parallel=model_parallel, devices=[torch.device("cpu")] * n)


def np_batch(B, obs_shape=OBS, num_actions=A, seed=0):
    r = np.random.default_rng(seed)
    return dict(
        obs=r.integers(0, 255, (B, *obs_shape), dtype=np.uint8),
        action=r.integers(0, num_actions, (B,), dtype=np.int32),
        reward=r.normal(size=(B,)).astype(np.float32),
        discount=np.full((B,), 0.95, np.float32),
        next_obs=r.integers(0, 255, (B, *obs_shape), dtype=np.uint8),
        indices=np.arange(B, dtype=np.int32),
        is_weights=(r.random(B) * 0.9 + 0.1).astype(np.float32),
    )


def jbatch(b):
    return JBatch(transition=JTransition(**{k: b[k] for k in
                                            ("obs", "action", "reward", "discount",
                                             "next_obs")}),
                  indices=b["indices"], is_weights=b["is_weights"])


def tbatch(b):
    return PrioritizedBatch(
        transition=NStepTransition(**{k: torch.from_numpy(b[k]) for k in
                                      ("obs", "action", "reward", "discount", "next_obs")}),
        indices=torch.from_numpy(b["indices"]), is_weights=torch.from_numpy(b["is_weights"]))


def twin_nets(kind="mlp", hidden=(32, 32), opt_kind="adam", obs=OBS, num_actions=A, **net_kw):
    """The same network, optimizer and initial train state in both packages."""
    if kind == "mlp":
        jnet = jdueling.DuelingMLP(num_actions=num_actions, hidden_sizes=hidden)
        tnet = tdueling.DuelingMLP(num_actions, obs, hidden_sizes=hidden)
    else:
        jnet = jdueling.build_network("conv", num_actions, compute_dtype=jnp.float32, **net_kw)
        tnet = tdueling.build_network("conv", num_actions, obs, compute_dtype=torch.float32,
                                      **net_kw)
    kw = {"learning_rate": 1e-3} if opt_kind == "adam" else {}
    jopt = jtrain.make_optimizer(opt_kind, **kw)
    topt = ttrain.make_optimizer(opt_kind, **kw)
    jstate = jtrain.init_train_state(jnet, jopt, jax.random.PRNGKey(0),
                                     jnp.zeros((1, *obs), jnp.uint8))
    return jnet, jopt, jstate, tnet, topt


def tstate_of(tnet, topt, jstate):
    params = params_from_jax(tnet, jax.device_get(jstate.params))
    return TrainState(params=params, target_params={k: v.clone() for k, v in params.items()},
                      opt_state=topt.init(params), step=0, seed=0)


def assert_updates_close(tnet, got: dict, jparams, init: dict, atol_frac=1e-3, rtol=1e-4):
    """Updates within rtol of JAX's plus ``atol_frac`` of the largest update
    plus one float32 ulp of the parameter (the updates are differences of
    float32 params, rounded at the param's magnitude)."""
    want = params_from_jax(tnet, jax.device_get(jparams))
    for k in want:
        d_want = (want[k] - init[k]).numpy()
        d_got = (got[k] - init[k]).numpy()
        bound = (rtol * np.abs(d_want) + atol_frac * max(np.abs(d_want).max(), 1e-12)
                 + np.spacing(np.abs(init[k].numpy())))
        bad = np.abs(d_got - d_want) > bound
        assert not bad.any(), (k, int(bad.sum()), float(np.abs(d_got - d_want)[bad].max()))


def assert_replicas_identical(sharded):
    rows = sharded.rows
    for r in rows[1:]:
        for k in rows[0].params:
            assert torch.equal(r.params[k], rows[0].params[k]), k
            assert torch.equal(r.target_params[k], rows[0].target_params[k]), k


def test_eight_cpu_slots_like_eight_virtual_devices():
    """The JAX tests' 8 virtual CPU devices; the port's twin is a mesh of 8
    CPU slots, each its own device slot."""
    assert len(jax.devices()) == 8
    mesh = cpu_mesh(8)
    assert mesh.shape == {"data": 8, "model": 1} and mesh.local_data == 8
    assert mesh.data_devices == [torch.device("cpu")] * 8


def test_mesh_shapes():
    for kw in ({}, {"model_parallel": 2}):
        assert cpu_mesh(8, **kw).shape == dict(jmake_mesh(**kw).shape)
    assert cpu_mesh(8, model_parallel=2).devices[0] == (torch.device("cpu"),) * 2
    # The same errors, with the same messages.
    for kw in ({"num_devices": 6, "model_parallel": 4}, {"num_devices": 16}):
        with pytest.raises(ValueError) as jerr:
            jmake_mesh(**kw)
        with pytest.raises(ValueError) as terr:
            make_mesh(devices=[torch.device("cpu")] * 8, **kw)
        assert str(terr.value) == str(jerr.value)
    # The default device list is the visible cards: none here, so a config
    # asking for 4 of them fails as JAX's make_mesh does.
    with pytest.raises(ValueError, match="requested 4 devices, only 0 visible"):
        make_mesh(num_devices=4)


def test_dp_step_matches_single_device():
    """The 8-slot step equals the single-device step on the whole batch,
    and both equal JAX's 8-device sharded step."""
    jnet, jopt, jstate, tnet, topt = twin_nets()
    b = np_batch(32)
    mesh = cpu_mesh(8)
    # The port's states first: JAX's step donates (and deletes) its state.
    s1, s8 = tstate_of(tnet, topt, jstate), tstate_of(tnet, topt, jstate)
    init = {k: v.clone() for k, v in s1.params.items()}
    jstep, jsharded = jbuild_sharded(jnet, jopt, jmake_mesh(), jstate, jbatch(b),
                                     target_sync_freq=10)
    js, jm = jstep(jsharded, jplace_batch(jbatch(b), jmake_mesh()))

    single = ttrain.build_train_step(tnet, topt, target_sync_freq=10)
    s1, m1 = single(s1, tbatch(b))
    step, sharded = build_sharded_train_step(tnet, topt, mesh, s8, target_sync_freq=10)
    placed = place_batch(tbatch(b), mesh)
    assert len(placed) == 8 and all(len(p.indices) == 4 for p in placed)
    assert torch.equal(torch.cat([p.transition.obs for p in placed]), tbatch(b).transition.obs)
    sharded, m2 = step(sharded, placed)

    np.testing.assert_allclose(float(m2.loss), float(m1.loss), rtol=1e-5)
    np.testing.assert_allclose(m2.priorities.numpy(), m1.priorities.numpy(),
                               rtol=1e-4, atol=1e-5)
    for k, v in s1.params.items():
        np.testing.assert_allclose(sharded.params[k].numpy(), v.numpy(), rtol=1e-4, atol=1e-6)
    # Against JAX's sharded step.
    np.testing.assert_allclose(float(m2.loss), float(jm.loss), rtol=1e-4)
    np.testing.assert_allclose(m2.priorities.numpy(), np.asarray(jm.priorities),
                               rtol=1e-4, atol=1e-6)
    assert_updates_close(tnet, sharded.params, js.params, init)
    assert_replicas_identical(sharded)


def test_dp_multiple_steps_stay_in_sync():
    jnet, jopt, jstate, tnet, topt = twin_nets()
    jmesh, mesh = jmake_mesh(), cpu_mesh(8)
    jstep, js = jbuild_sharded(jnet, jopt, jmesh, jstate, jbatch(np_batch(64)))
    state0 = tstate_of(tnet, topt, jstate)
    init = {k: v.clone() for k, v in state0.params.items()}
    step, sharded = build_sharded_train_step(tnet, topt, mesh, state0)
    for i in range(5):
        b = np_batch(64, seed=i)
        js, jm = jstep(js, jplace_batch(jbatch(b), jmesh))
        sharded, metrics = step(sharded, place_batch(tbatch(b), mesh))
        np.testing.assert_allclose(float(metrics.loss), float(jm.loss), rtol=1e-4)
    assert sharded.step == int(js.step) == 5
    assert all(row[0].step == 5 for row in sharded.replicas)
    assert np.isfinite(float(metrics.loss))
    # Every replica holds the same bits: one reduced gradient, one optimizer
    # step each.
    assert_replicas_identical(sharded)
    assert_updates_close(tnet, sharded.params, js.params, init)


def test_grad_reduce_axis_builds_the_mesh_step():
    """``build_train_step(grad_reduce_axis="data")`` is the step that
    ``build_sharded_train_step`` returns: the same bits after two steps
    over a 2-slot mesh.  Another axis name raises."""
    _, _, jstate, tnet, topt = twin_nets()
    mesh = cpu_mesh(2)
    state = tstate_of(tnet, topt, jstate)
    s_a = place_state(state, shard_train_state(state, mesh))
    step_a = ttrain.build_train_step(tnet, topt, grad_reduce_axis="data")
    step_b, s_b = build_sharded_train_step(tnet, topt, mesh, tstate_of(tnet, topt, jstate))
    for i in range(2):
        placed = place_batch(tbatch(np_batch(16, seed=i)), mesh)
        s_a, m_a = step_a(s_a, placed)
        s_b, m_b = step_b(s_b, placed)
        assert torch.equal(m_a.loss, m_b.loss)
    for k, v in s_b.params.items():
        assert torch.equal(s_a.params[k], v), k
    with pytest.raises(ValueError, match="'data' axis"):
        ttrain.build_train_step(tnet, topt, grad_reduce_axis="model")


def test_model_axis_shards_wide_kernels():
    jnet, jopt, jstate, tnet, topt = twin_nets(hidden=(512, 512), opt_kind="rmsprop")
    jmesh, mesh = jmake_mesh(model_parallel=2), cpu_mesh(8, model_parallel=2)
    jspecs = jinfer(jstate.params, jmesh)["params"]
    state0, state1 = tstate_of(tnet, topt, jstate), tstate_of(tnet, topt, jstate)
    specs = infer_param_sharding(state0.params, mesh)
    # The rule picks the same kernels: a flax kernel split on its trailing
    # dim is the torch weight split on dim 0; biases stay replicated.
    for fname, prefix, _ in _layer_map(tnet):
        j_split = jspecs[fname]["kernel"].spec == P(None, "model")
        assert (specs[f"{prefix}.weight"].spec[:1] == ("model",)) == j_split, fname
        assert specs[f"{prefix}.bias"].spec == ()
    assert sum(sh.spec[:1] == ("model",) for sh in specs.values()) == 2
    # The step at model = 2 equals the step at model = 1 and JAX's.
    b = np_batch(32)
    jstep, js = jbuild_sharded(jnet, jopt, jmesh, jstate, jbatch(b))
    js, jm = jstep(js, jplace_batch(jbatch(b), jmesh))
    step2, sh2 = build_sharded_train_step(tnet, topt, mesh, state0)
    chunk = sh2.replicas[0][1].params["hidden.0.weight"]
    assert chunk.shape == (256, 12) and "hidden.0.weight" in sh2.sharded
    sh2, m2 = step2(sh2, place_batch(tbatch(b), mesh))
    init = {k: v.clone() for k, v in state0.params.items()}
    step1, sh1 = build_sharded_train_step(tnet, topt, cpu_mesh(4), state1)
    sh1, m1 = step1(sh1, place_batch(tbatch(b), cpu_mesh(4)))
    np.testing.assert_allclose(float(m2.loss), float(m1.loss), rtol=1e-5)
    np.testing.assert_allclose(float(m2.loss), float(jm.loss), rtol=1e-4)
    for k, v in sh1.params.items():
        np.testing.assert_allclose(sh2.params[k].numpy(), v.numpy(), rtol=1e-4, atol=1e-6,
                                   err_msg=k)
    assert_updates_close(tnet, sh2.params, js.params, init, atol_frac=1e-4)


def test_conv_network_dp_step():
    """The conv dueling net through the mesh step on a 2D mesh (4 data × 2
    model), its 512-wide stream kernels split over the model axis; RMSProp
    with the global-norm clip, as JAX's."""
    obs = (36, 36, 1)
    net_kw = dict(channels=(8, 8, 8), hidden=512)
    jnet, jopt, jstate, tnet, topt = twin_nets("conv", opt_kind="rmsprop", obs=obs,
                                               num_actions=4, **net_kw)
    jmesh, mesh = jmake_mesh(model_parallel=2), cpu_mesh(8, model_parallel=2)
    b = np_batch(16, obs_shape=obs, num_actions=4)
    state0 = tstate_of(tnet, topt, jstate)
    init = {k: v.clone() for k, v in state0.params.items()}
    jstep, js = jbuild_sharded(jnet, jopt, jmesh, jstate, jbatch(b))
    js, jm = jstep(js, jplace_batch(jbatch(b), jmesh))
    step, sharded = build_sharded_train_step(tnet, topt, mesh, state0)
    assert sharded.sharded == {"value_hidden.weight", "adv_hidden.weight"}
    sharded, metrics = step(sharded, place_batch(tbatch(b), mesh))
    assert np.isfinite(float(metrics.loss)) and sharded.step == int(js.step) == 1
    np.testing.assert_allclose(float(metrics.loss), float(jm.loss), rtol=1e-4)
    np.testing.assert_allclose(metrics.priorities.numpy(), np.asarray(jm.priorities),
                               rtol=1e-4, atol=1e-6)
    assert_updates_close(tnet, sharded.params, js.params, init, atol_frac=1e-4)


def test_async_pipeline_data_parallel_end_to_end():
    """learner.data_parallel=2 runs the whole async runtime on the CPU —
    actor thread, host replay, prefetch, the mesh step, priority write-back,
    param publish — over a 2-slot mesh."""
    from ape_x_dqn_tpu_torch.config import ApexConfig
    from ape_x_dqn_tpu_torch.parallel.mesh import ShardedTrainState
    from ape_x_dqn_tpu_torch.runtime.async_pipeline import AsyncPipeline
    from ape_x_dqn_tpu_torch.utils.metrics import MetricLogger

    cfg = ApexConfig()
    cfg.network = "mlp"
    cfg.env.name = "chain:6"
    cfg.actor.num_actors = 4
    cfg.actor.T = 100_000
    cfg.actor.flush_every = 8
    cfg.actor.sync_every = 16
    cfg.learner.data_parallel = 2
    cfg.learner.min_replay_mem_size = 128
    cfg.learner.publish_every = 10
    cfg.learner.optimizer = "adam"
    cfg.replay.capacity = 4096
    pipe = AsyncPipeline(cfg, logger=MetricLogger(stream=io.StringIO()), log_every=100,
                         device="cpu")
    assert pipe.mesh is not None and pipe.mesh.shape["data"] == 2
    assert isinstance(pipe.comps.state, ShardedTrainState)
    assert len(pipe.comps.state.rows) == 2
    result = pipe.run(learner_steps=60)
    assert result["step"] >= 60
    assert np.isfinite(result["learner/loss"])
    assert result["param_version"] > 1
    assert pipe.comps.replay.size() > 0
    assert_replicas_identical(pipe.comps.state)
