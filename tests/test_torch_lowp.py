"""The low-precision knobs of the port against the JAX package.

* ``second_moment_dtype=bfloat16`` (RMSProp's ν stored in bf16, blended in
  float32, the step taken with the float32 ν before rounding);
* ``float32_master`` for ``param_dtype=bfloat16`` (the optimizer steps a
  float32 master copy; the params become ``cast(master)``);
* ``target_dtype=bfloat16`` (a real copy at init, syncs cast online →
  target dtype);
* the networks' ``param_dtype`` and ``weights.params_from_jax`` carrying
  bf16 leaves and the master copy without changing their dtype.

Tolerances: optimizer steps on given gradients, float32 leaves (master,
updates) rtol 1e-4 with atol 1e-4 of the largest update, as in
``test_torch_train_step.py``; bf16 leaves (params, ν, target) 2e-2
relative, the bf16 tolerance (bf16 keeps 8 significant bits; one rounding
flip of a float32 sum is 2^-8 relative).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ape_x_dqn_tpu.learner import train_step as jtrain
from ape_x_dqn_tpu.models import dueling as jdueling
from ape_x_dqn_tpu_torch.config import ApexConfig
from ape_x_dqn_tpu_torch.learner import train_step as ttrain
from ape_x_dqn_tpu_torch.models import dueling as tdueling
from ape_x_dqn_tpu_torch.runtime.components import build_components
from ape_x_dqn_tpu_torch.types import TrainState
from ape_x_dqn_tpu_torch.weights import params_from_jax
from test_torch_train_step import A, OBS, _jbatch, _np_batches, _tbatch

from _torch_harness import port_deadline  # noqa: F401 — the per-test deadline, autouse

BF16_RTOL = 2e-2


def _f32(t) -> np.ndarray:
    return np.asarray(t.float() if isinstance(t, torch.Tensor) else jnp.asarray(t, jnp.float32))


def _given_grads(seed=3):
    r = np.random.default_rng(seed)
    shapes = {"a": (4, 3), "b": (5,)}
    p0 = {k: r.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (r.normal(size=s) * sc).astype(np.float32) for k, s in shapes.items()}
             for sc in (1e-5, 1e3, 1.0)]
    return p0, grads


def test_bf16_second_moment_matches_optax():
    p0, grads = _given_grads()
    jopt = jtrain.make_optimizer("rmsprop", second_moment_dtype=jnp.bfloat16)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    jst = jopt.init(jp)
    topt = ttrain.make_optimizer("rmsprop", second_moment_dtype=torch.bfloat16)
    tp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    tst = topt.init(tp)
    assert all(v.dtype == torch.bfloat16 for v in tst["nu"].values())
    for g in grads:
        upd, jst = jopt.update({k: jnp.asarray(v) for k, v in g.items()}, jst, jp)
        jp = optax.apply_updates(jp, upd)
        topt.update_(tp, {k: torch.from_numpy(v) for k, v in g.items()}, tst)
        jnu = jst[1][0].nu
        for k in p0:
            d_want = np.asarray(jp[k]) - p0[k]
            np.testing.assert_allclose(tp[k].numpy() - p0[k], d_want, rtol=1e-4,
                                       atol=1e-4 * np.abs(d_want).max())
            np.testing.assert_allclose(_f32(tst["nu"][k]), _f32(jnu[k]), rtol=BF16_RTOL)


def test_bf16_second_moment_steps_with_the_unrounded_nu():
    """The step divides by the float32 ν of this update, not by its bf16
    copy: with ν = 0 and g = 1e-3·(1 + 2^-10), the rounded ν would differ."""
    opt = ttrain.make_optimizer("rmsprop", max_grad_norm=None,
                                second_moment_dtype=torch.bfloat16)
    p = {"w": torch.zeros(1)}
    st = opt.init(p)
    g = torch.tensor([1e-3 * (1 + 2**-10)])
    opt.update_(p, {"w": g}, st)
    nu32 = 0.05 * float(g) ** 2
    want = -opt.learning_rate * float(g) / np.sqrt(np.float32(nu32) + 1.5e-7)
    np.testing.assert_allclose(float(p["w"]), want, rtol=1e-6)
    assert st["nu"]["w"].dtype == torch.bfloat16
    assert float(st["nu"]["w"]) == float(torch.tensor([nu32]).to(torch.bfloat16))
    with pytest.raises(ValueError, match="only supported for rmsprop"):
        ttrain.make_optimizer("adam", second_moment_dtype=torch.bfloat16)


def test_float32_master_matches_with_float32_master():
    p0, grads = _given_grads(5)
    jopt = jtrain.with_float32_master(jtrain.make_optimizer("rmsprop"))
    jp = {k: jnp.asarray(v, jnp.bfloat16) for k, v in p0.items()}
    jst = jopt.init(jp)
    topt = ttrain.make_optimizer("rmsprop", float32_master=True)
    tp = {k: torch.from_numpy(v.copy()).to(torch.bfloat16) for k, v in p0.items()}
    tst = topt.init(tp)
    m0 = {k: tst["master"][k].clone() for k in p0}
    assert all(m.dtype == torch.float32 for m in m0.values())
    for g in grads:
        gb = {k: jnp.asarray(v, jnp.bfloat16) for k, v in g.items()}
        upd, jst = jopt.update(gb, jst, jp)
        jp = optax.apply_updates(jp, upd)
        topt.update_(tp, {k: torch.from_numpy(np.asarray(v, np.float32)).to(torch.bfloat16)
                          for k, v in gb.items()}, tst)
        for k in p0:
            d_want = np.asarray(jst[0][k]) - m0[k].numpy()
            d_got = tst["master"][k].numpy() - m0[k].numpy()
            np.testing.assert_allclose(d_got, d_want, rtol=1e-4,
                                       atol=1e-4 * np.abs(d_want).max())
            # The params land exactly on cast(master), as the JAX params do.
            assert tp[k].dtype == torch.bfloat16
            assert torch.equal(tp[k], tst["master"][k].to(torch.bfloat16))
            np.testing.assert_array_equal(_f32(jp[k]), _f32(jnp.asarray(jst[0][k], jnp.bfloat16)))
            np.testing.assert_allclose(_f32(tp[k]), _f32(jp[k]), rtol=BF16_RTOL)


def test_init_train_state_target_dtype_is_a_real_cast_copy():
    for param_dtype in (torch.float32, torch.bfloat16):
        net = tdueling.build_network("mlp", 3, (6,), hidden_sizes=(8,), param_dtype=param_dtype)
        opt = ttrain.make_optimizer("rmsprop", float32_master=param_dtype == torch.bfloat16)
        st = ttrain.init_train_state(net, opt, device="cpu", target_dtype=torch.bfloat16)
        for k, v in st.params.items():
            t = st.target_params[k]
            assert v.dtype == param_dtype and t.dtype == torch.bfloat16
            assert t.data_ptr() != v.data_ptr()
            assert torch.equal(t, v.to(torch.bfloat16))
        for v in st.params.values():
            v.add_(0.5)
        ttrain.sync_target_(st)
        for k, v in st.params.items():
            assert st.target_params[k].dtype == torch.bfloat16
            assert torch.equal(st.target_params[k], v.to(torch.bfloat16))


def test_bf16_params_forward_matches_flax():
    """The conv net with bf16 params (bf16 compute, f32 heads) on the same
    weights and frames, and the port's network storing bf16."""
    jnet = jdueling.build_network("conv", A, channels=(8, 8, 8), hidden=32,
                                  param_dtype=jnp.bfloat16)
    jparams = jnet.init(jax.random.PRNGKey(1), jnp.zeros((1, *OBS), jnp.uint8))
    tnet = tdueling.build_network("conv", A, OBS, channels=(8, 8, 8), hidden=32,
                                  param_dtype=torch.bfloat16)
    assert all(p.dtype == torch.bfloat16 for p in tnet.parameters())
    params = params_from_jax(tnet, jax.device_get(jparams))
    assert all(v.dtype == torch.bfloat16 for v in params.values())
    x = np.random.default_rng(2).integers(0, 256, (4, *OBS), dtype=np.uint8)
    want = np.asarray(jnet.apply(jparams, jnp.asarray(x))[2])
    got = tnet.apply_params(params, torch.from_numpy(x)).q
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=BF16_RTOL,
                               atol=BF16_RTOL * np.abs(want).max())


def test_lowp_train_steps_match_jax():
    """Three steps of the full learner step with every knob on: bf16
    params with the float32 master, bf16 ν, bf16 target (synced every 2
    steps), float32 compute, from the JAX package's own initial state."""
    jnet = jdueling.build_network("conv", A, channels=(8, 8, 8), hidden=32,
                                  compute_dtype=jnp.float32, param_dtype=jnp.bfloat16)
    jopt = jtrain.with_float32_master(
        jtrain.make_optimizer("rmsprop", second_moment_dtype=jnp.bfloat16))
    jstate = jtrain.init_train_state(jnet, jopt, jax.random.PRNGKey(0),
                                     jnp.zeros((1, *OBS), jnp.uint8), target_dtype=jnp.bfloat16)
    tnet = tdueling.build_network("conv", A, OBS, channels=(8, 8, 8), hidden=32,
                                  compute_dtype=torch.float32, param_dtype=torch.bfloat16)
    topt = ttrain.make_optimizer("rmsprop", second_moment_dtype=torch.bfloat16,
                                 float32_master=True)

    def carry(tree):
        return params_from_jax(tnet, jax.device_get(tree))

    master0 = carry(jstate.opt_state[0])
    tstate = TrainState(params=carry(jstate.params), target_params=carry(jstate.target_params),
                        opt_state={"master": {k: v.clone() for k, v in master0.items()},
                                   "nu": carry(jstate.opt_state[1][1][0].nu)},
                        step=0, seed=0)
    assert tstate.opt_state["master"]["value.weight"].dtype == torch.float32
    assert tstate.opt_state["nu"]["value.weight"].dtype == torch.bfloat16
    assert tstate.target_params["value.weight"].dtype == torch.bfloat16
    jstep = jtrain.build_train_step(jnet, jopt, target_sync_freq=2)
    tstep = ttrain.build_train_step(tnet, topt, target_sync_freq=2)
    for b in _np_batches():
        jstate, jm = jstep(jstate, _jbatch(b))
        tstate, tm = tstep(tstate, _tbatch(b))
        np.testing.assert_allclose(float(tm.loss), float(jm.loss), rtol=BF16_RTOL)
        np.testing.assert_allclose(tm.priorities.numpy(), np.asarray(jm.priorities),
                                   rtol=BF16_RTOL, atol=1e-6)
    jmaster = carry(jstate.opt_state[0])
    for k, m0 in master0.items():
        d_want = (jmaster[k] - m0).numpy()
        d_got = (tstate.opt_state["master"][k] - m0).numpy()
        np.testing.assert_allclose(d_got, d_want, rtol=BF16_RTOL,
                                   atol=BF16_RTOL * max(np.abs(d_want).max(), 1e-12), err_msg=k)
    for which, tree in (("params", jstate.params), ("target_params", jstate.target_params),
                        ("nu", jstate.opt_state[1][1][0].nu)):
        want = carry(tree)
        got = tstate.opt_state["nu"] if which == "nu" else getattr(tstate, which)
        for k in want:
            assert got[k].dtype == want[k].dtype == torch.bfloat16, (which, k)
            np.testing.assert_allclose(_f32(got[k]), _f32(want[k]), rtol=BF16_RTOL,
                                       atol=1e-6, err_msg=f"{which}.{k}")
    # The target synced at step 2 holds cast(params of step 2), not step 3's.
    assert not all(torch.equal(tstate.params[k], tstate.target_params[k])
                   for k in tstate.params)


def test_components_wire_the_lowp_knobs():
    cfg = ApexConfig()
    cfg.network = "conv"
    cfg.env.name = "catch:36"
    cfg.learner.device_replay = True
    cfg.replay.dedup = True
    cfg.replay.capacity = 1024
    cfg.learner.min_replay_mem_size = 64
    cfg.learner.steps_per_call = 2048
    cfg.learner.q_target_sync_freq = 2500
    cfg.learner.second_moment_dtype = "bfloat16"
    cfg.learner.target_dtype = "bfloat16"
    cfg.learner.param_dtype = "bfloat16"
    comps = build_components(cfg.validate(), device="cpu")
    st = comps.state
    assert comps.optimizer.float32_master
    assert comps.optimizer.second_moment_dtype == torch.bfloat16
    for k, v in st.params.items():
        assert v.dtype == torch.bfloat16 and st.target_params[k].dtype == torch.bfloat16
        assert st.opt_state["master"][k].dtype == torch.float32
        assert st.opt_state["nu"][k].dtype == torch.bfloat16
    learner = comps.make_fused_learner()
    assert type(learner).__name__ == "FusedDedupLearner"
    assert learner.replay.frames.shape == (1280, 36, 36, 1)
    # The fused loop's target sync rounds 2500 down to a multiple of K.
    assert learner.target_sync_freq == 2048
