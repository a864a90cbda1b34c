"""The port's learner step, optimizer and step math against the JAX package.

Identical params (carried with ``weights.params_from_jax``) and identical
numpy batches go through ``build_train_step`` of both packages in float32
compute.  Tolerances: losses and priorities rtol 1e-4; parameter UPDATES
(params after minus params before) rtol 1e-4 with atol 1e-4 of the largest
update — the update, not the params, because an RMSProp step moves a
weight by ~lr (6e-5), far below 1e-4 of its magnitude.  Adam gets atol
1e-3 of the largest update: its step lr·m̂/(√v̂+ε) divides a gradient by
its own magnitude, so a component whose gradient sits at the summation-
order noise floor moves by an ill-conditioned ratio.
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
from ape_x_dqn_tpu.ops import exploration as jexpl
from ape_x_dqn_tpu.ops import losses as jlosses
from ape_x_dqn_tpu.ops import nstep as jnstep
from ape_x_dqn_tpu.types import NStepTransition as JTransition
from ape_x_dqn_tpu.types import PrioritizedBatch as JBatch
from ape_x_dqn_tpu_torch.learner import train_step as ttrain
from ape_x_dqn_tpu_torch.models import dueling as tdueling
from ape_x_dqn_tpu_torch.ops import exploration as texpl
from ape_x_dqn_tpu_torch.ops import losses as tlosses
from ape_x_dqn_tpu_torch.ops import nstep as tnstep
from ape_x_dqn_tpu_torch.types import NStepTransition, PrioritizedBatch, TrainState
from ape_x_dqn_tpu_torch.weights import params_from_jax

OBS, A, B = (36, 36, 1), 3, 8


def _np_batches(seed=0, n=3, big_reward_at=1):
    r = np.random.default_rng(seed)
    out = []
    for i in range(n):
        reward = r.normal(size=B).astype(np.float32)
        if i == big_reward_at:
            reward *= 1e3  # gradient norm well above the clip at 40
        out.append(dict(
            obs=r.integers(0, 256, (B, *OBS), dtype=np.uint8),
            action=r.integers(0, A, B).astype(np.int32),
            reward=reward,
            discount=np.full(B, 0.97, np.float32) * (r.random(B) > 0.2),
            next_obs=r.integers(0, 256, (B, *OBS), dtype=np.uint8),
            indices=np.arange(B, dtype=np.int32),
            is_weights=(r.random(B) * 0.9 + 0.1).astype(np.float32),
        ))
    return out


def _jbatch(b):
    return JBatch(
        transition=JTransition(**{k: jnp.asarray(b[k]) for k in
                                  ("obs", "action", "reward", "discount", "next_obs")}),
        indices=jnp.asarray(b["indices"]), is_weights=jnp.asarray(b["is_weights"]))


def _tbatch(b):
    return PrioritizedBatch(
        transition=NStepTransition(**{k: torch.from_numpy(b[k]) for k in
                                      ("obs", "action", "reward", "discount", "next_obs")}),
        indices=torch.from_numpy(b["indices"]), is_weights=torch.from_numpy(b["is_weights"]))


@pytest.mark.parametrize("opt_kind,loss_kind,sync_in_step", [
    ("rmsprop", "huber", True),
    ("rmsprop", "squared", False),
    ("adam", "huber", True),
])
def test_three_steps_match_jax(opt_kind, loss_kind, sync_in_step):
    jnet = jdueling.build_network("conv", A, channels=(8, 8, 8), hidden=32,
                                  compute_dtype=jnp.float32)
    jopt = jtrain.make_optimizer(opt_kind)
    jstate = jtrain.init_train_state(jnet, jopt, jax.random.PRNGKey(0),
                                     jnp.zeros((1, *OBS), jnp.uint8))
    tnet = tdueling.build_network("conv", A, OBS, channels=(8, 8, 8), hidden=32,
                                  compute_dtype=torch.float32)
    topt = ttrain.make_optimizer(opt_kind)
    params = params_from_jax(tnet, jax.device_get(jstate.params))
    tstate = TrainState(params=params,
                        target_params={k: v.clone() for k, v in params.items()},
                        opt_state=topt.init(params), step=0, seed=0)
    init = {k: v.clone() for k, v in params.items()}
    jstep = jtrain.build_train_step(jnet, jopt, loss_kind=loss_kind,
                                    target_sync_freq=2, sync_in_step=sync_in_step)
    tstep = ttrain.build_train_step(tnet, topt, loss_kind=loss_kind,
                                    target_sync_freq=2, sync_in_step=sync_in_step)
    for b in _np_batches():
        jstate, jm = jstep(jstate, _jbatch(b))
        tstate, tm = tstep(tstate, _tbatch(b))
        np.testing.assert_allclose(float(tm.loss), float(jm.loss), rtol=1e-4)
        np.testing.assert_allclose(tm.priorities.numpy(), np.asarray(jm.priorities),
                                   rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(float(tm.mean_q), float(jm.mean_q), rtol=1e-4, atol=1e-6)
    assert tstate.step == int(jstate.step) == 3
    atol = 1e-3 if opt_kind == "adam" else 1e-4
    for which in ("params", "target_params"):
        want = params_from_jax(tnet, jax.device_get(getattr(jstate, which)))
        got = getattr(tstate, which)
        for k in want:
            d_want = (want[k] - init[k]).numpy()
            d_got = (got[k] - init[k]).numpy()
            np.testing.assert_allclose(
                d_got, d_want, rtol=1e-4, atol=atol * max(np.abs(d_want).max(), 1e-12),
                err_msg=f"{which}.{k}")


@pytest.mark.parametrize("kind", ["rmsprop", "adam"])
def test_optimizer_matches_optax_on_given_grads(kind):
    """Same gradients into both optimizers: a first step with tiny
    gradients (ν ≈ 0, where the ε placement shows), then one whose global
    norm is far above the clip at 40, then an ordinary one."""
    r = np.random.default_rng(3)
    shapes = {"a": (4, 3), "b": (5,)}
    p0 = {k: r.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    scales = (1e-5, 1e3, 1.0)
    grads = [{k: (r.normal(size=s) * sc).astype(np.float32) for k, s in shapes.items()}
             for sc in scales]
    jopt = jtrain.make_optimizer(kind)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    jst = jopt.init(jp)
    topt = ttrain.make_optimizer(kind)
    tp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    tst = topt.init(tp)
    for g in grads:
        upd, jst = jopt.update({k: jnp.asarray(v) for k, v in g.items()}, jst, jp)
        jp = optax.apply_updates(jp, upd)
        topt.update_(tp, {k: torch.from_numpy(v) for k, v in g.items()}, tst)
        for k in shapes:
            d_want = np.asarray(jp[k]) - p0[k]
            np.testing.assert_allclose(tp[k].numpy() - p0[k], d_want, rtol=1e-4,
                                       atol=1e-4 * np.abs(d_want).max())
    assert float(optax.global_norm(grads[1])) > 40.0


def test_rmsprop_eps_inside_sqrt_differs_from_torch_optim():
    """The trap the hand-written optimizer exists for: torch.optim.RMSprop
    puts ε outside the square root."""
    p = torch.zeros(3)
    g = torch.full((3,), 1e-4)
    opt = ttrain.make_optimizer("rmsprop", max_grad_norm=None)
    st = opt.init({"p": p})
    opt.update_({"p": p}, {"p": g}, st)
    nu = 0.05 * 1e-8
    want = -6.25e-5 * 1e-4 / np.sqrt(nu + 1.5e-7)
    np.testing.assert_allclose(float(p[0]), want, rtol=1e-5)
    assert abs(want - (-6.25e-5 * 1e-4 / (np.sqrt(nu) + 1.5e-7))) > 1e-3 * abs(want)


def test_losses_match_jax():
    r = np.random.default_rng(4)
    qn, qt = r.normal(size=(6, 4)).astype(np.float32), r.normal(size=(6, 4)).astype(np.float32)
    q = r.normal(size=(6, 4)).astype(np.float32)
    rew, disc = r.normal(size=6).astype(np.float32), r.random(6).astype(np.float32)
    act = r.integers(0, 4, 6).astype(np.int32)
    w = r.random(6).astype(np.float32)
    jt = jlosses.double_q_target(*map(jnp.asarray, (qn, qt, rew, disc)))
    tt = tlosses.double_q_target(*map(torch.from_numpy, (qn, qt, rew, disc)))
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=1e-6)
    jd = jlosses.td_error(jnp.asarray(q), jnp.asarray(act), jt)
    td = tlosses.td_error(torch.from_numpy(q), torch.from_numpy(act), tt)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-6, atol=1e-7)
    for kind in ("huber", "squared"):
        np.testing.assert_allclose(
            float(tlosses.td_loss(td * 3, torch.from_numpy(w), kind=kind)),
            float(jlosses.td_loss(jd * 3, jnp.asarray(w), kind=kind)), rtol=1e-6)
    np.testing.assert_allclose(tlosses.priorities_from_td(td).numpy(),
                               np.asarray(jlosses.priorities_from_td(jd)), rtol=1e-6)


def test_nstep_returns_match_jax():
    r = np.random.default_rng(5)
    rew = r.normal(size=20).astype(np.float32)
    disc = (0.99 * (r.random(20) > 0.15)).astype(np.float32)
    for n in (1, 3, 5):
        jr, jb = jnstep.nstep_returns(jnp.asarray(rew), jnp.asarray(disc), n)
        tr, tb = tnstep.nstep_returns(torch.from_numpy(rew), torch.from_numpy(disc), n)
        nr, nb = tnstep.nstep_returns_np(rew, disc, n)
        for got in (tr.numpy(), nr):
            np.testing.assert_allclose(got, np.asarray(jr), rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=1e-6)
        np.testing.assert_allclose(nb, np.asarray(jb), rtol=1e-6)
    with pytest.raises(ValueError, match="horizon"):
        tnstep.nstep_returns_np(rew[:2], disc[:2], 3)


def test_exploration_matches_jax():
    for n in (1, 2, 8):
        np.testing.assert_allclose(texpl.epsilon_ladder(0.4, 7.0, n).numpy(),
                                   np.asarray(jexpl.epsilon_ladder(0.4, 7.0, n)), rtol=1e-6)
    q = torch.from_numpy(np.random.default_rng(6).normal(size=(16, 5)).astype(np.float32))
    greedy = texpl.epsilon_greedy(q, 0.0)
    np.testing.assert_array_equal(greedy.numpy(), q.argmax(-1).numpy())
    g = torch.Generator().manual_seed(0)
    explored = texpl.epsilon_greedy(q, 1.0, generator=g)
    assert explored.dtype == torch.int32 and int(explored.max()) < 5
