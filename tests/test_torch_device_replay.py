"""The port's device replay against ``ape_x_dqn_tpu/replay/device.py``.

The same chunks go into both rings; the port's samplers get JAX's own
uniforms (``u``), rebuilt here from the same keys, since threefry draws
cannot be reproduced in torch.  Tolerances: ring contents, cursors and
sampled indices exact; IS weights atol 1e-6; masses rtol 1e-6 (float32
``pow`` in two libraries); fused-loop parameter updates rtol 1e-4 with atol
1e-4 of the largest update, as in ``test_torch_train_step.py``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ape_x_dqn_tpu.learner import train_step as jtrain
from ape_x_dqn_tpu.models import dueling as jdueling
from ape_x_dqn_tpu.replay import device as jdev
from ape_x_dqn_tpu.types import NStepTransition as JTransition
from ape_x_dqn_tpu_torch.learner import train_step as ttrain
from ape_x_dqn_tpu_torch.models import dueling as tdueling
from ape_x_dqn_tpu_torch.replay import device as tdev
from ape_x_dqn_tpu_torch.types import NStepTransition, TrainState
from ape_x_dqn_tpu_torch.weights import params_from_jax

from _torch_harness import port_deadline  # noqa: F401 — the per-test deadline, autouse

OBS = (6,)


def _chunk(M, seed=0, int_prio=False):
    r = np.random.default_rng(seed)
    fields = dict(
        obs=r.integers(0, 256, (M, *OBS), dtype=np.uint8),
        action=r.integers(0, 3, M).astype(np.int32),
        reward=r.normal(size=M).astype(np.float32),
        discount=np.full(M, 0.97, np.float32),
        next_obs=r.integers(0, 256, (M, *OBS), dtype=np.uint8),
    )
    prio = (r.integers(1, 20, M).astype(np.float32) if int_prio
            else (r.random(M) * 2 + 0.05).astype(np.float32))
    return fields, prio


def _both_add(jst, tst, fields, prio, alpha):
    jst = jdev.device_replay_add(jst, JTransition(**{k: jnp.asarray(v) for k, v in fields.items()}),
                                 jnp.asarray(prio), priority_exponent=alpha)
    tdev.device_replay_add(tst, NStepTransition(**{k: torch.from_numpy(v) for k, v in fields.items()}),
                           torch.from_numpy(prio), priority_exponent=alpha)
    return jst, tst


def _assert_rings_equal(jst, tst):
    for f in ("obs", "next_obs", "action", "reward", "discount"):
        np.testing.assert_array_equal(getattr(tst, f).numpy(), np.asarray(getattr(jst, f)))
    np.testing.assert_allclose(tst.mass.numpy(), np.asarray(jst.mass), rtol=1e-6)
    assert tst.cursor == int(jst.cursor) and tst.count == int(jst.count)


def test_ring_add_wraps_like_jax():
    C = 50
    jst = jdev.init_device_replay(C, OBS)
    tst = tdev.init_device_replay(C, OBS, device="cpu")
    for i, M in enumerate((20, 20, 20, 50)):   # wraps twice
        jst, tst = _both_add(jst, tst, *_chunk(M, seed=i), alpha=0.6)
        _assert_rings_equal(jst, tst)


def test_chunk_wider_than_ring_rejected():
    tst = tdev.init_device_replay(8, OBS, device="cpu")
    fields, prio = _chunk(9)
    with pytest.raises(ValueError, match="exceeds replay capacity"):
        tdev.device_replay_add(tst, NStepTransition(**{k: torch.from_numpy(v) for k, v in fields.items()}),
                               torch.from_numpy(prio))


@pytest.mark.parametrize("C,M,int_prio,alpha", [
    (1000, 700, False, 0.6),   # one sampler chunk: JAX's two-level == flat
    (3000, 2500, True, 1.0),   # integer masses: exact prefix sums, 3 chunks
])
def test_sample_many_matches_jax(C, M, int_prio, alpha):
    K, B, beta = 3, 16, 0.5
    jst = jdev.init_device_replay(C, OBS)
    tst = tdev.init_device_replay(C, OBS, device="cpu")
    jst, tst = _both_add(jst, tst, *_chunk(M, seed=1, int_prio=int_prio), alpha=alpha)
    rng = jax.random.PRNGKey(7)
    want = jdev.device_replay_sample_many(jst, rng, K, B, beta)
    u = torch.from_numpy(np.array(jax.random.uniform(rng, (K, B))))
    got = tdev.device_replay_sample_many(tst, K, B, beta, u=u)
    np.testing.assert_array_equal(got.indices.numpy(), np.asarray(want.indices))
    np.testing.assert_allclose(got.is_weights.numpy(), np.asarray(want.is_weights),
                               atol=1e-6, rtol=0)
    for f in ("obs", "action", "reward", "discount", "next_obs"):
        np.testing.assert_array_equal(getattr(got.transition, f).numpy(),
                                      np.asarray(getattr(want.transition, f)))
    assert int(got.indices.max()) < M  # zero-mass guard: never an empty slot


def test_sample_single_batch_is_k1_row():
    tst = tdev.init_device_replay(64, OBS, device="cpu")
    fields, prio = _chunk(40, seed=2)
    tdev.device_replay_add(tst, NStepTransition(**{k: torch.from_numpy(v) for k, v in fields.items()}),
                           torch.from_numpy(prio))
    u = torch.rand((1, 8), generator=torch.Generator().manual_seed(0))
    one = tdev.device_replay_sample(tst, 8, 0.4, u=u)
    many = tdev.device_replay_sample_many(tst, 1, 8, 0.4, u=u)
    np.testing.assert_array_equal(one.indices.numpy(), many.indices[0].numpy())
    assert one.transition.obs.shape == (8, *OBS)


def test_restamp_last_wins_matches_sequential():
    """Batched restamp == K sequential scatters (last write wins), and ==
    the JAX batched restamp."""
    C, K, B = 16, 6, 8
    jst = jdev.init_device_replay(C, (8,))
    tst = tdev.init_device_replay(C, (8,), device="cpu")
    ones = np.ones(C, np.float32)
    chunk = dict(obs=np.zeros((C, 8), np.uint8), action=np.zeros(C, np.int32),
                 reward=np.zeros(C, np.float32), discount=np.zeros(C, np.float32),
                 next_obs=np.zeros((C, 8), np.uint8))
    jst, tst = _both_add(jst, tst, chunk, ones, alpha=1.0)
    r = np.random.default_rng(0)
    indices = r.integers(0, C, (K, B)).astype(np.int32)  # heavy duplicates
    prios = r.random((K, B)).astype(np.float32) + 0.1
    seq = tdev.DeviceReplayState(**{**vars(tst), "mass": tst.mass.clone()})
    for k in range(K):
        tdev.device_replay_update_priorities(seq, torch.from_numpy(indices[k]),
                                             torch.from_numpy(prios[k]), priority_exponent=1.0)
    tdev.device_replay_restamp_last(tst, torch.from_numpy(indices),
                                    torch.from_numpy(prios), priority_exponent=1.0)
    np.testing.assert_allclose(tst.mass.numpy(), seq.mass.numpy(), rtol=1e-6)
    jst = jdev.device_replay_restamp_last(jst, jnp.asarray(indices), jnp.asarray(prios),
                                          priority_exponent=1.0)
    np.testing.assert_allclose(tst.mass.numpy(), np.asarray(jst.mass), rtol=1e-6)


def _learners(seed=0):
    jnet = jdueling.build_network("mlp", 3, hidden_sizes=(16,))
    jopt = jtrain.make_optimizer("rmsprop")
    jstate = jtrain.init_train_state(jnet, jopt, jax.random.PRNGKey(seed),
                                     jnp.zeros((1, *OBS), jnp.uint8))
    tnet = tdueling.build_network("mlp", 3, OBS, hidden_sizes=(16,))
    topt = ttrain.make_optimizer("rmsprop")
    params = params_from_jax(tnet, jax.device_get(jstate.params))
    tstate = TrainState(params=params, target_params={k: v.clone() for k, v in params.items()},
                        opt_state=topt.init(params), step=0, seed=seed)
    jstep = jtrain.build_train_step(jnet, jopt, sync_in_step=False, jit=False)
    tstep = ttrain.build_train_step(tnet, topt, sync_in_step=False)
    return (jstate, jstep), (tstate, tstep), tnet


def _jax_uniforms(rng, K, B, sample_ahead):
    """The uniforms JAX's fused_scan_body draws from ``rng``."""
    if sample_ahead:
        return np.array(jax.random.uniform(rng, (K, B)))
    return np.stack([np.asarray(jax.random.uniform(k, (1, B)))[0]
                     for k in jax.random.split(rng, K)])


@pytest.mark.parametrize("sample_ahead", [False, True])
def test_fused_scan_body_matches_jax(sample_ahead):
    """Two K=4 calls with target_sync_freq=6: the first call (steps 0→4)
    does not cross a multiple of 6, the second (4→8) does and syncs."""
    C, K, B, freq = 512, 4, 8, 6
    (jstate, jstep), (tstate, tstep), tnet = _learners()
    init = {k: v.clone() for k, v in tstate.params.items()}
    jrep = jdev.init_device_replay(C, OBS)
    trep = tdev.init_device_replay(C, OBS, device="cpu")
    jrep, trep = _both_add(jrep, trep, *_chunk(400, seed=3), alpha=0.6)
    knobs = dict(steps_per_call=K, batch_size=B, priority_exponent=0.6,
                 target_sync_freq=freq, sample_ahead=sample_ahead)
    for call in range(2):
        rng = jax.random.PRNGKey(100 + call)
        jstate, jrep, jm = jdev.fused_scan_body(jstep, jstate, jrep, 0.4, rng, **knobs)
        u = torch.from_numpy(_jax_uniforms(rng, K, B, sample_ahead))
        tstate, trep, tm = tdev.fused_scan_body(tstep, tstate, trep, 0.4, u=u, **knobs)
        np.testing.assert_allclose(tm.loss.numpy(), np.asarray(jm.loss), rtol=1e-4)
        np.testing.assert_allclose(tm.priorities.numpy(), np.asarray(jm.priorities),
                                   rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(trep.mass.numpy(), np.asarray(jrep.mass),
                                   rtol=1e-4, atol=1e-6)
        synced = all(torch.equal(tstate.params[k], tstate.target_params[k]) for k in init)
        assert synced == (call == 1)
    assert tstate.step == int(jstate.step) == 2 * K
    for which in ("params", "target_params"):
        want = params_from_jax(tnet, jax.device_get(getattr(jstate, which)))
        for k, w in want.items():
            d_want = (w - init[k]).numpy()
            d_got = (getattr(tstate, which)[k] - init[k]).numpy()
            np.testing.assert_allclose(d_got, d_want, rtol=1e-4,
                                       atol=1e-4 * max(np.abs(d_want).max(), 1e-12))


def test_build_fused_learn_step_with_ingest_equals_add_then_scan():
    (_, _), (tstate_a, tstep), _ = _learners()
    (_, _), (tstate_b, _), _ = _learners()
    fields, prio = _chunk(64, seed=4)
    trans = NStepTransition(**{k: torch.from_numpy(v) for k, v in fields.items()})
    u = torch.rand((2, 8), generator=torch.Generator().manual_seed(1))
    knobs = dict(batch_size=8, steps_per_call=2, target_sync_freq=None)
    rep_a = tdev.init_device_replay(128, OBS, device="cpu")
    fused = tdev.build_fused_learn_step(tstep, include_ingest=True, **knobs)
    tstate_a, rep_a, m_a = fused(tstate_a, rep_a, trans, torch.from_numpy(prio), 0.4, u=u)
    rep_b = tdev.init_device_replay(128, OBS, device="cpu")
    tdev.device_replay_add(rep_b, trans, torch.from_numpy(prio))
    plain = tdev.build_fused_learn_step(tstep, include_ingest=False, **knobs)
    tstate_b, rep_b, m_b = plain(tstate_b, rep_b, 0.4, u=u)
    torch.testing.assert_close(m_a.loss, m_b.loss, rtol=0, atol=0)
    torch.testing.assert_close(rep_a.mass, rep_b.mass, rtol=0, atol=0)
