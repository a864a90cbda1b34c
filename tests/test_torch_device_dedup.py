"""The port's frame-dedup device ring against
``ape_x_dqn_tpu/replay/device_dedup.py``.

The same frame and transition blocks go into both rings; the port's sampler
gets JAX's own uniforms (``u``), rebuilt from the same keys.  Tolerances:
ring contents, cursors, counters, the liveness sweep's dead set, sampled
indices and gathered frames exact; masses rtol 1e-6 (float32 ``pow`` in
two libraries); IS weights atol 1e-6; fused-loop metrics and parameter
updates as in ``test_torch_device_replay.py`` (rtol 1e-4, atol 1e-4 of the
largest update).  The port's dedup fused call equals its own double-store
fused call on one ingest stream exactly (the oracle of the JAX package's
``tests/test_device_dedup.py:161``).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ape_x_dqn_tpu.replay import device_dedup as jdd
from ape_x_dqn_tpu_torch.replay import device as tdev
from ape_x_dqn_tpu_torch.replay import device_dedup as tdd
from ape_x_dqn_tpu_torch.types import NStepTransition
from ape_x_dqn_tpu_torch.weights import params_from_jax
from test_torch_device_replay import _jax_uniforms, _learners

from _torch_harness import port_deadline  # noqa: F401 — the per-test deadline, autouse

OBS = (6,)


def frame(seq: int) -> np.ndarray:
    return np.full(OBS, seq % 251, np.uint8)


def make_stream(n_chunks=6, n_tx=8, seed=0, int_prio=False):
    """Chunk i: n_tx transitions over n_tx + 1 fresh frames, obs = frame(s),
    next = frame(s + 1); returns (dedup blocks, dense twins, priorities)."""
    rng = np.random.default_rng(seed)
    dedup, dense, prios = [], [], []
    fbase = 0
    for _ in range(n_chunks):
        frames = np.stack([frame(fbase + i) for i in range(n_tx + 1)])
        obs_ref = fbase + np.arange(n_tx)
        next_ref = obs_ref + 1
        action = rng.integers(0, 3, n_tx).astype(np.int32)
        reward = rng.normal(size=n_tx).astype(np.float32)
        discount = np.full(n_tx, 0.97, np.float32)
        p = (rng.integers(1, 20, n_tx).astype(np.float32) if int_prio
             else (np.abs(rng.normal(size=n_tx)) + 0.1).astype(np.float32))
        dedup.append((frames, obs_ref, next_ref, action, reward, discount))
        dense.append(NStepTransition(obs=np.stack([frame(s) for s in obs_ref]), action=action,
                                     reward=reward, discount=discount,
                                     next_obs=np.stack([frame(s) for s in next_ref])))
        prios.append(p)
        fbase += n_tx + 1
    return dedup, dense, prios


def both_ingest(jst, tst, stream, prios, alpha=0.6, shift=0):
    """The same blocks into both rings (refs shifted by ``shift`` mod Q)."""
    Q = jst.seq_modulus
    assert tst.seq_modulus == Q
    for (frames, oref, nref, a, r, d), p in zip(stream, prios):
        o, n = (oref + shift) % Q, (nref + shift) % Q
        jst = jdd.dedup_device_add_frames(jst, jnp.asarray(frames))
        jst = jdd.dedup_device_add_transitions(
            jst, jnp.asarray(o, jnp.int32), jnp.asarray(n, jnp.int32), jnp.asarray(a),
            jnp.asarray(r), jnp.asarray(d), jnp.asarray(p), priority_exponent=alpha)
        tdd.dedup_device_add_frames(tst, torch.from_numpy(frames))
        tdd.dedup_device_add_transitions(
            tst, torch.from_numpy(o.astype(np.int32)), torch.from_numpy(n.astype(np.int32)),
            torch.from_numpy(a), torch.from_numpy(r), torch.from_numpy(d),
            torch.from_numpy(p), priority_exponent=alpha)
        assert_rings_equal(jst, tst)
    return jst, tst


def assert_rings_equal(jst, tst):
    for f in ("frames", "obs_ref", "next_ref", "action", "reward", "discount"):
        np.testing.assert_array_equal(getattr(tst, f).numpy(), np.asarray(getattr(jst, f)),
                                      err_msg=f)
    jm = np.asarray(jst.mass)
    np.testing.assert_array_equal(tst.mass.numpy() == 0, jm == 0)   # the dead set
    np.testing.assert_allclose(tst.mass.numpy(), jm, rtol=1e-6)
    assert (tst.cursor, tst.count, tst.fcount) == (int(jst.cursor), int(jst.count),
                                                  int(jst.fcount))


def test_ring_wraps_frames_and_crosses_the_seq_modulus_like_jax():
    """12 chunks × 9 frames into a 40-frame ring that starts 50 frames below
    Q: the frame ring wraps twice, the seq counter crosses Q, the
    transition ring (64) wraps, and the sweep kills the aged-out rows."""
    C, Cf = 64, 40
    jst = jdd.init_dedup_device_replay(C, OBS, frame_capacity=Cf)
    tst = tdd.init_dedup_device_replay(C, OBS, frame_capacity=Cf, device="cpu")
    Q = tst.seq_modulus
    assert Q == (2**30 // Cf) * Cf
    start = Q - 50
    jst = jst.replace(fcount=jnp.int32(start))
    tst.fcount = start
    dedup, _, prios = make_stream(n_chunks=12, n_tx=8, seed=1)
    jst, tst = both_ingest(jst, tst, dedup, prios, shift=start)
    assert tst.fcount == (start + 12 * 9) % Q < start          # crossed Q
    mass = tst.mass.numpy()
    assert (mass == 0).any() and (mass > 0).any()


def test_sweep_kills_exactly_the_frame_dead_rows():
    dedup, _, prios = make_stream(n_chunks=8, n_tx=8)
    tst = tdd.init_dedup_device_replay(64, OBS, frame_capacity=32, device="cpu")
    for (frames, oref, nref, a, r, d), p in zip(dedup, prios):
        tdd.dedup_device_add_frames(tst, torch.from_numpy(frames))
        tdd.dedup_device_add_transitions(tst, *(torch.from_numpy(np.asarray(x)) for x in (
            oref.astype(np.int32), nref.astype(np.int32), a, r, d, p)))
    age = (tst.fcount - tst.obs_ref.numpy()) % tst.seq_modulus
    rows = np.arange(64)
    dead = age[rows] > 32
    assert dead.any() and (~dead).any()
    assert (tst.mass.numpy()[dead] == 0).all() and (tst.mass.numpy()[~dead] > 0).all()


@pytest.mark.parametrize("int_prio,alpha", [(False, 0.6), (True, 1.0)])
def test_dedup_sample_many_matches_jax(int_prio, alpha):
    K, B, beta = 3, 16, 0.5
    C, Cf = 96, 80
    jst = jdd.init_dedup_device_replay(C, OBS, frame_capacity=Cf)
    tst = tdd.init_dedup_device_replay(C, OBS, frame_capacity=Cf, device="cpu")
    dedup, _, prios = make_stream(n_chunks=10, n_tx=8, seed=2, int_prio=int_prio)
    jst, tst = both_ingest(jst, tst, dedup, prios, alpha=alpha)
    rng = jax.random.PRNGKey(7)
    want = jdd.dedup_sample_many(jst, rng, K, B, beta)
    u = torch.from_numpy(np.array(jax.random.uniform(rng, (K, B))))
    got = tdd.dedup_sample_many(tst, K, B, beta, u=u)
    np.testing.assert_array_equal(got.indices.numpy(), np.asarray(want.indices))
    np.testing.assert_allclose(got.is_weights.numpy(), np.asarray(want.is_weights),
                               atol=1e-6, rtol=0)
    for f in ("obs", "action", "reward", "discount", "next_obs"):
        np.testing.assert_array_equal(getattr(got.transition, f).numpy(),
                                      np.asarray(getattr(want.transition, f)), err_msg=f)
    # Dead rows (mass 0) are never drawn; gathered frames are the refs' own.
    idx = got.indices.numpy().reshape(-1)
    assert (tst.mass.numpy()[idx] > 0).all()
    oref = tst.obs_ref.numpy()[idx]
    np.testing.assert_array_equal(got.transition.obs.numpy().reshape(-1, *OBS),
                                  np.stack([frame(s) for s in oref]))


def test_add_guards():
    tst = tdd.init_dedup_device_replay(8, OBS, frame_capacity=10, device="cpu")
    with pytest.raises(ValueError, match="frame block 11 exceeds frame ring 10"):
        tdd.dedup_device_add_frames(tst, torch.zeros((11, *OBS), dtype=torch.uint8))
    z = torch.zeros(9, dtype=torch.int32)
    with pytest.raises(ValueError, match="chunk of 9 transitions exceeds replay capacity 8"):
        tdd.dedup_device_add_transitions(tst, z, z, z, z.float(), z.float(), z.float())


def test_footprint_is_frame_ratio_over_two_of_the_double_store():
    dd = tdd.init_dedup_device_replay(1024, (8, 8, 1), frame_ratio=1.25, device="cpu")
    ds = tdev.init_device_replay(1024, (8, 8, 1), device="cpu")
    assert dd.nbytes()["frames"] == pytest.approx(0.625 * (ds.obs.nbytes + ds.next_obs.nbytes),
                                                  rel=0.01)
    assert dd.nbytes()["columns"] == 1024 * 24


@pytest.mark.parametrize("sample_ahead", [False, True])
def test_dedup_fused_scan_matches_jax(sample_ahead):
    """Two K=4 calls of the dedup fused loop with target_sync_freq=6 (the
    second call syncs), against the JAX dedup builder."""
    C, K, B, freq = 128, 4, 8, 6
    (jstate, jstep), (tstate, tstep), tnet = _learners()
    init = {k: v.clone() for k, v in tstate.params.items()}
    jst = jdd.init_dedup_device_replay(C, OBS, frame_capacity=160)
    tst = tdd.init_dedup_device_replay(C, OBS, frame_capacity=160, device="cpu")
    dedup, _, prios = make_stream(n_chunks=10, n_tx=8, seed=3)
    jst, tst = both_ingest(jst, tst, dedup, prios)
    jfused = jdd.build_dedup_fused_learn_step(jstep, B, steps_per_call=K, target_sync_freq=freq,
                                              sample_ahead=sample_ahead, jit=False)
    tfused = tdd.build_dedup_fused_learn_step(tstep, B, steps_per_call=K, target_sync_freq=freq,
                                              sample_ahead=sample_ahead)
    for call in range(2):
        rng = jax.random.PRNGKey(100 + call)
        jstate, jst, jm = jfused(jstate, jst, 0.4, rng)
        u = torch.from_numpy(_jax_uniforms(rng, K, B, sample_ahead))
        tstate, tst, tm = tfused(tstate, tst, 0.4, u=u)
        np.testing.assert_allclose(tm.loss.numpy(), np.asarray(jm.loss), rtol=1e-4)
        np.testing.assert_allclose(tm.priorities.numpy(), np.asarray(jm.priorities),
                                   rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(tst.mass.numpy(), np.asarray(jst.mass), rtol=1e-4, atol=1e-6)
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


@pytest.mark.parametrize("sample_ahead", [False, True])
def test_dedup_fused_equals_double_store_fused(sample_ahead):
    """One content stream into both layouts, the same uniforms: the K-step
    loops give identical metrics, params and post-restamp masses."""
    C, K, B = 64, 5, 8
    dedup, dense, prios = make_stream(n_chunks=6, n_tx=8)
    dd = tdd.init_dedup_device_replay(C, OBS, frame_capacity=128, device="cpu")
    ds = tdev.init_device_replay(C, OBS, device="cpu")
    for (frames, oref, nref, a, r, d), t, p in zip(dedup, dense, prios):
        tdd.dedup_device_add_frames(dd, torch.from_numpy(frames))
        tdd.dedup_device_add_transitions(dd, *(torch.from_numpy(np.asarray(x)) for x in (
            oref.astype(np.int32), nref.astype(np.int32), a, r, d, p)))
        tdev.device_replay_add(ds, t.map(torch.from_numpy), torch.from_numpy(p))
    (_, _), (state_a, step_a), _ = _learners()
    (_, _), (state_b, step_b), _ = _learners()
    fused_ds = tdev.build_fused_learn_step(step_a, B, steps_per_call=K, target_sync_freq=10,
                                           include_ingest=False, sample_ahead=sample_ahead)
    fused_dd = tdd.build_dedup_fused_learn_step(step_b, B, steps_per_call=K, target_sync_freq=10,
                                                sample_ahead=sample_ahead)
    gen = torch.Generator().manual_seed(42)
    for i in range(3):
        u = torch.rand((K, B), generator=gen)
        state_a, ds, m_a = fused_ds(state_a, ds, 0.4, u=u)
        state_b, dd, m_b = fused_dd(state_b, dd, 0.4, u=u)
        assert torch.equal(m_a.priorities, m_b.priorities), f"call {i}"
        for k in state_a.params:
            assert torch.equal(state_a.params[k], state_b.params[k]), (i, k)
    assert torch.equal(ds.mass, dd.mass)
    assert state_a.step == state_b.step == 15


@pytest.mark.parametrize("sample_ahead", [False, True])
def test_fused_call_never_draws_a_frame_dead_row(sample_ahead):
    """Rows whose frames the ring overwrote have mass 0 after the sweep; a
    fused call never draws them, so its restamp leaves them at 0 while it
    moves live rows."""
    (_, _), (state, step), _ = _learners()
    dedup, _, prios = make_stream(n_chunks=8, n_tx=8, seed=5)
    ring = tdd.init_dedup_device_replay(64, OBS, frame_capacity=32, device="cpu")
    for (frames, oref, nref, a, r, d), p in zip(dedup, prios):
        tdd.dedup_device_add_frames(ring, torch.from_numpy(frames))
        tdd.dedup_device_add_transitions(ring, *(torch.from_numpy(np.asarray(x)) for x in (
            oref.astype(np.int32), nref.astype(np.int32), a, r, d, p)))
    before = ring.mass.clone()
    dead = before == 0
    assert dead.any() and (~dead).any()
    fused = tdd.build_dedup_fused_learn_step(step, 8, steps_per_call=4,
                                             sample_ahead=sample_ahead)
    u = torch.rand((4, 8), generator=torch.Generator().manual_seed(3))
    state, ring, m = fused(state, ring, 0.4, u=u)
    assert torch.isfinite(m.loss).all()
    assert (ring.mass[dead] == 0).all()
    assert (ring.mass[~dead] != before[~dead]).any()
