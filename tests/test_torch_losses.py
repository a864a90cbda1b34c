"""Twins of ``tests/test_losses.py``: the port's ``ops/losses.py`` against the
JAX package's ``ops/losses.py`` on the same numpy inputs.

Each test runs the JAX test's literal case through both packages and holds
the port to the JAX test's own expectation, then feeds a batch drawn from a
seeded ``numpy`` generator to both.  Float outputs agree within rtol 1e-6
(atol 1e-6): the same float32 elementwise math, summed in a different order
only in the mean of ``td_loss``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

from ape_x_dqn_tpu.ops import losses as jlosses
from ape_x_dqn_tpu_torch.ops import losses as tlosses

RTOL = ATOL = 1e-6


def _rng(seed: int):
    return np.random.default_rng(seed)


def _both(fn_name: str, *arrays, **kw):
    """``fn_name`` of each package on the same numpy arrays, as numpy."""
    j = getattr(jlosses, fn_name)(*map(jnp.asarray, arrays), **kw)
    t = getattr(tlosses, fn_name)(*map(torch.from_numpy, arrays), **kw)
    return np.asarray(j), t.detach().numpy()


def _batch(seed: int, B: int = 64, A: int = 6):
    r = _rng(seed)
    return (r.normal(size=(B, A)).astype(np.float32), r.normal(size=(B, A)).astype(np.float32),
            r.normal(size=B).astype(np.float32),
            (0.99 ** 3 * (r.random(B) > 0.1)).astype(np.float32))


def test_double_q_uses_online_argmax_target_eval():
    args = (np.array([[1.0, 5.0, 2.0]], np.float32), np.array([[10.0, 20.0, 30.0]], np.float32),
            np.array([1.0], np.float32), np.array([0.5], np.float32))
    j, t = _both("double_q_target", *args)
    np.testing.assert_allclose(t, [11.0])
    np.testing.assert_allclose(t, j, rtol=RTOL, atol=ATOL)
    j, t = _both("double_q_target", *_batch(0))
    np.testing.assert_allclose(t, j, rtol=RTOL, atol=ATOL)


def test_zero_discount_means_no_bootstrap():
    q = np.full((2, 4), 100.0, np.float32)
    j, t = _both("double_q_target", q, q, np.array([3.0, -1.0], np.float32),
                 np.zeros(2, np.float32))
    np.testing.assert_allclose(t, [3.0, -1.0])
    np.testing.assert_array_equal(t, j)
    qo, qt, rew, _ = _batch(1)
    j, t = _both("double_q_target", qo, qt, rew, np.zeros_like(rew))
    np.testing.assert_array_equal(t, rew)
    np.testing.assert_array_equal(t, j)


def test_max_q_target():
    j, t = _both("max_q_target", np.array([[1.0, 9.0]], np.float32),
                 np.array([1.0], np.float32), np.array([0.1], np.float32))
    np.testing.assert_allclose(t, [1.9], rtol=1e-6)
    np.testing.assert_allclose(t, j, rtol=RTOL, atol=ATOL)
    q, _, rew, disc = _batch(2)
    j, t = _both("max_q_target", q, rew, disc)
    np.testing.assert_allclose(t, j, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(t, rew + disc * q.max(-1), rtol=RTOL, atol=ATOL)


def test_td_error_gathers_taken_action():
    q = np.array([[1.0, 2.0], [3.0, 4.0]], np.float32)
    j, t = _both("td_error", q, np.array([1, 0], np.int32), np.zeros(2, np.float32))
    np.testing.assert_allclose(t, [2.0, 3.0])
    np.testing.assert_array_equal(t, j)
    q, _, tgt, _ = _batch(3)
    act = _rng(4).integers(0, q.shape[1], q.shape[0]).astype(np.int32)
    j, t = _both("td_error", q, act, tgt)
    np.testing.assert_allclose(t, j, rtol=RTOL, atol=ATOL)


def test_huber_matches_quadratic_inside_kappa():
    j, t = _both("huber", np.array([-0.5, 0.5, 2.0], np.float32), kappa=1.0)
    np.testing.assert_allclose(t[:2], 0.5 * 0.25, rtol=1e-6)
    np.testing.assert_allclose(t[2], 0.5 + 1.0 * (2.0 - 1.0), rtol=1e-6)
    np.testing.assert_allclose(t, j, rtol=RTOL, atol=ATOL)
    d = (3.0 * _rng(5).normal(size=256)).astype(np.float32)
    for kappa in (0.5, 1.0, 2.0):
        j, t = _both("huber", d, kappa=kappa)
        np.testing.assert_allclose(t, j, rtol=RTOL, atol=ATOL)


def test_is_weights_scale_loss():
    d = np.array([1.0, 1.0], np.float32)
    ju, tu = _both("td_loss", d, kind="squared")
    jw, tw = _both("td_loss", d, np.array([2.0, 2.0], np.float32), kind="squared")
    np.testing.assert_allclose(float(tw), 2 * float(tu))
    np.testing.assert_allclose([tu, tw], [ju, jw], rtol=RTOL, atol=ATOL)
    r = _rng(6)
    d = r.normal(size=128).astype(np.float32)
    w = r.random(128).astype(np.float32)
    for kind in ("huber", "squared"):
        j, t = _both("td_loss", d, w, kind=kind)
        np.testing.assert_allclose(t, j, rtol=RTOL, atol=ATOL)


def test_priorities_per_transition_not_collapsed():
    # The reference collapses batch priorities to one value (SURVEY §2.8).
    j, t = _both("priorities_from_td", np.array([1.0, -2.0, 3.0], np.float32), epsilon=0.0)
    np.testing.assert_allclose(t, [1.0, 2.0, 3.0])
    assert len(set(t.tolist())) == 3
    np.testing.assert_array_equal(t, j)
    d = _rng(7).normal(size=64).astype(np.float32)
    j, t = _both("priorities_from_td", d, epsilon=1e-6)
    np.testing.assert_allclose(t, j, rtol=RTOL, atol=ATOL)


def test_target_is_stop_gradiented():
    q = np.array([[1.0, 2.0]], np.float32)

    def f(q_next):
        return jnp.sum(jlosses.double_q_target(q_next, q_next, jnp.zeros(1), jnp.ones(1)))

    np.testing.assert_allclose(np.asarray(jax.grad(f)(jnp.asarray(q))), np.zeros((1, 2)))
    q_next = torch.from_numpy(q).requires_grad_(True)
    for t in (tlosses.double_q_target(q_next, q_next, torch.zeros(1), torch.ones(1)),
              tlosses.max_q_target(q_next, torch.zeros(1), torch.ones(1))):
        assert not t.requires_grad and t.grad_fn is None
    # The loss reaches the online Q-values only, through δ.
    q_sel = torch.from_numpy(q).requires_grad_(True)
    tgt = tlosses.double_q_target(q_next, q_next, torch.zeros(1), torch.ones(1))
    loss = tlosses.td_loss(tlosses.td_error(q_sel, torch.tensor([0]), tgt), kind="squared")
    g_sel, g_next = torch.autograd.grad(loss, (q_sel, q_next), allow_unused=True)
    assert g_next is None
    np.testing.assert_allclose(g_sel.numpy(), [[1.0 - 2.0, 0.0]])
