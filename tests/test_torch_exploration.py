"""Twins of ``tests/test_exploration.py``: the port's ``ops/exploration.py``
against the JAX package's on the same numpy inputs.

The ε-ladder is float32 math: rtol 1e-5 against JAX and the Ape-X formula.
Greedy actions (ε = 0) are integers and match JAX exactly.  Random draws
cannot match (torch cannot reproduce threefry), so ε = 1 is checked in each
package on its own as a frequency bound: 4 000 draws over 4 actions, each
action more than 800 times (expected 1 000; the bound sits > 7 standard
deviations below it).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

from ape_x_dqn_tpu.ops.exploration import epsilon_greedy as jax_greedy
from ape_x_dqn_tpu.ops.exploration import epsilon_ladder as jax_ladder
from ape_x_dqn_tpu_torch.ops.exploration import epsilon_greedy, epsilon_ladder

from _torch_harness import port_deadline  # noqa: F401 — the per-test deadline, autouse


def _gen(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed(seed)


def test_ladder_matches_apex_formula():
    # eps_i = eps^(1 + alpha*i/(N-1)), eps=0.4, alpha=7 (reference actor.py:114)
    eps, alpha = 0.4, 7.0
    for n in (5, 8, 256):
        got = epsilon_ladder(eps, alpha, n).numpy()
        expected = [eps ** (1 + alpha * i / (n - 1)) for i in range(n)]
        assert got.dtype == np.float32 and got.shape == (n,)
        np.testing.assert_allclose(got, expected, rtol=1e-5)
        np.testing.assert_allclose(got, np.asarray(jax_ladder(eps, alpha, n)), rtol=1e-5)
        assert got[0] == np.float32(0.4)
        assert np.all(np.diff(got) < 0)  # monotonically more greedy


def test_ladder_single_actor():
    np.testing.assert_allclose(epsilon_ladder(0.4, 7.0, 1).numpy(), [0.4])
    np.testing.assert_array_equal(epsilon_ladder(0.4, 7.0, 1).numpy(),
                                  np.asarray(jax_ladder(0.4, 7.0, 1)))


def test_epsilon_zero_is_greedy():
    q = np.array([[0.0, 1.0], [5.0, -1.0]], np.float32)
    a = epsilon_greedy(torch.from_numpy(q), torch.zeros(2), generator=_gen(0))
    assert a.dtype == torch.int32
    np.testing.assert_array_equal(a.numpy(), [1, 0])
    q = np.random.default_rng(0).normal(size=(512, 18)).astype(np.float32)
    a = epsilon_greedy(torch.from_numpy(q), torch.zeros(512), generator=_gen(1))
    j = jax_greedy(jax.random.PRNGKey(0), jnp.asarray(q), jnp.zeros(512))
    np.testing.assert_array_equal(a.numpy(), np.asarray(j))
    np.testing.assert_array_equal(a.numpy(), q.argmax(-1))


def test_epsilon_one_is_uniform():
    q = np.tile(np.array([[0.0, 10.0, 0.0, 0.0]], np.float32), (4000, 1))
    a = epsilon_greedy(torch.from_numpy(q), torch.ones(4000), generator=_gen(1))
    counts = np.bincount(a.numpy(), minlength=4)
    assert (counts > 800).all(), counts  # roughly uniform over 4 actions
    j = jax_greedy(jax.random.PRNGKey(1), jnp.asarray(q), jnp.ones(4000))
    assert (np.bincount(np.asarray(j), minlength=4) > 800).all()
    # A scalar ε broadcasts the same way.
    a = epsilon_greedy(torch.from_numpy(q), 1.0, generator=_gen(2))
    assert (np.bincount(a.numpy(), minlength=4) > 800).all()


def test_per_actor_epsilon_broadcast():
    # actor 0 epsilon=1 (random), actor 1 epsilon=0 (greedy)
    q = np.tile(np.array([[0.0, 10.0]], np.float32), (2000, 1))
    eps = np.array([1.0, 0.0] * 1000, np.float32)
    a = epsilon_greedy(torch.from_numpy(q), torch.from_numpy(eps), generator=_gen(2)).numpy()
    j = np.asarray(jax_greedy(jax.random.PRNGKey(2), jnp.asarray(q), jnp.asarray(eps)))
    greedy_slots = a[1::2]
    np.testing.assert_array_equal(greedy_slots, np.ones_like(greedy_slots))
    np.testing.assert_array_equal(greedy_slots, j[1::2])
    assert (a[0::2] == 0).sum() > 300  # random slots explore action 0 sometimes
