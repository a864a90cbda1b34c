"""The port's dueling networks against the JAX package's, weights carried
across with ``ape_x_dqn_tpu_torch.weights``.

Tolerances: float32 compute on both sides, atol 1e-5 (the same products in
another summation order).  At the bfloat16 default, rtol 2e-2 with atol
2e-2 of the largest |Q|: bfloat16 keeps 8 bits of mantissa (~4e-3 per
rounding) and the two frameworks round at different places across four
layers.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ape_x_dqn_tpu.models import dueling as jdueling
from ape_x_dqn_tpu_torch.models import dueling as tdueling
from ape_x_dqn_tpu_torch.weights import params_from_jax, params_to_jax

OBS = (52, 52, 2)  # torso output 3×3×C: the flatten permutation matters


def _pair(kind="conv", compute="float32", A=4, obs=OBS, **kw):
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[compute]
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[compute]
    jnet = jdueling.build_network(kind, A, compute_dtype=jdt, **kw)
    jparams = jnet.init(jax.random.PRNGKey(1), jnp.zeros((1, *obs), jnp.uint8))
    tnet = tdueling.build_network(kind, A, obs, compute_dtype=tdt, **kw)
    return jnet, jparams, tnet, params_from_jax(tnet, jparams)


def _frames(n, obs=OBS, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (n, *obs), dtype=np.uint8)


@pytest.mark.parametrize("kind,kw", [
    ("conv", dict(channels=(8, 16, 8), hidden=32)),
    ("nature", dict(hidden=16)),
])
def test_conv_q_values_match_float32(kind, kw):
    jnet, jparams, tnet, tparams = _pair(kind, **kw)
    x = _frames(5)
    want = jnet.apply(jparams, jnp.asarray(x))
    got = tnet.apply_params(tparams, torch.from_numpy(x))
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), atol=1e-5, rtol=0)


def test_conv_q_values_match_bfloat16_default():
    jnet, jparams, tnet, tparams = _pair("conv", compute="bfloat16",
                                         channels=(8, 16, 8), hidden=32)
    x = _frames(6, seed=1)
    want = np.asarray(jnet.apply(jparams, jnp.asarray(x))[2])
    got = tnet.apply_params(tparams, torch.from_numpy(x)).q.detach().numpy()
    assert got.dtype == np.float32  # float32 heads
    np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-2 * np.abs(want).max())


def test_default_compute_dtypes_match_jax():
    assert tdueling.DuelingDQN(3, (84, 84, 1)).compute_dtype == torch.bfloat16
    assert tdueling.DuelingMLP(3, (8,)).compute_dtype == torch.float32
    assert jdueling.DuelingDQN(num_actions=3).compute_dtype == jnp.bfloat16


def test_mlp_q_values_match_float32():
    jnet, jparams, tnet, tparams = _pair("mlp", obs=(10,), A=3, hidden_sizes=(16, 8))
    x = _frames(7, obs=(10,))
    want = jnet.apply(jparams, jnp.asarray(x))
    got = tnet.apply_params(tparams, torch.from_numpy(x))
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), atol=1e-5, rtol=0)


def test_greedy_apply_matches():
    jnet, jparams, tnet, tparams = _pair("conv", channels=(8, 16, 8), hidden=32)
    x = _frames(9, seed=2)
    ja, jq = jdueling.build_greedy_apply(jnet)(jparams, jnp.asarray(x))
    ta, tq = tdueling.build_greedy_apply(tnet)(tparams, torch.from_numpy(x))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), atol=1e-5, rtol=0)


def test_weights_round_trip_exactly():
    _, jparams, tnet, tparams = _pair("conv", channels=(8, 16, 8), hidden=32)
    back = params_to_jax(tnet, tparams)["params"]
    for layer, leaves in jparams["params"].items():
        for name, value in leaves.items():
            np.testing.assert_array_equal(back[layer][name], np.asarray(value))
    assert set(tparams) == set(tnet.state_dict())


def test_nchw_input_raises():
    net = tdueling.DuelingDQN(3, (84, 84, 1))
    with pytest.raises(ValueError, match="NCHW"):
        net(torch.zeros((2, 1, 84, 84), dtype=torch.uint8))
    with pytest.raises(ValueError, match="NHWC"):
        net(torch.zeros((84, 84, 1), dtype=torch.uint8))


def test_init_matches_flax_scale():
    """lecun-normal kernels and zero biases, as flax initialises them."""
    torch.manual_seed(0)
    net = tdueling.DuelingDQN(4, (84, 84, 1))
    w = net.value_hidden.weight.detach()
    fan_in = w.shape[1]
    assert abs(float(w.std()) * np.sqrt(fan_in) - 1.0) < 0.05
    assert float(w.abs().max()) <= 2.0 / 0.87962566103423978 / np.sqrt(fan_in) + 1e-6
    assert float(net.convs[0].bias.detach().abs().max()) == 0.0
