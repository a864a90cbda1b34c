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

from _torch_harness import port_deadline  # noqa: F401 — the per-test deadline, autouse

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


# -- twins of tests/test_model.py's structural oracles ------------------------


def test_conv_output_shapes():
    """Value [B, 1], advantage and Q [B, A] in float32, as JAX's, at 84×84×1."""
    jnet, jparams, tnet, tparams = _pair("conv", A=6, obs=(84, 84, 1))
    x = np.zeros((2, 84, 84, 1), np.uint8)
    jv, ja, jq = jnet.apply(jparams, jnp.asarray(x))
    v, a, q = tnet.apply_params(tparams, torch.from_numpy(x))
    assert tuple(v.shape) == jv.shape == (2, 1)
    assert tuple(a.shape) == ja.shape == (2, 6)
    assert tuple(q.shape) == jq.shape == (2, 6)
    assert q.dtype == torch.float32 and jq.dtype == jnp.float32


def _mlp_pair(obs=(8,)):
    return _pair("mlp", A=3, obs=obs)


def test_dueling_aggregation_per_row_mean():
    """Q = V + A − mean_a(A) per row, so mean_a Q = V per row (float32,
    rtol 1e-5 as JAX's test), and the port's Q equals JAX's (atol 1e-5)."""
    jnet, jparams, tnet, tparams = _mlp_pair()
    x = np.random.default_rng(1).normal(size=(4, 8)).astype(np.float32)
    v, a, q = (t.detach().numpy() for t in tnet.apply_params(tparams, torch.from_numpy(x)))
    np.testing.assert_allclose(q, v + a - a.mean(axis=1, keepdims=True), rtol=1e-5)
    np.testing.assert_allclose(q.mean(axis=1), v[:, 0], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(q, np.asarray(jnet.apply(jparams, jnp.asarray(x))[2]), atol=1e-5)


@pytest.mark.parametrize("kind,obs,kw", [
    ("mlp", (8,), {}),
    ("conv", OBS, dict(channels=(8, 16, 8), hidden=32)),
])
def test_aggregation_independent_across_batch(kind, obs, kw):
    """Row 0's Q does not change with the other rows of the batch (the
    reference's batch-mean bug guard), for either network."""
    _, _, tnet, tparams = _pair(kind, A=3, obs=obs, **kw)
    r = np.random.default_rng(2)
    x = torch.from_numpy(r.normal(size=(2, *obs)).astype(np.float32) if kind == "mlp"
                         else _frames(2, obs=obs, seed=2))
    q_full = tnet.apply_params(tparams, x).q
    q_row0 = tnet.apply_params(tparams, x[:1]).q
    np.testing.assert_allclose(q_full[:1].detach().numpy(), q_row0.detach().numpy(), rtol=1e-5)


def test_uint8_and_float_inputs_agree():
    """uint8 frames are scaled by 1/255 inside; the same frames given as
    float32 in [0, 1] give the same Q (rtol 1e-5, as JAX's test), and both
    equal JAX's."""
    jnet, jparams, tnet, tparams = _pair("conv", A=4, obs=(84, 84, 1))
    x = _frames(1, obs=(84, 84, 1), seed=3)
    q_u8 = tnet.apply_params(tparams, torch.from_numpy(x)).q.detach().numpy()
    q_f = tnet.apply_params(tparams, torch.from_numpy(x.astype(np.float32) / 255.0)).q
    np.testing.assert_allclose(q_u8, q_f.detach().numpy(), rtol=1e-5)
    np.testing.assert_allclose(q_u8, np.asarray(jnet.apply(jparams, jnp.asarray(x))[2]),
                               atol=1e-5)
