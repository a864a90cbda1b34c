"""The port's inverse-CDF sampler against the JAX package's.

CPU: the plain version (``sample_indices_reference``) and the CPU dispatch
of ``sample_indices`` against ``_xla_sample``, ``_two_level_sample`` and
the Pallas kernel in interpret mode, in the cases of
``tests/test_device_replay.py::TestPallasSampling``.  Integer-valued
priorities make every float32 prefix sum exact in any order, so indices
must be identical (tolerance: none).

GPU (marked ``gpu``, skipped without a card): the CUDA kernel against the
plain version on the card.  Run it where a card is:
``python -m pytest --noconftest -m gpu tests/test_torch_sampling.py``
(``--noconftest``: the test conftest pins JAX, which that machine lacks;
the JAX references here are imported only by the tests that use them).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from ape_x_dqn_tpu_torch.ops import sampling


@pytest.fixture
def jax_sampling():
    import jax.numpy as jnp

    from ape_x_dqn_tpu.ops.pallas import sampling as ref

    return jnp, ref


def _int_case(seed: int, C: int, B: int, hi: int = 100):
    r = np.random.default_rng(seed)
    pri = r.integers(1, hi, C).astype(np.float32)
    targets = (np.sort(r.random(B)) * pri.sum() * 0.999).astype(np.float32)
    return pri, targets


def _port(pri, targets):
    return sampling.sample_indices_reference(
        torch.from_numpy(pri), torch.from_numpy(targets)
    ).numpy()


@pytest.mark.parametrize("seed,C,B", [(0, 5000, 64), (1, 4096, 32), (2, 1000, 8)])
def test_plain_matches_xla_exactly(jax_sampling, seed, C, B):
    jnp, ref = jax_sampling
    pri, targets = _int_case(seed, C, B)
    want = np.asarray(ref._xla_sample(jnp.asarray(pri), jnp.asarray(targets)))
    got = _port(pri, targets)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed,C,B", [(0, 5000, 64), (3, 2048, 16)])
def test_plain_matches_pallas_interpret_exactly(jax_sampling, seed, C, B):
    jnp, ref = jax_sampling
    pri, targets = _int_case(seed, C, B)
    want = np.asarray(ref._pallas_sample(jnp.asarray(pri), jnp.asarray(targets),
                                         interpret=True))
    np.testing.assert_array_equal(_port(pri, targets), want)


def test_zero_mass_blocks(jax_sampling):
    jnp, ref = jax_sampling
    pri = np.zeros(5000, np.float32)
    pri[4000] = 1.0
    pri[4999] = 3.0
    targets = np.asarray([0.5, 1.5, 3.9], np.float32)
    got = _port(pri, targets)
    assert list(got) == [4000, 4999, 4999]
    pallas = ref._pallas_sample(jnp.asarray(pri), jnp.asarray(targets), interpret=True)
    np.testing.assert_array_equal(got, np.asarray(pallas))


def test_non_divisible_length(jax_sampling):
    jnp, ref = jax_sampling
    pri, targets = _int_case(4, 777, 32, hi=10)
    got = _port(pri, targets)
    np.testing.assert_array_equal(
        got, np.asarray(ref._xla_sample(jnp.asarray(pri), jnp.asarray(targets))))
    np.testing.assert_array_equal(
        got, np.asarray(ref._two_level_sample(jnp.asarray(pri), jnp.asarray(targets))))


def test_target_past_total_is_last_leaf(jax_sampling):
    jnp, ref = jax_sampling
    pri = np.asarray([1.0, 0.0, 2.0, 0.0], np.float32)
    targets = np.asarray([0.0, 1.0, 3.0, 10.0], np.float32)
    got = _port(pri, targets)
    np.testing.assert_array_equal(
        got, np.asarray(ref._xla_sample(jnp.asarray(pri), jnp.asarray(targets))))
    assert got[-1] == 3


def test_cpu_dispatch_is_plain_version():
    pri, targets = _int_case(5, 3000, 16)
    before = sampling.sample_indices.launches
    got = sampling.sample_indices(torch.from_numpy(pri), torch.from_numpy(targets))
    np.testing.assert_array_equal(got.numpy(), _port(pri, targets))
    assert sampling.sample_indices.launches == before  # no kernel on the CPU


def test_other_devices_raise():
    p = torch.empty(8, device="meta")
    with pytest.raises(ValueError, match="no sampler"):
        sampling.sample_indices(p, torch.empty(2, device="meta"))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("C,B", [(100_000, 32), (100_003, 4096), (2_000_000, 4096)])
def test_kernel_matches_plain_on_card(cuda_device, C, B):
    r = np.random.default_rng(C + B)
    hi = max(2, 2**24 // C)  # total < 2^24: float32 prefix sums exact
    pri = r.integers(0, hi, C).astype(np.float32)
    pri[: 3 * sampling.CHUNK] = 0.0  # whole zero-mass chunks
    p = torch.from_numpy(pri).to(cuda_device)
    t = torch.from_numpy(
        (np.sort(r.random(B)) * pri.sum()).astype(np.float32)).to(cuda_device)
    before = sampling.sample_indices.launches
    got = sampling.sample_indices(p, t)
    torch.cuda.synchronize()
    assert sampling.sample_indices.launches == before + 1
    torch.testing.assert_close(got, sampling.sample_indices_reference(p, t),
                               rtol=0, atol=0)
