"""The port's inverse-CDF sampler against the JAX package's.

CPU: the plain version (``sample_indices_reference``) and the CPU dispatch
of ``sample_indices`` against ``_xla_sample``, ``_two_level_sample`` and
the Pallas kernel in interpret mode, in the cases of
``tests/test_device_replay.py::TestPallasSampling``.  Integer-valued
priorities make every float32 prefix sum exact in any order, so indices
must be identical (tolerance: none).

CPU, without a card: the wrapper's argument checks and ``plan``, the grid
and slices the kernel is launched with.

GPU (marked ``gpu``, skipped without a card): the CUDA kernel against the
plain version on the card, tolerance 0 on integer priorities: main-path
shapes, unsorted targets, targets on block boundaries, zero-mass blocks,
C below one slice and C ≢ 0 (mod 4) at unaligned addresses, B = 1, targets
below 0 and past the total, back-to-back calls, the tiled branch, and a
call replayed from a CUDA graph.  Run it where a card is:
``python -m pytest --noconftest -m gpu tests/test_torch_sampling.py``
(``--noconftest``: the test conftest pins JAX, which that machine lacks;
the JAX references here are imported only by the tests that use them).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from ape_x_dqn_tpu_torch.ops import sampling

from _torch_harness import port_deadline  # noqa: F401 — the per-test deadline, autouse


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


@pytest.mark.parametrize("C", [1, 3, 1023, 1025, 4099, 100_000, 100_003,
                               2_000_000, 7_100_000, 2**31 - 1])
@pytest.mark.parametrize("num_sms", [1, 7, 132])
def test_plan_covers_every_priority_once(C, num_sms):
    grid, slice_, tile = sampling.plan(C, num_sms)
    assert 1 <= grid <= min(num_sms, sampling.MAX_GRID)
    assert slice_ % 4 == 0 and tile % 4 == 0  # 16-byte bulk copies
    assert (grid - 1) * slice_ < C <= grid * slice_  # the last block is not empty
    assert tile == min(slice_, sampling.MAX_TILE)


def test_plan_at_main_path_shapes():
    # One block per SM of an H100 SXM at most; the whole of p fits in the
    # SMs' shared memory, so no call on the main path takes the tiled branch.
    assert sampling.plan(100_000, 132) == (98, 1024, 1024)
    assert sampling.plan(2_000_000, 132) == (132, 15152, 15152)
    assert sampling.plan(8_000_000, 132) == (132, 60608, sampling.MAX_TILE)


@pytest.mark.parametrize("C", [0, -1, 2**31])
def test_plan_rejects_counts_outside_int32(C):
    with pytest.raises(ValueError, match="int32"):
        sampling.plan(C, 132)


@pytest.mark.parametrize("p,t,err", [
    (torch.ones(8, dtype=torch.float64), torch.ones(2), TypeError),
    (torch.ones(8), torch.ones(2, dtype=torch.float16), TypeError),
    (torch.ones(2, 4), torch.ones(2), ValueError),
    (torch.ones(16)[::2], torch.ones(2), ValueError),
    (torch.ones(8), torch.ones(2, device="meta"), ValueError),
])
def test_kernel_wrapper_rejects_before_launch(p, t, err):
    with pytest.raises(err):
        sampling._launch(p, t)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _int_priorities(r, C):
    hi = max(2, 2**24 // C)  # total < 2^24: float32 prefix sums exact
    return r.integers(0, hi, C).astype(np.float32)


def _on_card(pri, targets, device, offset=0):
    """The kernel's indices against the plain version's, tolerance 0.
    ``offset`` places p that many floats past a 16-byte boundary."""
    buf = torch.zeros(offset + len(pri), dtype=torch.float32, device=device)
    p = buf[offset:]
    p.copy_(torch.from_numpy(pri))
    t = torch.from_numpy(np.asarray(targets, np.float32)).to(device)
    before = sampling.sample_indices.launches
    got = sampling._launch(p, t)
    torch.cuda.synchronize()
    assert sampling.sample_indices.launches == before + 1
    torch.testing.assert_close(got, sampling.sample_indices_reference(p, t),
                               rtol=0, atol=0)
    return got


@pytest.mark.gpu
@pytest.mark.parametrize("C,B", [(100_000, 32), (100_003, 4096), (2_000_000, 4096),
                                 (8_000_000, 4096)])
def test_kernel_matches_plain_on_card(cuda_device, C, B):
    r = np.random.default_rng(C + B)
    pri = _int_priorities(r, C)
    pri[: 3 * sampling.MIN_SLICE] = 0.0  # whole zero-mass blocks
    targets = r.permutation(np.sort(r.random(B)) * pri.sum())
    _on_card(pri, targets, cuda_device)  # 8 000 000: the tiled branch


def _slices(C):
    grid, slice_, _ = sampling.plan(C, torch.cuda.get_device_properties(0)
                                    .multi_processor_count)
    return grid, slice_


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["unsorted", "block_boundaries", "zero_blocks",
                                  "below_one_slice", "b1", "out_of_range"])
def test_kernel_edge_cases_on_card(cuda_device, case):
    r = np.random.default_rng(7)
    C = 100_000
    pri = _int_priorities(r, C)
    if case == "unsorted":  # K rows, each sorted, flattened (sample_ahead)
        targets = np.sort(r.random((128, 32)), axis=1).ravel() * pri.sum()
    elif case == "block_boundaries":  # exactly the prefix at each block's end
        grid, slice_ = _slices(C)
        cdf = np.cumsum(pri.astype(np.float64))
        targets = np.concatenate([cdf[np.arange(1, grid) * slice_ - 1],
                                  cdf[np.arange(1, grid) * slice_]])
    elif case == "zero_blocks":  # first, a middle and the last block empty
        grid, slice_ = _slices(C)
        for g in (0, grid // 2, grid - 1):
            pri[g * slice_:(g + 1) * slice_] = 0.0
        cdf = np.cumsum(pri.astype(np.float64))
        targets = np.concatenate([np.sort(r.random(512)) * cdf[-1],
                                  cdf[np.arange(1, grid) * slice_ - 1], [cdf[-1]]])
    elif case == "below_one_slice":
        pri = pri[:700]
        targets = np.sort(r.random(64)) * pri.sum()
    elif case == "b1":
        targets = [0.5 * pri.sum()]
    else:
        targets = [-5.0, -0.0, 0.0, pri.sum(), pri.sum() + 1.0, 1e30]
    got = _on_card(pri, targets, cuda_device)
    if case == "out_of_range":
        assert got[0] == 0 and got[-1] == len(pri) - 1


@pytest.mark.gpu
@pytest.mark.parametrize("C", [4097, 4098, 4099, 5, 6, 7])
@pytest.mark.parametrize("offset", [0, 1, 2, 3])
def test_kernel_ragged_and_unaligned_on_card(cuda_device, C, offset):
    r = np.random.default_rng(C * 4 + offset)
    pri = _int_priorities(r, C)
    pri[-1] = 1.0  # mass in the ragged tail
    targets = np.concatenate([np.sort(r.random(33)) * pri.sum(),
                              [pri.sum() - 0.5, pri.sum()]])
    _on_card(pri, targets, cuda_device, offset=offset)


@pytest.mark.gpu
def test_kernel_back_to_back_calls_see_new_priorities(cuda_device):
    r = np.random.default_rng(11)
    C, B = 2_000_000, 4096
    pri = _int_priorities(r, C)
    p = torch.from_numpy(pri).to(cuda_device)
    t = torch.from_numpy((np.sort(r.random(B)) * pri.sum() * 0.5)
                         .astype(np.float32)).to(cuda_device)
    first = sampling.sample_indices(p, t)
    want_first = sampling.sample_indices_reference(p, t)
    p[: C // 2] = 0.0  # the mass moves to the upper half
    second = sampling.sample_indices(p, t)
    torch.cuda.synchronize()
    torch.testing.assert_close(first, want_first, rtol=0, atol=0)
    torch.testing.assert_close(second, sampling.sample_indices_reference(p, t),
                               rtol=0, atol=0)
    assert int(second.min()) >= C // 2


@pytest.mark.gpu
def test_kernel_replays_from_cuda_graph(cuda_device):
    r = np.random.default_rng(12)
    C, B = 100_000, 4096
    p = torch.from_numpy(_int_priorities(r, C)).to(cuda_device)
    t = torch.from_numpy((np.sort(r.random(B)) * float(p.sum()))
                         .astype(np.float32)).to(cuda_device)
    sampling.sample_indices(p, t)  # set-up outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = sampling.sample_indices(p, t)
    for _ in range(2):
        p.copy_(torch.from_numpy(_int_priorities(r, C)))
        graph.replay()
        torch.cuda.synchronize()
        torch.testing.assert_close(out, sampling.sample_indices_reference(p, t),
                                   rtol=0, atol=0)
