"""The port's sum-trees against the JAX package's.

The same random ``set`` sequences (duplicate indices included) go through
the JAX ``SumTree`` and ``NativeSumTree`` and the port's twins of both.
Everything is float64 in the same summation order, so totals, ``get``,
``max_priority`` and sampled indices must be identical, not close.  Error
paths raise the same exception types.  The port's native tree builds into
``build/native/`` and a failed build raises instead of falling back.
"""

from __future__ import annotations

import numpy as np
import pytest

from ape_x_dqn_tpu.replay import native as jnative
from ape_x_dqn_tpu.replay import sum_tree as jsum
from ape_x_dqn_tpu_torch.replay import native as tnative
from ape_x_dqn_tpu_torch.replay import sum_tree as tsum
from ape_x_dqn_tpu_torch.replay.buffer import PrioritizedReplay

TREES = {
    "jax_numpy": jsum.SumTree,
    "jax_native": jnative.NativeSumTree,
    "port_numpy": tsum.SumTree,
    "port_native": tnative.NativeSumTree,
}


def _all(capacity):
    return {name: cls(capacity) for name, cls in TREES.items()}


@pytest.mark.parametrize("capacity", [1, 7, 1000, 4096])
def test_random_sets_give_identical_trees(capacity):
    r = np.random.default_rng(capacity)
    trees = _all(capacity)
    for _ in range(30):
        n = int(r.integers(1, 3 * capacity + 2))
        idx = r.integers(0, capacity, n)                     # duplicates likely
        prio = r.random(n) * r.choice([1e-6, 1.0, 1e4])
        prio[r.random(n) < 0.1] = 0.0
        for t in trees.values():
            t.set(idx, prio)
        ref = trees["jax_numpy"]
        probe = np.arange(capacity)
        for name, t in trees.items():
            assert t.total == ref.total, name
            assert t.max_priority() == ref.max_priority(), name
            np.testing.assert_array_equal(t.get(probe), ref.get(probe), err_msg=name)
    # Last write wins for duplicates within one call.
    for t in trees.values():
        t.set(np.array([0, 0, 0]), np.array([1.0, 2.0, 3.0]))
        assert t.get(np.array([0]))[0] == 3.0


@pytest.mark.parametrize("capacity", [5, 1000, 3333])
def test_sample_and_stratified_sample_identical(capacity):
    r = np.random.default_rng(1)
    trees = _all(capacity)
    idx = r.integers(0, capacity, 2 * capacity)
    prio = r.random(2 * capacity) ** 3
    for t in trees.values():
        t.set(idx, prio)
    total = trees["jax_numpy"].total
    # Targets across the whole line, exactly on the total, and past it.
    targets = np.concatenate([r.random(256) * total, [0.0, total, 2 * total]])
    want = trees["jax_numpy"].sample(targets)
    for name, t in trees.items():
        np.testing.assert_array_equal(t.sample(targets), want, err_msg=name)
        assert t.sample(targets).max() <= capacity - 1
    for batch in (1, 32, 257):
        got = {name: t.sample_stratified(batch, np.random.default_rng(9))
               for name, t in trees.items()}
        for name, v in got.items():
            np.testing.assert_array_equal(v, got["jax_numpy"], err_msg=name)


def test_stratified_targets_match_jax():
    for total in (1e-9, 1.0, 12345.678):
        for b in (1, 3, 64):
            np.testing.assert_array_equal(
                tsum.stratified_targets(total, b, np.random.default_rng(4)),
                jsum.stratified_targets(total, b, np.random.default_rng(4)))


@pytest.mark.parametrize("case", ["index_high", "index_negative", "negative_priority",
                                  "nan_priority", "zero_capacity", "empty_sample"])
def test_error_paths_raise_the_same_types(case):
    def attempt(cls):
        if case == "zero_capacity":
            cls(0)
            return
        t = cls(8)
        if case == "index_high":
            t.set(np.array([8]), np.array([1.0]))
        elif case == "index_negative":
            t.set(np.array([-1]), np.array([1.0]))
        elif case == "negative_priority":
            t.set(np.array([2]), np.array([-1.0]))
        elif case == "nan_priority":
            t.set(np.array([2]), np.array([np.nan]))
        else:
            t.sample_stratified(4, np.random.default_rng(0))

    raised = {}
    for name, cls in TREES.items():
        with pytest.raises(Exception) as info:
            attempt(cls)
        raised[name] = type(info.value)
    assert len(set(raised.values())) == 1, raised
    assert raised["port_native"] in (IndexError, ValueError)


def test_native_get_rejects_out_of_range_indices():
    t = tnative.NativeSumTree(8)
    with pytest.raises(IndexError):
        t.get(np.array([8]))
    with pytest.raises(ValueError):
        t.set(np.array([1, 2]), np.array([1.0]))


def test_native_library_builds_under_build_dir():
    path, _ = tnative.build_library()
    assert path.parent == tnative.BUILD_DIR
    assert path.parent.parts[-2:] == ("build", "native")
    assert path.exists() and tnative.SOURCE.parent.name == "_native"


@pytest.mark.parametrize("fault", ["no_compiler", "bad_source"])
def test_failed_native_build_raises_instead_of_falling_back(fault, tmp_path, monkeypatch):
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "native")
    if fault == "no_compiler":
        monkeypatch.setattr(tnative, "CXX", str(tmp_path / "no-such-g++"))
    else:
        broken = tmp_path / "sum_tree.cc"
        broken.write_text("this is not C++\n")
        monkeypatch.setattr(tnative, "SOURCE", broken)
    tnative._library.cache_clear()
    try:
        with pytest.raises(RuntimeError):
            tnative.build_library()
        with pytest.raises(RuntimeError):
            tnative.NativeSumTree(8)
        with pytest.raises(RuntimeError):
            PrioritizedReplay(8, (2,))       # the replay's default tree
        assert not any((tmp_path / "native").glob("*.so"))
    finally:
        tnative._library.cache_clear()
    # With the numpy tree passed explicitly, the replay needs no compiler.
    assert PrioritizedReplay(8, (2,), sum_tree_cls=tsum.SumTree).size() == 0
