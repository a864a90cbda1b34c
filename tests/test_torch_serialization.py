"""The port's APXT snapshot format against the JAX package's.

The same tree gives the same bytes in both packages (exact), each package
restores the other's bytes exactly, and a snapshot of a JAX ``DuelingDQN``
param tree read by the port then carried by ``weights.params_from_jax``
equals the port's params converted from the same arrays (zero tolerance).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ape_x_dqn_tpu.models import dueling as jdueling
from ape_x_dqn_tpu.utils import serialization as jser
from ape_x_dqn_tpu_torch.models import dueling as tdueling
from ape_x_dqn_tpu_torch.utils import serialization as tser
from ape_x_dqn_tpu_torch.weights import params_from_jax

from _torch_harness import port_deadline  # noqa: F401 — the per-test deadline, autouse


def _trees(seed=0):
    """(numpy tree for the JAX package, the same tree with CPU tensors and
    a torch.bfloat16 leaf for the port)."""
    r = np.random.default_rng(seed)
    bf16_bits = r.integers(0, 2**15, (3, 4)).astype(np.uint16)
    np_tree = {
        "params": {
            "dense": {"kernel": r.normal(size=(5, 3)).astype(np.float32),
                      "bias": np.zeros(3, np.float32)},
            "emb": r.integers(0, 255, (2, 7, 7, 1), dtype=np.uint8),
            "half": bf16_bits.view(jnp.bfloat16),
        },
        "steps": [np.int32(7) * np.ones((), np.int32), np.arange(6, dtype=np.int32)],
        "scale": np.float32(0.25) * np.ones((), np.float32),
    }
    torch_tree = {
        "params": {
            "dense": {"kernel": torch.from_numpy(np_tree["params"]["dense"]["kernel"]),
                      "bias": torch.zeros(3)},
            "emb": np_tree["params"]["emb"],                       # numpy leaf
            "half": torch.from_numpy(bf16_bits.view(np.int16)).view(torch.bfloat16),
        },
        "steps": [torch.tensor(7, dtype=torch.int32), torch.arange(6, dtype=torch.int32)],
        "scale": np.float32(0.25) * np.ones((), np.float32),
    }
    return np_tree, torch_tree


def _bits(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            return leaf.view(torch.int16).numpy().view(np.uint16)
        return leaf.numpy()
    arr = np.asarray(leaf)
    return arr.view(np.uint16) if str(arr.dtype) == "bfloat16" else arr


def _assert_same_leaves(a, b):
    la = jax.tree_util.tree_flatten_with_path(a)[0]
    lb = jax.tree_util.tree_flatten_with_path(b)[0]
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (path, x), (_, y) in zip(la, lb):
        x, y = _bits(x), _bits(y)
        assert x.shape == y.shape and x.dtype == y.dtype, path
        np.testing.assert_array_equal(x, y, err_msg=str(path))


def test_port_bytes_equal_jax_bytes():
    np_tree, torch_tree = _trees()
    assert tser.tree_to_bytes(torch_tree) == jser.tree_to_bytes(np_tree)
    assert tser.tree_to_bytes(np_tree) == jser.tree_to_bytes(np_tree)


def test_each_package_restores_the_others_bytes():
    np_tree, torch_tree = _trees(1)
    from_jax = tser.tree_from_bytes(jser.tree_to_bytes(np_tree))
    assert from_jax["params"]["half"].dtype == torch.bfloat16
    _assert_same_leaves(from_jax, np_tree)
    from_port = jser.tree_from_bytes(tser.tree_to_bytes(torch_tree))
    _assert_same_leaves(from_port, np_tree)
    assert from_port["scale"].shape == () and from_jax["scale"].shape == ()


def test_restore_like_keeps_the_template_kind():
    np_tree, torch_tree = _trees(2)
    data = jser.tree_to_bytes(np_tree)
    got = tser.restore_like(torch_tree, data)
    assert isinstance(got["params"]["dense"]["kernel"], torch.Tensor)
    assert isinstance(got["params"]["emb"], np.ndarray)
    assert got["params"]["half"].dtype == torch.bfloat16
    assert got["steps"][0].shape == ()
    _assert_same_leaves(got, np_tree)
    back = jser.restore_like(np_tree, tser.tree_to_bytes(got))
    _assert_same_leaves(back, np_tree)


@pytest.mark.parametrize("break_it,message", [
    (lambda t: t["params"]["dense"].update(bias=torch.zeros(4)), "template"),
    (lambda t: t["params"]["dense"].update(bias=torch.zeros(3, dtype=torch.float64)),
     "template"),
    (lambda t: t["params"].pop("emb"), "leaves"),
    (lambda t: t["params"].update(extra=torch.zeros(1)), "path mismatch|leaves"),
])
def test_restore_like_rejects_a_mismatched_template(break_it, message):
    np_tree, torch_tree = _trees(3)
    break_it(torch_tree)
    with pytest.raises(ValueError, match=message):
        tser.restore_like(torch_tree, jser.tree_to_bytes(np_tree))


def test_restore_rejects_other_payloads():
    with pytest.raises(ValueError, match="bad magic"):
        tser.tree_from_bytes(b"NOPE" + bytes(12))
    data = bytearray(tser.tree_to_bytes({"a": np.zeros(2, np.float32)}))
    data[4] = 2
    with pytest.raises(ValueError, match="version"):
        tser.tree_from_bytes(bytes(data))


def test_single_leaf_and_list_roots_match_jax():
    for tree in (np.arange(5, dtype=np.float32), [np.zeros(2, np.uint8), np.ones(3, np.int32)]):
        data = tser.tree_to_bytes(tree)
        assert data == jser.tree_to_bytes(tree)
        _assert_same_leaves(tser.tree_from_bytes(data), jser.tree_from_bytes(data))


@pytest.mark.parametrize("kind,obs_shape,kwargs", [
    ("conv", (36, 36, 1), dict(channels=(8, 8, 8), hidden=32)),
    ("mlp", (6,), dict(hidden_sizes=(16, 16))),
])
def test_jax_param_snapshot_carries_into_the_port(kind, obs_shape, kwargs):
    jnet = jdueling.build_network(kind, 3, **kwargs)
    jparams = jax.device_get(jnet.init(jax.random.PRNGKey(5),
                                       jnp.zeros((1, *obs_shape), jnp.uint8)))
    tnet = tdueling.build_network(kind, 3, obs_shape, **kwargs)
    got = params_from_jax(tnet, tser.tree_from_bytes(jser.tree_to_bytes(jparams)))
    want = params_from_jax(tnet, jparams)
    assert got.keys() == want.keys() == tnet.state_dict().keys()
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)
