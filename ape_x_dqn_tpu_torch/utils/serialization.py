"""Flat-numpy tree ↔ bytes — the cross-process wire format.

Port of ``ape_x_dqn_tpu/utils/serialization.py``.  The learner snapshots
its params once per publish (``tree_to_bytes``), the bytes travel through
shared memory (``runtime/process_actors.py``), and the receiver rebuilds
the leaves without executing anything: the payload is a JSON manifest and
raw buffers, never a pickle.

Format (little-endian), byte-identical to the JAX package's for the same
tree:

    b"APXT" | u32 format version (=1) | u64 header_len | header JSON | buffers

where the header is ``{"leaves": [{"path": [...], "dtype": str,
"shape": [...]}, ...]}`` and each path element is ``{"k": str}`` (dict
key) or ``{"i": int}`` (list or tuple index).  Buffers are the leaves'
C-contiguous bytes concatenated in manifest order.

Trees are nested dicts, lists and tuples whose leaves are numpy arrays,
CPU tensors or Python scalars; they flatten in ``jax.tree_util``'s order
(dict keys sorted).  A bfloat16 leaf ships as its uint16 raw bits under
dtype ``"bfloat16"`` (a torch tensor is viewed as int16, never cast), and a
0-d leaf stays 0-d.

Restore modes:
  * ``tree_from_bytes(data)`` — nested dicts/lists of numpy arrays
    rebuilt from the paths; a bfloat16 leaf comes back as a CPU
    ``torch.bfloat16`` tensor (numpy has no bfloat16 dtype of its own);
  * ``tree_from_file(path, subtree=None)`` — the same from a file, reading
    only the leaves under the top-level key ``subtree`` when one is named
    (the serving tier loads a checkpoint's params, not its optimizer);
  * ``restore_like(template, data)`` — the template's structure, each leaf
    of the template's kind (tensor or array), after checking every leaf's
    path, dtype and shape against the manifest.
"""

from __future__ import annotations

import json
import struct
from typing import Any, List

import numpy as np

_MAGIC = b"APXT"
_VERSION = 1
_PREFIX = struct.Struct("<4sIQ")  # magic, version, header_len


def _is_tensor(x) -> bool:
    return type(x).__module__.startswith("torch") and hasattr(x, "detach")


def _flatten(tree, path=()) -> List[tuple]:
    """[(path entries, leaf), ...] in jax.tree_util order."""
    if isinstance(tree, dict):
        out = []
        for key in sorted(tree):
            out += _flatten(tree[key], path + ({"k": str(key)},))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, child in enumerate(tree):
            out += _flatten(child, path + ({"i": i},))
        return out
    if tree is None:
        return []  # jax treats None as an empty subtree
    return [(list(path), tree)]


def _to_numpy(leaf) -> np.ndarray:
    """A leaf as a numpy array; a bfloat16 tensor as its uint16 bits."""
    if _is_tensor(leaf):
        import torch

        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    return np.asarray(leaf)


def _leaf_dtype(leaf) -> str:
    if _is_tensor(leaf):
        return str(leaf.dtype).removeprefix("torch.")  # numpy's names
    return str(np.asarray(leaf).dtype)


def tree_to_bytes(tree: Any) -> bytes:
    """Serialize a tree of array-likes to a self-describing byte string."""
    manifest: List[dict] = []
    buffers: List[bytes] = []
    for path, leaf in _flatten(tree):
        dtype = _leaf_dtype(leaf)
        arr = _to_numpy(leaf)
        if not arr.flags.c_contiguous:
            # Only when needed: ascontiguousarray would promote a 0-d leaf
            # (a step counter) to shape (1,).
            arr = np.ascontiguousarray(arr)
        if dtype == "bfloat16":
            arr = arr.view(np.uint16)
        manifest.append({"path": path, "dtype": dtype, "shape": list(arr.shape)})
        buffers.append(arr.tobytes())
    header = json.dumps({"leaves": manifest}).encode()
    return b"".join([_PREFIX.pack(_MAGIC, _VERSION, len(header)), header, *buffers])


def _parse(data) -> List[tuple]:
    """[(path entries, dtype, owned numpy array), ...] in manifest order; a
    bfloat16 leaf is its uint16 bits."""
    view = memoryview(data)
    magic, version, header_len = _PREFIX.unpack_from(view, 0)
    if magic != _MAGIC:
        raise ValueError("not an APXT snapshot (bad magic)")
    if version != _VERSION:
        raise ValueError(f"unsupported snapshot format version {version}")
    off = _PREFIX.size
    header = json.loads(bytes(view[off:off + header_len]))
    off += header_len
    out = []
    for entry in header["leaves"]:
        shape = tuple(entry["shape"])
        dt = np.dtype(np.uint16 if entry["dtype"] == "bfloat16" else entry["dtype"])
        count = int(np.prod(shape, dtype=np.int64))
        arr = np.frombuffer(view, dt, count, off).reshape(shape)
        off += count * dt.itemsize
        out.append((entry["path"], entry["dtype"], arr.copy()))  # own the memory
    return out


def _bf16_tensor(bits: np.ndarray):
    import torch

    return torch.from_numpy(bits.view(np.int16)).view(torch.bfloat16)


def tree_from_bytes(data) -> Any:
    """Standalone restore: nested dicts (``k`` keys) / lists (``i`` keys)."""
    leaves = [(path, _bf16_tensor(a) if dt == "bfloat16" else a)
              for path, dt, a in _parse(data)]
    if len(leaves) == 1 and not leaves[0][0]:
        return leaves[0][1]

    def key_of(entry):
        if "a" in entry:
            raise ValueError("snapshot contains attr paths (struct dataclasses), "
                             "which the port does not restore")
        return entry.get("k", entry.get("i"))

    def get(node, key):
        if isinstance(node, list):
            node.extend([None] * (key + 1 - len(node)))
            return node[key]
        return node.get(key)

    root: Any = [] if "i" in leaves[0][0][0] else {}
    for path, arr in leaves:
        node = root
        for i, entry in enumerate(path[:-1]):
            key = key_of(entry)
            child = get(node, key)
            if child is None:
                child = [] if "i" in path[i + 1] else {}
                node[key] = child
            node = child
        key = key_of(path[-1])
        get(node, key)
        node[key] = arr
    return root


def tree_from_file(path: str, subtree: str | None = None) -> Any:
    """``tree_from_bytes`` of an APXT file.  With ``subtree``, only the
    leaves under that top-level dict key are read (the rest are skipped
    with a seek) and the subtree itself is returned."""
    with open(path, "rb") as f:
        prefix = f.read(_PREFIX.size)
        magic, version, header_len = _PREFIX.unpack(prefix)
        if magic != _MAGIC:
            raise ValueError(f"{path}: not an APXT snapshot (bad magic)")
        if version != _VERSION:
            raise ValueError(f"{path}: unsupported snapshot format version {version}")
        leaves = json.loads(f.read(header_len))["leaves"]
        if subtree is None:
            return tree_from_bytes(prefix + json.dumps({"leaves": leaves}).encode()
                                   + f.read())
        keep, bufs = [], []
        off = f.tell()
        for entry in leaves:
            dt = np.dtype(np.uint16 if entry["dtype"] == "bfloat16" else entry["dtype"])
            n = int(np.prod(entry["shape"], dtype=np.int64)) * dt.itemsize
            if entry["path"][:1] == [{"k": subtree}]:
                f.seek(off)
                bufs.append(f.read(n))
                keep.append({**entry, "path": entry["path"][1:]})
            off += n
    if not keep:
        raise KeyError(f"{path}: no subtree {subtree!r}")
    header = json.dumps({"leaves": keep}).encode()
    return tree_from_bytes(b"".join([_PREFIX.pack(_MAGIC, _VERSION, len(header)),
                                     header, *bufs]))


def restore_like(template: Any, data) -> Any:
    """Restore into ``template``'s structure, verifying every leaf's path,
    dtype and shape against the manifest.  Tensor leaves of the template
    come back as CPU tensors, array leaves as numpy arrays."""
    leaves = _parse(data)
    t_leaves = _flatten(template)
    if len(leaves) != len(t_leaves):
        raise ValueError(f"snapshot has {len(leaves)} leaves, template has {len(t_leaves)}")
    restored = []
    for (path, dtype, arr), (t_path, t_leaf) in zip(leaves, t_leaves):
        if t_path != path:
            raise ValueError(f"leaf path mismatch: snapshot {path} != template {t_path}")
        t_dtype, t_shape = _leaf_dtype(t_leaf), tuple(_to_numpy(t_leaf).shape)
        if tuple(arr.shape) != t_shape or dtype != t_dtype:
            raise ValueError(f"leaf {path}: snapshot {dtype}{arr.shape} != "
                             f"template {t_dtype}{t_shape}")
        if dtype == "bfloat16":
            restored.append(_bf16_tensor(arr) if _is_tensor(t_leaf) else arr)
        elif _is_tensor(t_leaf):
            import torch

            restored.append(torch.from_numpy(arr))
        else:
            restored.append(arr)
    return _unflatten(template, iter(restored))


def _unflatten(template, leaves):
    if isinstance(template, dict):
        out = {key: None for key in template}
        for key in sorted(template):
            out[key] = _unflatten(template[key], leaves)
        return out
    if isinstance(template, (list, tuple)):
        items = [_unflatten(child, leaves) for child in template]
        return tuple(items) if isinstance(template, tuple) else items
    if template is None:
        return None
    return next(leaves)
