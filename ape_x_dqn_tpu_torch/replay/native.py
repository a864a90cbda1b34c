"""ctypes bindings for the native C++ sum-tree core.

Port of ``ape_x_dqn_tpu/replay/native.py``.  ``NativeSumTree`` has the exact
interface of the numpy ``SumTree``; the host replay takes either through its
``sum_tree_cls`` parameter and defaults to this one.  Two things differ from
the JAX module:

* **Where it builds.**  ``_native/sum_tree.cc`` (the port's own copy) is
  compiled with ``g++`` at first use into ``build/native/`` at the
  repository root, never next to the source, and the library is named by a
  hash of source and flags.  The compile writes a private temporary file
  and renames it into place, so a concurrent first use never loads a torn
  library.
* **No silent fallback.**  A missing compiler or a failed build raises; the
  numpy tree is used only where a caller passes ``sum_tree_cls=SumTree``.

The boundary is a C ABI: numpy arrays pass as raw pointers, validated here
(dtype, contiguity, bounds) before they do.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

from ape_x_dqn_tpu_torch.replay.sum_tree import stratified_targets

SOURCE = Path(__file__).resolve().parents[1] / "_native" / "sum_tree.cc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX = "g++"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")


def build_library() -> tuple[Path, str]:
    """Compile ``SOURCE`` with ``CXX`` unless this source's library exists.
    Returns the library path and the compiler's output ("" when cached).
    Raises ``RuntimeError`` if the compiler is missing or fails."""
    return compile_shared(SOURCE, "libapex_sum_tree", CXX, CXX_FLAGS, BUILD_DIR)


def compile_shared(source: Path, stem: str, cxx: str, flags, build_dir: Path
                   ) -> tuple[Path, str]:
    """Build ``source`` into ``build_dir/<stem>_<hash>.so`` (hash of source,
    compiler and flags) unless it exists: a private temporary file renamed
    into place.  Shared by every native core of the port."""
    src = source.read_bytes()
    tag = hashlib.sha256(src + " ".join((cxx, *flags)).encode()).hexdigest()[:16]
    lib = build_dir / f"{stem}_{tag}.so"
    if lib.exists():
        return lib, ""
    build_dir.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    try:
        res = subprocess.run([cxx, *flags, "-o", str(tmp), str(source)],
                             capture_output=True, text=True)
    except OSError as e:  # no compiler at all
        raise RuntimeError(f"cannot build {source.name}: {e}") from e
    try:
        if res.returncode != 0:
            raise RuntimeError(
                f"{cxx} failed ({res.returncode}) building {source.name}:\n"
                f"{res.stdout}{res.stderr}"
            )
        os.replace(tmp, lib)  # atomic within the directory
    finally:
        if tmp.exists():
            tmp.unlink()
    return lib, res.stdout + res.stderr


@functools.cache
def _library() -> ctypes.CDLL:
    path, _ = build_library()
    lib = ctypes.CDLL(str(path))
    lib.st_create.restype = ctypes.c_void_p
    lib.st_create.argtypes = [ctypes.c_int64]
    lib.st_destroy.restype = None
    lib.st_destroy.argtypes = [ctypes.c_void_p]
    lib.st_total.restype = ctypes.c_double
    lib.st_total.argtypes = [ctypes.c_void_p]
    lib.st_max.restype = ctypes.c_double
    lib.st_max.argtypes = [ctypes.c_void_p]
    lib.st_set.restype = ctypes.c_int32
    lib.st_set.argtypes = [
        ctypes.c_void_p, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_double),
    ]
    lib.st_get.restype = None
    lib.st_get.argtypes = [
        ctypes.c_void_p, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_double),
    ]
    lib.st_sample.restype = None
    lib.st_sample.argtypes = [
        ctypes.c_void_p, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int64),
    ]
    return lib


def _i64(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def _f64(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


class NativeSumTree:
    """Drop-in replacement for ``sum_tree.SumTree`` backed by the C++ core."""

    def __init__(self, capacity: int):
        lib = _library()
        if capacity <= 0:
            raise ValueError("capacity must be positive")
        self.capacity = int(capacity)
        self._lib = lib
        self._handle = lib.st_create(self.capacity)
        if not self._handle:
            raise MemoryError("st_create failed")

    def __del__(self):
        handle = getattr(self, "_handle", None)
        if handle:
            self._lib.st_destroy(handle)
            self._handle = None

    @property
    def total(self) -> float:
        return float(self._lib.st_total(self._handle))

    def max_priority(self) -> float:
        return float(self._lib.st_max(self._handle))

    def _indices(self, indices) -> np.ndarray:
        idx = np.ascontiguousarray(np.asarray(indices).reshape(-1), dtype=np.int64)
        if idx.size and (idx.min() < 0 or idx.max() >= self.capacity):
            raise IndexError("sum-tree index out of range")
        return idx

    def get(self, indices: np.ndarray) -> np.ndarray:
        idx = self._indices(indices)
        out = np.empty(idx.shape[0], dtype=np.float64)
        self._lib.st_get(self._handle, idx.shape[0], _i64(idx), _f64(out))
        return out

    def set(self, indices: np.ndarray, priorities: np.ndarray) -> None:
        idx = self._indices(indices)
        pri = np.ascontiguousarray(np.asarray(priorities).reshape(-1), dtype=np.float64)
        if pri.shape != idx.shape:
            raise ValueError(f"{idx.shape[0]} indices but {pri.shape[0]} priorities")
        if idx.size == 0:
            return
        rc = self._lib.st_set(self._handle, idx.shape[0], _i64(idx), _f64(pri))
        if rc == -1:
            raise IndexError("sum-tree index out of range")
        if rc == -2:
            raise ValueError("priorities must be finite and non-negative")

    def sample(self, targets: np.ndarray) -> np.ndarray:
        tgt = np.ascontiguousarray(np.asarray(targets).reshape(-1), dtype=np.float64)
        out = np.empty(tgt.shape[0], dtype=np.int64)
        self._lib.st_sample(self._handle, tgt.shape[0], _f64(tgt), _i64(out))
        return out

    def sample_stratified(self, batch_size: int, rng: np.random.Generator) -> np.ndarray:
        return self.sample(stratified_targets(self.total, batch_size, rng))


def default_sum_tree_cls():
    """The native tree, built now if it was not: raises if it cannot be."""
    _library()
    return NativeSumTree
