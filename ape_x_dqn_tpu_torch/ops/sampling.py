"""Stratified inverse-CDF sampling over priorities: CUDA kernel + plain version.

Port of ``ape_x_dqn_tpu/ops/pallas/sampling.py``: the Pallas TPU kernel
(``_kernel`` / ``_pallas_sample``, ``pallas_call`` at :118) and its XLA
spellings ``_two_level_sample`` (the JAX default) and ``_xla_sample`` all
compute one function: for each target mass t_b, the first index i whose
inclusive prefix sum exceeds t_b (searchsorted ``side="right"``), clamped
to C−1.

* ``sample_indices_reference`` — the plain PyTorch version
  (``cumsum`` + ``searchsorted(right=True)`` + clamp, as ``_xla_sample``).
  The tests and CPU runs use it.
* ``sample_indices`` — the dispatch.  On a CUDA tensor it launches the
  hand-written kernel in ``csrc/sampling.cu`` and nothing else: a failed
  build or launch raises.  On a CPU tensor it runs the plain version.
* ``plan`` — the kernel's grid: how many blocks, how many priorities each
  block owns, and the shared-memory tile they are staged through.

The kernel is one cooperative launch (one block per SM at most) that reads
the priorities once into shared memory; see the note at the top of
``csrc/sampling.cu``.  It is compiled with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface at first use (``build/kernels/`` at
the repository root, named by a hash of the source) and loaded with
``ctypes``.  ``sample_indices.launches`` counts kernel launches (one per
call), so a run can show that its samples went through the kernel.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path

import torch

MIN_SLICE = 1024  # fewest priorities a block takes (kernel's grid rule)
MAX_TILE = 53248  # priorities a block holds in shared memory (kernel's kMaxTile)
MAX_GRID = 256  # most blocks one launch takes (kernel's kMaxGrid)

_SOURCE = Path(__file__).resolve().parent / "csrc" / "sampling.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def sample_indices_reference(priorities: torch.Tensor,
                             targets: torch.Tensor) -> torch.Tensor:
    """Plain version: full cumsum + searchsorted (side="right", so a target
    exactly on a boundary selects the next nonzero-mass leaf), clamped to
    C−1.  int32 [B]."""
    cdf = torch.cumsum(priorities.to(torch.float32), dim=0)
    idx = torch.searchsorted(cdf, targets.to(torch.float32), right=True)
    return torch.clamp(idx, 0, priorities.shape[0] - 1).to(torch.int32)


def build_cuda_library(source: Path, stem: str,
                       extra_flags: tuple[str, ...] = ()) -> tuple[Path, str]:
    """Compile ``source`` (a ``csrc/*.cu`` with a plain C interface) into
    ``BUILD_DIR/<stem>_<hash of source and flags>.so`` unless it exists.
    Returns the library path and the compiler's output ("" when cached).
    Raises if ``nvcc`` fails."""
    from torch.utils.cpp_extension import CUDA_HOME

    src = source.read_bytes()
    flags = (*NVCC_FLAGS, *extra_flags)
    tag = hashlib.sha256(src + " ".join(flags).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"{stem}_{tag}.so"
    if lib.exists():
        return lib, ""
    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME) to build "
                           f"{source.name}")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cmd = [os.path.join(CUDA_HOME, "bin", "nvcc"), *flags,
           "-o", str(tmp), str(source)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({res.returncode}) building {source.name}:\n"
            f"{res.stdout}{res.stderr}"
        )
    os.replace(tmp, lib)  # atomic: a concurrent build never loads a torn file
    return lib, res.stdout + res.stderr


def build_library(extra_flags: tuple[str, ...] = ()) -> tuple[Path, str]:
    """``csrc/sampling.cu``'s library (``build_cuda_library``)."""
    return build_cuda_library(_SOURCE, "libapex_sampling", extra_flags)


def plan(C: int, num_sms: int) -> tuple[int, int, int]:
    """(grid, slice, tile) of one launch over C priorities on ``num_sms`` SMs.

    min(SMs, ceil(C / MIN_SLICE)) blocks, so at most one per SM; each owns a
    contiguous slice of ceil(C / grid) priorities rounded up to a multiple of
    4 (16-byte aligned bulk copies), and every block, the last included,
    owns at least one.  A slice longer than ``MAX_TILE`` is walked in tiles
    of ``MAX_TILE``."""
    if not 0 < C < 2**31:
        raise ValueError(f"priority count {C} outside the kernel's int32 range")
    grid = max(1, min(num_sms, MAX_GRID, -(-C // MIN_SLICE)))
    slice_ = (-(-C // grid) + 3) // 4 * 4
    grid = -(-C // slice_)  # rounding the slice up may leave a block empty
    return grid, slice_, min(slice_, MAX_TILE)


@functools.cache
def _library(extra_flags: tuple[str, ...] = ()) -> ctypes.CDLL:
    path, _ = build_library(extra_flags)
    lib = ctypes.CDLL(str(path))
    lib.apex_sample_setup.argtypes = [ctypes.POINTER(ctypes.c_int)]
    lib.apex_sample_setup.restype = ctypes.c_int
    lib.apex_sample_indices.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.apex_sample_indices.restype = ctypes.c_int
    return lib


@functools.cache
def _device_state(index: int) -> tuple[int, torch.Tensor]:
    """SM count and the block-mass scratch of one device, set up once.

    Every call on the device reuses the scratch, so calls must be ordered:
    one stream, or streams the caller synchronises (the learner samples on
    one stream)."""
    lib = _library()
    num_sms = ctypes.c_int(0)
    with torch.cuda.device(index):
        err = lib.apex_sample_setup(ctypes.byref(num_sms))
    if err != 0:
        raise RuntimeError(f"sampling kernel setup failed: cudaError_t {err}")
    scratch = torch.empty(min(num_sms.value, MAX_GRID), dtype=torch.float32,
                          device=torch.device("cuda", index))
    return num_sms.value, scratch


def _launch(priorities: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    if priorities.dtype != torch.float32 or targets.dtype != torch.float32:
        raise TypeError(
            f"sampling kernel takes float32 priorities and targets, got "
            f"{priorities.dtype} and {targets.dtype}"
        )
    if priorities.dim() != 1 or targets.dim() != 1:
        raise ValueError(
            f"sampling kernel takes 1-D priorities and targets, got shapes "
            f"{tuple(priorities.shape)} and {tuple(targets.shape)}"
        )
    if not (priorities.is_contiguous() and targets.is_contiguous()):
        raise ValueError("sampling kernel takes contiguous tensors")
    if targets.device != priorities.device:
        raise ValueError(
            f"priorities on {priorities.device}, targets on {targets.device}"
        )
    C, B = priorities.shape[0], targets.shape[0]
    index = priorities.device.index
    num_sms, scratch = _device_state(index)
    grid, slice_, tile = plan(C, num_sms)
    out = torch.empty(B, dtype=torch.int32, device=priorities.device)
    if B == 0:
        return out
    args = (priorities.data_ptr(), C, targets.data_ptr(), B, grid, slice_, tile,
            scratch.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream(index).cuda_stream)
    if index == torch.cuda.current_device():
        err = _library().apex_sample_indices(*args)
    else:  # the launch goes to the current device's context
        with torch.cuda.device(index):
            err = _library().apex_sample_indices(*args)
    if err != 0:
        raise RuntimeError(f"sampling kernel launch failed: cudaError_t {err}")
    sample_indices.launches += 1
    return out


def sample_indices(priorities: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Stratified inverse-CDF lookup: int32 indices [B] for target masses [B].

    CUDA tensors go to the kernel (which raises on a failed build or
    launch — there is no fallback); CPU tensors to the plain version.  The
    kernel's calls on one device share its scratch and must be ordered on
    one stream; they keep no state from one call to the next, so a call may
    be captured in a CUDA graph."""
    if priorities.device.type == "cpu":
        return sample_indices_reference(priorities, targets)
    if priorities.device.type != "cuda":
        raise ValueError(f"no sampler for device {priorities.device}")
    return _launch(priorities, targets)


sample_indices.launches = 0
