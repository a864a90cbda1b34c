"""The optimizer's global-norm clip and RMSProp update: one CUDA kernel pair.

No TPU kernel is ported here: the JAX package leaves optax's
``clip_by_global_norm`` and ``rmsprop`` to XLA, which fuses them into the
step's program.  Eager PyTorch runs ``learner/train_step.Optimizer``'s
``clip`` and ``_update`` op by op and leaf by leaf: 240 launches a step for
config3's network.  ``csrc/rmsprop.cu`` does the same arithmetic, op by op,
in two launches over every leaf; the note at its top gives the design and
its byte bound.

* ``on_card(params, grads)`` — the part of the dispatch rule that reads
  the tensors: whether any param or gradient is a CUDA tensor.
  ``Optimizer.update_`` adds the rest (RMSProp, no float32 master copy)
  and then always calls ``update_``.  Every other case runs the plain
  version, ``Optimizer.clip`` then ``Optimizer.apply_``: the CPU, Adam,
  the master copy, and the data-parallel step, which clips and applies
  apart.
* ``check(params, grads, nu)`` — raises ``ValueError`` unless the kernel
  takes these tensors: at most ``MAX_LEAVES`` leaves; every param a
  contiguous float32 CUDA tensor, every ν a contiguous float32 or bfloat16
  one (all of one dtype), every gradient a float32 CUDA tensor, contiguous
  or of at most ``MAX_DIMS`` dims (the kernel reads it through its
  strides: cuDNN hands back the conv weights' gradients channels-last),
  all on one device.
* ``update_(params, grads, nu, ...)`` — the step in place, or an error:
  there is no fallback, so no step on the card reaches the plain version
  unseen.  ``update_.launches`` counts the kernel's launches (two a step,
  one without a clip), so a run can show that its steps went through the
  kernel; ``runtime/graphed_call`` adds a graph's captured launches after
  each of its replays.

The norm's partial sums live in one float32 buffer per device, allocated
at the device's first call, which must be eager (a graph's warm-up is), so
no capture takes it from its private pool.  Calls on one device share it,
so they must be ordered on one stream, as the learner's are.  The library
is built with ``nvcc`` for ``sm_90a`` at first use (``ops/sampling.
build_cuda_library``) and loaded with ``ctypes``.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch

from ape_x_dqn_tpu_torch.ops.sampling import build_cuda_library

THREADS = 256        # threads a block (the kernel's kThreads)
MAX_GRID = 1024      # blocks a launch at most (the kernel's kMaxGrid)
MAX_DIMS = 4         # dims of a gradient read through its strides (kMaxDims)
MAX_LEAVES = 48      # leaves a call at most (kMaxLeaves: one table a launch)
BLOCKS_PER_SM = 4    # the grid covers every SM this many times
NU_DTYPES = (torch.float32, torch.bfloat16)
_INT32 = 2**31

_SOURCE = Path(__file__).resolve().parent / "csrc" / "rmsprop.cu"
# Per device index: (blocks a launch at most, the norm's partials).
_DEVICES: Dict[int, Tuple[int, torch.Tensor]] = {}


def build_library(extra_flags: tuple[str, ...] = ()) -> tuple[Path, str]:
    """``csrc/rmsprop.cu``'s library (``sampling.build_cuda_library``)."""
    return build_cuda_library(_SOURCE, "libapex_rmsprop", extra_flags)


@functools.cache
def _library() -> ctypes.CDLL:
    path, _ = build_library()
    lib = ctypes.CDLL(str(path))
    lib.apex_rmsprop_setup.argtypes = [ctypes.POINTER(ctypes.c_int)]
    lib.apex_rmsprop_setup.restype = ctypes.c_int
    ptrs = ctypes.POINTER(ctypes.c_void_p)
    ints = ctypes.POINTER(ctypes.c_int)
    lib.apex_rmsprop_step.argtypes = [
        ptrs, ptrs, ptrs, ctypes.POINTER(ctypes.c_longlong), ints, ints, ints, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_float,
        ctypes.c_float, ctypes.c_float, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.apex_rmsprop_step.restype = ctypes.c_int
    return lib


def _device_state(index: int) -> Tuple[int, torch.Tensor]:
    """The grid's largest size and the partials buffer of one device, set
    up at its first call."""
    state = _DEVICES.get(index)
    if state is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("the RMSProp kernel's first call on a device must be eager "
                               "(a capture would own its scratch buffer)")
        num_sms = ctypes.c_int(0)
        with torch.cuda.device(index):
            err = _library().apex_rmsprop_setup(ctypes.byref(num_sms))
        if err != 0:
            raise RuntimeError(f"RMSProp kernel setup failed: cudaError_t {err}")
        grid = max(1, min(MAX_GRID, num_sms.value * BLOCKS_PER_SM))
        partials = torch.empty(grid, dtype=torch.float32, device=torch.device("cuda", index))
        state = _DEVICES[index] = (grid, partials)
    return state


def _strided(g) -> bool:
    """Whether the kernel reads ``g`` through its strides: at most
    ``MAX_DIMS`` dims, every element and offset in int32 range."""
    return (g.dim() <= MAX_DIMS and g.numel() < _INT32
            and sum((n - 1) * s for n, s in zip(g.shape, g.stride())) < _INT32)


def on_card(params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor]) -> bool:
    """Whether any of ``params`` or ``grads`` is a CUDA tensor."""
    return any(t.device.type == "cuda" for tree in (params, grads) for t in tree.values())


def check(params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor],
          nu: Dict[str, torch.Tensor]) -> None:
    """Raises ``ValueError`` unless the kernel takes these tensors (see the
    module docstring)."""
    def refuse(why):
        raise ValueError(f"the RMSProp kernel takes {why}")

    if len(grads) > MAX_LEAVES:
        refuse(f"at most {MAX_LEAVES} leaves, not {len(grads)}")
    device, nu_dtype = None, None
    for k, g in grads.items():
        p, v = params[k], nu[k]
        for what, t in (("gradient", g), ("param", p), ("ν", v)):
            if t.device.type != "cuda":
                refuse(f"CUDA tensors alone: leaf {k}'s {what} is on {t.device}")
            if device is None:
                device = t.device
            elif t.device != device:
                refuse(f"tensors on one device: leaf {k}'s {what} is on {t.device}, "
                       f"not {device}")
        if g.dtype != torch.float32 or p.dtype != torch.float32:
            refuse(f"float32 params and gradients: leaf {k}'s are {p.dtype} and {g.dtype}")
        if v.dtype not in NU_DTYPES or v.dtype != (nu_dtype or v.dtype):
            refuse(f"float32 or bfloat16 ν of one dtype: leaf {k}'s is {v.dtype}")
        nu_dtype = v.dtype
        if not (p.is_contiguous() and v.is_contiguous()):
            refuse(f"contiguous params and ν: leaf {k}'s are not")
        if not (g.is_contiguous() or _strided(g)):
            refuse(f"gradients of at most {MAX_DIMS} dims in another layout than "
                   f"the param's: leaf {k}'s has {g.dim()}")


def update_(params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor],
            nu: Dict[str, torch.Tensor], *, learning_rate: float, decay: float, eps: float,
            max_grad_norm: Optional[float]) -> None:
    """Clip ``grads`` by their global norm (unless ``max_grad_norm`` is None)
    and step every ``params[k]`` and ``nu[k]`` of a key of ``grads`` in
    place, on the current stream: two launches, no allocation, no sync."""
    check(params, grads, nu)
    leaves = []
    for k, g in grads.items():
        p, v = params[k], nu[k]
        if p.shape != g.shape or v.shape != g.shape:
            raise ValueError(f"leaf {k}: param {tuple(p.shape)}, gradient {tuple(g.shape)}, "
                             f"ν {tuple(v.shape)}")
        if g.numel():
            leaves.append((g, p, v))
    if not leaves:
        return
    index = leaves[0][0].device.index
    grid_max, partials = _device_state(index)
    total = sum(g.numel() for g, _, _ in leaves)
    grid = max(1, min(grid_max, -(-total // (THREADS * 4))))
    n = len(leaves)

    def table(col):
        return (ctypes.c_void_p * n)(*[leaf[col].data_ptr() for leaf in leaves])

    # A gradient laid out otherwise than its param goes with its sizes and
    # strides; a contiguous one with ndim 0.
    ndim, sizes, strides = [], [], []
    for g, _, _ in leaves:
        dims = [] if g.is_contiguous() else list(zip(g.shape, g.stride()))
        ndim.append(len(dims))
        dims += [(0, 0)] * (MAX_DIMS - len(dims))
        sizes += [d for d, _ in dims]
        strides += [s for _, s in dims]
    clip = max_grad_norm is not None
    lib = _library()
    args = (table(0), table(1), table(2),
            (ctypes.c_longlong * n)(*[g.numel() for g, _, _ in leaves]),
            (ctypes.c_int * n)(*ndim), (ctypes.c_int * len(sizes))(*sizes),
            (ctypes.c_int * len(strides))(*strides), n,
            int(leaves[0][2].dtype == torch.bfloat16), int(clip),
            # The float constants PyTorch's scalar ops use: each cast from
            # the Python double, 1 − ρ taken in double first.
            decay, 1.0 - decay, eps, -learning_rate, max_grad_norm if clip else 0.0,
            partials.data_ptr(), grid, torch.cuda.current_stream(index).cuda_stream)
    if index == torch.cuda.current_device():
        err = lib.apex_rmsprop_step(*args)
    else:  # the launches go to the current device's context
        with torch.cuda.device(index):
            err = lib.apex_rmsprop_step(*args)
    if err != 0:
        raise RuntimeError(f"RMSProp kernel launch failed: cudaError_t {err}")
    update_.launches += 2 if clip else 1


update_.launches = 0
