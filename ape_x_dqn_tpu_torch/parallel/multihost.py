"""Multi-process execution: ``torch.distributed`` across processes.

Port of ``ape_x_dqn_tpu/parallel/multihost.py``.  Where the JAX package
stitches every host's devices into one global device set with
``jax.distributed.initialize``, the port keeps one controller per process:
each process drives a mesh of its own device slots (``parallel/mesh.py``)
and reduces over them in-process, and ``torch.distributed`` carries only
what crosses processes — the gradient mean and the step's scalar metrics
(``learner/train_step.slot_mean`` and ``reduce_slot_metrics`` call
``all_reduce_mean_`` / ``all_reduce_metrics_`` here).  Every process runs
the same program: its own actors feed its own host replay, it samples its
B / process_count rows, the reduced gradient keeps every replica in every
process identical, and it writes back the priorities of its own rows.

The group is ``nccl`` over a ``cuda`` device and ``gloo`` over the CPU; no
other backend is chosen for a device, so a card that cannot join the NCCL
group fails instead of falling back.  ``process_count`` and
``process_index`` are 1 and 0 until ``initialize_multihost`` has run.
Global row order is process order: process p's rows of a global batch are
rows [p·B/W, (p+1)·B/W) (``local_rows``), the inverse of ``local_shard``.
"""

from __future__ import annotations

import datetime
import numpy as np
import torch

# all_reduce calls issued by this process (the card's smoke gates on it).
ALL_REDUCE_CALLS = [0]


def initialize_multihost(
    coordinator: str,
    num_processes: int,
    process_id: int,
    device: str | torch.device = "cuda",
    timeout_s: float = 300.0,
) -> None:
    """Join the process group at ``coordinator`` ("HOST:PORT", the JAX
    spelling; a ``tcp://`` prefix is accepted) as rank ``process_id`` of
    ``num_processes``: ``nccl`` when ``device`` is a card, ``gloo`` on the
    CPU.  Call once, before the learner is built."""
    import torch.distributed as dist

    dev = torch.device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"no process-group backend for device {dev}")
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(dev.index or 0)
    addr = coordinator if coordinator.startswith("tcp://") else f"tcp://{coordinator}"
    dist.init_process_group(backend, init_method=addr, world_size=int(num_processes),
                            rank=int(process_id),
                            timeout=datetime.timedelta(seconds=timeout_s))


def shutdown_multihost() -> None:
    """Leave the process group, if one is up."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def _group_up() -> bool:
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()


def process_count() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if _group_up() else 1


def process_index() -> int:
    import torch.distributed as dist

    return dist.get_rank() if _group_up() else 0


def all_reduce_mean_(tree: dict) -> dict:
    """Average a dict of tensors across the processes in place (one
    ``all_reduce`` over their concatenation, divided by the process count);
    a no-op without a process group."""
    if not _group_up():
        return tree
    import torch.distributed as dist

    keys = list(tree)
    flat = torch.cat([tree[k].reshape(-1) for k in keys])
    dist.all_reduce(flat)
    ALL_REDUCE_CALLS[0] += 1
    flat.div_(dist.get_world_size())
    off = 0
    for k in keys:
        v = tree[k]
        v.copy_(flat[off:off + v.numel()].view_as(v))
        off += v.numel()
    return tree


def all_reduce_metrics_(means: torch.Tensor, peak: torch.Tensor):
    """The step's scalar metrics across processes: ``means`` averaged,
    ``peak`` maxed (JAX's pmean/pmax over the global mesh); returned as
    they are without a process group."""
    if not _group_up():
        return means, peak
    import torch.distributed as dist

    dist.all_reduce(means)
    dist.all_reduce(peak, op=dist.ReduceOp.MAX)
    ALL_REDUCE_CALLS[0] += 2
    return means.div_(dist.get_world_size()), peak


def host_value(x) -> np.ndarray:
    """Host numpy of a replicated value (loss, step, a param leaf): every
    process holds the full value."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu").numpy()
    return np.asarray(x)


def local_rows(n_global: int) -> slice:
    """This process's rows of a global batch of ``n_global`` rows."""
    w, p = process_count(), process_index()
    if n_global % w:
        raise ValueError(f"{n_global} rows do not split over {w} processes")
    per = n_global // w
    return slice(p * per, (p + 1) * per)


def local_shard(x) -> np.ndarray:
    """This process's rows of a data-sharded value (the step's priorities),
    in global row order.  The port's step already returns only this
    process's rows, its slots in order (``reduce_slot_metrics``)."""
    return host_value(x)


def barrier(name: str) -> None:
    """Cross-process synchronisation point (a no-op in one process), e.g.
    every process's replay leg on disk before process 0 commits the
    checkpoint's state leg; ``name`` says which, for a reader."""
    if _group_up():
        import torch.distributed as dist

        dist.barrier()
