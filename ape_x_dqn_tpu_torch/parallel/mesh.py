"""Device mesh and shardings: the ``(data, model)`` grid of device slots.

Port of ``ape_x_dqn_tpu/parallel/mesh.py``.  The JAX package builds a
``jax.sharding.Mesh`` and lets XLA place and reduce; the port has one
controller per process, which drives every slot of its mesh itself:

* a ``Mesh`` is a ``(data, model)`` grid of ``torch.device`` slots owned by
  this process (``devices[d][m]``); ``shape`` is the global extent, the
  data axis spanning every process of a group (``parallel/multihost.py``);
* each data slot holds its own replica of the train state and its own
  batch rows or ring shard, and the reductions over the data axis run in
  the process (``learner/train_step.slot_mean``);
* a device list may name one device more than once.  Each slot is a device
  in its own right all the same — its own replica, its own shard, and the
  reduce always runs — so four slots on one card run the code path that
  four cards run.

The model axis follows ``infer_param_sharding``'s rule: a kernel whose
output width (the trailing dim of the flax kernel, dim 0 of the torch
weight) is at least ``min_dim`` and divides by the model extent is held as
that many chunks along that dim, one per model slot; everything else is
replicated.  ``place_state`` lays a host train state out so, and
``ShardedTrainState.gather`` puts the chunks back together for a forward.

Shardings are descriptions here (``NamedSharding(mesh, spec)`` with the
JAX spec tuple), read by ``place_state`` and ``parallel/dp.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ape_x_dqn_tpu_torch.types import TrainState


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's ``(data, model)`` grid of device slots."""

    devices: Tuple[Tuple[torch.device, ...], ...]   # [data][model]
    process_count: int = 1

    @property
    def shape(self) -> Dict[str, int]:
        """Global extents: the data axis counts every process's rows."""
        return {"data": len(self.devices) * self.process_count,
                "model": len(self.devices[0])}

    @property
    def local_data(self) -> int:
        """Data slots this process drives."""
        return len(self.devices)

    @property
    def data_devices(self) -> List[torch.device]:
        """The device of each local data slot (its model slot 0)."""
        return [row[0] for row in self.devices]


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A layout over ``mesh``: ``spec`` names the mesh axis each dim is
    split over (None: replicated), as a JAX ``PartitionSpec``."""

    mesh: Mesh
    spec: tuple = ()


def make_mesh(
    num_devices: Optional[int] = None,
    model_parallel: int = 1,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """A ``(data, model)`` mesh over the first ``num_devices`` devices
    (default: all).  ``devices`` defaults to the visible cards; it may
    repeat a device (see the module docstring).  In a process group of W
    processes the mesh spans W times this process's devices, each process
    owning a contiguous block of data rows."""
    from ape_x_dqn_tpu_torch.parallel.multihost import process_count

    if devices is None:
        devs = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    else:
        devs = [torch.device(d) for d in devices]
    w = process_count()
    visible = len(devs) * w
    n = num_devices if num_devices is not None else visible
    if n > visible:
        raise ValueError(f"requested {n} devices, only {visible} visible")
    if n % model_parallel != 0:
        raise ValueError(f"model_parallel={model_parallel} must divide num_devices={n}")
    if n % (w * model_parallel):
        raise ValueError(f"num_devices={n} must split into whole model rows over "
                         f"{w} processes")
    local = devs[:n // w]
    grid = tuple(tuple(local[i:i + model_parallel])
                 for i in range(0, len(local), model_parallel))
    return Mesh(grid, process_count=w)


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, ())


def batch_sharding(mesh: Mesh) -> NamedSharding:
    """Leading axis split over ``data``; all trailing axes replicated."""
    return NamedSharding(mesh, ("data",))


def tree_batch_sharding(tree, mesh: Mesh):
    """Batch sharding for every field of a batch (a dict of the same keys
    for a dict, one sharding for anything else)."""
    sh = batch_sharding(mesh)
    if isinstance(tree, dict):
        return {k: sh for k in tree}
    return sh


def _model_sharded(x, m: int, min_dim: int) -> bool:
    return (m > 1 and isinstance(x, torch.Tensor) and x.dim() >= 2
            and x.shape[0] >= min_dim and x.shape[0] % m == 0)


def infer_param_sharding(params: dict, mesh: Mesh, min_dim: int = 512) -> dict:
    """Tensor-parallel layout rule (JAX :89): split the output-feature dim
    of every kernel at least ``min_dim`` wide that divides by the model
    extent; replicate everything else.  At model = 1 every leaf is
    replicated.  Torch weights are [out, in, ...], so the JAX rule's
    trailing dim of a [in, out] kernel is dim 0 here; the spec says so."""
    m = mesh.shape["model"]

    def rule(x):
        if _model_sharded(x, m, min_dim):
            return NamedSharding(mesh, ("model",) + (None,) * (x.dim() - 1))
        return replicated(mesh)

    return {k: rule(v) for k, v in params.items()}


def shard_train_state(state: TrainState, mesh: Mesh, min_dim: int = 512) -> dict:
    """Sharding tree of a train state (JAX :116): params and target follow
    the param rule, optimizer-state leaves keyed like a param follow it
    (moments mirror their parameters), everything else is replicated."""
    param_sh = infer_param_sharding(state.params, mesh, min_dim)

    def opt_rule(tree):
        return {k: (opt_rule(v) if isinstance(v, dict)
                    else param_sh.get(k, replicated(mesh)))
                for k, v in tree.items()}

    return {"params": param_sh,
            "target_params": infer_param_sharding(state.target_params, mesh, min_dim),
            "opt_state": opt_rule(state.opt_state),
            "step": replicated(mesh), "rng": replicated(mesh)}


def _split(x: torch.Tensor, sh: NamedSharding, j: int, m: int) -> torch.Tensor:
    if sh.spec[:1] == ("model",):
        return x.chunk(m, dim=0)[j]
    return x


@dataclasses.dataclass
class ShardedTrainState:
    """A train state laid out over a mesh: ``replicas[d][m]`` is the
    ``TrainState`` of slot (d, m) on its device, holding model slot m's
    chunk of every model-sharded leaf (``sharded``) and a full copy of the
    rest.  Every data row holds the same values."""

    mesh: Mesh
    replicas: List[List[TrainState]]
    sharded: frozenset = frozenset()

    @property
    def step(self) -> int:
        return self.replicas[0][0].step

    @property
    def rows(self) -> List[TrainState]:
        """Model slot 0 of every local data row."""
        return [row[0] for row in self.replicas]

    def gather(self, d: int = 0, tree: str = "params") -> dict:
        """Data row ``d``'s full ``params`` or ``target_params``, its chunks
        concatenated on the row's device (model slot 0's)."""
        row = self.replicas[d]
        dev = self.mesh.devices[d][0]
        out = {}
        for k, v in getattr(row[0], tree).items():
            if k in self.sharded:
                out[k] = torch.cat([getattr(r, tree)[k].to(dev) for r in row], 0)
            else:
                out[k] = v
        return out

    @property
    def params(self) -> dict:
        """Row 0's full params (every row holds the same)."""
        return self.gather(0)

    def host_state(self) -> TrainState:
        """Row 0's full train state on the CPU (checkpoints, publishes)."""
        r0 = self.replicas[0][0]

        def cpu(t):
            return {k: (cpu(v) if isinstance(v, dict) else
                        v.detach().to("cpu", copy=True) if isinstance(v, torch.Tensor) else v)
                    for k, v in t.items()}

        opt = _gather_opt(self, 0)
        return TrainState(params=cpu(self.gather(0)),
                          target_params=cpu(self.gather(0, "target_params")),
                          opt_state=cpu(opt), step=r0.step, seed=r0.seed,
                          rng_state=r0.rng_state)


def _gather_opt(state: ShardedTrainState, d: int) -> dict:
    row = state.replicas[d]
    dev = state.mesh.devices[d][0]

    def walk(trees):
        out = {}
        for k, v in trees[0].items():
            if isinstance(v, dict):
                out[k] = walk([t[k] for t in trees])
            elif k in state.sharded:
                out[k] = torch.cat([t[k].to(dev) for t in trees], 0)
            else:
                out[k] = v
        return out

    return walk([r.opt_state for r in row])


def place_state(state: TrainState, state_sharding: dict) -> ShardedTrainState:
    """Lay a train state out over the mesh of ``state_sharding`` (from
    ``shard_train_state``): real copies on every slot, chunks where the
    sharding splits the model axis."""
    mesh = state_sharding["params"][next(iter(state.params))].mesh
    m = mesh.shape["model"]
    sharded = frozenset(k for k, sh in state_sharding["params"].items()
                        if sh.spec[:1] == ("model",))

    def put(tree, shs, dev, j):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = put(v, shs[k], dev, j)
            else:
                out[k] = _split(v, shs[k], j, m).detach().to(dev, copy=True).contiguous()
        return out

    replicas = [[TrainState(params=put(state.params, state_sharding["params"], dev, j),
                            target_params=put(state.target_params,
                                              state_sharding["target_params"], dev, j),
                            opt_state=put(state.opt_state, state_sharding["opt_state"], dev, j),
                            step=state.step, seed=state.seed, rng_state=state.rng_state)
                 for j, dev in enumerate(row)]
                for row in mesh.devices]
    return ShardedTrainState(mesh, replicas, sharded)
