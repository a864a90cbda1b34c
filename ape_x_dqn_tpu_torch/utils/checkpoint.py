"""Checkpoint save and resume: the whole train state and the replay.

Port of ``ape_x_dqn_tpu/utils/checkpoint.py``.  The reference can only load
the online net; this saves and restores everything: params, target,
optimizer state (the float32 master, ν, μ), ``step``, ``seed`` and the
fused learner's sampling generator, plus the replay as a ``replay.npz``
snapshot or as the incremental chain of ``utils/checkpoint_inc``.

Layout under ``<root>/`` (the JAX package's, but for the state leg):
    step_<N>/torch_state/train_state.apxt — the train state (APXT tree)
    step_<N>/replay<sfx>.npz              — optional replay snapshot
    replay_inc<sfx>/                      — incremental replay chain

The state leg is the port's own: the JAX package writes an orbax tree
under ``step_<N>/state/``, which the port cannot read.  The port writes one
APXT file (``utils/serialization.py``: bf16 leaves as their uint16 bits,
never cast) under a marker directory of another name, written under a
temporary name and renamed into place.  So neither package's
``latest_step`` mistakes the other's checkpoint for its own, and a port
restore pointed at a root that holds only JAX steps raises
``ForeignCheckpointError``, naming the conversion (``weights.
train_state_from_jax``), instead of starting from scratch.  The replay
legs keep the JAX package's keys and dtypes and load across the packages
as they are.

Commit order, as in the JAX package: every replay leg first, the state leg
last.  The state leg is the commit marker: ``latest_step`` and ``keep``
count only steps that have it, so a reader never sees a step whose state
is half written.

The state leg also carries the sampling generator's state
(``sampler_rng``).  The fused learners draw each call's uniforms from a
``torch.Generator`` that lives outside ``TrainState``; without it a resumed
learner would sample other slots than the uninterrupted one.  A generator
state saved on another device type (CPU against CUDA) cannot be adopted:
the restore then keeps the freshly seeded stream and emits a
``sampler_rng_reseeded`` event.
"""

from __future__ import annotations

import os
import re
import shutil
from typing import Optional, Tuple

import numpy as np
import torch

from ape_x_dqn_tpu_torch.types import TrainState
from ape_x_dqn_tpu_torch.utils.metrics import emit_event
from ape_x_dqn_tpu_torch.utils.serialization import tree_from_file, tree_to_bytes

_STEP_RE = re.compile(r"^step_(\d+)$")
STATE_LEG = "torch_state"          # the port's commit marker directory
STATE_FILE = "train_state.apxt"
JAX_STATE_LEG = "state"            # the JAX package's (orbax)


class ForeignCheckpointError(ValueError):
    """The root holds only the JAX package's (orbax) checkpoints."""


def _step_dir(root: str, step: int) -> str:
    return os.path.join(os.path.abspath(root), f"step_{step}")


def _committed(root: str, leg: str = STATE_LEG) -> list:
    """Steps under ``root`` whose ``leg`` directory exists, ascending."""
    if not os.path.isdir(root):
        return []
    return sorted(
        int(m.group(1))
        for m in (_STEP_RE.match(n) for n in os.listdir(root))
        if m and os.path.isdir(os.path.join(root, m.group(0), leg))
    )


def latest_step(root: str) -> Optional[int]:
    """Newest step with a committed state leg of the port, or None."""
    steps = _committed(root)
    return steps[-1] if steps else None


def _state_tree(state: TrainState, generator: Optional[torch.Generator] = None) -> dict:
    """The state leg's tree: params, target, optimizer state, ``step``,
    ``seed`` and, when there is one, the sampling generator's state."""
    tree = {
        "params": state.params,
        "target_params": state.target_params,
        "opt_state": state.opt_state,
        "step": np.asarray(int(state.step), np.int64),
        "seed": np.asarray(int(state.seed), np.int64),
    }
    rng = generator.get_state() if generator is not None else state.rng_state
    if rng is not None:
        tree["sampler_rng"] = rng.cpu().numpy()
    return tree


def _write_state_leg(path: str, state: TrainState, generator) -> None:
    """``path/torch_state/`` via a temporary directory and one rename."""
    final = os.path.join(path, STATE_LEG)
    tmp = f"{final}.tmp-{os.getpid()}"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    with open(os.path.join(tmp, STATE_FILE), "wb") as f:
        f.write(tree_to_bytes(_state_tree(state, generator)))
        f.flush()
        os.fsync(f.fileno())
    if os.path.isdir(final):  # a re-save of the same step replaces it
        shutil.rmtree(final)
    os.replace(tmp, final)
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def save_checkpoint(
    root: str,
    state: TrainState,
    replay=None,
    keep: int = 3,
    replay_suffix: str = "",
    generator: Optional[torch.Generator] = None,
) -> str:
    """Save the train state (and optionally the replay) at its step.

    The replay leg lands first, the state leg last (the commit marker).
    ``generator`` is the fused learner's sampling generator (None: the
    state's own ``rng_state``, if any).  Keeps the newest ``keep``
    committed steps.  Returns the step directory."""
    path = _step_dir(root, int(state.step))
    os.makedirs(path, exist_ok=True)
    if replay is not None:
        np.savez(os.path.join(path, f"replay{replay_suffix}.npz"), **replay.state_dict())
    _write_state_leg(path, state, generator)
    if keep is not None:
        _prune(root, keep)
    return path


def save_replay_snapshot(root: str, step: int, replay, replay_suffix: str = "") -> str:
    """Replay-only save into ``step_<step>/`` (the step counts only once
    its state leg lands)."""
    path = _step_dir(root, step)
    os.makedirs(path, exist_ok=True)
    file = os.path.join(path, f"replay{replay_suffix}.npz")
    np.savez(file, **replay.state_dict())
    return file


def _foreign(root: str) -> ForeignCheckpointError:
    return ForeignCheckpointError(
        f"{root} holds only the JAX package's (orbax) checkpoints; restore "
        "one with ape_x_dqn_tpu.utils.checkpoint.restore_checkpoint, carry it "
        "across with ape_x_dqn_tpu_torch.weights.train_state_from_jax and save "
        "it with this module's save_checkpoint"
    )


def _resolve_step_path(root_or_path: str) -> str:
    """An explicit ``step_N`` dir passes through; a root resolves to its
    newest committed step (``FileNotFoundError`` when there is none,
    ``ForeignCheckpointError`` when only JAX steps are there)."""
    root_or_path = os.path.abspath(root_or_path)
    if _STEP_RE.match(os.path.basename(root_or_path)):
        if not os.path.isdir(os.path.join(root_or_path, STATE_LEG)) and \
                os.path.isdir(os.path.join(root_or_path, JAX_STATE_LEG)):
            raise _foreign(root_or_path)
        return root_or_path
    step = latest_step(root_or_path)
    if step is None:
        if _committed(root_or_path, JAX_STATE_LEG):
            raise _foreign(root_or_path)
        raise FileNotFoundError(f"no checkpoint under {root_or_path}")
    return _step_dir(root_or_path, step)


def read_state_leg(root_or_path: str, subtree: Optional[str] = None):
    """The newest (or an explicit ``step_N``) state leg as a tree of numpy
    arrays (bf16 leaves as CPU bf16 tensors); with ``subtree`` only that
    part is read (``"params"`` for serving)."""
    path = _resolve_step_path(root_or_path)
    return tree_from_file(os.path.join(path, STATE_LEG, STATE_FILE), subtree)


def _copy_into(template: dict, tree: dict, where: str) -> None:
    if set(template) != set(tree):
        raise ValueError(f"checkpoint {where or 'state'} keys {sorted(tree)} != "
                         f"the learner's {sorted(template)}")
    for key, t in template.items():
        src = tree[key]
        if isinstance(t, dict):
            _copy_into(t, src, f"{where}{key}.")
            continue
        src = src if isinstance(src, torch.Tensor) else torch.from_numpy(np.asarray(src))
        if tuple(src.shape) != tuple(t.shape) or src.dtype != t.dtype:
            raise ValueError(f"checkpoint leaf {where}{key}: {src.dtype}{tuple(src.shape)} "
                             f"!= the learner's {t.dtype}{tuple(t.shape)}")
        t.copy_(src)


def adopt_rng_state(generator: torch.Generator, rng_state: torch.Tensor) -> bool:
    """Set ``generator`` to a saved state; False (and an event) when the
    state was saved on another device type."""
    try:
        generator.set_state(rng_state)
        return True
    except RuntimeError as e:
        emit_event("sampler_rng_reseeded", device=str(generator.device),
                   consequence="the sampling stream restarts from the seed",
                   error=str(e))
        return False


def restore_checkpoint(
    root_or_path: str,
    state_template: TrainState,
    replay=None,
    replay_suffix: str = "",
    generator: Optional[torch.Generator] = None,
) -> Tuple[TrainState, int]:
    """Restore the newest (or an explicit ``step_N``) checkpoint into
    ``state_template`` in place and return ``(state_template, step)``.

    Every tensor is copied into the template's own tensor, so a learner
    built on the template (and its captured CUDA graphs) keeps its
    addresses.  ``step``, ``seed`` and ``rng_state`` are set; with
    ``generator`` the saved sampling state is adopted at once.  With
    ``replay``, the replay leg restores too (``load_replay_leg``); a
    checkpoint without one emits ``checkpoint_restore_missing_replay``.

    A missing checkpoint raises ``FileNotFoundError``: the caller decides
    whether that means "start from scratch" (the reference's fallback)."""
    path = _resolve_step_path(root_or_path)
    tree = read_state_leg(path)
    with torch.no_grad():
        for key in ("params", "target_params", "opt_state"):
            _copy_into(getattr(state_template, key), tree[key], f"{key}.")
    state_template.step = int(tree["step"])
    state_template.seed = int(tree["seed"])
    rng = tree.get("sampler_rng")
    state_template.rng_state = torch.from_numpy(np.asarray(rng)) if rng is not None else None
    if generator is not None and state_template.rng_state is not None:
        adopt_rng_state(generator, state_template.rng_state)
    if replay is not None and load_replay_leg(path, replay,
                                              replay_suffix=replay_suffix) is None:
        emit_event("checkpoint_restore_missing_replay", path=path,
                   replay_file=f"replay{replay_suffix}.npz",
                   consequence="resuming with an empty buffer")
    return state_template, state_template.step


def load_replay_snapshot(root_or_path: str, replay, replay_suffix: str = "") -> bool:
    """Load the newest (or an explicit ``step_N``) checkpoint's
    ``replay.npz`` into ``replay`` (any object with ``load_state_dict``).
    False when the step has none.  The npz is the JAX package's layout, so
    an explicit step of either package loads."""
    path = os.path.abspath(root_or_path)
    if not _STEP_RE.match(os.path.basename(path)):
        path = _resolve_step_path(path)
    replay_file = os.path.join(path, f"replay{replay_suffix}.npz")
    if not os.path.exists(replay_file):
        return False
    with np.load(replay_file) as z:
        replay.load_state_dict({k: z[k] for k in z.files})
    return True


def load_replay_leg(root_or_path: str, replay, replay_suffix: str = "",
                    fallback: bool = True, on_fallback=None) -> Optional[str]:
    """Restore the replay from whichever leg the checkpoint has: the step's
    ``replay.npz`` first, else the committed incremental chain under
    ``<root>/replay_inc<suffix>/``.  Returns ``"snapshot"``,
    ``"incremental"`` or None.  ``fallback`` (the default here) walks a
    corrupt chain back to its longest good prefix or the previous
    generation, with a ``degraded_restore`` event; only a chain with no
    restorable rung raises ``ChunkCorrupt``."""
    from ape_x_dqn_tpu_torch.utils.checkpoint_inc import load_incremental_replay

    try:
        if load_replay_snapshot(root_or_path, replay, replay_suffix=replay_suffix):
            return "snapshot"
    except FileNotFoundError:
        pass  # no committed step: the chain may still exist
    root = os.path.abspath(root_or_path)
    if _STEP_RE.match(os.path.basename(root)):
        root = os.path.dirname(root)
    if load_incremental_replay(root, replay, suffix=replay_suffix, fallback=fallback,
                               on_event=on_fallback) is not None:
        return "incremental"
    return None


def _prune(root: str, keep: int) -> None:
    """Keep the newest ``keep`` committed steps; uncommitted directories
    (a crash between the legs) never displace a real checkpoint."""
    steps = _committed(root)
    for s in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(_step_dir(root, s), ignore_errors=True)
