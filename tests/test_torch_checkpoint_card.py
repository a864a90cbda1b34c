"""Checkpoint restore onto a graphed learner, on the card.

A learner on the card runs two fused calls (CUDA-graph replays), saves
(the npz leg for the double-store ring; an APXC base plus one delta for the
dedup ring, the delta's gathers copied off the learner thread), then runs
its third call: the reference.  A second learner, built (and captured)
fresh, restores the checkpoint in place and runs the same third call with
its uniforms drawn from the restored generator.  Float32, TF32 off, cuDNN's
deterministic algorithms: the sampled indices, params, ν, target and ring
masses are bit-identical, and the restored learner captured once, at
construction (the restore copies into the captured tensors).

Marked ``gpu``: skipped without a card.  On the card:
``python -m pytest --noconftest -m gpu tests/test_torch_checkpoint_card.py``.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from ape_x_dqn_tpu_torch.learner import train_step as ttrain
from ape_x_dqn_tpu_torch.models import dueling as tdueling
from ape_x_dqn_tpu_torch.runtime.fused_dedup import FusedDedupLearner
from ape_x_dqn_tpu_torch.runtime.fused_learner import FusedDeviceLearner
from ape_x_dqn_tpu_torch.types import DedupChunk, NStepTransition
from ape_x_dqn_tpu_torch.utils.checkpoint import (
    load_replay_leg,
    restore_checkpoint,
    save_checkpoint,
)
from ape_x_dqn_tpu_torch.utils.checkpoint_inc import IncrementalCheckpointer
from test_torch_graphed_call import cuda_device, float32_on_card  # noqa: F401 — fixtures

OBS = (36, 36, 1)


def _learner(layout, dev):
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        net = tdueling.build_network("conv", 3, OBS, channels=(8, 8, 8), hidden=32,
                                     compute_dtype=torch.float32)
    opt = ttrain.make_optimizer("rmsprop", second_moment_dtype=torch.bfloat16)
    state = ttrain.init_train_state(net, opt, seed=0, device=dev,
                                    target_dtype=torch.bfloat16)
    kw = dict(capacity=1024, batch_size=32, steps_per_call=8, ingest_block=64,
              target_sync_freq=8, sample_ahead=layout == "dedup", device=dev)
    if layout == "dedup":
        return FusedDedupLearner(net, opt, state, OBS, frame_ratio=1.25, **kw)
    return FusedDeviceLearner(net, opt, state, OBS, **kw)


def _feed(learner, layout, k, rows=200):
    r = np.random.default_rng(k)
    p = r.integers(1, 5, rows).astype(np.float32)
    if layout == "dedup":
        obs_ref = np.arange(rows, dtype=np.int32)
        obs_ref[:2] = [-2, -1] if k else [0, 1]
        learner.add_chunk(p, DedupChunk(
            frames=r.integers(0, 255, (rows + 1, *OBS), dtype=np.uint8), obs_ref=obs_ref,
            next_ref=np.arange(1, rows + 1, dtype=np.int32),
            action=r.integers(0, 3, rows).astype(np.int32),
            reward=r.normal(size=rows).astype(np.float32),
            discount=np.full(rows, 0.9, np.float32), source=1, chunk_seq=k,
            prev_frames=rows + 1))
    else:
        learner.add_chunk(p, NStepTransition(
            obs=r.integers(0, 255, (rows, *OBS), dtype=np.uint8),
            action=r.integers(0, 3, rows).astype(np.int32),
            reward=r.normal(size=rows).astype(np.float32),
            discount=np.full(rows, 0.9, np.float32),
            next_obs=r.integers(0, 255, (rows, *OBS), dtype=np.uint8)))
    learner.ingest_staged()


def _tensors(learner):
    st = learner.state
    out = {f"params.{k}": v for k, v in st.params.items()}
    out.update({f"target.{k}": v for k, v in st.target_params.items()})
    out.update({f"nu.{k}": v for k, v in st.opt_state["nu"].items()})
    out.update({f"ring.{k}": v for k, v in vars(learner.replay).items()
                if isinstance(v, torch.Tensor)})
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["double", "dedup"])
def test_in_place_restore_onto_a_graphed_learner(tmp_path, cuda_device, float32_on_card,
                                                 layout):
    a = _learner(layout, cuda_device)
    ck = IncrementalCheckpointer(str(tmp_path), a) if layout == "dedup" else None
    for k in range(2):
        _feed(a, layout, k)
        if ck is not None and k == 0:
            assert ck.save(a.step)
            assert ck.flush(60.0)
        a.train(0.5)
    if ck is not None:
        assert ck.save(a.step)     # a delta: its gathers copied by the writer
        assert ck.flush(60.0) and ck.stats()["deltas"] == 1
        ck.close()
    save_checkpoint(str(tmp_path), a.state, replay=None if ck else a, generator=a.generator)
    b = _learner(layout, cuda_device)
    assert b.graphed_call.captures == 1
    restore_checkpoint(str(tmp_path), b.state, generator=b.generator)
    assert load_replay_leg(str(tmp_path), b) == ("incremental" if ck else "snapshot")
    for learner in (a, b):
        learner.ingest_staged(drain=True)
        learner.train(0.5)
    torch.cuda.synchronize()
    assert b.graphed_call.captures == 1          # the restore rebound nothing
    assert torch.equal(a.graphed_call.body.sampled_indices(),
                       b.graphed_call.body.sampled_indices())
    ta, tb = _tensors(a), _tensors(b)
    for name, t in ta.items():
        assert torch.equal(t, tb[name]), name
    assert (a.replay.cursor, a.replay.count, a.size) == (b.replay.cursor, b.replay.count, b.size)
