"""A tcp-fed fused call equals an shm-fed one over the same records.

The same worker records (``DXP`` frame-dedup chunks, as config3's learner
ingests them) go through a ``ProcessActorPool`` on each transport — the
shm ring and the tcp wire with coalescing and in-window frame dedup on —
into a frame-dedup fused learner (sample-ahead, bf16 ν and target), which
runs two calls from one seed.  The sampled indices, the params, ν, the
target and the ring must be bit-identical: the transport changes how the
bytes travel, never what the learner trains on.  Float32 compute, TF32 off
and cuDNN's deterministic algorithms on the card.

The CPU case runs here; the ``gpu``-marked case runs on the card:
``python -m pytest --noconftest -m gpu tests/test_torch_net_card.py``.
"""

from __future__ import annotations

import time

import numpy as np
import pytest
import torch

from ape_x_dqn_tpu_torch.actors.pool import Chunk
from ape_x_dqn_tpu_torch.config import ApexConfig
from ape_x_dqn_tpu_torch.learner import train_step as ttrain
from ape_x_dqn_tpu_torch.models import dueling as tdueling
from ape_x_dqn_tpu_torch.runtime.fused_dedup import FusedDedupLearner
from ape_x_dqn_tpu_torch.runtime.process_actors import ProcessActorPool, encode_record
from ape_x_dqn_tpu_torch.runtime.transport import connect_channel
from ape_x_dqn_tpu_torch.types import DedupChunk
from test_torch_graphed_call import cuda_device, float32_on_card  # noqa: F401 — fixtures

OBS = (36, 36, 1)


def _records(n=6, rows=96):
    """``n`` chained dedup chunks of one source (carries reach back one
    chunk), encoded as a worker encodes them."""
    r = np.random.default_rng(0)
    out = []
    for k in range(n):
        obs_ref = np.arange(rows, dtype=np.int32)
        if k:
            obs_ref[:2] = [-2, -1]
        chunk = DedupChunk(
            frames=r.integers(0, 255, (rows + 1, *OBS), dtype=np.uint8), obs_ref=obs_ref,
            next_ref=np.arange(1, rows + 1, dtype=np.int32),
            action=r.integers(0, 3, rows).astype(np.int32),
            reward=r.normal(size=rows).astype(np.float32),
            discount=np.full(rows, 0.9, np.float32), source=7, chunk_seq=k,
            prev_frames=rows + 1)
        prio = r.integers(1, 5, rows).astype(np.float32)
        out.append(encode_record(Chunk(prio, chunk, rows), param_version=k + 1))
    return out


def _delivered(transport):
    """The (priorities, DedupChunk) pairs a pool on ``transport`` hands its
    sink for ``_records()``."""
    cfg = ApexConfig()
    cfg.network = "mlp"
    cfg.env.name = "chain:6"
    cfg.actor.mode = "process"
    cfg.actor.num_workers = 1
    cfg.actor.num_actors = 2
    cfg.actor.transport = transport
    if transport == "tcp":
        cfg.actor.net_coalesce_bytes = 1 << 20
    cfg.validate()
    pool = ProcessActorPool(cfg, num_workers=1)
    records = _records()
    try:
        pool._queues[0] = pool._ctx.Queue(maxsize=4)
        pool._rings[0] = pool._transport.make_channel(0, 0)
        w = connect_channel(pool._transport.endpoint(pool._rings[0], 0, 0))
        items = []
        for parts in records:
            assert w.write(parts, timeout=10)
            items += pool.poll(max_items=64)      # the ring holds ~one chunk
        if transport == "tcp":
            assert w.flush(timeout=10)
        deadline = time.monotonic() + 20.0
        while len(items) < len(records) and time.monotonic() < deadline:
            items += pool.poll(max_items=64)
            time.sleep(0.01)
        w.close()
        if transport == "tcp":
            assert pool.net_stats()["torn_frames"] == 0
        # The sink copies, as the runtime's process sink does.
        return [(p.copy(), t.copy()) for p, t in items]
    finally:
        pool.stop(join_timeout=1.0)


def _train(dev, items, calls=2):
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        net = tdueling.build_network("conv", 3, OBS, channels=(8, 8, 8), hidden=32,
                                     compute_dtype=torch.float32)
    opt = ttrain.make_optimizer("rmsprop", second_moment_dtype=torch.bfloat16)
    state = ttrain.init_train_state(net, opt, seed=0, device=dev, target_dtype=torch.bfloat16)
    learner = FusedDedupLearner(net, opt, state, OBS, frame_ratio=1.25, capacity=1024,
                                batch_size=32, steps_per_call=8, ingest_block=64,
                                target_sync_freq=8, sample_ahead=True, device=dev)
    for prio, chunk in items:
        learner.add_chunk(prio, chunk)
    learner.ingest_staged(drain=True)
    indices = []
    for _ in range(calls):
        learner.train(0.5)
        indices.append(learner.graphed_call.body.sampled_indices().clone())
    st = learner.state
    out = {f"params.{k}": v for k, v in st.params.items()}
    out.update({f"target.{k}": v for k, v in st.target_params.items()})
    out.update({f"nu.{k}": v for k, v in st.opt_state["nu"].items()})
    out.update({f"ring.{k}": v for k, v in vars(learner.replay).items()
                if isinstance(v, torch.Tensor)})
    return indices, out


def _assert_tcp_equals_shm(dev):
    shm, tcp = _delivered("shm"), _delivered("tcp")
    assert len(shm) == len(tcp) == 6
    ia, ta = _train(dev, shm)
    ib, tb = _train(dev, tcp)
    for a, b in zip(ia, ib):
        assert torch.equal(a, b)
    for name, t in ta.items():
        assert torch.equal(t, tb[name]), name


def test_tcp_fed_call_equals_shm_fed_call_on_cpu():
    _assert_tcp_equals_shm(torch.device("cpu"))


@pytest.mark.gpu
def test_tcp_fed_call_equals_shm_fed_call_on_card(cuda_device, float32_on_card):
    _assert_tcp_equals_shm(cuda_device)
