"""The port's data-parallel learner across processes (twins of
``tests/test_multihost.py``): two OS processes in a ``gloo`` group on
localhost, each driving 2 CPU slots of one 4-slot mesh, the gradient mean
crossing the process boundary as an ``all_reduce`` of each process's
local slot mean (``parallel/multihost.py``).

Each run is 2 processes × 1 intra-op thread on a free port; every wait has
a deadline and a child that outlives it is killed.  ``step``: the two
processes' losses and params are bit-identical (one reduced gradient), and
equal a single-process 4-slot run of the port on the same batches within
float32 summation order: params rtol 1e-5 atol 1e-7 (RMSProp with ε = 1,
linear in the gradient).  ``pipeline``: the async runtime end to end, the
params bit-identical across the processes after 60 steps.  ``checkpoint``:
each process saves its own replay leg (``replay_h<i>.npz``, or its own
``replay_inc_h<i>`` chain) and restores exactly that, bit for bit.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_harness import port_deadline  # noqa: F401 — the per-test deadline, autouse

CHILD = Path(__file__).parent / "_torch_multihost_child.py"
REPO = str(Path(__file__).parent.parent)
DEADLINE_S = 240.0


def step_parts():
    """The net, optimizer and initial state every process builds alike."""
    from ape_x_dqn_tpu_torch.learner import train_step as ttrain
    from ape_x_dqn_tpu_torch.models import dueling as tdueling

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        net = tdueling.DuelingMLP(3, (6,), hidden_sizes=(32,))
    opt = ttrain.Optimizer("rmsprop", learning_rate=1e-3, rmsprop_eps=1.0)
    return net, opt, ttrain.init_train_state(net, opt, seed=0, device="cpu")


def batch(i, B=16):
    from ape_x_dqn_tpu_torch.types import NStepTransition, PrioritizedBatch

    r = np.random.default_rng(i)
    t = NStepTransition(obs=r.integers(0, 255, (B, 6), dtype=np.uint8),
                        action=r.integers(0, 3, (B,)).astype(np.int32),
                        reward=r.normal(size=(B,)).astype(np.float32),
                        discount=np.full((B,), 0.97, np.float32),
                        next_obs=r.integers(0, 255, (B, 6), dtype=np.uint8))
    return PrioritizedBatch(transition=t, indices=np.arange(B, dtype=np.int32),
                            is_weights=np.ones((B,), np.float32))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_children(mode: str, tmp_path, n: int = 2) -> dict:
    port = _free_port()
    env = {**os.environ, "OMP_NUM_THREADS": "1", "CUDA_VISIBLE_DEVICES": "",
           "PYTHONPATH": os.pathsep.join([str(CHILD.parent), REPO,
                                          os.environ.get("PYTHONPATH", "")])}
    procs = [subprocess.Popen([sys.executable, str(CHILD), str(pid), str(n), str(port), mode,
                               str(tmp_path / f"params{pid}.npz")],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
             for pid in range(n)]
    results = {}
    try:
        for p in procs:
            out, err = p.communicate(timeout=DEADLINE_S)
            assert p.returncode == 0, f"child failed:\n{out}\n{err[-3000:]}"
            for line in out.splitlines():
                if line.startswith("RESULT"):
                    parts = line.split()
                    results[int(parts[1])] = (float(parts[2]), int(parts[3]), float(parts[4]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate(timeout=30)
    assert set(results) == set(range(n)), results
    return results


def _params(tmp_path, pid):
    with np.load(tmp_path / f"params{pid}.npz") as f:
        return {k: f[k] for k in f.files}


def test_two_process_mesh_trains_in_lockstep(tmp_path):
    from ape_x_dqn_tpu_torch.parallel import build_sharded_train_step, make_mesh, place_batch

    results = _run_children("step", tmp_path)
    (l0, s0, _), (l1, s1, _) = results[0], results[1]
    assert s0 == s1 == 3
    assert l0 == l1                     # one reduced loss in both processes
    p0, p1 = _params(tmp_path, 0), _params(tmp_path, 1)
    for k in p0:
        np.testing.assert_array_equal(p0[k], p1[k], err_msg=k)
    # The same three steps in this process over 4 CPU slots.
    net, opt, state = step_parts()
    mesh = make_mesh(devices=[torch.device("cpu")] * 4)
    step_fn, sharded = build_sharded_train_step(net, opt, mesh, state, target_sync_freq=100)
    for i in range(3):
        sharded, metrics = step_fn(sharded, place_batch(batch(i), mesh))
    np.testing.assert_allclose(l0, float(metrics.loss), rtol=1e-5)
    for k, v in sharded.params.items():
        np.testing.assert_allclose(p0[k], v.numpy(), rtol=1e-5, atol=1e-7, err_msg=k)


def test_two_process_async_pipeline_end_to_end(tmp_path):
    """The whole runtime in each process — its actors and host replay, its
    B/2 rows of every global batch, the all-reduce, its own write-back —
    params bit-identical across the processes after 60 learner steps."""
    results = _run_children("pipeline", tmp_path)
    (loss0, step0, dig0), (loss1, step1, dig1) = results[0], results[1]
    assert step0 == step1 >= 60
    assert np.isfinite(loss0) and np.isfinite(loss1)
    assert dig0 == dig1
    p0, p1 = _params(tmp_path, 0), _params(tmp_path, 1)
    for k in p0:
        np.testing.assert_array_equal(p0[k], p1[k], err_msg=k)


@pytest.mark.parametrize("leg", ["npz", "inc"])
def test_two_process_checkpoint_restores_each_replay_shard(tmp_path, leg):
    """Both processes checkpoint every 20 steps into one directory; each
    then restores its own replay shard through the resume gate and finds
    the last snapshot it saved, every column and one fixed-generator sample
    equal (checked in the child)."""
    results = _run_children(f"ckpt_{leg}", tmp_path)
    assert results[0][1] == results[1][1] >= 60
    ckpt = tmp_path / "ckpt"
    for pid in range(2):
        if leg == "npz":
            assert (ckpt / "step_60" / f"replay_h{pid}.npz").is_file()
        else:
            assert (ckpt / f"replay_inc_h{pid}" / "MANIFEST.json").is_file()
    assert not (ckpt / "step_60" / "replay.npz").exists()
    assert not (ckpt / "replay_inc").exists()
