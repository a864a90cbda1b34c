"""Child program of ``tests/test_torch_multihost.py``: one process of a
``gloo`` group on localhost, driving 2 CPU slots of a 4-slot mesh.

    python tests/_torch_multihost_child.py <process_id> <num_processes> <port> \
        <mode: step|pipeline> <out.npz>

``step``: three mesh steps of the port's data-parallel learner step on the
same global batch in every process (each takes its own rows); ``pipeline``:
the async runtime end to end (each process's actors feed its own host
replay); ``ckpt_npz`` / ``ckpt_inc``: the pipeline saving checkpoints into
``ckpt/`` beside ``out.npz`` (the npz leg or the incremental chain), then
this process restoring its own replay from them and checking it against
the last snapshot it saved.  Prints ``RESULT <pid> <loss> <step> [<digest>]``
and saves the params to ``out.npz``.
"""

import os
import sys


def main() -> int:
    pid, n, port, mode, out = (int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]),
                               sys.argv[4], sys.argv[5])
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
    import numpy as np
    import torch

    torch.set_num_threads(1)
    from ape_x_dqn_tpu_torch.parallel.multihost import (
        ALL_REDUCE_CALLS,
        initialize_multihost,
        process_count,
        shutdown_multihost,
    )

    initialize_multihost(f"127.0.0.1:{port}", n, pid, device="cpu", timeout_s=120.0)
    try:
        assert process_count() == n
        if mode == "pipeline":
            loss, step, params = pipeline_mode()
        elif mode.startswith("ckpt_"):
            loss, step, params = checkpoint_mode(
                os.path.join(os.path.dirname(out), "ckpt"), incremental=mode == "ckpt_inc")
        else:
            loss, step, params = step_mode()
        assert ALL_REDUCE_CALLS[0] > 0
        np.savez(out, **{k: v.numpy() for k, v in params.items()})
        digest = float(sum(np.abs(v.numpy()).sum() for v in params.values()))
        print(f"RESULT {pid} {loss!r} {step} {digest!r}", flush=True)
    finally:
        shutdown_multihost()
    return 0


def step_mode():
    import torch

    from test_torch_multihost import batch, step_parts

    from ape_x_dqn_tpu_torch.parallel import build_sharded_train_step, make_mesh, place_batch

    net, opt, state = step_parts()
    mesh = make_mesh(num_devices=4, devices=[torch.device("cpu")] * 2)
    assert mesh.shape["data"] == 4 and mesh.local_data == 2
    step_fn, sharded = build_sharded_train_step(net, opt, mesh, state, target_sync_freq=100)
    for i in range(3):
        sharded, metrics = step_fn(sharded, place_batch(batch(i), mesh))
    assert metrics.priorities.shape == (8,)      # this process's rows
    return float(metrics.loss), sharded.step, sharded.params


def pipeline_config():
    from ape_x_dqn_tpu_torch.config import ApexConfig

    cfg = ApexConfig()
    cfg.network = "mlp"
    cfg.env.name = "chain:6"
    cfg.actor.num_actors = 4
    cfg.actor.T = 1_000_000
    cfg.actor.flush_every = 8
    cfg.actor.sync_every = 16
    cfg.learner.data_parallel = 4            # the global mesh: 2 slots per process
    cfg.learner.replay_sample_size = 32
    cfg.learner.min_replay_mem_size = 128
    cfg.learner.optimizer = "adam"
    cfg.replay.capacity = 4096
    return cfg


def pipeline_mode():
    import io

    from ape_x_dqn_tpu_torch.runtime.async_pipeline import AsyncPipeline
    from ape_x_dqn_tpu_torch.utils.metrics import MetricLogger

    pipe = AsyncPipeline(pipeline_config(), logger=MetricLogger(stream=io.StringIO()),
                         log_every=100, device="cpu")
    assert pipe._n_proc == 2 and pipe.mesh.local_data == 2
    result = pipe.run(learner_steps=60)
    return result["learner/loss"], pipe.comps.state.step, pipe.comps.state.params


def checkpoint_mode(ckpt_dir, incremental):
    """Save every 20 steps for 60 steps, recording the replay state each
    save took (under the replay's lock, so the actors' adds cannot slip in
    between), then restore through the components' resume gate and hold
    the restored replay to the last recorded state: every column equal,
    and one sample from a fixed generator equal."""
    import io
    import time

    import numpy as np

    from ape_x_dqn_tpu_torch.replay.buffer import PrioritizedReplay
    from ape_x_dqn_tpu_torch.runtime.async_pipeline import AsyncPipeline
    from ape_x_dqn_tpu_torch.runtime.components import build_components
    from ape_x_dqn_tpu_torch.utils.checkpoint import latest_step
    from ape_x_dqn_tpu_torch.utils.metrics import MetricLogger

    cfg = pipeline_config()
    cfg.learner.checkpoint_every = 20
    cfg.learner.checkpoint_dir = ckpt_dir
    cfg.learner.checkpoint_incremental = incremental
    pipe = AsyncPipeline(cfg, logger=MetricLogger(stream=io.StringIO()), log_every=100,
                         device="cpu")
    replay = pipe.comps.replay
    saved = []
    if incremental:
        # Both the base and the delta end by marking the chain, lock held.
        mark = replay._mark_locked

        def recording_mark():
            saved.append(replay._state_dict_locked())
            mark()

        replay._mark_locked = recording_mark
    else:
        snapshot = replay.state_dict

        def recording_snapshot():
            out = snapshot()
            saved.append(out)
            return out

        replay.state_dict = recording_snapshot
    result = pipe.run(learner_steps=60)
    # Process 0 commits a step after the barrier that every replay leg
    # passed: another process can return from its run before that commit.
    deadline = time.monotonic() + 120.0
    while latest_step(ckpt_dir) != 60:
        assert time.monotonic() < deadline, f"step 60 never committed: {latest_step(ckpt_dir)}"
        time.sleep(0.05)
    assert len(saved) >= 2 and saved[-1]["count"] > 0

    cfg2 = pipeline_config()
    cfg2.learner.checkpoint_dir = ckpt_dir
    cfg2.learner.checkpoint_incremental = incremental
    cfg2.learner.restore_from = True
    comps = build_components(cfg2, device="cpu")
    restored = comps.replay
    got = restored.state_dict()
    assert sorted(got) == sorted(saved[-1]), (sorted(got), sorted(saved[-1]))
    for k, v in saved[-1].items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    twin = PrioritizedReplay(cfg.replay.capacity, comps.obs_shape,
                             priority_exponent=cfg.replay.priority_exponent)
    twin.load_state_dict(saved[-1])
    a = restored.sample(8, rng=np.random.default_rng(0))
    b = twin.sample(8, rng=np.random.default_rng(0))
    np.testing.assert_array_equal(a.indices, b.indices)
    np.testing.assert_array_equal(a.transition.obs, b.transition.obs)
    np.testing.assert_array_equal(a.is_weights, b.is_weights)
    return result["learner/loss"], pipe.comps.state.step, pipe.comps.state.params


if __name__ == "__main__":
    raise SystemExit(main())
