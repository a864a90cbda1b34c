"""The port's ``PolicyServer`` on the card (marked ``gpu``, skipped without
one; no JAX import, so it runs where JAX is absent):

  * a forward issued while a long CUDA-graph replay runs on another stream
    returns before that replay ends: the server's stream never waits for
    the learner's;
  * forwards issued while the learner's own ``GraphedCall`` runs a 1024-step
    call on another thread each return within a quarter of the call (the
    runner paces its replays, so the launch queue never fills);
  * a reload under load (four clients, three published versions) drops no
    request, and every reply's q equals its claimed version's float32 CPU
    forward (rtol 1e-4, atol 1e-4 of the largest |q|; TF32 off).

``python -m pytest --noconftest -m gpu tests/test_torch_serving_card.py``.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import pytest
import torch

from ape_x_dqn_tpu_torch.models import dueling as tdueling
from ape_x_dqn_tpu_torch.runtime.param_store import ParamStore
from ape_x_dqn_tpu_torch.serving.server import PolicyServer

CONV_OBS = (36, 36, 1)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture
def float32_on_card():
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


def _conv_pair(seed=0):
    net = tdueling.build_network("conv", 4, CONV_OBS, channels=(8, 16, 8), hidden=32,
                                 compute_dtype=torch.float32)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        fresh = tdueling.build_network("conv", 4, CONV_OBS, channels=(8, 16, 8), hidden=32)
    return net, {k: v.detach().clone() for k, v in fresh.state_dict().items()}


@pytest.mark.gpu
def test_forward_does_not_wait_for_a_learner_replay_on_card(cuda_device, float32_on_card):
    """One CUDA-graph replay of ~1 s of large matmuls on another stream
    (the learner's shape of work, few launches): a forward issued right
    after returns before that replay has finished."""
    net, params = _conv_pair()
    server = PolicyServer(net, params, max_batch=4, max_wait_ms=0.5)
    server.warmup(CONV_OBS)
    server.start()
    learner = torch.cuda.Stream()
    a = torch.randn(8192, 8192, device=cuda_device)
    b = torch.randn(8192, 8192, device=cuda_device)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(learner):
        c = a @ b                      # warm-up outside the capture
        learner.synchronize()
        with torch.cuda.graph(graph, stream=learner):
            for _ in range(48):
                c = a @ b
    replay_done = torch.cuda.Event(enable_timing=True)
    replay_start = torch.cuda.Event(enable_timing=True)
    try:
        with torch.cuda.stream(learner):
            replay_start.record(learner)
            graph.replay()
            replay_done.record(learner)
        t0 = time.monotonic()
        res = server.act(np.zeros(CONV_OBS, np.uint8), timeout=60.0)
        rtt = time.monotonic() - t0
        still_running = not replay_done.query()
        replay_done.synchronize()
        replay_ms = replay_start.elapsed_time(replay_done)
    finally:
        server.close()
    assert res.action in range(4)
    assert replay_ms > 300.0, f"the replay took only {replay_ms} ms: not a long call"
    assert still_running, (f"the forward returned after the replay ended "
                           f"(rtt {rtt * 1e3:.1f} ms, replay {replay_ms:.1f} ms)")
    assert rtt * 1e3 < replay_ms / 4


@pytest.mark.gpu
def test_forward_beside_a_graphed_fused_call_on_card(cuda_device):
    """The learner's own runner: a ``GraphedCall`` of 1024 sample-ahead
    steps runs on a learner thread (its replays paced to
    ``MAX_REPLAYS_AHEAD`` in flight); forwards issued meanwhile each
    return within a quarter of the call's time, most of them long before
    it ends."""
    from ape_x_dqn_tpu_torch.learner.train_step import (
        build_train_step,
        init_train_state,
        make_optimizer,
    )
    from ape_x_dqn_tpu_torch.replay.device import init_device_replay
    from ape_x_dqn_tpu_torch.runtime.graphed_call import GraphedCall

    gen = torch.Generator(device=cuda_device).manual_seed(0)
    net = tdueling.build_network("conv", 3, (84, 84, 1))
    opt = make_optimizer("rmsprop")
    state = init_train_state(net, opt, device=cuda_device)
    C = 8192
    ring = init_device_replay(C, (84, 84, 1), device=cuda_device)
    ring.obs.random_(0, 256, generator=gen)
    ring.next_obs.random_(0, 256, generator=gen)
    ring.action.random_(0, 3, generator=gen)
    ring.reward.normal_(generator=gen)
    ring.discount.fill_(0.97)
    ring.mass.copy_(torch.rand(C, generator=gen, device=cuda_device) + 0.05)
    ring.count = C
    call = GraphedCall(build_train_step(net, opt, sync_in_step=False), steps_per_call=1024,
                       batch_size=32, priority_exponent=0.6, target_sync_freq=None,
                       sample_ahead=True)
    call.bind(state, ring)
    params = {k: v.detach().clone() for k, v in state.params.items()}
    server = PolicyServer(net, params, max_batch=8, max_wait_ms=0.5)
    server.warmup((84, 84, 1))
    server.start()
    done = torch.cuda.Event(enable_timing=True)
    start = torch.cuda.Event(enable_timing=True)

    def learn():
        start.record()
        call(state, ring, 0.4, generator=gen)
        done.record()

    learner = threading.Thread(target=learn)
    rtts, running = [], []
    obs = np.zeros((8, 84, 84, 1), np.uint8)
    try:
        learner.start()
        time.sleep(0.05)
        while learner.is_alive() or not done.query():
            t0 = time.monotonic()
            for f in [server.submit(o) for o in obs]:
                f.result(timeout=60.0)
            rtts.append((time.monotonic() - t0) * 1e3)
            # ``done`` is recorded when the call's last replay is issued.
            running.append(learner.is_alive() or not done.query())
        learner.join()
        done.synchronize()
        call_ms = start.elapsed_time(done)
    finally:
        server.close()
    assert call_ms > 400.0, f"the call took only {call_ms} ms"
    assert sum(running) >= 10, f"only {sum(running)} forwards while the call ran"
    assert max(rtts) < call_ms / 4, (max(rtts), call_ms)


@pytest.mark.gpu
def test_reload_under_load_on_card(cuda_device, float32_on_card):
    """Four clients while three new versions are published: no request
    dropped or errored, and every reply's q equals its claimed version's
    float32 CPU forward (rtol 1e-4, atol 1e-4 of the largest |q|)."""
    net, p0 = _conv_pair(0)
    versions = {0: p0}
    store = ParamStore(p0)
    server = PolicyServer(net, param_source=store, max_batch=8, max_wait_ms=1.0,
                          reload_poll_s=0.02)
    server.warmup(CONV_OBS)
    server.start()
    results, errors = [], []
    stop = threading.Event()

    def client(seed):
        rng = np.random.default_rng(seed)
        while not stop.is_set():
            obs = rng.integers(0, 255, CONV_OBS, dtype=np.uint8)
            try:
                results.append((obs, server.act(obs, timeout=30.0)))
            except Exception as e:  # noqa: BLE001
                errors.append(e)

    threads = [threading.Thread(target=client, args=(i,), daemon=True) for i in range(4)]
    try:
        for t in threads:
            t.start()
        for v in (1, 2, 3):
            time.sleep(0.3)
            versions[v] = _conv_pair(v)[1]
            store.publish(versions[v])
            deadline = time.monotonic() + 10.0
            while server.param_version < v and time.monotonic() < deadline:
                time.sleep(0.01)
        time.sleep(0.3)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=30.0)
        server.close()
    assert not errors, errors[:3]
    assert {r.param_version for _, r in results} == {0, 1, 2, 3}
    for v, params in versions.items():
        group = [(o, r) for o, r in results if r.param_version == v]
        with torch.no_grad():
            q_ref = net.apply_params(params, torch.from_numpy(
                np.stack([o for o, _ in group]))).q.numpy()
        q_got = np.stack([r.q_values for _, r in group])
        np.testing.assert_allclose(q_got, q_ref, rtol=1e-4,
                                   atol=1e-4 * float(np.abs(q_ref).max()))
