"""The port's graph-safe fused call against the JAX package's fused call.

CPU: ``GraphedCall`` runs ``replay/device.FusedBody`` eagerly, step by step
(the body a card replays as CUDA graphs).  Two calls of K = 4 on the
double-store ring and on the frame-dedup ring, strict and sample-ahead,
with RMSProp, RMSProp with bf16 ν and target, and Adam, against
``ape_x_dqn_tpu.replay.device.build_fused_learn_step`` and
``replay.device_dedup.build_dedup_fused_learn_step`` on the same ring, the
same weights and JAX's own uniforms.  Tolerances, those of
``test_torch_slice.py``: losses rtol 1e-4, sampled indices exact (through
the restamped masses, rtol 1e-4), parameter updates rtol 1e-4 with atol
1e-4 of the largest; with bf16 ν and target 2e-2 relative, the bf16
tolerance of ``test_torch_lowp.py``.  Adam's device step count against
optax's count over 5 steps.

GPU (marked ``gpu``, skipped without a card): on the card, with float32
math and cuDNN's deterministic algorithms, a graphed call equals the eager
body from the same state and uniforms (both layouts, strict and
sample-ahead: losses rtol 1e-3, updates within 1e-3 of the largest, masses
within 1e-4); a rebound parameter tensor makes the next call
recapture and still equal the eager body; a capture while a thread runs
policy forwards on the card succeeds.  Run it where a card is:
``python -m pytest --noconftest -m gpu tests/test_torch_graphed_call.py``.
"""

from __future__ import annotations

import threading

import numpy as np
import pytest
import torch

from ape_x_dqn_tpu_torch.learner import train_step as ttrain
from ape_x_dqn_tpu_torch.models import dueling as tdueling
from ape_x_dqn_tpu_torch.replay import device as tdev
from ape_x_dqn_tpu_torch.replay import device_dedup as tdd
from ape_x_dqn_tpu_torch.runtime import graphed_call
from ape_x_dqn_tpu_torch.types import NStepTransition, TrainState

OBS = (6,)
K, B = 4, 8
BF16_RTOL = 2e-2
OPTIMIZERS = ("rmsprop", "rmsprop_bf16", "adam")


def _optimizers(kind):
    """(JAX optimizer, port optimizer, JAX target dtype, port target dtype)."""
    import jax.numpy as jnp

    from ape_x_dqn_tpu.learner import train_step as jtrain

    if kind == "adam":
        return (jtrain.make_optimizer("adam", learning_rate=1e-3),
                ttrain.make_optimizer("adam", learning_rate=1e-3), None, None)
    if kind == "rmsprop_bf16":
        return (jtrain.make_optimizer("rmsprop", second_moment_dtype=jnp.bfloat16),
                ttrain.make_optimizer("rmsprop", second_moment_dtype=torch.bfloat16),
                jnp.bfloat16, torch.bfloat16)
    return jtrain.make_optimizer("rmsprop"), ttrain.make_optimizer("rmsprop"), None, None


def _jax_and_port_states(kind):
    import jax
    import jax.numpy as jnp

    from ape_x_dqn_tpu.learner import train_step as jtrain
    from ape_x_dqn_tpu.models import dueling as jdueling
    from ape_x_dqn_tpu_torch.weights import params_from_jax

    jopt, topt, jtd, ttd = _optimizers(kind)
    jnet = jdueling.build_network("mlp", 3, hidden_sizes=(16,))
    jstate = jtrain.init_train_state(jnet, jopt, jax.random.PRNGKey(0),
                                     jnp.zeros((1, *OBS), jnp.uint8), target_dtype=jtd)
    tnet = tdueling.build_network("mlp", 3, OBS, hidden_sizes=(16,))
    params = params_from_jax(tnet, jax.device_get(jstate.params))
    tstate = TrainState(params=params,
                        target_params={k: v.to(ttd or v.dtype, copy=True)
                                       for k, v in params.items()},
                        opt_state=topt.init(params), step=0, seed=0)
    jstep = jtrain.build_train_step(jnet, jopt, sync_in_step=False, jit=False)
    tstep = ttrain.build_train_step(tnet, topt, sync_in_step=False)
    return (jstate, jstep), (tstate, tstep), tnet


def _rings(layout):
    """The same contents in a JAX ring and a port ring."""
    from ape_x_dqn_tpu.replay import device as jdev
    from ape_x_dqn_tpu.replay import device_dedup as jdd
    from test_torch_device_dedup import both_ingest, make_stream
    from test_torch_device_replay import _both_add, _chunk

    if layout == "double":
        jrep = jdev.init_device_replay(512, OBS)
        trep = tdev.init_device_replay(512, OBS, device="cpu")
        return _both_add(jrep, trep, *_chunk(400, seed=3), alpha=0.6)
    jrep = jdd.init_dedup_device_replay(128, OBS, frame_capacity=160)
    trep = tdd.init_dedup_device_replay(128, OBS, frame_capacity=160, device="cpu")
    dedup, _, prios = make_stream(n_chunks=10, n_tx=8, seed=3)
    return both_ingest(jrep, trep, dedup, prios)


def _jax_count(opt_state) -> int:
    import jax

    leaves = jax.tree_util.tree_flatten_with_path(opt_state)[0]
    counts = [int(v) for path, v in leaves if "count" in jax.tree_util.keystr(path)]
    assert len(set(counts)) == 1, counts
    return counts[0]


@pytest.mark.parametrize("opt_kind", OPTIMIZERS)
@pytest.mark.parametrize("sample_ahead", [False, True])
@pytest.mark.parametrize("layout", ["double", "dedup"])
def test_graph_safe_body_matches_jax(layout, sample_ahead, opt_kind):
    """Two calls with target_sync_freq 6: the first (steps 0 → 4) does not
    sync, the second (4 → 8) does."""
    import jax

    from ape_x_dqn_tpu.replay import device as jdev
    from ape_x_dqn_tpu.replay import device_dedup as jdd
    from ape_x_dqn_tpu_torch.weights import params_from_jax
    from test_torch_device_replay import _jax_uniforms

    (jstate, jstep), (tstate, tstep), tnet = _jax_and_port_states(opt_kind)
    jrep, trep = _rings(layout)
    knobs = dict(steps_per_call=K, target_sync_freq=6, sample_ahead=sample_ahead)
    if layout == "double":
        jfused = jdev.build_fused_learn_step(jstep, B, include_ingest=False, jit=False, **knobs)
        tfused = tdev.build_fused_learn_step(tstep, B, include_ingest=False, **knobs)
    else:
        jfused = jdd.build_dedup_fused_learn_step(jstep, B, jit=False, **knobs)
        tfused = tdd.build_dedup_fused_learn_step(tstep, B, **knobs)
    assert isinstance(tfused, graphed_call.GraphedCall)
    rtol = BF16_RTOL if opt_kind == "rmsprop_bf16" else 1e-4
    init = {k: v.clone() for k, v in tstate.params.items()}
    for call in range(2):
        rng = jax.random.PRNGKey(100 + call)
        jstate, jrep, jm = jfused(jstate, jrep, 0.4, rng)
        u = torch.from_numpy(_jax_uniforms(rng, K, B, sample_ahead))
        tstate, trep, tm = tfused(tstate, trep, 0.4, u=u)
        np.testing.assert_allclose(tm.loss.numpy(), np.asarray(jm.loss), rtol=rtol)
        np.testing.assert_allclose(tm.priorities.numpy(), np.asarray(jm.priorities),
                                   rtol=rtol, atol=1e-6)
        np.testing.assert_allclose(trep.mass.numpy(), np.asarray(jrep.mass),
                                   rtol=rtol, atol=1e-6)
        synced = all(torch.equal(tstate.params[k].to(v.dtype), v)
                     for k, v in tstate.target_params.items())
        assert synced == (call == 1)
    assert tstate.step == int(jstate.step) == 2 * K
    assert tfused.captures == 0   # the CPU runs the body eagerly
    for which in ("params", "target_params"):
        want = params_from_jax(tnet, jax.device_get(getattr(jstate, which)))
        for k, w in want.items():
            d_want = (w.float() - init[k]).numpy()
            d_got = (getattr(tstate, which)[k].float() - init[k]).numpy()
            np.testing.assert_allclose(d_got, d_want, rtol=rtol,
                                       atol=rtol * max(np.abs(d_want).max(), 1e-12),
                                       err_msg=f"{which}.{k}")
    if opt_kind == "adam":
        count = tstate.opt_state["count"]
        assert count.dtype == torch.int32 and count.device == trep.mass.device
        assert int(count) == _jax_count(jstate.opt_state) == 2 * K
    if opt_kind == "rmsprop_bf16":
        assert all(v.dtype == torch.bfloat16 for v in tstate.opt_state["nu"].values())
        assert all(v.dtype == torch.bfloat16 for v in tstate.target_params.values())


def test_adam_device_count_matches_optax():
    """Five Adam steps on given gradients: the int32 device count and the
    float32 bias corrections computed from it give optax's updates."""
    import jax.numpy as jnp
    import optax

    from ape_x_dqn_tpu.learner import train_step as jtrain

    r = np.random.default_rng(4)
    shapes = {"a": (4, 3), "b": (5,)}
    p0 = {k: r.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    jopt = jtrain.make_optimizer("adam", learning_rate=1e-3)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    jst = jopt.init(jp)
    topt = ttrain.make_optimizer("adam", learning_rate=1e-3)
    tp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    tst = topt.init(tp)
    assert tst["count"].dtype == torch.int32 and int(tst["count"]) == 0
    count_tensor = tst["count"]
    for step in range(1, 6):
        g = {k: (r.normal(size=s) * 10.0 ** (step - 3)).astype(np.float32)
             for k, s in shapes.items()}
        upd, jst = jopt.update({k: jnp.asarray(v) for k, v in g.items()}, jst, jp)
        jp = optax.apply_updates(jp, upd)
        topt.update_(tp, {k: torch.from_numpy(v) for k, v in g.items()}, tst)
        assert tst["count"] is count_tensor     # updated in place
        assert int(tst["count"]) == _jax_count(jst) == step
        for k in shapes:
            d_want = np.asarray(jp[k]) - p0[k]
            np.testing.assert_allclose(tp[k].numpy() - p0[k], d_want, rtol=1e-4,
                                       atol=1e-4 * np.abs(d_want).max())


def test_train_step_update_leaves_host_bookkeeping_to_the_caller():
    """``train_step.update`` is the device work alone: it does not move
    ``state.step`` or the target; the full step does both."""
    net = tdueling.build_network("mlp", 3, OBS, hidden_sizes=(16,))
    opt = ttrain.make_optimizer("rmsprop")
    state = ttrain.init_train_state(net, opt, device="cpu")
    step = ttrain.build_train_step(net, opt, target_sync_freq=1)
    r = np.random.default_rng(0)
    batch = tdev.PrioritizedBatch(
        transition=NStepTransition(
            obs=torch.from_numpy(r.integers(0, 256, (B, *OBS), dtype=np.uint8)),
            action=torch.from_numpy(r.integers(0, 3, B).astype(np.int32)),
            reward=torch.from_numpy(r.normal(size=B).astype(np.float32)),
            discount=torch.full((B,), 0.97),
            next_obs=torch.from_numpy(r.integers(0, 256, (B, *OBS), dtype=np.uint8))),
        indices=torch.arange(B, dtype=torch.int32), is_weights=torch.ones(B))
    target = {k: v.clone() for k, v in state.target_params.items()}
    m = step.update(state, batch)
    assert state.step == 0 and torch.isfinite(m.loss)
    assert all(torch.equal(state.target_params[k], v) for k, v in target.items())
    step(state, batch)
    assert state.step == 1
    assert all(torch.equal(state.target_params[k], v) for k, v in state.params.items())


def test_signature_sees_a_rebound_tensor():
    """The runner's capture key changes when a state tensor is rebound or a
    TF32 flag flips (what forces a recapture on a card) and not when a
    tensor is written in place."""
    net = tdueling.build_network("mlp", 3, OBS, hidden_sizes=(16,))
    opt = ttrain.make_optimizer("adam")
    state = ttrain.init_train_state(net, opt, device="cpu")
    ring = tdev.init_device_replay(64, OBS, device="cpu")
    body = tdev.FusedBody(ttrain.build_train_step(net, opt).update, state, ring,
                          steps_per_call=K, batch_size=B, priority_exponent=0.6,
                          sample_ahead=False)
    names = [n for n, _ in graphed_call._state_tensors(body)]
    assert "opt.count" in names and "ring.mass" in names and "target.value.weight" in names
    before = graphed_call._signature(body)
    state.params["value.weight"].add_(1.0)
    ring.mass.fill_(2.0)
    assert graphed_call._signature(body) == before
    state.params["value.weight"] = state.params["value.weight"].clone()
    assert graphed_call._signature(body) != before
    before = graphed_call._signature(body)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = not tf32
    try:
        assert graphed_call._signature(body) != before   # a math mode is captured too
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    assert graphed_call._signature(body) == before
    written = graphed_call._written(body)
    assert any(t is ring.mass for t in written)
    assert not any(t is ring.obs for t in written)


# -- on the card ---------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _card_pair(layout, sample_ahead, dev):
    """Two identical (state, ring) pairs on ``dev`` and the step function."""
    torch.manual_seed(0)
    net = tdueling.build_network("conv", 3, (36, 36, 1), channels=(8, 8, 8), hidden=32,
                                 compute_dtype=torch.float32)
    opt = ttrain.make_optimizer("rmsprop")
    r = np.random.default_rng(1)
    M = 512
    pairs = []
    for _ in range(2):
        state = ttrain.init_train_state(net, opt, device=dev)
        if layout == "double":
            ring = tdev.init_device_replay(1024, (36, 36, 1), device=dev)
        else:
            ring = tdd.init_dedup_device_replay(1024, (36, 36, 1), frame_capacity=1280,
                                                device=dev)
        pairs.append((state, ring))
    frames = r.integers(0, 256, (M + 1, 36, 36, 1), dtype=np.uint8)
    prio = torch.from_numpy((r.random(M) + 0.05).astype(np.float32)).to(dev)
    cols = dict(action=torch.from_numpy(r.integers(0, 3, M).astype(np.int32)).to(dev),
                reward=torch.from_numpy(r.normal(size=M).astype(np.float32)).to(dev),
                discount=torch.full((M,), 0.97, device=dev))
    for _, ring in pairs:
        if layout == "double":
            tdev.device_replay_add(ring, NStepTransition(
                obs=torch.from_numpy(frames[:M]).to(dev), next_obs=torch.from_numpy(frames[1:]).to(dev),
                **cols), prio)
        else:
            tdd.dedup_device_add_frames(ring, torch.from_numpy(frames).to(dev))
            seq = torch.arange(M, dtype=torch.int32, device=dev)
            tdd.dedup_device_add_transitions(ring, seq, seq + 1, cols["action"], cols["reward"],
                                             cols["discount"], prio)
    step = ttrain.build_train_step(net, opt, sync_in_step=False)
    return pairs, step


def _knobs(layout, sample_ahead):
    return dict(steps_per_call=8, batch_size=32, priority_exponent=0.6,
                sample_ahead=sample_ahead,
                sample_many_fn=tdd.dedup_sample_many if layout == "dedup" else None)


def _eager_call(step, state, ring, knobs, u):
    """The eager body's call (the reference), with its sampled slots."""
    body = tdev.FusedBody(step.update, state, ring, **knobs)
    metrics = tdev.run_eager(body, 0.4, u)
    tdev.finish_call(state, knobs["steps_per_call"], 8)
    return metrics, body.sampled_indices()


def _assert_close_states(a, b, init, tol=1e-3):
    for k in init:
        d_a, d_b = a.params[k] - init[k], b.params[k] - init[k]
        scale = float(d_a.abs().max()) + 1e-12
        assert float((d_a - d_b).abs().max()) <= tol * scale, k


@pytest.fixture
def float32_on_card():
    """float32 math, TF32 off, and cuDNN's deterministic algorithms: the
    default ones may sum a gradient in another order on every call, and a
    strict call then samples other slots (another trajectory, not a
    graph's error)."""
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.backends.cudnn.deterministic)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    yield
    (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
     torch.backends.cudnn.deterministic) = flags


def _graphed_vs_eager(dev, layout, sample_ahead, calls=3, between=None):
    """``calls`` calls graphed and eager from one state and the same
    uniforms; ``between(call, graphed_pair, eager_pair)`` runs after each."""
    ((sg, rg), (se, re)), step = _card_pair(layout, sample_ahead, dev)
    init = {k: v.clone() for k, v in sg.params.items()}
    knobs = _knobs(layout, sample_ahead)
    call = graphed_call.GraphedCall(step, target_sync_freq=8, **knobs)
    call.bind(sg, rg)
    gen = torch.Generator(device=dev).manual_seed(3)
    for i in range(calls):
        u = torch.rand((8, 32), generator=gen, device=dev)
        _, _, mg = call(sg, rg, 0.4, u=u)
        ig = call.body.sampled_indices()
        me, ie = _eager_call(step, se, re, knobs, u)
        torch.cuda.synchronize()
        if i == 0 or sample_ahead:   # call 0 starts from equal masses
            assert torch.equal(ig[0], ie[0])
        if sample_ahead:
            assert torch.equal(ig, ie)
        torch.testing.assert_close(mg.loss, me.loss, rtol=1e-3, atol=1e-5)
        if between is not None:
            between(i, (sg, rg), (se, re))
    assert sg.step == se.step == 8 * calls
    _assert_close_states(sg, se, init)
    assert float((rg.mass - re.mass).abs().max()) <= 1e-4
    return call


@pytest.mark.gpu
@pytest.mark.parametrize("sample_ahead", [False, True])
@pytest.mark.parametrize("layout", ["double", "dedup"])
def test_graphed_call_equals_eager_on_card(cuda_device, float32_on_card, layout,
                                           sample_ahead):
    """Three calls (float32, TF32 off): sample-ahead indices identical,
    strict step 0 of the first call identical, losses rtol 1e-3, updates
    within 1e-3 of the largest, masses within 1e-4; one capture."""
    call = _graphed_vs_eager(cuda_device, layout, sample_ahead)
    assert call.captures == 1


@pytest.mark.gpu
def test_rebound_tensor_recaptures_on_card(cuda_device, float32_on_card):
    """A weight import that rebinds a parameter tensor between calls: the
    next call recaptures and still equals the eager body."""
    def rebind(i, graphed, eager):
        if i == 0:
            for state, _ in (graphed, eager):
                state.params["value.weight"] = state.params["value.weight"].clone()

    call = _graphed_vs_eager(cuda_device, "double", False, between=rebind)
    assert call.captures == 2


@pytest.mark.gpu
def test_capture_while_a_thread_runs_forwards_on_card(cuda_device, float32_on_card):
    """A thread runs policy forwards on the card (as thread actors do)
    while the learner captures, and recaptures after a rebind."""
    net = tdueling.build_network("conv", 3, (36, 36, 1), channels=(8, 8, 8), hidden=32,
                                 compute_dtype=torch.float32)
    params = {k: v.to(cuda_device) for k, v in net.state_dict().items()}
    obs = torch.zeros((16, 36, 36, 1), dtype=torch.uint8, device=cuda_device)
    stop, errors, forwards = threading.Event(), [], [0]

    def actor():
        try:
            while not stop.is_set():
                net.apply_params(params, obs).q.argmax(-1).cpu()
                forwards[0] += 1
        except BaseException as e:  # noqa: BLE001 — asserted below
            errors.append(e)

    thread = threading.Thread(target=actor, daemon=True)
    thread.start()
    try:
        def rebind(i, graphed, eager):
            for state, _ in (graphed, eager):
                state.params["value.weight"] = state.params["value.weight"].clone()

        call = _graphed_vs_eager(cuda_device, "dedup", True, calls=2, between=rebind)
    finally:
        stop.set()
        thread.join(60)
    assert not thread.is_alive() and not errors and forwards[0] > 0
    assert call.captures == 2
