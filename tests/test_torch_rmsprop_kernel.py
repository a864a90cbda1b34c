"""The fused clip and RMSProp kernel pair (``ops/rmsprop.py``) and its dispatch.

CPU: the dispatch rule.  An update on the CPU runs the plain version
(``Optimizer.clip`` then ``apply_``) and launches nothing; any CUDA param
or gradient sends RMSProp without a master copy to the kernel's entry,
which refuses (``rmsprop.check``, reading dtype, device, layout and the
leaf count alone; fake tensors stand in for CUDA ones) what it cannot
take, so nothing on the card falls back to the plain version; with the
tensors taken for CUDA ones, RMSProp without a master copy reaches the
kernel's entry while Adam, the float32 master copy, ``clip`` and
``apply_`` called apart, and the data-parallel ``sharded_step`` (which
calls those two) never do.

GPU (marked ``gpu``, skipped without a card): the kernel pair against the
plain version over 64 steps of random gradients, at config3's 14 leaf
shapes plus leaves of 1, 3 and 1 000 003 elements, each leaf its own
allocation, all packed into one buffer (leaves at unaligned addresses), or
with its gradient in another layout (channels-last, transposed, strided),
ν in bfloat16 and float32, ``max_grad_norm`` 1e-3 (the clip engages), 1e9
(it does not) and None.  While the clip does not engage, params and ν
must equal the plain version's bit for bit over the 64 steps.  Where it
engages only the norm's summation order differs, so each step is held
from the same state: params within 1e-6 relative (atol a millionth of the
learning rate, for elements that pass through 0) and ν within one ulp of
its storage (one bfloat16 ulp of the larger of the two, or 1e-6 relative
in float32).  Over independent trajectories a ν one ulp apart can end one
and a half ulps apart where the two straddle a power of two.  Also: CUDA
tensors the kernel does not take (a param or ν in another layout, bfloat16
params without a master copy, ν of two dtypes, gradients off the card,
49 leaves) raise and leave every tensor as it was, a step captured in a
CUDA graph equal to the eager kernel after 8 replays, ``GraphedCall``'s
count, two launches a step replayed, and config3's own network's gradients
(bfloat16 torso, conv weight gradients channels-last from cuDNN) taking
the kernel, bit for bit with the plain version.  Run it where a card is:
``python -m pytest --noconftest -m gpu tests/test_torch_rmsprop_kernel.py``.
"""

from __future__ import annotations

import types

import numpy as np
import pytest
import torch

from ape_x_dqn_tpu_torch.learner import train_step as ttrain
from ape_x_dqn_tpu_torch.models import dueling as tdueling
from ape_x_dqn_tpu_torch.ops import rmsprop, sampling
from ape_x_dqn_tpu_torch.types import NStepTransition, PrioritizedBatch

from _torch_harness import port_deadline  # noqa: F401 — the per-test deadline, autouse

# config3's network (DuelingDQN(4, (84, 84, 1))): 14 leaves, 3 321 541 params.
CONFIG3_SHAPES = [(64, 1, 8, 8), (64,), (64, 64, 4, 4), (64,), (64, 64, 3, 3), (64,),
                  (512, 3136), (512,), (512, 3136), (512,), (1, 512), (1,), (4, 512), (4,)]
RAGGED_SHAPES = [(1,), (3,), (1_000_003,)]


def _cpu_state(seed=0):
    g = torch.Generator().manual_seed(seed)
    shapes = {"w": (5, 3), "b": (3,), "v": (7,)}
    params = {k: torch.randn(s, generator=g) for k, s in shapes.items()}
    grads = {k: torch.randn(s, generator=g) * 4 for k, s in shapes.items()}
    return params, grads


# -- CPU: the dispatch rule ------------------------------------------------------


@pytest.mark.parametrize("nu_dtype", [None, torch.bfloat16])
@pytest.mark.parametrize("max_norm", [1.0, None])
def test_cpu_update_runs_the_plain_version(nu_dtype, max_norm):
    opt = ttrain.make_optimizer("rmsprop", max_grad_norm=max_norm, second_moment_dtype=nu_dtype)
    params, grads = _cpu_state()
    plain = {k: v.clone() for k, v in params.items()}
    state, plain_state = opt.init(params), opt.init(plain)
    before = rmsprop.update_.launches
    for _ in range(3):
        opt.update_(params, grads, state)
        opt.apply_(plain, opt.clip(grads), plain_state)
    assert rmsprop.update_.launches == before
    assert not rmsprop.on_card(params, grads)
    for k in params:
        assert torch.equal(params[k], plain[k]) and torch.equal(state["nu"][k],
                                                                plain_state["nu"][k])
    with pytest.raises(ValueError, match="RMSProp kernel takes"):
        rmsprop.update_(params, grads, state["nu"], learning_rate=0.1, decay=0.9, eps=1e-7,
                        max_grad_norm=max_norm)


def _fake(dtype=torch.float32, device=("cuda", 0), contiguous=True, shape=(8, 4, 3, 3)):
    """What ``check`` reads of a tensor, on a device this machine need not have;
    a non-contiguous one is laid out channels-last (or its dims reversed,
    past 4 dims)."""
    t = torch.empty(shape, device="meta")
    if not contiguous:
        t = t.permute(*reversed(range(len(shape)))).contiguous().permute(
            *reversed(range(len(shape))))
    return types.SimpleNamespace(dtype=dtype, device=torch.device(*device),
                                 is_contiguous=t.is_contiguous, dim=t.dim, shape=t.shape,
                                 stride=t.stride, numel=t.numel)


@pytest.mark.parametrize("change,taken", [
    ({}, True),
    ({"nu": dict(dtype=torch.bfloat16)}, True),
    ({"nu": dict(dtype=torch.float16)}, False),
    ({"p": dict(dtype=torch.bfloat16)}, False),
    ({"g": dict(dtype=torch.bfloat16)}, False),
    ({"g": dict(contiguous=False)}, True),           # read through its strides
    ({"g": dict(contiguous=False, shape=(2, 3, 4))}, True),
    ({"g": dict(contiguous=False, shape=(2, 3, 4, 2, 2))}, False),  # past MAX_DIMS
    ({"p": dict(contiguous=False)}, False),
    ({"nu": dict(contiguous=False)}, False),
    ({"p": dict(device=("cpu",))}, False),
    ({"nu": dict(device=("cuda", 1))}, False),
    ({"nu_b": dict(dtype=torch.bfloat16)}, False),   # ν of two dtypes
])
def test_rule_reads_dtype_device_and_layout(change, taken):
    def leaf(name):
        return _fake(**change.get(name, {}))

    params = {"a": leaf("p"), "b": _fake()}
    grads = {"a": leaf("g"), "b": _fake()}
    nu = {"a": leaf("nu"), "b": leaf("nu_b") if "nu_b" in change else leaf("nu")}
    if taken:
        rmsprop.check(params, grads, nu)
    else:
        with pytest.raises(ValueError, match="RMSProp kernel takes"):
            rmsprop.check(params, grads, nu)
    assert rmsprop.on_card(params, grads)
    assert not rmsprop.on_card({}, {})


@pytest.mark.parametrize("leaves,taken", [(48, True), (49, False)])
def test_one_table_takes_at_most_48_leaves(leaves, taken):
    tree = {f"leaf{i}": _fake(shape=(3,)) for i in range(leaves)}
    assert rmsprop.MAX_LEAVES == 48
    if taken:
        rmsprop.check(tree, tree, tree)
    else:
        with pytest.raises(ValueError, match="at most 48 leaves, not 49"):
            rmsprop.check(tree, tree, tree)


@pytest.mark.parametrize("where,card", [
    ({"p": ("cuda", 0)}, True), ({"g": ("cuda", 0)}, True),
    ({"p": ("cuda", 0), "g": ("cuda", 0)}, True), ({}, False)])
def test_any_cuda_tensor_puts_the_update_on_the_card(where, card):
    """One CUDA param or gradient is enough: the kernel's entry then takes
    the update, or refuses it, and the plain version never runs it."""
    params = {"a": _fake(device=where.get("p", ("cpu",))), "b": _fake(device=("cpu",))}
    grads = {"a": _fake(device=where.get("g", ("cpu",))), "b": _fake(device=("cpu",))}
    assert rmsprop.on_card(params, grads) is card
    if card:
        with pytest.raises(ValueError, match="CUDA tensors alone"):
            rmsprop.check(params, grads, params)


@pytest.fixture
def kernel_entry(monkeypatch):
    """CPU tensors taken for CUDA ones (``on_card`` forced true), and the
    kernel's entry replaced by a recorder: which updates would reach the
    kernel."""
    calls = []
    monkeypatch.setattr(rmsprop, "on_card", lambda params, grads: True)
    monkeypatch.setattr(rmsprop, "update_", lambda *a, **kw: calls.append(kw))
    return calls


@pytest.mark.parametrize("kind,master,reaches", [
    ("rmsprop", False, True), ("adam", False, False), ("rmsprop", True, False)])
def test_only_rmsprop_without_master_reaches_the_kernel(kernel_entry, kind, master, reaches):
    opt = ttrain.make_optimizer(kind, float32_master=master)
    params, grads = _cpu_state()
    state = opt.init(params)
    opt.update_(params, grads, state)
    assert len(kernel_entry) == int(reaches)
    if reaches:
        assert kernel_entry[0] == dict(learning_rate=opt.learning_rate,
                                       decay=opt.rmsprop_decay, eps=opt.rmsprop_eps,
                                       max_grad_norm=opt.max_grad_norm)
    opt.apply_(params, opt.clip(grads), state)      # the pieces apart: never
    assert len(kernel_entry) == int(reaches)


def test_sharded_step_never_reaches_the_kernel(kernel_entry):
    from ape_x_dqn_tpu_torch.parallel.dp import build_sharded_train_step, place_batch
    from ape_x_dqn_tpu_torch.parallel.mesh import make_mesh

    torch.manual_seed(0)
    net = tdueling.build_network("mlp", 3, (6,), hidden_sizes=(16,))
    opt = ttrain.make_optimizer("rmsprop")
    state = ttrain.init_train_state(net, opt, device="cpu")
    mesh = make_mesh(devices=[torch.device("cpu")] * 2)
    step, sharded = build_sharded_train_step(net, opt, mesh, state)
    r = np.random.default_rng(0)
    batch = PrioritizedBatch(
        transition=NStepTransition(
            obs=torch.from_numpy(r.integers(0, 256, (8, 6), dtype=np.uint8)),
            action=torch.from_numpy(r.integers(0, 3, 8).astype(np.int32)),
            reward=torch.from_numpy(r.normal(size=8).astype(np.float32)),
            discount=torch.full((8,), 0.97),
            next_obs=torch.from_numpy(r.integers(0, 256, (8, 6), dtype=np.uint8))),
        indices=torch.arange(8, dtype=torch.int32), is_weights=torch.ones(8))
    before = {k: v.clone() for k, v in sharded.params.items()}
    sharded, _ = step(sharded, place_batch(batch, mesh))
    assert kernel_entry == []
    assert any(not torch.equal(before[k], v) for k, v in sharded.params.items())


# -- on the card -----------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _leaves(shapes, dev, packed, seed):
    """Params of ``shapes`` on ``dev``: each its own allocation, or all cut in
    turn from one flat buffer (so most start at unaligned addresses)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    names = [f"leaf{i}" for i in range(len(shapes))]
    sizes = [int(np.prod(s)) for s in shapes]
    if packed:
        flat = (torch.randn(sum(sizes) + 1, generator=gen, device=dev) * 0.05)[1:]
        offsets = np.cumsum([0] + sizes)
        return {n: flat[offsets[i]:offsets[i + 1]].view(s)
                for i, (n, s) in enumerate(zip(names, shapes))}
    return {n: torch.randn(s, generator=gen, device=dev) * 0.05 for n, s in zip(names, shapes)}


def _grads(params, gen):
    """Random gradients, each leaf at its own scale (10^-3 … 10^1)."""
    out = {}
    for k, p in params.items():
        scale = 10.0 ** float(torch.empty(()).uniform_(-3, 1, generator=gen))
        out[k] = torch.randn(p.shape, generator=torch.Generator(p.device).manual_seed(
            int(torch.randint(0, 2**31, (), generator=gen))), device=p.device) * scale
    return out


def _relaid(g):
    """``g`` in another layout: channels-last (4 dims), transposed (2), every
    other element of a buffer twice as long (1)."""
    if g.dim() == 4:
        return g.contiguous(memory_format=torch.channels_last)
    if g.dim() == 2:
        return g.t().contiguous().t()
    buf = torch.zeros(2 * g.numel(), device=g.device)
    buf[::2] = g.reshape(-1)
    return buf[::2].view(g.shape)


def _copy(tree):
    return {k: v.clone() for k, v in tree.items()}


def _bf16_ulp(x):
    """One bfloat16 ulp at |x| (x already a bfloat16 value), as float32."""
    _, e = torch.frexp(x.float().abs())
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32), e - 8)


def _assert_one_ulp(nu_k, nu_p, dtype, what):
    if dtype == torch.bfloat16:
        a, b = nu_k.float(), nu_p.float()
        ulp = _bf16_ulp(torch.maximum(a.abs(), b.abs()))
        bad = (a - b).abs() > ulp
        assert not bool(bad.any()), f"{what}: {int(bad.sum())} ν elements over one ulp"
    else:
        torch.testing.assert_close(nu_k, nu_p, rtol=1e-6, atol=0, msg=what)


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["separate", "packed", "relaid_grads"])
@pytest.mark.parametrize("max_norm", [1e-3, 1e9, None])
@pytest.mark.parametrize("nu_dtype", [torch.bfloat16, torch.float32])
def test_kernel_matches_plain_version_on_card(cuda_device, nu_dtype, max_norm, layout):
    dev = cuda_device
    opt = ttrain.make_optimizer("rmsprop", max_grad_norm=max_norm, second_moment_dtype=nu_dtype)
    params = _leaves(CONFIG3_SHAPES + RAGGED_SHAPES, dev, layout == "packed", seed=1)
    plain = _copy(params)
    state, plain_state = opt.init(params), opt.init(plain)
    rmsprop.check(params, params, state["nu"])
    engages = max_norm == 1e-3
    gen = torch.Generator().manual_seed(2)
    before = rmsprop.update_.launches
    for step in range(64):
        grads = _grads(params, gen)
        if layout == "relaid_grads":
            grads = {k: _relaid(g) for k, g in grads.items()}
            assert sum(not g.is_contiguous() for g in grads.values()) == 13
        norm = float(torch.sqrt(sum(torch.sum(g * g) for g in grads.values())))
        if max_norm is not None:
            assert (norm >= max_norm) == engages
        opt.update_(params, grads, state)                   # the kernel pair
        opt.apply_(plain, opt.clip(grads), plain_state)     # the plain version
        if not engages:
            continue
        torch.cuda.synchronize()
        for k in params:
            what = f"step {step}, {k}"
            torch.testing.assert_close(params[k], plain[k], rtol=1e-6,
                                       atol=1e-6 * opt.learning_rate, msg=what)
            _assert_one_ulp(state["nu"][k], plain_state["nu"][k], nu_dtype, what)
            plain[k].copy_(params[k])                        # the next step from one state
            plain_state["nu"][k].copy_(state["nu"][k])
    torch.cuda.synchronize()
    assert rmsprop.update_.launches - before == 64 * (1 if max_norm is None else 2)
    for k in params:
        assert torch.equal(params[k], plain[k]), k
        assert torch.equal(state["nu"][k], plain_state["nu"][k]), k


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["param_relaid", "nu_relaid", "bf16_params", "nu_two_dtypes",
                                  "grads_on_cpu", "49_leaves"])
def test_tensors_the_kernel_cannot_take_raise_on_card(cuda_device, case):
    """RMSProp without a master copy on the card never falls back to the
    plain version: tensors the kernel does not take raise, nothing is
    launched and nothing is stepped."""
    dev = cuda_device
    opt = ttrain.make_optimizer("rmsprop", second_moment_dtype=torch.bfloat16)
    shapes = [(64, 1, 8, 8), (512, 3136), (512,)] + [(5,)] * (46 if case == "49_leaves" else 0)
    params = _leaves(shapes, dev, packed=False, seed=10)
    if case == "bf16_params":
        params = {k: v.to(torch.bfloat16) for k, v in params.items()}
    state = opt.init(params)
    nu = state["nu"]
    if case == "param_relaid":
        params["leaf1"] = params["leaf1"].t().contiguous().t()
        assert not params["leaf1"].is_contiguous()
    elif case == "nu_relaid":
        nu["leaf1"] = nu["leaf1"].t().contiguous().t()
        assert not nu["leaf1"].is_contiguous()
    elif case == "nu_two_dtypes":
        nu["leaf2"] = nu["leaf2"].float()
    grads = _grads(params, torch.Generator().manual_seed(11))
    if case == "grads_on_cpu":
        grads = {k: g.cpu() for k, g in grads.items()}
    assert len(params) == (49 if case == "49_leaves" else 3)
    before_p, before_nu = _copy(params), _copy(nu)
    before = rmsprop.update_.launches
    with pytest.raises(ValueError, match="RMSProp kernel takes"):
        opt.update_(params, grads, state)
    torch.cuda.synchronize()
    assert rmsprop.update_.launches == before
    for k in params:
        assert torch.equal(params[k], before_p[k]) and torch.equal(nu[k], before_nu[k]), k


@pytest.mark.gpu
def test_step_replayed_from_a_cuda_graph_on_card(cuda_device):
    """The step captured once (``graphed_call._capture_graph``: it holds two
    RMSProp launches and no sampler launch) and replayed over 8 gradients
    copied into its static inputs, against the eager kernel over the same
    8: bit for bit."""
    from ape_x_dqn_tpu_torch.runtime import graphed_call

    dev = cuda_device
    opt = ttrain.make_optimizer("rmsprop", second_moment_dtype=torch.bfloat16)
    params = _leaves(CONFIG3_SHAPES, dev, packed=False, seed=8)
    eager = _copy(params)
    state, eager_state = opt.init(params), opt.init(eager)
    gen = torch.Generator().manual_seed(9)
    static = _grads(params, gen)
    scratch = _copy(params)
    opt.update_(scratch, static, opt.init(scratch))   # eager first use: the device's set-up
    torch.cuda.synchronize()
    graph, held = graphed_call._capture_graph(lambda: opt.update_(params, static, state),
                                              dev, torch.cuda.graph_pool_handle())
    assert held == (0, 2)
    for _ in range(8):
        grads = _grads(params, gen)
        for k, g in grads.items():
            static[k].copy_(g)
        graph.replay()
        opt.update_(eager, grads, eager_state)
    torch.cuda.synchronize()
    for k in params:
        assert torch.equal(params[k], eager[k]), k
        assert torch.equal(state["nu"][k], eager_state["nu"][k]), k


@pytest.mark.gpu
def test_graphed_call_counts_two_launches_a_step_on_card(cuda_device):
    """Two fused calls of K = 8 steps through ``GraphedCall`` on a small conv
    learner with bfloat16 ν: the RMSProp kernel's count moves by exactly
    2 × the steps replayed (the warm-up's and the capture's launches rolled
    back), the sampler's by one a step (strict mode)."""
    from ape_x_dqn_tpu_torch.replay import device as tdev
    from ape_x_dqn_tpu_torch.runtime import graphed_call

    dev = cuda_device
    torch.manual_seed(0)
    net = tdueling.build_network("conv", 3, (36, 36, 1), channels=(8, 8, 8), hidden=32)
    opt = ttrain.make_optimizer("rmsprop", second_moment_dtype=torch.bfloat16)
    state = ttrain.init_train_state(net, opt, device=dev)
    ring = tdev.init_device_replay(1024, (36, 36, 1), device=dev)
    r = np.random.default_rng(1)
    M = 512
    frames = torch.from_numpy(r.integers(0, 256, (M + 1, 36, 36, 1), dtype=np.uint8)).to(dev)
    tdev.device_replay_add(ring, NStepTransition(
        obs=frames[:M], next_obs=frames[1:],
        action=torch.from_numpy(r.integers(0, 3, M).astype(np.int32)).to(dev),
        reward=torch.from_numpy(r.normal(size=M).astype(np.float32)).to(dev),
        discount=torch.full((M,), 0.97, device=dev)),
        torch.from_numpy((r.random(M) + 0.05).astype(np.float32)).to(dev))
    step = ttrain.build_train_step(net, opt, sync_in_step=False)
    call = graphed_call.GraphedCall(step, steps_per_call=8, batch_size=32,
                                    priority_exponent=0.6, target_sync_freq=8,
                                    sample_ahead=False)
    fused0, sampled0 = rmsprop.update_.launches, sampling.sample_indices.launches
    call.bind(state, ring)
    assert (rmsprop.update_.launches, sampling.sample_indices.launches) == (fused0, sampled0)
    gen = torch.Generator(device=dev).manual_seed(3)
    for _ in range(2):
        call(state, ring, 0.4, u=torch.rand((8, 32), generator=gen, device=dev))
    torch.cuda.synchronize()
    assert state.step == 16 and call.captures == 1
    assert rmsprop.update_.launches - fused0 == 2 * 16
    assert sampling.sample_indices.launches - sampled0 == 16


@pytest.mark.gpu
def test_config3_network_gradients_take_the_kernel_on_card(cuda_device):
    """config3's network (bfloat16 torso, float32 params, bfloat16 ν) on a
    batch of 32: its gradients, whatever layout cuDNN hands them back in,
    take the kernel (two launches), and the step equals the plain
    version's bit for bit (a max norm of 1e9: the clip does not engage)."""
    dev = cuda_device
    torch.manual_seed(0)
    net = tdueling.DuelingDQN(4, (84, 84, 1))
    opt = ttrain.make_optimizer("rmsprop", max_grad_norm=1e9,
                                second_moment_dtype=torch.bfloat16)
    state = ttrain.init_train_state(net, opt, device=dev)
    step = ttrain.build_train_step(net, opt, sync_in_step=False)
    r = np.random.default_rng(4)
    B = 32
    batch = PrioritizedBatch(
        transition=NStepTransition(
            obs=torch.from_numpy(r.integers(0, 256, (B, 84, 84, 1), dtype=np.uint8)).to(dev),
            action=torch.from_numpy(r.integers(0, 4, B).astype(np.int32)).to(dev),
            reward=torch.from_numpy(r.normal(size=B).astype(np.float32)).to(dev),
            discount=torch.full((B,), 0.97, device=dev),
            next_obs=torch.from_numpy(r.integers(0, 256, (B, 84, 84, 1),
                                                 dtype=np.uint8)).to(dev)),
        indices=torch.arange(B, dtype=torch.int32, device=dev),
        is_weights=torch.ones(B, device=dev))
    grads, _ = step.local_grads(state, batch)
    rmsprop.check(state.params, grads, state.opt_state["nu"])
    plain = _copy(state.params)
    plain_state = {"nu": _copy(state.opt_state["nu"])}
    before = rmsprop.update_.launches
    opt.update_(state.params, grads, state.opt_state)
    opt.apply_(plain, opt.clip(grads), plain_state)
    torch.cuda.synchronize()
    assert rmsprop.update_.launches - before == 2
    for k in plain:
        assert torch.equal(state.params[k], plain[k]), k
        assert torch.equal(state.opt_state["nu"][k], plain_state["nu"][k]), k
