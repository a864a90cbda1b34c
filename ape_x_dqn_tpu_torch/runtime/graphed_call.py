"""One fused K-step call as CUDA-graph replays.

The port's counterpart of ``jax.jit(fused, donate_argnums=(0, 1))``
(``ape_x_dqn_tpu/replay/device.py:377-378``, ``replay/device_dedup.py:
274-275``): the JAX package compiles a whole K-step call into one XLA
program; eager PyTorch issues ~400 launches per step, and the host, not the
card, set the pace.  ``GraphedCall`` captures the pieces of
``replay/device.FusedBody`` once and replays them, so a call is

    load (the [K, B] uniforms, β, the sampling size, k = 0)
    → prologue graph (sample-ahead: sample + gather into static buffers)
    → K / G replays of the step graph (G steps each; a tail graph if G ∤ K)
    → epilogue graph (sample-ahead: the last-wins restamp)
    → one copy of the metrics out of the static buffer
    → on the host: ``step += K`` and the target sync it decides.

Strict mode has no prologue or epilogue work, so no graph for them.  On
the CPU the same body runs eagerly (``run_eager``).  On a CUDA device there
is no eager path: a failed capture or replay raises.

How it meets the traps of capturing a training step:

* **Warm-up does not train.**  PyTorch wants eager iterations before a
  capture (autograd's and cuDNN's first-use work, the sampler's set-up).
  They run on the real tensors, on a side stream, and then the params, the
  optimizer state, the target and the ring's ``mass`` are copied back in
  place, so N graphed calls equal N eager calls on the same uniforms.  The
  capture itself records and runs nothing, so it needs no data: the
  learners capture at construction, on the empty ring.
* **Static addresses.**  A graph bakes in every tensor's address.  The
  state is only ever updated in place; before each call the runner
  compares the address, shape, stride and dtype of every tensor the body
  reads or writes with those it captured, and **recaptures** if any
  changed (a ``load_state_dict`` or weight import that rebinds a tensor).
  Passing another state or ring object rebinds the body and recaptures too.
  The key also holds the math-mode flags (TF32 in cuBLAS and cuDNN,
  cuDNN's deterministic mode): a graph keeps the kernels it was captured
  with, so a flag set after the learner was built recaptures too.
* **Other threads.**  Capture runs with ``capture_error_mode=
  "thread_local"``: a thread actor's policy forward or the publisher's
  copy on another thread is not an error.  The learners capture before any
  actor thread starts.
* **Calls in flight.**  A call's metrics are copied out of the static
  buffer into a fresh tensor, so a later call cannot overwrite metrics
  that the dispatch pipeline has not read yet.
* **The sampler's shared scratch** (``ops/sampling.py``): replays and every
  eager sampler call run on the learner's stream; the warm-up's side stream
  is joined both ways around it.
* **Other streams' launches.**  The host can issue a step graph far
  faster than the card runs it (~1.2 ms); unpaced, a call fills CUDA's
  launch queue, and from then on every kernel launch of the
  process, on any stream — a ``PolicyServer``'s forward on its
  high-priority stream among them — waits for room in it: on an H100
  beside config3's learner, an 8-row forward's round trip took ~57 ms
  unpaced and ~3 ms paced (``profile_serving``).
  So the runner keeps at most ``MAX_REPLAYS_AHEAD`` replays in flight,
  waiting (GIL released) on the event of the replay that many back.
* **Launch counting.**  ``sample_indices.launches`` counts on the host
  when a launch is issued; a capture issues none and a replay issues one
  per captured launch.  So the runner undoes the counts of its warm-up and
  capture (set-up, rolled back with the state they touched) and adds a
  graph's captured launches right after each of its replays; ``replays``
  counts the replays issued.  A count read between two replays is exact.
* **Replay boundaries.**  ``on_replay(step)``, where given, is called on
  the calling thread before each replay and once after the last, with the
  learner step reached so far: the call's first step (``train_state.step``)
  plus the steps replayed.  The runtime passes its on-demand tracer's tick
  (``obs/trace.TraceOnDemand``), so a trace window starts and stops between
  two replays, inside a call; on the CPU ``run_eager`` calls it between
  the body's pieces.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Callable, List, Optional, Tuple

import torch

from ape_x_dqn_tpu_torch.ops import sampling
from ape_x_dqn_tpu_torch.replay.device import FusedBody, finish_call, run_eager

# Steps captured in one step graph (G).  Not a config key.  On an NVIDIA
# H100 80GB HBM3 at 700 W (profile_fused, double-store ring of 100 000
# slots, K = 128, strict), G = 1 ran 1.225 ms/step at a device idle share
# of 0.203 and G = 8 1.224 ms/step at 0.207: the idle lies between the
# kernels inside a step's graph, which more steps per graph do not shorten.
STEPS_PER_GRAPH = 1
# Eager body steps before a capture (at most K).
WARMUP_STEPS = 2
# Replays in flight at most (the pacing above): ~19 ms of step graphs at
# 1.2 ms per step, so the host's wake-ups never starve the card.  0 turns
# the pacing off (``profile_serving`` measures both).
MAX_REPLAYS_AHEAD = 16


def _state_tensors(body: FusedBody) -> List[Tuple[str, torch.Tensor]]:
    """(name, tensor) of every tensor outside the runner that the body
    reads or writes: params, target, optimizer state, ring columns."""
    st, ring = body.train_state, body.replay
    out = [(f"params.{k}", v) for k, v in st.params.items()]
    out += [(f"target.{k}", v) for k, v in st.target_params.items()]

    def walk(prefix, tree):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(f"{prefix}{k}.", v)
            elif isinstance(v, torch.Tensor):
                out.append((f"{prefix}{k}", v))

    walk("opt.", st.opt_state)
    out += [(f"ring.{k}", v) for k, v in vars(ring).items() if isinstance(v, torch.Tensor)]
    return out


def _signature(body: FusedBody) -> tuple:
    tensors = tuple((name, t.data_ptr(), t.dtype, tuple(t.shape), t.stride())
                    for name, t in _state_tensors(body))
    return tensors + (("math", torch.backends.cuda.matmul.allow_tf32,
                       torch.backends.cudnn.allow_tf32, torch.backends.cudnn.deterministic),)


@functools.cache
def _warmup_stream(device: torch.device) -> torch.cuda.Stream:
    """One warm-up stream per device: every stream that runs a matmul keeps
    a cuBLAS workspace for the life of the process, so a capture that took
    a fresh pool stream each time would add one more."""
    return torch.cuda.Stream(device)


def _written(body: FusedBody) -> List[torch.Tensor]:
    """What a warm-up changes and must put back."""
    return [t for name, t in _state_tensors(body)
            if not name.startswith("ring.") or name == "ring.mass"]


def _warm_up(bodies: list, run: Callable[[], None]) -> None:
    """``run()`` on each device's warm-up stream, joined both ways with
    the current stream; then every tensor the bodies' pieces write is put
    back as it was, so the warm-up trains nothing."""
    saved = [(t, t.clone()) for b in bodies for t in _written(b)]
    devices = list(dict.fromkeys(b.device for b in bodies))
    mains = [torch.cuda.current_stream(d) for d in devices]
    sides = [_warmup_stream(d) for d in devices]
    for main, side in zip(mains, sides):
        side.wait_stream(main)
    with contextlib.ExitStack() as stack:
        for side in sides:
            stack.enter_context(torch.cuda.stream(side))
        run()
    for main, side in zip(mains, sides):
        main.wait_stream(side)
    for t, copy in saved:
        t.copy_(copy)
    for d in devices:
        torch.cuda.synchronize(d)


def _capture_graph(fn: Callable[[], None], device: torch.device, pool) -> tuple:
    """(graph, sampler launches it holds): ``fn`` captured on ``device``."""
    graph = torch.cuda.CUDAGraph()
    before = sampling.sample_indices.launches
    with torch.cuda.device(device):
        with torch.cuda.graph(graph, pool=pool, capture_error_mode="thread_local"):
            fn()
    return graph, sampling.sample_indices.launches - before


class _Pacer:
    """At most ``MAX_REPLAYS_AHEAD`` ticks in flight: a tick waits for the
    event of the tick that many back (a blocking event: the learner thread
    sleeps instead of spinning a core the actors need), issues its work,
    and records its own event on ``device``'s current stream."""

    def __init__(self):
        self._events: list = []
        self._ticks = 0

    def tick(self, device: torch.device, issue: Callable[[], None]) -> None:
        ahead = MAX_REPLAYS_AHEAD
        if not ahead:
            issue()
            return
        if len(self._events) != ahead:
            self._events = [torch.cuda.Event(blocking=True) for _ in range(ahead)]
            self._ticks = 0
        ev = self._events[self._ticks % ahead]
        if self._ticks >= ahead:
            ev.synchronize()
        issue()
        ev.record(torch.cuda.current_stream(device))
        self._ticks += 1


class GraphedCall:
    """``fn(train_state, replay_state, beta, u=None, generator=None) ->
    (train_state, replay_state, metrics)``: one fused K-step call of either
    device layout (see the module docstring).

    ``train_step_fn`` is a ``build_train_step`` step (its ``update`` is the
    body's step); the other arguments are ``FusedBody``'s, plus the target
    sync frequency (None: no sync).  ``bind`` captures ahead of the first
    call; ``captures`` counts captures (1 unless a rebind forced another).
    """

    def __init__(self, train_step_fn, *, steps_per_call: int, batch_size: int,
                 priority_exponent: float, target_sync_freq: Optional[int],
                 sample_ahead: bool, sample_many_fn: Optional[Callable] = None):
        self._update = train_step_fn.update
        self._knobs = dict(steps_per_call=steps_per_call, batch_size=batch_size,
                           priority_exponent=priority_exponent, sample_ahead=sample_ahead,
                           sample_many_fn=sample_many_fn)
        self.steps_per_call = steps_per_call
        self.target_sync_freq = target_sync_freq
        self.body: Optional[FusedBody] = None
        # (graph, sampler launches captured, steps per replay, replays per call)
        self._graphs: list = []
        self._signature: Optional[tuple] = None
        self.captures = 0
        self._pacer = _Pacer()
        self.replays = 0

    def bind(self, train_state, replay_state) -> FusedBody:
        """The body over these states; on a card, captured for their
        current tensors (a capture when they changed)."""
        body = self.body
        if body is None or body.train_state is not train_state \
                or body.replay is not replay_state:
            self._graphs, self._signature = [], None
            body = self.body = FusedBody(self._update, train_state, replay_state,
                                         **self._knobs)
        if body.device.type == "cuda":
            if _signature(body) != self._signature:
                self._capture(body)
        elif body.device.type != "cpu":
            raise ValueError(f"no fused call for device {body.device}")
        return body

    def __call__(self, train_state, replay_state, beta: float,
                 u: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None,
                 on_replay: Optional[Callable[[int], None]] = None):
        body = self.bind(train_state, replay_state)
        if body.device.type == "cuda":
            body.load(beta, u, generator)
            self._replay(body.device, train_state.step, on_replay)
            metrics = body.read_metrics()
        else:
            metrics = run_eager(body, beta, u, generator, on_replay, train_state.step)
        finish_call(train_state, self.steps_per_call, self.target_sync_freq)
        return train_state, replay_state, metrics

    def _replay(self, device: torch.device, step: int,
                on_replay: Optional[Callable[[int], None]]) -> None:
        """Every graph of one call, in order, paced (see the module
        docstring); ``on_replay`` at each replay boundary."""
        for graph, launches, steps, replays in self._graphs:
            for _ in range(replays):
                if on_replay is not None:
                    on_replay(step)
                self._pacer.tick(device, graph.replay)
                self.replays += 1
                sampling.sample_indices.launches += launches
                step += steps
        if on_replay is not None:
            on_replay(step)

    def _capture(self, body: FusedBody) -> None:
        dev = body.device
        K = self.steps_per_call
        self._graphs, self._signature = [], None   # release the old pool first
        launches = sampling.sample_indices.launches

        def warm():
            body.load(0.0, torch.zeros_like(body.u))
            body.prologue()
            for _ in range(min(WARMUP_STEPS, K)):
                body.step()
            body.epilogue()

        _warm_up([body], warm)
        body.batches = None

        def steps(n):
            return lambda: [body.step() for _ in range(n)]

        full, tail = divmod(K, STEPS_PER_GRAPH)
        pieces = []   # (fn, steps per replay, replays)
        if body.sample_ahead:
            pieces.append((body.prologue, 0, 1))
        if full:
            pieces.append((steps(STEPS_PER_GRAPH), STEPS_PER_GRAPH, full))
        if tail:
            pieces.append((steps(tail), tail, 1))
        if body.sample_ahead:
            pieces.append((body.epilogue, 0, 1))
        pool = torch.cuda.graph_pool_handle()
        self._graphs = [(*_capture_graph(fn, dev, pool), n, replays)
                        for fn, n, replays in pieces]
        sampling.sample_indices.launches = launches
        self._signature = _signature(body)
        self.captures += 1


class ShardedGraphedCall:
    """``fn(train_states, replay, beta, u=None, generators=None) ->
    (train_states, replay, metrics)``: one sharded fused K-step call
    (``replay/device_dp.ShardedFusedBody``).

    On the CPU the body runs eagerly (``run_sharded_eager``).  On a card
    each slot's pieces (prologue, sample, grads, apply, epilogue) are
    captured as CUDA graphs on that slot's device, and a call replays them
    in ``run_sharded``'s order with the cross-slot steps (the weights' max,
    the gradient reduce) run eagerly between them: a graph holds one
    device's work, so the steps that read several slots stay outside.  The
    warm-up with the restore of what it wrote, the capture's launch count,
    the recapture on a rebound tensor and the pacing (one tick per step,
    at its apply) are ``GraphedCall``'s.
    """

    def __init__(self, train_step_fn, *, steps_per_call: int, batch_size: int,
                 priority_exponent: float, target_sync_freq: Optional[int],
                 sample_ahead: bool, sample_many_fn: Callable):
        self._step_fn = train_step_fn
        self._knobs = dict(steps_per_call=steps_per_call, batch_size=batch_size,
                           priority_exponent=priority_exponent, sample_ahead=sample_ahead,
                           sample_many_fn=sample_many_fn)
        self.steps_per_call = steps_per_call
        self.target_sync_freq = target_sync_freq
        self.body = None
        self._graphs: list = []         # per slot: {piece: (graph, launches)}
        self._signature: Optional[tuple] = None
        self.captures = 0
        self._pacer = _Pacer()
        self.replays = 0

    def bind(self, train_states: list, replay):
        from ape_x_dqn_tpu_torch.replay.device_dp import ShardedFusedBody

        body = self.body
        if body is None or body.replay is not replay or any(
                a is not b for a, b in zip(body.train_states, train_states)):
            self._graphs, self._signature = [], None
            body = self.body = ShardedFusedBody(self._step_fn, list(train_states), replay,
                                                **self._knobs)
        types = {b.device.type for b in body.slots}
        if types == {"cuda"}:
            if self._sharded_signature(body) != self._signature:
                self._capture(body)
        elif types != {"cpu"}:
            raise ValueError(f"no sharded fused call over devices {sorted(types)}")
        return body

    @staticmethod
    def _sharded_signature(body) -> tuple:
        return tuple(_signature(b) for b in body.slots)

    def __call__(self, train_states: list, replay, beta: float,
                 u: Optional[torch.Tensor] = None, generators: Optional[list] = None,
                 on_replay: Optional[Callable[[int], None]] = None):
        from ape_x_dqn_tpu_torch.replay.device_dp import run_sharded, run_sharded_eager

        body = self.bind(train_states, replay)
        step = train_states[0].step
        if body.slots[0].device.type == "cuda":
            body.load(beta, u, generators)
            run_sharded(body, self._replay_piece, on_replay, step)
            metrics = body.read_metrics()
        else:
            metrics = run_sharded_eager(body, beta, u, generators, on_replay, step)
        for st in train_states:
            finish_call(st, self.steps_per_call, self.target_sync_freq)
        return train_states, replay, metrics

    def _replay_piece(self, name: str) -> None:
        def issue():
            for slot in self._graphs:
                graph, launches = slot[name]
                if graph is None:
                    continue
                graph.replay()
                self.replays += 1
                sampling.sample_indices.launches += launches

        if name == "apply":     # one tick per step
            self._pacer.tick(self.body.slots[0].device, issue)
        else:
            issue()

    def _capture(self, body) -> None:
        from ape_x_dqn_tpu_torch.replay.device_dp import run_sharded

        self._graphs, self._signature = [], None   # release the old pools first
        launches = sampling.sample_indices.launches

        def warm():
            body.load(0.0, torch.zeros((body.n, *body.slots[0].u.shape),
                                       device=body.slots[0].device))
            K, body.steps_per_call = body.steps_per_call, min(WARMUP_STEPS, body.steps_per_call)
            try:
                run_sharded(body, lambda name: [getattr(b, name)() for b in body.slots])
            finally:
                body.steps_per_call = K

        _warm_up(body.slots, warm)
        pools = {d: torch.cuda.graph_pool_handle()
                 for d in dict.fromkeys(b.device for b in body.slots)}
        wanted = ["grads", "apply"]
        wanted = (["prologue"] + wanted + ["epilogue"] if body.sample_ahead
                  else ["sample"] + wanted)
        graphs = [{name: (None, 0) for name in body.PIECES} for _ in body.slots]
        for name in wanted:          # capture order: a piece's inputs exist first
            for s, b in enumerate(body.slots):
                graphs[s][name] = _capture_graph(getattr(b, name), b.device, pools[b.device])
        for b in body.slots:
            b.k.zero_()
        sampling.sample_indices.launches = launches
        self._graphs = graphs
        self._signature = self._sharded_signature(body)
        self.captures += 1
