"""One run of one cell: set-up, the measured window, the traced stretch,
the correctness check and the result line.

The cell drives the port's normal learner path, ``ape_x_dqn_tpu_torch.
runtime.async_pipeline.AsyncPipeline`` (what ``python -m
ape_x_dqn_tpu_torch.train`` runs), built from the cell's configuration
file with the traffic file's overrides.  Around it the benchmark only
observes and feeds:

  * set-up writes the benchmark's weights into the train state (in place,
    so the captured graphs keep their addresses) and publishes them to the
    actors, and fills the device ring (``prefill.py``);
  * the learner's first fused call is the checked call: it runs inside
    ``AsyncPipeline.run`` on the benchmark's uniforms, actor chunks held in
    staging until it is issued, and what it produced is copied aside on the
    learner's stream (``correct.py`` judges it after the window, with the
    program's own train step run eagerly from the state the call began
    from);
  * the learner's replay-boundary hook (``on_replay``, the runtime's
    tracer tick) logs (host time, learner step) and, in a traced run,
    starts and stops ``torch.profiler`` on the learner thread at call
    boundaries (stopping it from another thread hung an H100);
  * the experience sink counts the rows the actors hand the learner and
    records a seeded sample of them; each call's sampled slots and
    priorities are kept on the card, so that the sample can be held
    against the ring after the window;
  * the param store records what the learner publishes, version by
    version, and in a central cell the server's batch function records a
    seeded sample of served batches.

The window opens once the checked call is issued, every actor source has
delivered and ``WARM_CALLS`` further calls have started; it closes
``--seconds`` later by the host clock, when the runtime's stop event is set.
"""

from __future__ import annotations

import gc
import json
import os
import sys
import threading
import time
from typing import Dict, List, Optional

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "build", "benchmark")
FORBIDDEN = ("jax", "jaxlib", "flax", "ape_x_dqn_tpu")
WARM_TIMEOUT_S = 300.0
WARM_CALLS = 4           # calls after every actor source delivered, before the window
TRACE_STEPS = 2048       # a traced stretch: the fewest whole calls that hold this many steps
RATE_AGREEMENT = 0.05    # a stretch whose rate is off the window's by more is flagged
EDGE_MARGIN_S = 0.05     # idle device at both edges of a traced stretch
LEAD_KERNELS = 64        # throwaway kernels after the profiler starts
SERVED_BATCHES = 48      # served batches the check records at most
SERVED_SHARE = 1 / 128   # of the window's batches (~9 000 in 30 s on the card)
INGEST_SHARE = 1 / 32    # of the rows the sink takes, recorded for the check
INGEST_ROWS = 4096       # recorded rows at most


class BenchmarkError(RuntimeError):
    """The run cannot produce a result."""


def forbidden_modules(modules=None) -> List[str]:
    """Loaded modules whose top-level name (before the first dot) is one of
    ``FORBIDDEN``, compared whole: ``ape_x_dqn_tpu_torch`` is not
    ``ape_x_dqn_tpu``."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".", 1)[0] for m in names} & set(FORBIDDEN))


def load_benchmark(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def load_cell(name: str, root: str = ROOT) -> dict:
    """The workload ``name`` of ``BENCHMARK.json`` with its configuration
    entry, its traffic file and the metrics that apply to it."""
    bench = load_benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise BenchmarkError(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    config = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    with open(os.path.join(BENCH_DIR, "traffic", f"{cell['traffic']}.json")) as f:
        traffic = json.load(f)
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if name in m.get("workloads", [name] if m["moves"] in reported else [])]
    return {"workload": cell, "config": config, "traffic": traffic,
            "config_file": os.path.join(root, config["file"]),
            "end_to_end": e2e, "per_layer": per_layer,
            "run_seconds": bench["run_seconds"]}


def metric_reader(name: str):
    """``benchmark/metrics/<name>.py``'s ``read(ctx)``, loaded by path (a
    metric's name may hold dots)."""
    import importlib.util

    path = os.path.join(BENCH_DIR, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def card_state(index: int = 0) -> Optional[dict]:
    """The card's name, clocks and power from ``nvidia-smi``; None where
    it cannot be read."""
    import subprocess

    fields = "name,clocks.sm,clocks.mem,power.draw,power.limit,temperature.gpu"
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader",
                              "-i", str(index)], capture_output=True, text=True,
                             timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return None
    if not out:
        return None
    vals = [v.strip() for v in out.splitlines()[0].split(",")]
    return dict(zip(fields.split(","), vals), at=time.monotonic())


class _Profiler:
    """``torch.profiler`` started and stopped on the learner thread, set up
    as the port's ``utils/profiling`` sets it up for CUDA graphs (CUPTI
    kept attached, a larger activity buffer, idle edges, lead kernels)."""

    def __init__(self, cuda: bool):
        import torch

        self._torch = torch
        self.cuda = cuda
        self.prof = None

    def start(self):
        torch = self._torch
        # On a card the device's records and the CUDA calls alone: the CPU
        # operators of every thread (64 actors in some cells) would slow the
        # host the stretch is meant to show.
        acts = [torch.profiler.ProfilerActivity.CUDA if self.cuda
                else torch.profiler.ProfilerActivity.CPU]
        if self.cuda:
            torch.cuda.synchronize()
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.start()
        if self.cuda:
            lead = torch.empty(1, device=torch.cuda.current_device())
            for _ in range(LEAD_KERNELS):
                lead.fill_(0.0)
            torch.cuda.synchronize()
            time.sleep(EDGE_MARGIN_S)

    def stop(self):
        if self.cuda:
            self._torch.cuda.synchronize()
            time.sleep(EDGE_MARGIN_S)
        self.prof.stop()


class Run:
    """State of one run (see the module docstring)."""

    def __init__(self, cell: dict, seed: int, seconds: float, trace: bool, device: str,
                 overrides=(), t_process: Optional[float] = None):
        self.cell = cell
        self.seed = int(seed)
        self.seconds = float(seconds)
        self.trace = bool(trace)
        self.device = device
        self.overrides = list(overrides)
        self.t_process = t_process if t_process is not None else time.monotonic()
        self.marks: Dict[str, float] = {}
        self.steps_log: List[tuple] = []
        self.sink_log: List[tuple] = [(0.0, 0)]
        self.sources: set = set()
        self.rows_in = 0
        self.accepted = 0        # rows the learner accepted, in its order
        self.ingested = 0        # rows it moved into the ring
        self.recorded: List[dict] = []
        self.recorded_rows = 0
        self.last_frames: dict = {}
        self.calls_log: List[tuple] = []
        self.published: dict = {}
        self.calls = 0
        self.calls_at_sources: Optional[int] = None
        self.t0: Optional[float] = None
        self.t1: Optional[float] = None
        self.snapshot: Optional[dict] = None
        self.served: List[dict] = []
        self.stretch: Optional[dict] = None
        self.cards: List[dict] = []
        self.error: Optional[str] = None
        self._lock = threading.Lock()

    def mark(self, name: str) -> None:
        self.marks[name] = time.monotonic()

    # -- set-up ------------------------------------------------------------

    def build(self):
        import torch

        from ape_x_dqn_tpu_torch.config import load_config
        from ape_x_dqn_tpu_torch.runtime.async_pipeline import AsyncPipeline
        from ape_x_dqn_tpu_torch.utils.metrics import MetricLogger

        self.mark("imported")
        traffic = self.cell["traffic"]
        sets = [f"{k}={v}" for k, v in traffic.get("overrides", {}).items()]
        sets += [f"seed={self.seed}", *self.overrides]
        self.cfg = load_config(self.cell["config_file"], overrides=sets)
        self._log = open(os.devnull, "w")
        self.pipe = AsyncPipeline(self.cfg, logger=MetricLogger(stream=self._log),
                                  log_every=1 << 40, device=self.device)
        self.fused = self.pipe.fused
        if self.fused is None:
            raise BenchmarkError("the cell's configuration does not run the fused learner")
        self.num_actions = self.pipe.comps.num_actions
        self.obs_shape = tuple(self.pipe.comps.obs_shape)
        self.update = self.fused.graphed_call._update
        self.mark("built")
        self._hook_store()
        self._load_weights(torch)
        from benchmark.prefill import prefill

        self.layout = prefill(self.fused, self.seed, self.cfg, self.num_actions,
                              traffic["prefill"])
        self.cursor0 = self.fused.replay.cursor
        if self.device != "cpu":
            torch.cuda.synchronize()
        self.mark("prefilled")
        self._hook()
        if self.trace:
            # CUPTI's first set-up in a process takes seconds: pay it here.
            p = _Profiler(self.device != "cpu")
            p.start()
            p.stop()
            self.mark("profiler_ready")

    def _load_weights(self, torch) -> None:
        from benchmark.reference import init_weights

        net = self.pipe.comps.network
        channels = [c.out_channels for c in net.convs]
        hidden = net.value_hidden.out_features
        self.net_shape = {"obs_shape": self.obs_shape, "channels": channels,
                          "hidden": hidden, "num_actions": self.num_actions}
        dev = torch.device(self.device)
        self.weights0 = init_weights(self.seed, self.obs_shape, channels, hidden,
                                     self.num_actions, dev)
        st = self.fused.state
        if set(st.params) != set(self.weights0):
            raise BenchmarkError(f"the train state's parameters {sorted(st.params)} are not "
                                 f"the network the benchmark makes {sorted(self.weights0)}")
        with torch.no_grad():
            for k, w in self.weights0.items():
                st.params[k].copy_(w)
                st.target_params[k].copy_(w)
        # The state the checked call starts from, for the eager first steps.
        self.state0 = {"params": _clone(st.params), "target_params": _clone(st.target_params),
                       "opt_state": {k: _clone(v) for k, v in st.opt_state.items()}}
        self.pipe.store.publish(_clone(st.params))

    def _hook_store(self) -> None:
        """Keep every params snapshot the learner publishes, by the version
        the store gives it (each publish hands over a fresh copy)."""
        store = self.pipe.store
        publish = store.publish
        run = self

        def recorded_publish(params):
            version = publish(params)
            run.published[version] = params
            return version

        store.publish = recorded_publish

    # -- hooks -------------------------------------------------------------

    def _hook(self) -> None:
        import torch

        fused, pipe = self.fused, self.pipe
        K = self.fused_K = fused.steps_per_call
        B = self.cfg.learner.replay_sample_size
        g = torch.Generator(device=self.device)
        from benchmark.prefill import stream_seed

        g.manual_seed(stream_seed(self.seed, 4))
        self.u = torch.rand((K, B), generator=g, device=self.device)
        ingest, train = fused.ingest_staged, fused.train
        run = self

        def held_ingest(*args, **kwargs):
            # Actor chunks wait in staging until the checked call is issued,
            # so that call samples the ring exactly as the prefill left it.
            if run.snapshot is None:
                return 0
            rows = ingest(*args, **kwargs)
            run.ingested += rows
            return rows

        call = fused.graphed_call

        def observed_train(beta, u=None, on_replay=None):
            before = run.ingested
            if run.snapshot is None:
                metrics = train(beta, u=run.u, on_replay=on_replay)
                run.snapshot = run._take_snapshot(beta, metrics)
            else:
                metrics = train(beta, u=u, on_replay=on_replay)
                # Kept on the card, queued behind the call: no host sync.
                run.calls_log.append((before, call.body.sampled_indices(),
                                      metrics.priorities))
            with run._lock:
                run.calls += 1
            return metrics

        fused.ingest_staged = held_ingest
        fused.train = observed_train
        add = fused.add_chunk
        stager = getattr(fused, "stager", None)
        pick = np.random.default_rng(stream_seed(self.seed, 6))

        def counted_sink(priorities, transitions):
            now = time.monotonic()
            with run._lock:
                run.rows_in += len(priorities)
                run.sink_log.append((now, run.rows_in))
                run.sources.add(getattr(transitions, "source", 0))
                if run.calls_at_sources is None and len(run.sources) >= run.expected_sources:
                    run.calls_at_sources = run.calls
                # Added under the lock, so the order of the learner's
                # staging is the order of this count.
                before = stager.rows_in if stager is not None else run.accepted
                out = add(priorities, transitions)
                taken = (stager.rows_in - before if stager is not None
                         else len(priorities))
                run._record(priorities, transitions, run.accepted, taken,
                            pick.random(len(priorities)) < INGEST_SHARE)
                run.accepted += taken
            return out

        fused.add_chunk = counted_sink
        worker = pipe.worker
        if getattr(worker, "_sink", None) == add:   # thread actors hold the bound method
            worker._sink = counted_sink
        a = self.cfg.actor
        self.expected_sources = a.num_workers if a.mode == "process" else 1
        tick = pipe.trace_on_demand.tick
        self._profiler = _Profiler(self.device != "cpu") if self.trace else None
        self._trace_calls = -(-TRACE_STEPS // K)

        def observed_tick(step):
            now = time.monotonic()
            run.steps_log.append((now, step))
            if run._profiler is not None:
                run._trace_tick(step, now)
            tick(step)

        pipe.trace_on_demand.tick = observed_tick
        server = getattr(pipe, "_central_server", None)
        if server is not None:
            self._hook_server(server)

    def _record(self, priorities, transitions, first: int, taken: int, picked) -> None:
        """Copy the picked rows of one chunk as the sink got it, with their
        place ``first + i`` in the learner's order.  A dedup chunk's frames
        are resolved as the learner resolves them: a negative reference is
        a frame of the source's previous chunk.  A chunk of which the
        learner took fewer rows than it holds (a carry it dropped) is not
        recorded."""
        frames = getattr(transitions, "frames", None)
        source = getattr(transitions, "source", 0)
        prev = self.last_frames.get(source)
        if frames is not None:
            self.last_frames[source] = frames
        rows = np.nonzero(picked)[0][:max(0, INGEST_ROWS - self.recorded_rows)]
        if taken != len(priorities) or not len(rows):
            return
        if frames is None:
            obs, nxt = transitions.obs[rows], transitions.next_obs[rows]
        else:
            def frame(ref):
                if ref >= 0:
                    return frames[ref]
                if prev is None or transitions.prev_frames != len(prev):
                    return None
                return prev[len(prev) + ref]
            pairs = [(frame(int(transitions.obs_ref[i])), frame(int(transitions.next_ref[i])))
                     for i in rows]
            keep = [j for j, (o, n) in enumerate(pairs) if o is not None and n is not None]
            rows = rows[keep]
            if not len(rows):
                return
            obs = np.stack([pairs[j][0] for j in keep])
            nxt = np.stack([pairs[j][1] for j in keep])
        self.recorded.append({
            "a": first + rows.astype(np.int64),
            "action": np.asarray(transitions.action)[rows].astype(np.int32),
            "reward": np.asarray(transitions.reward)[rows].astype(np.float32),
            "discount": np.asarray(transitions.discount)[rows].astype(np.float32),
            "prio": np.asarray(priorities, np.float32)[rows],
            "obs": np.array(obs), "next_obs": np.array(nxt)})
        self.recorded_rows += len(rows)

    def _take_snapshot(self, beta: float, metrics) -> dict:
        """The checked call's outputs, copied on the learner's stream right
        behind its replays."""
        fused = self.fused
        st = fused.state
        body = fused.graphed_call.body
        return {
            "beta": float(beta),
            "u": self.u.clone(),
            "indices": body.sampled_indices().long(),
            "loss": metrics.loss.clone(),
            "prio": metrics.priorities.clone(),
            "params": {k: v.detach().clone() for k, v in st.params.items()},
            "nu": {k: v.detach().clone() for k, v in st.opt_state["nu"].items()},
            "mass": fused.replay.mass.clone(),
            "obs_shape": self.obs_shape,
        }

    def _hook_server(self, server) -> None:
        import random

        run_batch = server.batcher._run_batch
        rng = random.Random(self.seed ^ 0x5E4E)
        run = self

        def recorded(obs):
            params, _, version, _ = server._live
            out = run_batch(obs)
            if run.t0 is not None and run.t1 is None and len(run.served) < SERVED_BATCHES:
                # The window's first batch, then a seeded share of the rest,
                # spread over the whole window (nearly all hold max_batch
                # rows on the card).
                if not run.served or rng.random() < SERVED_SHARE:
                    actions, q, served_version = out
                    if served_version == version:
                        run.served.append({"obs": obs.copy(), "actions": actions.copy(),
                                           "q": q.copy(), "params": params,
                                           "version": version})
            return out

        server.batcher._run_batch = recorded
        self.server = server

    def _trace_tick(self, step: int, now: float) -> None:
        """A stretch of whole calls, a third into the window: the profiler
        starts at a call's last boundary (before the host's work between
        two calls), and stops once the call after the stretch has issued
        its first replay, so that the stretch runs from the device start of
        its first call to that of the next one: as many boundaries as
        calls, as in the window."""
        s = self.stretch
        K = self.fused_K
        if s is None:
            if (self.t0 is not None and self.t1 is None and step > 0 and step % K == 0
                    and now >= self.t0 + self.seconds / 3):
                self._profiler.start()
                self.stretch = {"from_step": step, "to_step": step + self._trace_calls * K,
                                "at": now, "started": time.monotonic()}
            return
        if "stopped" in s:
            return
        replays = self.fused.graphed_call.replays
        if "replays_at_end" not in s:
            if step == s["to_step"]:
                s["replays_at_end"] = replays
                s["ended"] = now
        elif replays > s["replays_at_end"] or step > s["to_step"]:
            self._profiler.stop()
            s["stopped"] = time.monotonic()

    # -- the window --------------------------------------------------------

    def _window(self) -> None:
        """Open the window once the learner and every actor source are
        running, close it ``seconds`` later, stop the runtime."""
        stop = self.pipe.stop_event
        deadline = time.monotonic() + WARM_TIMEOUT_S
        while not stop.is_set():
            with self._lock:
                ready = (self.snapshot is not None and self.calls_at_sources is not None
                         and self.calls >= self.calls_at_sources + WARM_CALLS)
                steps = self.steps_log[-1][1] if self.steps_log else 0
            if ready:
                break
            if time.monotonic() > deadline:
                self.error = (f"not warm after {WARM_TIMEOUT_S} s: checked call "
                              f"{self.snapshot is not None}, sources {len(self.sources)} of "
                              f"{self.expected_sources}, calls {self.calls}, step {steps}")
                stop.set()
                return
            time.sleep(0.01)
        if stop.is_set():
            return
        # The card is read outside the window only: an nvidia-smi query
        # stalls the running learner (on an H100, a ~5 % dip of the call
        # it lands in, once 1.2 s beside thread actors).  The window opens
        # at the next call's start after the query.
        self.cards.append(card_state() or {})
        with self._lock:
            calls = self.calls
        while not stop.is_set() and self.calls == calls:
            time.sleep(0.001)
        self.t0 = time.monotonic()
        self.state_t0 = self._counters()
        stop.wait(max(0.0, self.t0 + self.seconds - time.monotonic()))
        self.t1 = time.monotonic()
        self.state_t1 = self._counters()
        self.cards.append(card_state() or {})
        stop.set()

    def _counters(self) -> dict:
        """What the program counts that a per-layer metric reads at the
        window's edges: the server's batches and times, the central workers'
        round-trip histograms."""
        out = {}
        server = getattr(self, "server", None)
        if server is not None:
            out["batch_hist"] = dict(server.batcher.batch_hist)
            out["forward_times"] = server.forward_times()
        pool = getattr(self.pipe.worker, "pool", None)
        if pool is not None:
            out["rtt"] = {w: dict(st["rtt_state"]) for w, st in
                          list(pool.inference_by_worker.items()) if "rtt_state" in st}
        return out

    def measure(self) -> dict:
        self.mark("setup_done")
        controller = threading.Thread(target=self._window, name="bench-window", daemon=True)
        controller.start()
        try:
            final = self.pipe.run(learner_steps=1 << 50)
        finally:
            self.pipe.stop_event.set()
            controller.join(timeout=60.0)
            self._log.close()
        if self.error:
            raise BenchmarkError(self.error)
        if self.t0 is None or self.t1 is None:
            raise BenchmarkError("the runtime stopped before the window closed")
        return final

    # -- after the window ----------------------------------------------------

    def reduce_stretch(self) -> Optional[dict]:
        """The traced stretch's device timeline (``yardstick.reduce_trace``
        between the device starts of its first call and of the call after
        it), from the Chrome trace the profiler exports into the checkout;
        its rate beside the window's."""
        s = self.stretch
        if self._profiler is None or s is None:
            return None
        if "stopped" not in s:
            self._profiler.stop()
            return None
        from benchmark.yardstick import launch_device_starts, reduce_trace, window_rate


        os.makedirs(OUT_DIR, exist_ok=True)
        path = os.path.join(OUT_DIR, f"{self.cell['workload']['name']}.trace.json")
        self._profiler.prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
        os.remove(path)
        starts = launch_device_starts(events)
        if len(starts) < 2:
            return None
        red = reduce_trace(events, starts[0], starts[-1])
        if red is None:
            return None
        steps = s["to_step"] - s["from_step"]
        rate = steps / (red["span_us"] / 1e6)
        # The window's calls before the stretch: the profiler's stop holds
        # the learner for seconds, so the traced run's own window is slower.
        before = sorted(self.fused_K / (end - t) for _, t, end in _call_starts(self)
                        if self.t0 <= t and end <= s["at"])
        window = before[len(before) // 2] if before else window_rate(self.steps_log,
                                                                     self.t0, s["at"])
        red.update(steps=steps, launches=len(starts), steps_per_s=rate,
                   host_steps_per_s=steps / (s["ended"] - s["started"]),
                   window_steps_per_s=window,
                   agrees=bool(window) and abs(rate / window - 1.0) <= RATE_AGREEMENT)
        return red

    def read_ring(self) -> None:
        """The ring slots the recorded rows landed in, read after the
        window (before the program's state is freed): rows the learner
        moved into the ring and has not overwritten since."""
        import torch

        self.ring_rows = self.ring_read = None
        if not self.recorded:
            return
        rows = {k: np.concatenate([r[k] for r in self.recorded]) for k in self.recorded[0]}
        ring = self.fused.replay
        C = ring.capacity
        live = (rows["a"] < self.ingested) & (rows["a"] >= self.ingested - C)
        rows = {k: v[live] for k, v in rows.items()}
        dev = ring.mass.device
        slots = torch.remainder(torch.as_tensor(rows["a"], device=dev) + self.cursor0, C)
        read = {"slot": slots, "action": ring.action[slots], "reward": ring.reward[slots],
                "discount": ring.discount[slots], "mass": ring.mass[slots]}
        if hasattr(ring, "frames"):
            F = ring.frame_capacity
            read["obs"] = ring.frames[torch.remainder(ring.obs_ref[slots].long(), F)]
            read["next_obs"] = ring.frames[torch.remainder(ring.next_ref[slots].long(), F)]
        else:
            read["obs"], read["next_obs"] = ring.obs[slots], ring.next_obs[slots]
        self.ring_rows = rows
        self.ring_read = {k: v.cpu().numpy() for k, v in read.items()}

    def context(self, red: Optional[dict]) -> dict:
        """What the metric readers read."""
        return {
            "t0": self.t0, "t1": self.t1, "seconds": self.t1 - self.t0,
            "setup_s": self.t0 - self.t_process,
            "steps_log": self.steps_log, "sink_log": self.sink_log,
            "cfg": self.cfg, "net_shape": self.net_shape,
            "capacity": self.fused.replay.capacity,
            "steps_per_call": self.fused.steps_per_call,
            "batch": self.cfg.learner.replay_sample_size,
            "trace": red,
            "state_t0": self.state_t0, "state_t1": self.state_t1,
            "central": self.cfg.actor.inference == "central",
        }

    def release(self) -> None:
        """Drop every reference to the program's state, so the reference
        finds the card's memory free."""
        import torch

        self.pipe = self.fused = self.server = None
        gc.collect()
        if self.device != "cpu":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()

    def check(self) -> Dict[str, float]:
        """The compared numbers (``correct.py``)."""
        from benchmark import correct

        snap = self.snapshot
        inp = correct.training_inputs(self.seed, self.cfg, self.num_actions,
                                      self.cell["traffic"]["prefill"], self.layout, snap,
                                      self.weights0.get("value.bias").device)
        snap["eager"] = eager_steps(self.update, self.state0, correct.eager_batches(inp))
        refrun = correct.follow(self.weights0, inp, snap["indices"].shape[0])
        self.detail = {}
        numbers = correct.training_numbers(self.weights0, snap, inp, refrun, self.detail)
        del inp, refrun
        empty = {"a": np.zeros(0, np.int64)}
        numbers.update(correct.ingest_numbers(
            self.ring_rows or empty, self.ring_read, self.calls_log,
            float(self.cfg.replay.priority_exponent), self.layout.capacity, self.detail))
        if self.cfg.actor.inference == "central":
            served = correct.served_numbers(self.served, self.published)
            if served is None:
                served = {"served_q_gap": float("nan"), "served_greedy_gap": float("nan"),
                          "served_params_gap": float("nan")}
            numbers.update(served)
        return numbers


def _clone(tree: dict) -> dict:
    return {k: v.detach().clone() for k, v in tree.items()}


def eager_steps(update, state0: dict, batches: list) -> dict:
    """The program's train step (``update``, the function its graphs
    captured) run eagerly from a copy of ``state0`` over ``batches``:
    RMSProp's ν after the first step and the params after the last."""
    import torch

    from ape_x_dqn_tpu_torch.types import NStepTransition, PrioritizedBatch, TrainState

    state = TrainState(params=_clone(state0["params"]),
                       target_params=_clone(state0["target_params"]),
                       opt_state={k: _clone(v) for k, v in state0["opt_state"].items()},
                       step=0, seed=0)
    nu1 = None
    for obs, action, reward, discount, next_obs, weights, slots in batches:
        batch = PrioritizedBatch(
            transition=NStepTransition(obs=obs, action=action, reward=reward,
                                       discount=discount, next_obs=next_obs),
            indices=slots.to(torch.int32), is_weights=weights)
        update(state, batch)
        if nu1 is None:
            nu1 = _clone(state.opt_state["nu"])
    return {"nu1": nu1, "params3": _clone(state.params)}


def device_info(run: Run, red: Optional[dict], chips: int) -> dict:
    import torch

    out = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
           "memory_peak_bytes": int(torch.cuda.max_memory_allocated())}
    if red is not None:
        out["busy_s"] = red["busy_us"] / 1e6
        out["window_s"] = red["span_us"] / 1e6
    return out


def run_cell(name: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             overrides=(), t_process: Optional[float] = None, out=print,
             err=lambda s: print(s, file=sys.stderr, flush=True)) -> dict:
    """One run of workload ``name``; returns the result line's object (also
    printed through ``out`` as the last line, after the earlier lines)."""
    from benchmark.yardstick import count_at

    cell = load_cell(name)
    run = Run(cell, seed, seconds, trace, device, overrides, t_process)
    run.build()
    run.measure()
    red = run.reduce_stretch()
    ctx = run.context(red)
    metrics = {}
    for m in (cell["per_layer"] if trace else cell["end_to_end"]):
        value = metric_reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = device_info(run, red, cell["workload"]["chips"]) if device != "cpu" else {
        "platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    steps_in = count_at(run.steps_log, run.t1) - count_at(run.steps_log, run.t0)
    rows_in = count_at(run.sink_log, run.t1) - count_at(run.sink_log, run.t0)
    t_check = time.monotonic()
    run.read_ring()
    run.release()
    numbers = run.check()
    from benchmark import correct

    limits = correct.load_limits()
    ok = correct.judge(numbers, limits)
    found = forbidden_modules()
    if found:
        err(f"modules of {found} are loaded in the process that prints the result")
        raise BenchmarkError(f"forbidden modules loaded: {found}")
    setup = {k: round(v - run.t_process, 3) for k, v in run.marks.items()}
    earlier = {
        "workload": name, "seed": seed, "trace": int(trace),
        "setup_split_s": setup, "window_open_s": round(run.t0 - run.t_process, 3),
        "card": run.cards, "reference_s": round(time.monotonic() - t_check, 3),
        "check_detail": run.detail, "steps_in_window": steps_in,
        "rows_in_window": rows_in, "served_recorded": len(run.served),
        "call_rates": _call_rates(run),
    }
    if red is not None:
        earlier["stretch"] = {k: red[k] for k in (
            "device_records", "busy_us", "span_us", "graph_kernels", "steps", "launches",
            "steps_per_s", "host_steps_per_s", "window_steps_per_s", "agrees")}
        if not red["agrees"]:
            err(f"the traced stretch ran at {red['steps_per_s']:.1f} steps/s, the window's "
                f"calls before it at {red['window_steps_per_s']:.1f}: off by more than "
                f"{RATE_AGREEMENT:.0%}, so the per-layer readings describe a slower learner")
    if ctx["central"]:
        earlier["act_rtt_samples"] = _rtt_samples(ctx)
    out(json.dumps(earlier))
    _write_run_file(name, seed, trace, earlier)
    checks = {k: {"value": numbers[k], "limit": limits[k]} for k in numbers}
    for k, v in checks.items():
        err(f"check {k} {v['value']!r} limit {v['limit']!r}")
    result = {"correct": bool(ok), "attempted": int(steps_in), "failed": 0,
              "metrics": metrics, "device": dev}
    if red is not None:
        result["breakdown"] = {
            "device_ops": [[n, us / 1e6] for n, us in red["device_ops"]],
            "idle_gaps": [[n, us / 1e6] for n, us in red["idle_gaps"]],
        }
    result["checks"] = checks
    out(json.dumps(result))
    return result


def _call_starts(run: Run) -> list:
    """(learner step, host time) of each fused call's first replay
    boundary, and of the boundary after its last replay."""
    starts = {}
    for t, step in run.steps_log:
        starts.setdefault(step, t)
    K = run.fused_K
    return [(s, t, starts[s + K]) for s, t in sorted(starts.items())
            if s % K == 0 and s + K in starts]


def _call_rates(run: Run) -> list:
    """Steps per second of each fused call that began and ended inside the
    window."""
    return [round(run.fused_K / (end - t), 2) for _, t, end in _call_starts(run)
            if run.t0 <= t and end <= run.t1]


def _rtt_samples(ctx: dict) -> int:
    a, b = ctx["state_t0"].get("rtt", {}), ctx["state_t1"].get("rtt", {})
    return int(sum(st["count"] - a.get(w, {"count": 0})["count"] for w, st in b.items()))


def _write_run_file(name: str, seed: int, trace: bool, record: dict) -> None:
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, f"{name}.{seed}.{int(trace)}.run.json"), "w") as f:
        json.dump(record, f, indent=1)
