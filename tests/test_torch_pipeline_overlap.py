"""The port's overlapped fused pipeline: twins of ``tests/test_pipeline_overlap.py``.

* **Strict against overlapped, bit for bit** (port only), on both device
  layouts: the same chunks, ingested inline and forced every call, or
  carved by ``prepare_staged`` (the stager thread's half), the last full
  block folded into the call (double-store), and chained through a depth-3
  ``DispatchPipeline`` drained at the end: identical train state, ring
  tensors (compared directly: the port has no ``state_dict`` yet, ROADMAP
  A9), size and staged rows.  The fold equals add-then-train exactly.
* **Prepared staging**: carved blocks stay in ``staged_rows``; prepare then
  add equals inline ingest, tensor for tensor.
* **``DispatchPipeline``** with fake probes, as the JAX tests drive it;
  and one scripted probe sequence through the JAX pipeline and the port's
  gives the same ``host_syncs``, ``gaps_observed``, ``steps_inflight`` and
  retired steps after every dispatch.  ``HostProbe`` on the CPU is ready
  at once.
* **The runtime**: ``AsyncPipeline`` at ``pipeline_depth`` 2 and
  ``sync_every`` 64 on the CPU, end to end, with the JSONL ``pipeline``
  section (the JAX test's ``/varz`` check is left out: obs is not ported);
  the frame-dedup ring through the same loop.
* **Config**: ``pipeline_depth`` and ``sync_every`` validate as in JAX.
"""

from __future__ import annotations

import io
import json
import threading
import time

import numpy as np
import pytest
import torch

from ape_x_dqn_tpu_torch.config import ApexConfig, apply_overrides
from ape_x_dqn_tpu_torch.learner import train_step as ttrain
from ape_x_dqn_tpu_torch.models import dueling as tdueling
from ape_x_dqn_tpu_torch.runtime.async_pipeline import AsyncPipeline
from ape_x_dqn_tpu_torch.runtime.fused_dedup import FusedDedupLearner
from ape_x_dqn_tpu_torch.runtime.fused_learner import FusedDeviceLearner
from ape_x_dqn_tpu_torch.runtime.infeed import DispatchPipeline, HostProbe, loss_probe
from ape_x_dqn_tpu_torch.types import NStepTransition
from ape_x_dqn_tpu_torch.utils.metrics import MetricLogger

OBS = (8, 8, 1)
A = 3


def _mk_learner(layout="double", seed=0, K=4, B=8, C=256, block=32, sample_ahead=True):
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        net = tdueling.build_network("mlp", A, OBS if layout == "double" else (10, 5, 1))
    opt = ttrain.make_optimizer("adam", learning_rate=1e-3)
    state = ttrain.init_train_state(net, opt, seed=seed, device="cpu")
    kw = dict(capacity=C, batch_size=B, steps_per_call=K, ingest_block=block,
              target_sync_freq=8, sample_ahead=sample_ahead, device="cpu")
    if layout == "double":
        return FusedDeviceLearner(net, opt, state, OBS, **kw)
    return FusedDedupLearner(net, opt, state, (10, 5, 1), frame_ratio=1.5, **kw)


def _chunk(rng, m):
    return (
        (np.abs(rng.normal(size=m)) + 0.1).astype(np.float32),
        NStepTransition(
            obs=rng.integers(0, 255, (m, *OBS), dtype=np.uint8),
            action=rng.integers(0, A, (m,), dtype=np.int32),
            reward=rng.normal(size=(m,)).astype(np.float32),
            discount=np.full((m,), 0.97, np.float32),
            next_obs=rng.integers(0, 255, (m, *OBS), dtype=np.uint8),
        ),
    )


def _chunks(layout):
    if layout == "double":
        return [_chunk(np.random.default_rng(100 + r), 48) for r in range(6)]
    from test_torch_fused_dedup import _fleet_chunks

    return [(c.priorities, c.transitions) for c in _fleet_chunks(96)]


def _state_tensors(learner):
    st, ring = learner.state, learner.replay
    out = {f"params.{k}": v for k, v in st.params.items()}
    out.update({f"target.{k}": v for k, v in st.target_params.items()})
    for group, tree in st.opt_state.items():
        if isinstance(tree, dict):
            out.update({f"opt.{group}.{k}": v for k, v in tree.items()})
        else:
            out[f"opt.{group}"] = tree
    out.update({f"ring.{k}": v for k, v in vars(ring).items()
                if isinstance(v, torch.Tensor)})
    return out


def _assert_learners_equal(a, b):
    ta, tb = _state_tensors(a), _state_tensors(b)
    assert set(ta) == set(tb)
    for k in ta:
        assert torch.equal(ta[k], tb[k]), k
    assert a.state.step == b.state.step
    for f in ("cursor", "count"):
        assert getattr(a.replay, f) == getattr(b.replay, f)
    assert a.size == b.size
    assert a.staged_rows == b.staged_rows


class TestStrictVsOverlappedEquivalence:
    @pytest.mark.parametrize("layout", ["double", "dedup"])
    def test_depth_gt_1_is_bit_for_bit_identical_to_strict(self, layout):
        chunks = _chunks(layout)
        strict = _mk_learner(layout)
        for prio, trans in chunks:
            strict.add_chunk(prio, trans)
            strict.ingest_staged()
            m = strict.train(0.4)
            float(m.loss[-1])  # force, strict-style

        over = _mk_learner(layout)
        pipe = DispatchPipeline(3, probe_fn=loss_probe)
        folds = 0
        for prio, trans in chunks:
            over.add_chunk(prio, trans)
            over.prepare_staged()  # the stager thread's half, inline here
            blocks = over.pop_prepared()
            fold = None
            if blocks and over.supports_ingest_fold and len(blocks[-1][0]) == 32:
                fold = blocks.pop()
            for blk in blocks:
                over.add_block(*blk)
            if fold is not None:
                folds += 1
                pipe.dispatch(lambda: over.train_with_ingest(0.4, fold[0], fold[1]),
                              over.steps_per_call)
            else:
                pipe.dispatch(lambda: over.train(0.4), over.steps_per_call)
        pipe.sync()
        assert len(pipe) == 0 and pipe.steps_inflight == 0
        assert (folds > 0) == (layout == "double")
        assert strict.size > 0
        _assert_learners_equal(strict, over)

    def test_fold_is_identical_to_separate_add_then_train(self):
        prio, trans = _chunk(np.random.default_rng(7), 32)
        warm = [_chunk(np.random.default_rng(8), 32)]

        def run(folded: bool):
            le = _mk_learner(seed=3)
            for p, t in warm:
                le.add_chunk(p, t)
                le.ingest_staged()
            if folded:
                m = le.train_with_ingest(0.4, prio, trans)
            else:
                le.add_block(prio, trans)
                m = le.train(0.4)
            m.loss.numpy()
            return le

        _assert_learners_equal(run(False), run(True))

    def test_fold_rejects_partial_block(self):
        le = _mk_learner()
        prio, trans = _chunk(np.random.default_rng(9), 16)
        with pytest.raises(ValueError, match="full ingest_block"):
            le.train_with_ingest(0.4, prio, trans)
        assert le.supports_ingest_fold and not _mk_learner("dedup").supports_ingest_fold


class TestPreparedStaging:
    def test_prepared_rows_still_ride_staged_rows(self):
        """A carved block not yet dispatched stays visible in
        ``staged_rows`` (the JAX test also reads it from ``state_dict``,
        which the port does not have yet)."""
        le = _mk_learner()
        prio, trans = _chunk(np.random.default_rng(1), 40)
        le.add_chunk(prio, trans)
        assert le.staged_rows == 40
        assert le.prepare_staged() == 32
        assert le.staged_rows == 40  # 32 prepared + 8 staged tail
        blocks = le.pop_prepared()
        np.testing.assert_array_equal(blocks[0][0], prio[:32])
        assert le.staged_rows == 8

    @pytest.mark.parametrize("layout", ["double", "dedup"])
    def test_prepare_then_dispatch_matches_inline_ingest(self, layout):
        chunks = (_chunks(layout) if layout == "dedup"
                  else [_chunk(np.random.default_rng(2), 80)])
        a, b = _mk_learner(layout), _mk_learner(layout)
        for prio, trans in chunks:
            a.add_chunk(prio, trans)
            b.add_chunk(prio, trans)
        inline = a.ingest_staged(drain=True)
        b.prepare_staged(drain=True)
        ingested = sum(b.add_block(*blk) for blk in b.pop_prepared())
        assert ingested == inline > 0 and a.size == b.size
        _assert_learners_equal(a, b)


class _FakeProbe:
    """Duck-typed probe with controllable readiness (as the JAX test's)."""

    def __init__(self, ready=False):
        self.ready = ready
        self.copies = 0

    def is_ready(self):
        return self.ready

    def copy_to_host_async(self):
        self.copies += 1

    def __array__(self, dtype=None, copy=None):
        return np.zeros(1, np.float32)


class _GapSink:
    def __init__(self):
        self.values = []

    def observe(self, v):
        self.values.append(v)


class TestDispatchPipelineUnit:
    def test_strict_depth1_counts_a_sync_per_unready_call(self):
        pipe = DispatchPipeline(1, probe_fn=lambda p: p)
        for _ in range(5):
            pipe.dispatch(lambda: _FakeProbe(ready=False), steps=4)
        assert pipe.host_syncs == 5
        assert len(pipe) == 0

    def test_ready_calls_retire_free(self):
        pipe = DispatchPipeline(1, probe_fn=lambda p: p)
        for _ in range(5):
            pipe.dispatch(lambda: _FakeProbe(ready=True), steps=4)
        assert pipe.host_syncs == 0

    def test_depth_window_polls_instead_of_blocking(self):
        pipe = DispatchPipeline(2, probe_fn=lambda p: p, poll_s=1e-4, poll_deadline_s=5.0)
        probes = []

        def make():
            p = _FakeProbe(ready=False)
            probes.append(p)
            return p

        pipe.dispatch(make, steps=1)

        def release():
            time.sleep(0.05)
            probes[0].ready = True

        t = threading.Thread(target=release)
        t.start()
        pipe.dispatch(make, steps=1)
        t.join(10)
        assert not t.is_alive()
        assert pipe.host_syncs == 0
        assert len(pipe) == 1
        assert probes[0].copies == probes[1].copies == 1

    def test_poll_deadline_degrades_to_counted_block(self):
        pipe = DispatchPipeline(2, probe_fn=lambda p: p, poll_s=1e-4, poll_deadline_s=0.02)
        pipe.dispatch(lambda: _FakeProbe(ready=False), steps=1)
        pipe.dispatch(lambda: _FakeProbe(ready=False), steps=1)
        assert pipe.host_syncs == 1

    def test_sync_counts_one_event_per_burst(self):
        pipe = DispatchPipeline(8, probe_fn=lambda p: p)
        for _ in range(4):
            pipe.dispatch(lambda: _FakeProbe(ready=False), steps=1)
        assert pipe.sync() == 4
        assert pipe.host_syncs == 1
        for _ in range(3):
            pipe.dispatch(lambda: _FakeProbe(ready=True), steps=1)
        pipe.drain_ready()
        assert pipe.sync() == 0
        assert pipe.host_syncs == 1

    def test_gap_recorded_when_device_idles(self):
        gaps = _GapSink()
        pipe = DispatchPipeline(4, probe_fn=lambda p: p, gap_hist_ms=gaps)
        pipe.dispatch(lambda: _FakeProbe(ready=True), steps=1)
        time.sleep(0.02)
        pipe.dispatch(lambda: _FakeProbe(ready=False), steps=1)
        assert gaps.values and gaps.values[-1] >= 10.0  # ms
        pipe.dispatch(lambda: _FakeProbe(ready=False), steps=1)
        assert gaps.values[-1] == 0.0

    def test_steps_accounting_via_on_retire(self):
        seen = []
        pipe = DispatchPipeline(4, probe_fn=lambda p: p,
                                on_retire=lambda m, s: seen.append(s))
        for _ in range(6):
            pipe.dispatch(lambda: _FakeProbe(ready=True), steps=16)
        pipe.sync()
        assert sum(seen) == 96
        assert pipe.steps_inflight == 0

    def test_degrade_drops_to_strict(self):
        pipe = DispatchPipeline(4, probe_fn=lambda p: p)
        pipe.degrade()
        pipe.dispatch(lambda: _FakeProbe(ready=False), steps=1)
        assert pipe.depth == 1 and pipe.host_syncs == 1 and len(pipe) == 0

    @pytest.mark.parametrize("depth", [1, 2, 3])
    def test_scripted_sequence_matches_the_jax_pipeline(self, depth):
        """One scripted sequence of probe readiness through both packages'
        pipelines: the same counters after every dispatch and sync."""
        from ape_x_dqn_tpu.runtime.infeed import DispatchPipeline as JPipeline

        script = [False, True, False, False, True, True, False, False, False, True,
                  False, True]
        trace = {}
        for name, cls in (("jax", JPipeline), ("port", DispatchPipeline)):
            retired = []
            pipe = cls(depth, probe_fn=lambda p: p, poll_s=1e-4, poll_deadline_s=0.005,
                       on_retire=lambda m, s, retired=retired: retired.append(s))
            out = []
            for i, ready in enumerate(script):
                pipe.dispatch(lambda ready=ready: _FakeProbe(ready=ready), steps=i + 1)
                out.append((pipe.host_syncs, pipe.gaps_observed, pipe.steps_inflight,
                            len(pipe), sum(retired)))
                if i == 6:
                    pipe.sync()
                    out.append((pipe.host_syncs, pipe.steps_inflight, len(pipe)))
            pipe.sync()
            out.append((pipe.host_syncs, pipe.steps_inflight, len(pipe), sum(retired)))
            trace[name] = out
        assert trace["port"] == trace["jax"]
        assert trace["port"][-1][1:] == (0, 0, sum(range(1, len(script) + 1)))

    def test_host_probe_on_the_cpu_is_ready_at_once(self):
        loss = torch.tensor([0.5, 0.25])
        probe = HostProbe(loss[-1:])
        assert probe.is_ready()
        np.testing.assert_array_equal(np.asarray(probe), [0.25])


def _cfg(depth, sync_every, steps, dedup=False):
    cfg = ApexConfig()
    cfg.network = "mlp"
    cfg.env.name = "catch" if dedup else "random:8x8x1"
    cfg.actor.num_actors = 4
    cfg.actor.T = 1_000_000
    cfg.actor.flush_every = 8
    cfg.learner.device_replay = True
    cfg.learner.sample_ahead = True
    cfg.learner.steps_per_call = 32
    cfg.learner.ingest_block = 64
    cfg.learner.min_replay_mem_size = 128
    cfg.learner.publish_every = 128
    cfg.learner.total_steps = steps
    cfg.learner.pipeline_depth = depth
    cfg.learner.sync_every = sync_every
    cfg.replay.capacity = 2048
    cfg.replay.dedup = dedup
    return cfg.validate()


class TestOverlappedRuntime:
    @pytest.mark.parametrize("dedup", [False, True])
    def test_overlapped_fused_run_end_to_end(self, dedup):
        buf = io.StringIO()
        pipe = AsyncPipeline(_cfg(depth=2, sync_every=64, steps=256, dedup=dedup),
                             logger=MetricLogger(stream=buf), log_every=128, device="cpu")
        assert pipe._overlapped
        final = pipe.run(learner_steps=256)
        assert final["step"] >= 256
        assert np.isfinite(final["learner/loss"])
        p = final["pipeline"]
        assert p["depth"] == 2 and p["sync_every"] == 64
        assert p["inflight"] == 0, "flush-at-exit left calls in flight"
        assert p["gaps_observed"] > 0
        calls = final["step"] // 32
        assert p["host_syncs"] <= final["step"] // 64 + calls // 2 + 2
        lines = [json.loads(line) for line in buf.getvalue().splitlines()]
        periodic = [r for r in lines if "pipeline" in r and not r.get("final")]
        assert periodic, "pipeline section missing from the JSONL stream"
        assert "fused_dispatch" in final["stage_us"]

    def test_strict_run_has_no_pipeline_section(self):
        pipe = AsyncPipeline(_cfg(depth=1, sync_every=0, steps=64),
                             logger=MetricLogger(stream=io.StringIO()), log_every=1000,
                             device="cpu")
        assert not pipe._overlapped
        final = pipe.run(learner_steps=64)
        assert final["step"] >= 64 and "pipeline" not in final


class TestConfigKnobs:
    def test_validation(self):
        cfg = ApexConfig()
        cfg.learner.pipeline_depth = 0
        with pytest.raises(ValueError, match="pipeline_depth"):
            cfg.validate()
        cfg = ApexConfig()
        cfg.learner.sync_every = 64
        with pytest.raises(ValueError, match="sync_every"):
            cfg.validate()  # requires device_replay
        cfg.learner.device_replay = True
        cfg.validate()
        cfg.learner.sync_every = -1
        with pytest.raises(ValueError, match="sync_every must be >= 0"):
            cfg.validate()

    def test_cli_overrides_reach_both_keys(self):
        cfg = apply_overrides(ApexConfig(), ["learner.device_replay=true",
                                             "learner.pipeline_depth=2",
                                             "learner.sync_every=64"])
        assert cfg.learner.pipeline_depth == 2 and cfg.learner.sync_every == 64

    def test_same_rules_as_the_jax_config(self):
        from ape_x_dqn_tpu.config import ApexConfig as JConfig

        for depth, sync, dr in [(1, 0, False), (2, 0, True), (2, 0, False), (1, 64, True),
                                (1, 64, False), (0, 0, True), (3, -1, True)]:
            verdicts = []
            for cfg in (ApexConfig(), JConfig()):
                cfg.learner.pipeline_depth, cfg.learner.sync_every = depth, sync
                cfg.learner.device_replay = dr
                try:
                    cfg.validate()
                    verdicts.append(True)
                except ValueError:
                    verdicts.append(False)
            assert verdicts[0] == verdicts[1], (depth, sync, dr)
