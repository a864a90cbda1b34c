"""The port's serving tier (``ape_x_dqn_tpu_torch/serving/``) against the JAX
package's, mirrored from ``tests/test_serving.py``.

CPU: buckets and bucket choice equal to JAX's; padded rows never change
real rows; the deadline flushes a lone request; a full queue sheds typed; a
hot reload lands between batches (every reply's q is its claimed version's,
atol 1e-5 in float32); a closed server refuses typed; a failed forward
reaches every waiter as its error.  Forward parity: a port ``PolicyServer``
and a JAX ``PolicyServer`` with the same weights (``weights.py``) give, for
every bucket 1..8, equal actions and q within atol 1e-5 (float32 compute
on both sides: the same products in another summation order).  The
latency histogram, its serialized merges and the trace logs equal JAX's.
The serve CLI's ``--attach`` runs on the CPU; ``--replicas`` without a
checkpoint to feed it exits with 2, as in the JAX CLI.  The server's two card traps are held by
``tests/test_torch_serving_card.py``.
"""

from __future__ import annotations

import io
import json
import threading
import time
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ape_x_dqn_tpu.models import dueling as jdueling
from ape_x_dqn_tpu.obs import lineage as jlineage
from ape_x_dqn_tpu.serving import PolicyServer as JaxPolicyServer
from ape_x_dqn_tpu.serving import batcher as jbatcher
from ape_x_dqn_tpu.utils import metrics as jmetrics
from ape_x_dqn_tpu_torch.models import dueling as tdueling
from ape_x_dqn_tpu_torch.obs import lineage as tlineage
from ape_x_dqn_tpu_torch.runtime.param_store import ParamStore
from ape_x_dqn_tpu_torch.serving import (
    MicroBatcher,
    PolicyServer,
    ServerClosed,
    ServerOverloaded,
    bucket_for,
    bucket_sizes,
)
from ape_x_dqn_tpu_torch.utils import metrics as tmetrics
from ape_x_dqn_tpu_torch.weights import params_from_jax

OBS = (6,)
A = 3
CONV_OBS = (36, 36, 1)


def make_net_and_params(seed=0, compute=torch.float32):
    net = tdueling.build_network("mlp", A, OBS, hidden_sizes=(16,), compute_dtype=compute)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        fresh = tdueling.build_network("mlp", A, OBS, hidden_sizes=(16,))
    return net, {k: v.detach().clone() for k, v in fresh.state_dict().items()}


def ref_q(net, params, obs):
    """Batch-1 float32 forward: the oracle every served row must match."""
    with torch.no_grad():
        return net.apply_params(params, torch.from_numpy(obs[None])).q[0].numpy()


def cpu_server(net, params=None, **kw):
    return PolicyServer(net, params, device="cpu", **kw)


class TestBuckets:
    @pytest.mark.parametrize("max_batch", [1, 2, 7, 8, 12, 32, 33])
    def test_bucket_ladder_equals_jax(self, max_batch):
        assert bucket_sizes(max_batch) == jbatcher.bucket_sizes(max_batch)

    def test_bucket_for(self):
        buckets = bucket_sizes(8)
        for n in range(1, 9):
            assert bucket_for(n, buckets) == jbatcher.bucket_for(n, buckets)
        with pytest.raises(ValueError):
            bucket_for(9, buckets)
        with pytest.raises(ValueError):
            bucket_sizes(0)


class TestPaddingCorrectness:
    def test_padded_rows_never_influence_real_rows(self):
        """5 concurrent requests ride one bucket-8 batch (3 padded rows);
        each reply equals the batch-1 oracle (atol 1e-5)."""
        net, params = make_net_and_params()
        server = cpu_server(net, params, max_batch=8, max_wait_ms=100.0,
                            queue_capacity=16)
        server.warmup(OBS)
        server.start()
        try:
            rng = np.random.default_rng(3)
            obs = [rng.integers(0, 255, OBS, dtype=np.uint8) for _ in range(5)]
            results = [f.result(timeout=10.0) for f in [server.submit(o) for o in obs]]
            assert server.stats()["batch_hist"].get("5") == 1
            for o, r in zip(obs, results):
                q = ref_q(net, params, o)
                np.testing.assert_allclose(r.q_values, q, atol=1e-5)
                assert r.action == int(np.argmax(q))
        finally:
            server.close()

    def test_every_bucket_shape_matches_oracle(self):
        net, params = make_net_and_params()
        server = cpu_server(net, params, max_batch=8, max_wait_ms=50.0, queue_capacity=16)
        server.warmup(OBS)
        server.start()
        rng = np.random.default_rng(11)
        try:
            for n in (1, 2, 3, 5, 8):
                obs = [rng.integers(0, 255, OBS, dtype=np.uint8) for _ in range(n)]
                results = [f.result(timeout=10.0) for f in [server.submit(o) for o in obs]]
                for o, r in zip(obs, results):
                    assert r.action == int(np.argmax(ref_q(net, params, o)))
            assert set(server.forward_times()) <= {"1", "2", "4", "8"}
        finally:
            server.close()


class TestForwardParity:
    @pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 6, 7, 8])
    def test_port_server_equals_jax_server(self, n):
        """The same conv weights in both packages' servers (float32): equal
        actions wherever the top-2 q gap exceeds 1e-4, q within atol 1e-5,
        for a batch of ``n`` concurrent requests (bucket ``bucket_for(n)``)."""
        kw = dict(channels=(8, 16, 8), hidden=32)
        jnet = jdueling.build_network("conv", 4, compute_dtype=jnp.float32, **kw)
        jparams = jnet.init(jax.random.PRNGKey(2), jnp.zeros((1, *CONV_OBS), jnp.uint8))
        tnet = tdueling.build_network("conv", 4, CONV_OBS, compute_dtype=torch.float32, **kw)
        tparams = params_from_jax(tnet, jparams)
        obs = np.random.default_rng(n).integers(0, 256, (n, *CONV_OBS), dtype=np.uint8)
        got, want = [], []
        for make, out in ((lambda: cpu_server(tnet, tparams, max_batch=8,
                                              max_wait_ms=200.0), got),
                          (lambda: JaxPolicyServer(jnet, jparams, max_batch=8,
                                                   max_wait_ms=200.0), want)):
            server = make()
            server.start()
            try:
                out.extend(f.result(timeout=60.0) for f in [server.submit(o) for o in obs])
                assert server.stats()["batch_hist"] == {str(n): 1}
            finally:
                server.close()
        q_got = np.stack([r.q_values for r in got])
        q_want = np.stack([np.asarray(r.q_values) for r in want])
        np.testing.assert_allclose(q_got, q_want, atol=1e-5, rtol=0)
        top2 = np.sort(q_want, axis=1)[:, -2:]
        clear = top2[:, 1] - top2[:, 0] > 1e-4
        a_got = np.array([r.action for r in got])
        a_want = np.array([r.action for r in want])
        np.testing.assert_array_equal(a_got[clear], a_want[clear])
        assert {r.param_version for r in got} == {r.param_version for r in want} == {0}


class TestDeadlineFlush:
    def test_lone_request_flushes_at_deadline(self):
        net, params = make_net_and_params()
        server = cpu_server(net, params, max_batch=32, max_wait_ms=30.0, queue_capacity=64)
        server.warmup(OBS)
        server.start()
        try:
            t0 = time.monotonic()
            res = server.act(np.zeros(OBS, np.uint8), timeout=10.0)
            wall = time.monotonic() - t0
            assert res.action in range(A)
            assert wall < 2.0, f"lone request took {wall:.3f}s"
            assert server.stats()["batch_hist"].get("1") >= 1
        finally:
            server.close()


class TestAdmissionControl:
    def test_load_shed_at_queue_capacity(self):
        release = threading.Event()
        entered = threading.Event()

        def blocking_run(obs):
            entered.set()
            release.wait(timeout=10.0)
            n = obs.shape[0]
            return np.zeros(n, np.int32), np.zeros((n, A), np.float32), 0

        b = MicroBatcher(blocking_run, max_batch=1, max_wait_s=0.0, queue_capacity=3)
        b.start()
        first = b.submit(np.zeros(OBS, np.uint8))
        assert entered.wait(timeout=5.0)
        queued = [b.submit(np.zeros(OBS, np.uint8)) for _ in range(3)]
        with pytest.raises(ServerOverloaded):
            b.submit(np.zeros(OBS, np.uint8))
        assert b.shed_count == 1
        release.set()
        for f in [first, *queued]:
            assert f.result(timeout=10.0).action == 0
        assert b.shed_count == 1
        b.close()

    def test_closed_server_rejects_typed(self):
        net, params = make_net_and_params()
        server = cpu_server(net, params, max_batch=2, queue_capacity=4)
        server.start()
        server.close()
        with pytest.raises(ServerClosed):
            server.submit(np.zeros(OBS, np.uint8))

    def test_failed_forward_reaches_every_waiter(self):
        """A forward that raises is delivered to each request of its batch
        as that exception (nothing is served in its place) and counted."""
        net, params = make_net_and_params()
        server = cpu_server(net, params, max_batch=4, max_wait_ms=100.0)
        server.start()
        try:
            futures = [server.submit(np.zeros((5,), np.uint8)) for _ in range(3)]  # bad width
            for f in futures:
                with pytest.raises(RuntimeError):
                    f.result(timeout=10.0)
            assert server.stats()["error_total"] == 3
            assert server.stats()["served_total"] == 0
        finally:
            server.close()

    def test_chaos_delay_and_missing_card_refused(self):
        """The chaos delay is ported (its stream against the JAX package's:
        ``tests/test_torch_chaos.py``): a 5 ms delay serves, each batch at
        least the jitter's low end later; a missing card is refused."""
        net, params = make_net_and_params()
        server = PolicyServer(net, params, device="cpu", apply_delay_ms=5.0, delay_seed=3)
        server.start()
        try:
            t0 = time.monotonic()
            assert server.act(np.zeros(OBS, np.uint8)).action >= 0
            assert time.monotonic() - t0 >= 0.00375
        finally:
            server.close()
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="no CUDA device"):
                PolicyServer(net, params)


class TestHotReload:
    def test_version_swap_atomicity(self):
        """Every reply's q matches the params of the version it claims
        (atol 1e-5): a swap lands only between batches, and no request is
        dropped or errored across it."""
        net, p0 = make_net_and_params(seed=0)
        _, p1 = make_net_and_params(seed=1)
        by_version = {0: p0, 1: p1}
        store = ParamStore(p0)
        server = cpu_server(net, param_source=store, max_batch=4, max_wait_ms=2.0,
                            queue_capacity=64, reload_poll_s=0.02)
        server.warmup(OBS)
        server.start()
        results, errors = [], []
        stop = threading.Event()

        def client(seed):
            rng = np.random.default_rng(seed)
            while not stop.is_set():
                obs = rng.integers(0, 255, OBS, dtype=np.uint8)
                try:
                    results.append((obs, server.act(obs, timeout=10.0)))
                except Exception as e:  # noqa: BLE001
                    errors.append(e)

        threads = [threading.Thread(target=client, args=(i,), daemon=True) for i in range(4)]
        try:
            for t in threads:
                t.start()
            time.sleep(0.3)
            store.publish(p1)
            deadline = time.monotonic() + 5.0
            while server.param_version < 1 and time.monotonic() < deadline:
                time.sleep(0.01)
            assert server.param_version == 1, "reload never adopted"
            time.sleep(0.3)
        finally:
            stop.set()
            for t in threads:
                t.join(timeout=10.0)
            server.close()
        assert not errors, errors[:3]
        assert {r.param_version for _, r in results} == {0, 1}
        for version, params in by_version.items():
            group = [(o, r) for o, r in results if r.param_version == version]
            with torch.no_grad():
                q_ref = net.apply_params(params, torch.from_numpy(
                    np.stack([o for o, _ in group]))).q.numpy()
            np.testing.assert_allclose(np.stack([r.q_values for _, r in group]), q_ref,
                                       atol=1e-5)
            np.testing.assert_array_equal(np.array([r.action for _, r in group]),
                                          np.argmax(q_ref, axis=-1))
        assert server.reload_count == 1
        assert server.stats()["versions_behind"] == 0


class TestStatistics:
    def test_latency_histogram_equals_jax(self):
        """Same samples, same buckets, percentiles and summary as JAX's."""
        samples = np.random.default_rng(0).uniform(1e-6, 200.0, 3000)
        samples[:500] = np.random.default_rng(1).uniform(0.001, 0.1, 500)
        t, j = tmetrics.LatencyHistogram(), jmetrics.LatencyHistogram()
        for s in samples:
            t.record(s)
            j.record(s)
        assert t.buckets() == j.buckets()
        assert t.summary() == j.summary()
        for p in (1, 50, 95, 99, 100):
            assert t.percentile(p) == j.percentile(p)
        for s in (0.0, 1e-5, 3e-3, 119.0, 500.0):
            assert t.bucket_edge(s) == j.bucket_edge(s)
        assert t.state_dict() == j.state_dict()
        t2, j2 = tmetrics.LatencyHistogram(), jmetrics.LatencyHistogram()
        assert t2.merge_state(j.state_dict()) and j2.merge_state(t.state_dict())
        assert t2.summary() == j2.summary() == t.summary()
        t2.merge(t)
        assert t2.count == 2 * t.count

    def test_empty_and_clamp(self):
        h = tmetrics.LatencyHistogram()
        assert h.summary() == {"count": 0}
        assert np.isnan(h.percentile(50))
        h.record(0.020)
        assert h.percentile(50) == pytest.approx(0.020, rel=0.15)
        assert h.percentile(99) <= 0.020 + 1e-9
        with pytest.raises(ValueError, match="layouts"):
            h.merge(tmetrics.LatencyHistogram(per_decade=10))
        assert not h.merge_state(tmetrics.LatencyHistogram(per_decade=10).state_dict())

    def test_serialized_merges_equal_jax(self):
        rng = np.random.default_rng(4)
        a, b = tmetrics.LatencyHistogram(), tmetrics.LatencyHistogram()
        for s in rng.uniform(1e-4, 1.0, 200):
            a.record(s)
        for s in rng.uniform(1e-3, 150.0, 300):
            b.record(s)
        ta = tmetrics.merge_bucket_dicts(a.buckets(), b.buckets())
        assert ta == jmetrics.merge_bucket_dicts(a.buckets(), b.buckets())
        for p in (0, 50, 99, 100):
            assert tmetrics.bucket_percentile(ta, p) == jmetrics.bucket_percentile(ta, p)
        assert np.isnan(tmetrics.bucket_percentile({}, 50))
        x = {"a": 1, "b": {"c": 2.5, "d": True}, "e": "x"}
        y = {"a": 2, "b": {"c": 1, "d": False, "f": 3}, "e": "y", "g": [1]}
        assert tmetrics.merge_counter_maps(x, y) == jmetrics.merge_counter_maps(x, y)

    def test_rate_counter_total(self):
        r = tmetrics.RateCounter(window_s=10.0)
        for _ in range(5):
            r.add(2)
        assert r.total == 10.0 and r.rate() > 0

    def test_trace_logs_equal_jax(self):
        """Same records: same spans (pid and times aside), exemplars and
        counts; trace id 0 records nothing in either."""
        logs = (tlineage.TraceSpanLog(depth=3), jlineage.TraceSpanLog(depth=3))
        for log in logs:
            assert log.record(0, "hop", 1.0) is None
            for i in range(1, 6):
                log.record(i, "serve.infer", 10.0 + i, 11.0 + i, rows=i)
        (ts, js) = (log.snapshot() for log in logs)
        assert ts["recorded"] == js["recorded"] == 5
        assert ts["spans"] == js["spans"]
        hists = (tmetrics.LatencyHistogram(), jmetrics.LatencyHistogram())
        ex = (tlineage.BucketExemplars(hists[0], max_buckets=2),
              jlineage.BucketExemplars(hists[1], max_buckets=2))
        for e in ex:
            for s, tid in ((0.001, 1), (0.002, 0), (0.5, 2), (3.0, 3), (0.5, 4)):
                e.record(s, tid)
        assert ex[0].snapshot() == ex[1].snapshot()
        assert ex[0].recorded == ex[1].recorded == 4


class TestServeCLI:
    def test_attach_serves_live_params_on_cpu(self):
        """``serve --attach --listen 0 --clients 2`` on the CPU: a
        serving_listen event, serve/ records with reloads from the live
        trainer, a final record with the serving_net section."""
        from ape_x_dqn_tpu_torch import serve

        out = io.StringIO()
        with redirect_stdout(out):
            rc = serve.main(["--attach", "--listen", "0", "--clients", "2",
                             "--duration", "4", "--metrics-every", "1", "--device", "cpu",
                             "--steps", "100000", "--set", "env.name=chain:6",
                             "--set", "network=mlp", "--set", "replay.capacity=5000",
                             "--set", "learner.min_replay_mem_size=200",
                             "--set", "learner.publish_every=5",
                             "--set", "serving.reload_poll_s=0.05"])
        assert rc == 0
        recs = [json.loads(line) for line in out.getvalue().splitlines()
                if line.startswith("{")]
        listen = [r for r in recs if r.get("event") == "serving_listen"]
        assert len(listen) == 1 and listen[0]["port"] > 0
        serve_recs = [r for r in recs if "serve/served_total" in r]
        final = serve_recs[-1]
        assert final["final"] and final["serve/served_total"] > 0
        assert final["serve/reloads"] >= 1
        assert {"port", "torn_frames", "inference_rows"} <= set(final["serving_net"])

    @pytest.mark.parametrize("flags,name", [
        (["--checkpoint", "/nonexistent", "--replicas", "2"], "no checkpoint under"),
        (["--attach", "--replicas", "2"], "--replicas requires --checkpoint"),
    ])
    def test_unported_flags_raise_by_name(self, flags, name, capsys):
        """``--replicas`` is ported (``serve._run_fleet``): as in the JAX CLI,
        an empty root and a fleet without ``--checkpoint`` exit with 2 and
        say why."""
        from ape_x_dqn_tpu_torch import serve

        assert serve.main([*flags, "--device", "cpu"]) == 2
        assert name in capsys.readouterr().err
