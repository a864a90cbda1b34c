"""The sharded device rings and the sharded fused learners against the JAX
package's (twins of ``tests/test_sharded_fused.py``).

JAX runs ``replay/device_dp.py`` under ``shard_map`` on the conftest's 8
virtual CPU devices; the port runs ``replay/device_dp.py`` on a mesh of
``[cpu] * n`` slots at the same n, one ring shard and one replica per
slot.  The uniforms are JAX's own draws, injected per shard as [n, K, B/n]
(``fold_in(rng, s)`` in sample-ahead, ``split(fold_in(rng, s), K)[k]`` per
strict step); tests never compare seeds.  Masses are integers, so the
prefix sums are exact and sampled indices must match EXACTLY.
Tolerances: IS weights rtol 1e-5 (the JAX test's); params and masses after
a fused call rtol 1e-5 atol 1e-7 against the port's own single-device
emulation (the JAX test's), rtol 1e-4 atol 1e-6 against JAX (the
train-step tests' float32 tolerance).  The fused steps use RMSProp with
ε = 1, whose first steps are linear in the gradient as the JAX test's SGD
is, so a summation-order difference is not amplified to ±lr.
"""

from __future__ import annotations

import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding as JNamedSharding
from jax.sharding import PartitionSpec as JP

from ape_x_dqn_tpu.learner import train_step as jtrain
from ape_x_dqn_tpu.models.dueling import DuelingMLP as JDuelingMLP
from ape_x_dqn_tpu.parallel import make_mesh as jmake_mesh
from ape_x_dqn_tpu.parallel.mesh import shard_map as jshard_map
from ape_x_dqn_tpu.replay import device_dp as jdp
from ape_x_dqn_tpu.replay.device import device_replay_sample_many as jsample_many
from ape_x_dqn_tpu.runtime.fused_dedup import DedupStager as JDedupStager
from ape_x_dqn_tpu.runtime.fused_dedup import FusedDedupLearner as JFusedDedup
from ape_x_dqn_tpu.runtime.fused_learner import FusedDeviceLearner as JFusedDevice
from ape_x_dqn_tpu.types import DedupChunk as JDedupChunk
from ape_x_dqn_tpu.types import NStepTransition as JTransition
from ape_x_dqn_tpu_torch.learner import train_step as ttrain
from ape_x_dqn_tpu_torch.models import dueling as tdueling
from ape_x_dqn_tpu_torch.parallel import make_mesh, place_state, shard_train_state
from ape_x_dqn_tpu_torch.replay.device import (
    DeviceReplayState,
    device_replay_sample,
    device_replay_update_priorities,
)
from ape_x_dqn_tpu_torch.replay.device_dp import (
    ShardedFusedBody,
    build_sharded_fused_learn_step,
    init_sharded_device_replay,
    sharded_replay_add,
)
from ape_x_dqn_tpu_torch.runtime.fused_dedup import DedupStager, FusedDedupLearner
from ape_x_dqn_tpu_torch.runtime.fused_learner import FusedDeviceLearner
from ape_x_dqn_tpu_torch.types import DedupChunk, NStepTransition, PrioritizedBatch, TrainState
from ape_x_dqn_tpu_torch.weights import params_from_jax

from _torch_harness import port_deadline  # noqa: F401 — the per-test deadline, autouse

OBS = (8,)


def cpu_mesh(n):
    return make_mesh(devices=[torch.device("cpu")] * n)


def cpu_replicas(state, n):
    """``state`` replicated over an n-slot CPU mesh, one copy per slot."""
    return place_state(state, shard_train_state(state, cpu_mesh(n))).rows


def np_chunk(M, obs_shape=OBS, seed=0, cls=NStepTransition):
    r = np.random.default_rng(seed)
    return cls(
        obs=r.integers(0, 255, (M, *obs_shape), dtype=np.uint8),
        action=r.integers(0, 3, (M,), dtype=np.int32),
        reward=r.normal(size=(M,)).astype(np.float32),
        discount=np.full((M,), 0.9, np.float32),
        next_obs=r.integers(0, 255, (M, *obs_shape), dtype=np.uint8),
    )


def full_rings(n, C_local, mass):
    """JAX's and the port's sharded rings, every slot filled with the same
    rows, masses overwritten with ``mass`` (JAX ``_manual_global_state``)."""
    C = n * C_local
    chunk = np_chunk(C, seed=7)
    jmesh = jmake_mesh(num_devices=n)
    jstate = jdp.init_sharded_device_replay(C, OBS, jmesh)
    jstate = jdp.build_sharded_replay_add(jmesh)(jstate, jax.device_put(np_chunk(C, seed=7,
                                                                                  cls=JTransition)),
                                                 jnp.ones(C))
    jstate = jstate.replace(mass=jax.device_put(jnp.asarray(mass, jnp.float32),
                                                jstate.mass.sharding))
    tstate = init_sharded_device_replay(C, OBS, cpu_mesh(n))
    sharded_replay_add(tstate, chunk, np.ones(C, np.float32))
    tstate.load_column_("mass", mass.astype(np.float32))
    return jstate, tstate, chunk


def twin_learner_parts(opt=("rmsprop", 1.0)):
    """The same MLP and RMSProp (ε as given, no clip) in both packages."""
    kind, eps = opt
    jnet = JDuelingMLP(num_actions=3, hidden_sizes=(16,))
    jopt = jtrain.make_optimizer(kind, learning_rate=1e-3, rmsprop_eps=eps, max_grad_norm=None)
    jstate = jtrain.init_train_state(jnet, jopt, jax.random.PRNGKey(0),
                                     jnp.zeros((1, *OBS), jnp.uint8))
    tnet = tdueling.DuelingMLP(3, OBS, hidden_sizes=(16,))
    topt = ttrain.Optimizer(kind, learning_rate=1e-3, rmsprop_eps=eps, max_grad_norm=None)
    params = params_from_jax(tnet, jax.device_get(jstate.params))
    tstate = TrainState(params=params, target_params={k: v.clone() for k, v in params.items()},
                        opt_state=topt.init(params), step=0, seed=0)
    return jnet, jopt, jstate, tnet, topt, tstate


def strict_u(rng, n, K, B):
    """JAX's strict-mode uniforms: shard s, step k draws
    uniform(split(fold_in(rng, s), K)[k], (1, B))."""
    return torch.from_numpy(np.stack([
        np.concatenate([np.asarray(jax.random.uniform(k, (1, B)))
                        for k in jax.random.split(jax.random.fold_in(rng, s), K)])
        for s in range(n)]))


def ahead_u(rng, n, K, B):
    """JAX's sample-ahead uniforms: shard s draws uniform(fold_in(rng, s), (K, B))."""
    return torch.from_numpy(np.stack([np.asarray(jax.random.uniform(
        jax.random.fold_in(rng, s), (K, B))) for s in range(n)]))


class TestShardedIngest:
    def test_chunk_splits_contiguously_over_shards(self):
        n, C = 4, 64   # C_local = 16
        jmesh = jmake_mesh(num_devices=n)
        jstate = jdp.init_sharded_device_replay(C, OBS, jmesh)
        jstate = jdp.build_sharded_replay_add(jmesh)(
            jstate, jax.device_put(np_chunk(32, seed=1, cls=JTransition)), jnp.ones(32))
        got = jax.device_get(jstate)
        chunk = np_chunk(32, seed=1)
        state = init_sharded_device_replay(C, OBS, cpu_mesh(n))
        sharded_replay_add(state, chunk, np.ones(32, np.float32))
        # Shard d holds chunk rows [d*8, (d+1)*8) in its first 8 slots, as
        # JAX's global rows [d*16, d*16 + 8).
        for d, shard in enumerate(state.shards):
            np.testing.assert_array_equal(shard.obs[:8].numpy(), chunk.obs[d * 8:(d + 1) * 8])
        for f in ("obs", "next_obs", "action", "reward", "discount", "mass"):
            np.testing.assert_array_equal(state.column(f), np.asarray(getattr(got, f)),
                                          err_msg=f)
        np.testing.assert_array_equal(state.cursor, np.asarray(got.cursor))
        np.testing.assert_array_equal(state.count, np.asarray(got.count))

    def test_capacity_must_divide(self):
        with pytest.raises(ValueError, match="divide") as jerr:
            jdp.init_sharded_device_replay(30, OBS, jmake_mesh(num_devices=4))
        with pytest.raises(ValueError, match="divide") as terr:
            init_sharded_device_replay(30, OBS, cpu_mesh(4))
        assert str(terr.value) == str(jerr.value)


class TestShardedSampler:
    def test_indices_and_weights_match_numpy_oracle(self):
        """The realized per-shard law is q_i = (m_i / M_s) / n; indices
        come from a stratified inverse-CDF over the shard's mass and the
        weights are (N_global · q_i)^-β normalised by the GLOBAL batch max:
        the port's fused body (each slot's prologue, then the cross-slot
        max) against the numpy oracle and JAX's shard_map sampler, on JAX's
        uniforms."""
        n, C_local, K, B = 4, 16, 3, 8
        beta = 0.7
        r = np.random.default_rng(3)
        mass = r.integers(1, 50, n * C_local).astype(np.float32)
        jstate, tstate, _ = full_rings(n, C_local, mass)
        rng = jax.random.PRNGKey(11)
        jmesh = jmake_mesh(num_devices=n)

        def body(st_l):
            b = jsample_many(jdp._local(st_l), jax.random.fold_in(rng, jax.lax.axis_index("data")),
                             K, B, beta, axis_name="data")
            return b.indices, b.is_weights

        jidx, jw = jax.device_get(jshard_map(body, mesh=jmesh, in_specs=(jdp.replay_specs(),),
                                             out_specs=(JP(None, "data"), JP(None, "data")))(jstate))
        # ---- numpy oracle ----
        us = ahead_u(rng, n, K, B)
        want_idx = np.zeros((K, n * B), np.int64)
        raw_w = np.zeros((K, n * B), np.float64)
        for s in range(n):
            m_s = mass[s * C_local:(s + 1) * C_local]
            total = np.float32(m_s.sum())
            targets = ((np.arange(B, dtype=np.float32)[None, :] + us[s].numpy())
                       * (total / np.float32(B))).astype(np.float32)
            targets = np.minimum(targets, total * np.float32(1.0 - 1e-7))
            idx = np.clip(np.searchsorted(np.cumsum(m_s, dtype=np.float32), targets,
                                          side="right"), 0, C_local - 1)
            want_idx[:, s * B:(s + 1) * B] = idx
            raw_w[:, s * B:(s + 1) * B] = (n * C_local * (m_s[idx] / total / n)) ** (-beta)
        want_w = raw_w / raw_w.max(axis=1, keepdims=True)
        np.testing.assert_array_equal(jidx, want_idx)
        # The fused body's pieces: per-slot raw weights, then the global max.
        _, _, _, tnet, topt, t0 = twin_learner_parts()
        step = ttrain.build_train_step(tnet, topt, sync_in_step=False)
        fb = ShardedFusedBody(step, cpu_replicas(t0, n), tstate,
                              steps_per_call=K, batch_size=n * B, priority_exponent=0.6,
                              sample_ahead=True)
        fb.load(beta, us)
        for b in fb.slots:
            b.prologue()
        fb.normalize_weights_()
        np.testing.assert_array_equal(
            torch.cat([b.batches.indices for b in fb.slots], 1).numpy(), want_idx)
        w = torch.cat([b.batches.is_weights for b in fb.slots], 1).numpy()
        np.testing.assert_allclose(w, want_w, rtol=1e-5)
        np.testing.assert_allclose(w, jw, rtol=1e-5)


class TestShardedFusedStrict:
    def test_matches_concat_batch_emulation(self):
        """The whole strict-PER fused call — K × [per-shard sample → train
        on the slot-mean gradient → per-shard restamp] — against the port's
        emulation from single-device pieces (per-shard sampling with
        hand-computed global IS weights, ONE train step on the concatenated
        global batch, per-shard priority updates), and against JAX's
        sharded fused call on the same uniforms."""
        n, C_local, K, B_local = 2, 32, 3, 4
        B = n * B_local
        pexp, beta = 0.6, 0.5
        r = np.random.default_rng(5)
        mass = r.integers(1, 30, n * C_local).astype(np.float32)
        jring, tring, chunk = full_rings(n, C_local, mass)
        jnet, jopt, jstate, tnet, topt, t0 = twin_learner_parts()
        rng = jax.random.PRNGKey(42)
        jmesh = jmake_mesh(num_devices=n)
        jstep = jtrain.build_train_step(jnet, jopt, sync_in_step=False, grad_reduce_axis="data",
                                        jit=False)
        jfused = jdp.build_sharded_fused_learn_step(jstep, jmesh, B, steps_per_call=K,
                                                    priority_exponent=pexp,
                                                    target_sync_freq=None)
        # The port's states first: JAX's call donates its inputs.
        states = cpu_replicas(t0, n)
        init = {k: v.clone() for k, v in t0.params.items()}
        t_em = cpu_replicas(t0, 1)[0]
        jrepl = jax.jit(lambda s: s, out_shardings=JNamedSharding(jmesh, JP()))(jstate)
        jt, jr, jm = jfused(jrepl, jring, beta, rng)
        # --- the port's sharded call ---
        u = strict_u(rng, n, K, B_local)
        step = ttrain.build_train_step(tnet, topt, sync_in_step=False)
        fused = build_sharded_fused_learn_step(step, cpu_mesh(n), B, steps_per_call=K,
                                               priority_exponent=pexp, target_sync_freq=None)
        _, _, metrics = fused(states, tring, beta, u=u)
        assert all(s.step == K for s in states) and torch.isfinite(metrics.loss).all()
        assert metrics.priorities.shape == (K, B)
        # --- the emulation ---
        step_em = ttrain.build_train_step(tnet, topt, sync_in_step=False)
        locals_ = []
        for s in range(n):
            sl = slice(s * C_local, (s + 1) * C_local)
            locals_.append(DeviceReplayState(
                obs=torch.from_numpy(chunk.obs[sl]), next_obs=torch.from_numpy(chunk.next_obs[sl]),
                action=torch.from_numpy(chunk.action[sl]),
                reward=torch.from_numpy(chunk.reward[sl]),
                discount=torch.from_numpy(chunk.discount[sl]),
                mass=torch.from_numpy(mass[sl].copy()), cursor=0, count=C_local))
        for k in range(K):
            parts = [device_replay_sample(locals_[s], B_local, beta, u=u[s, k][None])
                     for s in range(n)]
            raw = []
            for s, p in enumerate(parts):
                m_s = locals_[s].mass.numpy().astype(np.float64)
                q = m_s[p.indices.numpy()] / m_s.sum() / n
                raw.append((n * C_local * q) ** (-beta))
            wmax = max(float(w.max()) for w in raw)
            batch = PrioritizedBatch(
                transition=NStepTransition(*(torch.cat([getattr(p.transition, f) for p in parts])
                                             for f in ("obs", "action", "reward", "discount",
                                                       "next_obs"))),
                indices=torch.cat([p.indices for p in parts]),
                is_weights=torch.from_numpy(np.concatenate([w / wmax for w in raw])
                                            .astype(np.float32)))
            t_em, m_em = step_em(t_em, batch)
            for s in range(n):
                device_replay_update_priorities(
                    locals_[s], parts[s].indices, m_em.priorities[s * B_local:(s + 1) * B_local],
                    pexp)
        for k, v in t_em.params.items():
            for st in states:
                np.testing.assert_allclose(st.params[k].numpy(), v.numpy(), rtol=1e-5, atol=1e-7,
                                           err_msg=k)
        want_mass = np.concatenate([loc.mass.numpy() for loc in locals_])
        np.testing.assert_allclose(tring.column("mass"), want_mass, rtol=1e-5, atol=1e-7)
        # --- against JAX ---
        want = params_from_jax(tnet, jax.device_get(jt.params))
        for k in want:
            np.testing.assert_allclose((states[0].params[k] - init[k]).numpy(),
                                       (want[k] - init[k]).numpy(), rtol=1e-4, atol=1e-6,
                                       err_msg=k)
        np.testing.assert_allclose(tring.column("mass"), np.asarray(jax.device_get(jr.mass)),
                                   rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(metrics.loss.numpy(), np.asarray(jm.loss), rtol=1e-4)
        np.testing.assert_allclose(metrics.priorities.numpy(), np.asarray(jm.priorities),
                                   rtol=1e-4, atol=1e-6)


def _pipe_cfg(**learner):
    from ape_x_dqn_tpu_torch.config import ApexConfig

    cfg = ApexConfig()
    cfg.env.name = "chain:6"
    cfg.network = "mlp"
    cfg.actor.num_actors = 4
    cfg.actor.flush_every = 8
    cfg.learner.device_replay = True
    cfg.learner.data_parallel = 4
    cfg.learner.steps_per_call = 8
    cfg.learner.min_replay_mem_size = 128
    cfg.learner.replay_sample_size = 16
    cfg.learner.max_grad_norm = None
    cfg.replay.capacity = 2048
    for k, v in learner.items():
        setattr(cfg.learner, k, v)
    return cfg


class TestFusedDPRuntime:
    def test_pipeline_end_to_end(self):
        from ape_x_dqn_tpu_torch.replay.device_dp import ShardedReplay
        from ape_x_dqn_tpu_torch.runtime.async_pipeline import AsyncPipeline
        from ape_x_dqn_tpu_torch.utils.metrics import MetricLogger

        pipe = AsyncPipeline(_pipe_cfg(), logger=MetricLogger(stream=io.StringIO()),
                             log_every=32, device="cpu")
        assert isinstance(pipe.fused.replay, ShardedReplay) and pipe.fused.replay.n == 4
        out = pipe.run(learner_steps=64)
        assert out["step"] >= 64
        assert np.isfinite(out["learner/loss"])
        assert out["replay_size"] >= 128
        states = pipe.fused._states
        for st in states[1:]:
            for k in st.params:
                assert torch.equal(st.params[k], states[0].params[k]), k

    def test_capacity_divisibility_validated(self):
        from ape_x_dqn_tpu.config import ApexConfig as JApexConfig
        from ape_x_dqn_tpu_torch.config import ApexConfig

        for cls in (JApexConfig, ApexConfig):
            cfg = cls()
            cfg.learner.device_replay = True
            cfg.learner.data_parallel = 4
            cfg.replay.capacity = 100_002
            with pytest.raises(ValueError, match="capacity must be divisible"):
                cfg.validate()


def _learners(capacity, steps_per_call, seed=0, n=4):
    """JAX's and the port's fused learners over an n-slot mesh, the same
    MLP and Adam, the port's params carried from JAX's."""
    jnet = JDuelingMLP(num_actions=3, hidden_sizes=(16,))
    jopt = jtrain.make_optimizer("adam", learning_rate=1e-3)
    jst = jtrain.init_train_state(jnet, jopt, jax.random.PRNGKey(seed),
                                  jnp.zeros((1, *OBS), jnp.uint8))
    tnet = tdueling.DuelingMLP(3, OBS, hidden_sizes=(16,))
    topt = ttrain.make_optimizer("adam", learning_rate=1e-3)
    params = params_from_jax(tnet, jax.device_get(jst.params))
    tst = TrainState(params=params, target_params={k: v.clone() for k, v in params.items()},
                     opt_state=topt.init(params), step=0, seed=seed)
    kw = dict(capacity=capacity, batch_size=16, steps_per_call=steps_per_call,
              ingest_block=32)
    return (JFusedDevice(jnet, jopt, jst, OBS, mesh=jmake_mesh(num_devices=n), **kw),
            FusedDeviceLearner(tnet, topt, tst, OBS, mesh=cpu_mesh(n), device="cpu", **kw))


class TestShardedSnapshot:
    def test_roundtrip_with_staged_rows(self, tmp_path):
        """A sharded ring with staged rows round-trips: state_dict in JAX's
        keys, shapes and dtypes; load_state_dict into a fresh learner; the
        checkpoint's replay leg (``utils/checkpoint.py``) into a third; and
        JAX's snapshot of the same feed into the port."""
        from ape_x_dqn_tpu_torch.utils.checkpoint import restore_checkpoint, save_checkpoint

        jfl, fl = _learners(256, 4)
        for f, cls in ((jfl, JTransition), (fl, NStepTransition)):
            f.add_chunk(np.ones(64, np.float32), np_chunk(64, seed=1, cls=cls))
            f.ingest_staged()
            # 10 staged rows: 8 drain in g·2^k sub-blocks, 2 stay staged (< n
            # shards) — the snapshot carries them anyway.
            f.add_chunk(np.ones(10, np.float32), np_chunk(10, seed=2, cls=cls))
            f.ingest_staged(drain=True)
            assert f.size == 72 and f.staged_rows == 2
        fl.train(beta=0.4)
        sd, jsd = fl.state_dict(), jfl.state_dict()
        assert len(sd["staged_prio"]) == 2
        assert set(sd) == set(jsd)
        for k in sd:
            assert np.shape(sd[k]) == np.shape(jsd[k]), k
            assert np.asarray(sd[k]).dtype == np.asarray(jsd[k]).dtype, k
            if k != "mass":   # the port trained once
                np.testing.assert_array_equal(sd[k], jsd[k], err_msg=k)
        assert sd["cursor"].shape == (4,)
        _, fl2 = _learners(256, 4, seed=9)
        fl2.load_state_dict(sd)
        assert fl2.size == 72 and fl2.staged_rows == 2
        np.testing.assert_array_equal(fl2.replay.column("mass"), fl.replay.column("mass"))
        assert torch.isfinite(fl2.train(beta=0.4).loss).all()
        # The checkpoint's legs: train state (with the shards' sampling
        # streams) and the replay npz.
        save_checkpoint(str(tmp_path), fl.state, replay=fl, generator=fl.generator)
        _, fl3 = _learners(256, 4, seed=3)
        restore_checkpoint(str(tmp_path), fl3.state, replay=fl3, generator=fl3.generator)
        assert fl3.size == 72 and fl3.staged_rows == 2
        np.testing.assert_array_equal(fl3.replay.column("mass"), fl.replay.column("mass"))
        np.testing.assert_array_equal(fl3.generator.get_state(), fl.generator.get_state())
        # A JAX snapshot loads into the port's ring; a 1-shard one is refused.
        _, fl4 = _learners(256, 4, seed=4)
        fl4.load_state_dict(jsd)
        np.testing.assert_array_equal(fl4.replay.column("obs"), jsd["obs"])
        with pytest.raises(ValueError, match="data_parallel extent must match"):
            fl4.load_state_dict({**jsd, "cursor": np.int32(0), "count": np.int32(0)})


class TestSampleAheadRestampCollisions:
    def test_last_wins_per_shard_against_emulation(self):
        """Sample-ahead restamps under dp > 1.  Tiny per-shard rings force
        heavy duplicate sampling across the K batches; the final masses
        equal a per-shard LAST-WINS emulation over the metrics' own
        (indices, priorities), the indices equal JAX's sampler's on the
        same uniforms, and no shard's restamp touches another shard's rows."""
        n, C_local, K, B_local = 4, 8, 6, 4
        r = np.random.default_rng(3)
        mass = r.integers(1, 20, n * C_local).astype(np.float32)
        _, tring, _ = full_rings(n, C_local, mass)
        pre_mass = tring.column("mass").copy()
        _, _, _, tnet, topt, t0 = twin_learner_parts()
        pexp, rng = 0.6, jax.random.PRNGKey(7)
        step = ttrain.build_train_step(tnet, topt, sync_in_step=False)
        fused = build_sharded_fused_learn_step(step, cpu_mesh(n), n * B_local, steps_per_call=K,
                                               priority_exponent=pexp, target_sync_freq=None,
                                               sample_ahead=True)
        states = cpu_replicas(t0, n)
        _, _, metrics = fused(states, tring, 0.5, u=ahead_u(rng, n, K, B_local))
        prios = metrics.priorities.numpy()
        post = tring.column("mass")
        idx = fused.body.sampled_indices().numpy()
        # JAX's sampler on each shard's pre-call ring, same folded rng.
        for s in range(n):
            local = jdp.DeviceReplayState(
                obs=jnp.zeros((C_local, *OBS), jnp.uint8),
                next_obs=jnp.zeros((C_local, *OBS), jnp.uint8),
                action=jnp.zeros((C_local,), jnp.int32), reward=jnp.zeros((C_local,)),
                discount=jnp.zeros((C_local,)),
                mass=jnp.asarray(pre_mass[s * C_local:(s + 1) * C_local]),
                cursor=jnp.int32(0), count=jnp.int32(C_local))
            b = jsample_many(local, jax.random.fold_in(rng, s), K, B_local, 0.5)
            np.testing.assert_array_equal(idx[:, s * B_local:(s + 1) * B_local],
                                          np.asarray(b.indices))
        expect = pre_mass.copy()
        for s in range(n):
            cols = slice(s * B_local, (s + 1) * B_local)
            for k in range(K):
                for j_local, p in zip(idx[k, cols], prios[k, cols]):
                    expect[s * C_local + int(j_local)] = np.power(max(float(p), 1e-12), pexp)
        np.testing.assert_allclose(post, expect, rtol=1e-6)
        touched = {s * C_local + int(j) for s in range(n)
                   for j in idx[:, s * B_local:(s + 1) * B_local].reshape(-1)}
        untouched = [g for g in range(n * C_local) if g not in touched]
        np.testing.assert_array_equal(post[untouched], pre_mass[untouched])


class TestAwkwardIngestMidScan:
    def test_odd_chunks_interleaved_with_trains_lose_nothing(self):
        """Chunks of sizes coprime to the shard count arrive BETWEEN fused
        calls; exact-row accounting holds across drains and a mid-stream
        restore, and matches JAX's learner fed the same way."""
        jfl, fl = _learners(512, 2)
        sizes = [37, 51, 64, 7, 129, 3, 40]
        totals = []
        for f, cls in ((jfl, JTransition), (fl, NStepTransition)):
            staged_total = 0
            for i, m in enumerate(sizes[:4]):
                f.add_chunk(np.ones(m, np.float32), np_chunk(m, seed=i, cls=cls))
                staged_total += m
            f.ingest_staged()
            f.train(beta=0.4)
            f.ingest_staged(drain=True)
            assert f.size + f.staged_rows == staged_total
            totals.append((f.size, f.staged_rows))
        assert totals[0] == totals[1]
        sd = fl.state_dict()
        _, fl2 = _learners(512, 2, seed=1)
        fl2.load_state_dict(sd)
        staged_total = sum(sizes[:4])
        assert fl2.size + fl2.staged_rows == staged_total
        for i, m in enumerate(sizes[4:]):
            fl2.add_chunk(np.ones(m, np.float32), np_chunk(m, seed=10 + i))
            staged_total += m
            fl2.train(beta=0.4)
            fl2.ingest_staged(drain=(i == 2))
        assert fl2.size + fl2.staged_rows == staged_total
        assert fl2.staged_rows < 4   # everything drainable drained
        assert torch.isfinite(fl2.train(beta=0.4).loss).all()


# -- the sharded dedup ring -----------------------------------------------------


def dchunk(M=8, src=1, seq=0, seed=0, carry=0, cls=DedupChunk):
    r = np.random.default_rng(seed)
    obs_ref = np.arange(M, dtype=np.int32)
    obs_ref[:carry] = -np.arange(1, carry + 1, dtype=np.int32)
    return cls(frames=r.integers(0, 255, (M + 1, *OBS), dtype=np.uint8), obs_ref=obs_ref,
               next_ref=np.arange(1, M + 1, dtype=np.int32),
               action=r.integers(0, 3, M).astype(np.int32),
               reward=r.normal(size=M).astype(np.float32),
               discount=np.full(M, 0.9, np.float32),
               source=src, chunk_seq=seq, prev_frames=M + 1)


def dedup_feed(learners, rounds, start=0):
    """Two sources, pinned to shards 0 and 1 round-robin, carries each round."""
    for k in range(start, start + rounds):
        for f in learners:
            for src in (1, 2):
                cls = JDedupChunk if isinstance(f, (JFusedDedup, JDedupStager)) else DedupChunk
                prio = (np.abs(np.random.default_rng(100 * k + src).normal(size=8)) + 0.1)
                f.add_chunk(prio.astype(np.float32),
                            dchunk(src=src, seq=k, seed=10 * k + src, carry=2 if k else 0,
                                   cls=cls))
            if hasattr(f, "ingest_staged"):
                f.ingest_staged(drain=True)


def test_sharded_dedup_stager_blocks_match_jax():
    """Sources pin to shards round-robin and resolve their carries per
    shard: [n, block] frame and transition blocks equal JAX's."""
    st, jst = DedupStager(2), JDedupStager(2)
    dedup_feed([st, jst], 4)
    assert st.shard_of == jst.shard_of == {1: 0, 2: 1}
    assert st.staged_rows == jst.staged_rows and st.dropped_carry == jst.dropped_carry == 0
    for b in (8, 4, 2, 1):
        while st.frame_blocks_available(b):
            np.testing.assert_array_equal(st.take_frame_block(b), jst.take_frame_block(b))
        while st.txn_blocks_available(b):
            got, want = st.take_txn_block(b), jst.take_txn_block(b)
            for f in want:
                np.testing.assert_array_equal(got[f], want[f], err_msg=f)
        assert jst.txn_blocks_available(b) == 0
    sd, jsd = st.state_dict(), jst.state_dict()
    assert set(sd) == set(jsd)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_sharded_dedup_chain_restores_across_packages(tmp_path, writer):
    """A 2-shard dedup ring's incremental chain (``utils/checkpoint_inc``:
    a base, then a delta of per-shard spans, staged rows included) written
    by either package restores in the other's 2-shard learner, exactly."""
    from ape_x_dqn_tpu.utils.checkpoint_inc import IncrementalCheckpointer as JCkpt
    from ape_x_dqn_tpu.utils.checkpoint_inc import load_incremental_replay as jload
    from ape_x_dqn_tpu_torch.utils.checkpoint_inc import (
        IncrementalCheckpointer,
        load_incremental_replay,
    )

    def port(seed=0):
        net = tdueling.DuelingMLP(3, OBS, hidden_sizes=(16,))
        opt = ttrain.make_optimizer("adam", learning_rate=1e-3)
        return FusedDedupLearner(net, opt, ttrain.init_train_state(net, opt, seed=seed,
                                                                   device="cpu"),
                                 OBS, capacity=64, batch_size=4, steps_per_call=2,
                                 ingest_block=8, target_sync_freq=4, mesh=cpu_mesh(2),
                                 device="cpu")

    def jax_learner():
        net = JDuelingMLP(num_actions=3, hidden_sizes=(16,))
        opt = jtrain.make_optimizer("adam", learning_rate=1e-3)
        st = jtrain.init_train_state(net, opt, jax.random.PRNGKey(0),
                                     jnp.zeros((1, *OBS), jnp.uint8))
        return JFusedDedup(net, opt, st, OBS, capacity=64, batch_size=4, steps_per_call=2,
                           ingest_block=8, target_sync_freq=4,
                           mesh=jmake_mesh(num_devices=2))

    src = port() if writer == "port" else jax_learner()
    ckpt = (IncrementalCheckpointer if writer == "port" else JCkpt)(str(tmp_path), src,
                                                                    sync=True)
    dedup_feed([src], 3)
    ckpt.save(1)
    src.train(0.5)
    dedup_feed([src], 2, start=3)
    src.add_chunk(np.ones(8, np.float32), dchunk(src=1, seq=5, seed=99, carry=2,
                                                 cls=DedupChunk if writer == "port"
                                                 else JDedupChunk))   # stays staged
    ckpt.save(2)
    assert ckpt.stats()["deltas"] == 1
    dst = jax_learner() if writer == "port" else port(seed=5)
    assert (load_incremental_replay if writer == "jax" else jload)(str(tmp_path), dst) == 2
    want, got = src.state_dict(), dst.state_dict()
    assert set(want) == set(got) and int(want["stage_n_shards"]) == 2
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)
    assert dst.staged_rows == src.staged_rows > 0
