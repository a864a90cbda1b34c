"""The twin of ``tests/test_envs.py`` for the port's env copies
(``envs/core.py``, ``envs/vector.py``, the wrappers of ``envs/atari.py``).

Every test runs on both packages (the fixture ``m``): the JAX package's assertions
hold for the port's envs unchanged.  The wrapper cases that the step-for-
step parity of ``tests/test_torch_atari_envs.py`` repeats are kept here as
cases of the same parametrised tests.
"""

from __future__ import annotations

import importlib

import numpy as np
import pytest


@pytest.fixture(params=["ape_x_dqn_tpu", "ape_x_dqn_tpu_torch"])
def m(request):
    return importlib.import_module(f"{request.param}.envs")


class TestChainMDP:
    def test_optimal_rollout(self, m):
        env = m.ChainMDP(n_states=5)
        obs = env.reset()
        assert obs.argmax() == 0
        total, done = 0.0, False
        for _ in range(4):
            obs, r, done, trunc = env.step(1)
            total += r
        assert done and total == 1.0 and obs.argmax() == 4

    def test_left_clamps_and_truncates(self, m):
        env = m.ChainMDP(n_states=5, time_limit=3)
        env.reset()
        for _ in range(3):
            obs, r, term, trunc = env.step(0)
        assert trunc and not term and obs.argmax() == 0


class TestCatch:
    def test_catch_and_miss(self, m):
        env = m.CatchEnv(rows=5, cols=3, seed=0)
        env.reset(seed=1)
        ball_col = int(np.argwhere(env._obs()[0, :, 0])[0][0])
        done, reward = False, 0.0
        while not done:
            a = 1 + np.sign(ball_col - env._paddle)
            _, reward, done, _ = env.step(int(a))
        assert reward == 1.0

    def test_obs_has_two_pixels(self, m):
        obs = m.CatchEnv().reset(seed=0)
        assert (obs > 0).sum() in (1, 2)

    def test_same_seed_same_frames_in_both_packages(self):
        envs = [importlib.import_module(f"{p}.envs").CatchEnv(seed=4)
                for p in ("ape_x_dqn_tpu", "ape_x_dqn_tpu_torch")]
        np.testing.assert_array_equal(envs[0].reset(seed=2), envs[1].reset(seed=2))
        for a in np.random.default_rng(0).integers(0, 3, 40):
            j, t = (e.step(int(a)) for e in envs)
            np.testing.assert_array_equal(t.obs, j.obs)
            assert (t.reward, t.terminated, t.truncated) == (j.reward, j.terminated, j.truncated)
            if t.terminated:
                np.testing.assert_array_equal(envs[0].reset(), envs[1].reset())


class FakePixelEnv:
    """Deterministic raw RGB env for wrapper tests (test_envs.py's)."""

    observation_shape = (10, 8, 3)
    num_actions = 2

    def __init__(self, step_result):
        self.t = 0
        self._sr = step_result

    def reset(self, seed=None):
        self.t = 0
        return np.full(self.observation_shape, 10, np.uint8)

    def step(self, action):
        self.t += 1
        obs = np.full(self.observation_shape, 10 * self.t % 250, np.uint8)
        return self._sr(obs, 1.0, self.t >= 6, False)


class TestWrappers:
    @pytest.mark.parametrize("hw", [(4, 4), (5, 4), (3, 2)])
    def test_obs_preprocess_resizes_and_grays(self, m, hw):
        env = m.ObsPreprocess(FakePixelEnv(m.StepResult), height=hw[0], width=hw[1])
        obs = env.reset()
        assert obs.shape == (*hw, 1) and obs.dtype == np.uint8
        assert np.all(obs == 10)   # a constant frame stays constant

    def test_frame_skip_accumulates_reward(self, m):
        env = m.FrameSkip(FakePixelEnv(m.StepResult), skip=4)
        env.reset()
        assert env.step(0).reward == 4.0

    def test_frame_skip_stops_at_terminal(self, m):
        env = m.FrameSkip(FakePixelEnv(m.StepResult), skip=4)
        env.reset()
        env.step(0)
        r = env.step(0)
        assert r.terminated and r.reward == 2.0

    def test_frame_skip_rejects_zero(self, m):
        with pytest.raises(ValueError):
            m.FrameSkip(FakePixelEnv(m.StepResult), skip=0)

    def test_frame_stack(self, m):
        env = m.FrameStack(m.ObsPreprocess(FakePixelEnv(m.StepResult), 4, 4), k=3)
        obs = env.reset()
        assert obs.shape == (4, 4, 3)
        r = env.step(0)
        assert r.obs.shape == (4, 4, 3)
        r = env.step(0)   # frames 10 (reset), 10 (t=1), 20 (t=2): newest last
        assert list(r.obs[0, 0]) == [10, 10, 20]

    @pytest.mark.parametrize("reward,want", [(7.5, 1.0), (-3.0, -1.0), (0.25, 0.25)])
    def test_reward_clip(self, m, reward, want):
        class Big(FakePixelEnv):
            def step(self, action):
                return super().step(action)._replace(reward=reward)

        env = m.RewardClip(Big(m.StepResult))
        env.reset()
        assert env.step(0).reward == want

    def test_episodic_life_is_a_no_op_without_lives(self, m):
        env = m.EpisodicLife(FakePixelEnv(m.StepResult))
        env.reset()
        flags = [env.step(0).terminated for _ in range(6)]
        assert flags == [False] * 5 + [True]


class TestVector:
    def test_lockstep_and_autoreset(self, m):
        envs = m.SyncVectorEnv([lambda: m.ChainMDP(4, time_limit=50)] * 3)
        obs = envs.reset(seed=0)
        assert obs.shape == (3, 4)
        for _ in range(3):
            vs = envs.step(np.ones(3, np.int64))
        assert vs.terminated.all()
        assert (vs.obs.argmax(-1) == 3).all()
        assert (vs.reset_obs.argmax(-1) == 0).all()
        assert np.allclose(vs.episode_return, 1.0)
        assert (vs.episode_length == 3).all()

    def test_episode_stats_nan_when_running(self, m):
        envs = m.SyncVectorEnv([lambda: m.ChainMDP(10)] * 2)
        envs.reset()
        vs = envs.step(np.ones(2, np.int64))
        assert np.isnan(vs.episode_return).all()

    def test_heterogeneous_rejected(self, m):
        with pytest.raises(ValueError):
            m.SyncVectorEnv([lambda: m.ChainMDP(4), lambda: m.ChainMDP(5)])

    def test_fake_atari_vector_matches_across_packages(self):
        mods = [importlib.import_module(f"{p}.envs") for p in
                ("ape_x_dqn_tpu", "ape_x_dqn_tpu_torch")]
        vecs = [x.SyncVectorEnv([lambda x=x: x.make_env("fake-atari")] * 2) for x in mods]
        np.testing.assert_array_equal(vecs[0].reset(seed=0), vecs[1].reset(seed=0))
        for a in np.random.default_rng(3).integers(0, 4, (30, 2)):
            j, t = (v.step(a) for v in vecs)
            for f in ("obs", "reward", "terminated", "truncated", "reset_obs"):
                np.testing.assert_array_equal(getattr(t, f), getattr(j, f), err_msg=f)


def test_make_env_specs(m):
    assert isinstance(m.make_env("chain:7"), m.ChainMDP)
    assert isinstance(m.make_env("catch"), m.CatchEnv)
    env = m.make_env("random:16x16x1")
    assert isinstance(env, m.RandomFrameEnv)
    assert env.observation_shape == (16, 16, 1)
    assert m.make_env("fake-atari").observation_shape == (84, 84, 1)


class TestGymnasiumAdapter:
    @pytest.fixture(autouse=True)
    def _need_gymnasium(self):
        pytest.importorskip("gymnasium")

    def test_cartpole_protocol_roundtrip(self, m):
        env = m.make_local_env("CartPole-v1")
        assert env.num_actions == 2 and env.observation_shape == (4,)
        assert env.reset(seed=0).shape == (4,)
        for _ in range(600):
            r = env.step(1)
            assert isinstance(r.reward, float) and isinstance(r.terminated, bool)
            if r.terminated or r.truncated:
                break
        else:
            pytest.fail("constant-action CartPole must terminate quickly")

    def test_cartpole_seeded_reset_reproducible(self, m):
        a = m.make_local_env("CartPole-v1").reset(seed=7)
        b = m.make_local_env("CartPole-v1").reset(seed=7)
        np.testing.assert_array_equal(a, b)

    def test_unwrapped_exposes_gym_env(self, m):
        assert hasattr(m.make_local_env("CartPole-v1").unwrapped, "action_space")


class TestQuantizeObs:
    def test_affine_map_and_clip(self, m):
        class FloatBoxEnv:
            observation_shape = (3,)
            num_actions = 2

            def reset(self, seed=None):
                return np.array([-1.0, 0.0, 99.0])

            def step(self, action):
                return m.StepResult(np.array([1.0, -5.0, 0.5]), 0.0, False, False)

        env = m.QuantizeObs(FloatBoxEnv(), low=[-1, -1, -1], high=[1, 1, 1])
        obs = env.reset()
        assert obs.dtype == np.uint8
        np.testing.assert_array_equal(obs, [0, 128, 255])
        np.testing.assert_array_equal(env.step(0).obs, [255, 0, 191])

    def test_infinite_bounds_clamped(self, m):
        pytest.importorskip("gymnasium")
        obs = m.make_gym_env("CartPole-v1", inf_bound=5.0).reset(seed=0)
        assert obs.dtype == np.uint8 and obs.shape == (4,)

    def test_requires_bounds_without_box_space(self, m):
        with pytest.raises(ValueError, match="low/high"):
            m.QuantizeObs(m.ChainMDP())

    def test_rejects_empty_box(self, m):
        with pytest.raises(ValueError, match="high > low"):
            m.QuantizeObs(m.ChainMDP(3), low=0.0, high=0.0)


class TestPixelUpscale:
    def test_upscale_and_pad_geometry(self, m):
        env = m.PixelUpscale(m.CatchEnv(seed=0), 84, 84)
        obs = env.reset(seed=0)
        assert obs.shape == (84, 84, 1) and obs.dtype == np.uint8
        assert (obs > 0).sum() == 2 * 8 * 16
        assert env.step(1).obs.shape == (84, 84, 1)
        assert env.num_actions == 3

    def test_target_smaller_than_source_rejected(self, m):
        with pytest.raises(ValueError):
            m.PixelUpscale(m.CatchEnv(), 8, 8)

    def test_factory_spec(self, m):
        assert m.make_env("catch:32").reset(seed=1).shape == (32, 32, 1)
