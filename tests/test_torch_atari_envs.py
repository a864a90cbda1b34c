"""The port's Atari wrapper stack and fake emulator against the JAX package's.

* Every wrapper, and the full ``wrap_dqn`` stack in several settings, over
  the same raw frame sequences (``FakeAtariEnv`` of each package, and a
  seeded numpy pixel env): the same actions give byte-equal observations,
  equal rewards, terminated and truncated flags and lives at every step,
  through ``EpisodicLife``'s no-op resets, the one that hits game over
  included.  Tolerance: exact.
* ``ObsPreprocess`` (numpy in the port, cv2 in the JAX package) on the
  committed golden file, on 64 random RGB frames and on fake-atari frames:
  byte-equal (max |Δ| = 0, share of pixels that differ 0).
* ``make_env`` specs in both packages, and ``gym:CartPole-v1`` through both
  (``QuantizeObs`` bytes equal).
"""

from __future__ import annotations

import importlib
import os

import numpy as np
import pytest

from _torch_harness import port_deadline  # noqa: F401 — the per-test deadline, autouse

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "fixtures", "atari_golden.npz")
PKGS = ("ape_x_dqn_tpu", "ape_x_dqn_tpu_torch")


def envs(pkg: str):
    return importlib.import_module(f"{pkg}.envs")


class PixelEnv:
    """A seeded raw-frame env: random 210×160×3 frames, rewards in ±5, a
    lives counter lost every ``life_every`` steps (``unwrapped.ale``) and a
    time limit: the same stream for both packages' wrappers."""

    num_actions = 4

    def __init__(self, step_result, seed=0, lives=3, life_every=7, limit=200,
                 shape=(210, 160, 3)):
        self._sr, self._seed = step_result, seed
        self.observation_shape = shape
        self._lives0, self._life_every, self._limit = lives, life_every, limit
        self.ale = self
        self.unwrapped = self

    def lives(self):
        return self._lives

    def _frame(self):
        return self._rng.integers(0, 256, self.observation_shape, dtype=np.uint8)

    def reset(self, seed=None):
        self._rng = np.random.default_rng(self._seed)
        self._seed += 1
        self._t, self._lives = 0, self._lives0
        return self._frame()

    def step(self, action):
        self._t += 1
        reward = float(self._rng.integers(-5, 6)) * (action + 1)
        if self._t % self._life_every == 0:
            self._lives -= 1
        return self._sr(self._frame(), reward, self._lives <= 0, self._t >= self._limit)


def _stack(pkg: str, kind: str):
    """(wrapped env, the raw env under it) of one package."""
    m = envs(pkg)
    if kind.startswith("pixel"):
        raw = PixelEnv(m.StepResult, seed=5)
    elif kind == "fake_game_over":
        raw = m.FakeAtariEnv(lives=2, steps_per_life=1)
    elif kind == "fake_short_lives":
        raw = m.FakeAtariEnv(lives=3, steps_per_life=5, reward_every=3)
    else:
        raw = m.FakeAtariEnv()
    build = {
        "fake_dqn": lambda e: m.wrap_dqn(e),
        "fake_dqn_stack4": lambda e: m.wrap_dqn(e, frame_stack=4),
        "fake_dqn_skip1_raw": lambda e: m.wrap_dqn(e, frame_skip=1, episodic_life=False,
                                                   clip_rewards=False),
        "fake_dqn_skip3_small": lambda e: m.wrap_dqn(e, frame_skip=3, height=42, width=42),
        "fake_game_over": lambda e: m.EpisodicLife(e),
        "fake_short_lives": lambda e: m.wrap_dqn(e, frame_skip=2, frame_stack=2),
        "episodic_life": lambda e: m.EpisodicLife(e),
        "frame_skip": lambda e: m.FrameSkip(e, 4),
        "obs_preprocess": lambda e: m.ObsPreprocess(e),
        "frame_stack": lambda e: m.FrameStack(m.ObsPreprocess(e), 4),
        "reward_clip": lambda e: m.RewardClip(e),
        "pixel_dqn": lambda e: m.wrap_dqn(e, frame_stack=4),
        "pixel_episodic_life": lambda e: m.EpisodicLife(e),
        "pixel_frame_skip": lambda e: m.FrameSkip(e, 3),
        "pixel_reward_clip": lambda e: m.RewardClip(e),
    }[kind]
    return build(raw), raw


def _roll(env, raw, actions):
    """Every observation of a fixed action sequence, resetting (as an actor
    does) whenever a step ends the learner's episode: (obs bytes, reward,
    terminated, truncated, lives, full resets) per step."""
    out = [("reset", env.reset().tobytes(), raw.ale.lives())]
    for a in actions:
        r = env.step(int(a))
        out.append((r.obs.tobytes(), r.reward, r.terminated, r.truncated, raw.ale.lives(),
                    getattr(raw, "full_resets", None)))
        if r.terminated or r.truncated:
            out.append(("reset", env.reset().tobytes(), raw.ale.lives()))
    return out


@pytest.mark.parametrize("kind", [
    "fake_dqn", "fake_dqn_stack4", "fake_dqn_skip1_raw", "fake_dqn_skip3_small",
    "fake_game_over", "fake_short_lives", "episodic_life", "frame_skip",
    "obs_preprocess", "frame_stack", "reward_clip", "pixel_dqn",
    "pixel_episodic_life", "pixel_frame_skip", "pixel_reward_clip",
])
def test_wrapper_stack_matches_jax_step_for_step(kind):
    actions = np.random.default_rng(1).integers(0, 4, 120)
    jenv, jraw = _stack(PKGS[0], kind)
    tenv, traw = _stack(PKGS[1], kind)
    want, got = _roll(jenv, jraw, actions), _roll(tenv, traw, actions)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g == w, f"step {i} differs"
    assert tenv.observation_shape == jenv.observation_shape
    assert tenv.num_actions == jenv.num_actions


def test_no_op_reset_hitting_game_over_resets_fully_in_both():
    """EpisodicLife's fall-through: the post-death no-op step loses the last
    life, so reset must be a real reset (corner pixel back to 0)."""
    for pkg in PKGS:
        m = envs(pkg)
        inner = m.FakeAtariEnv(lives=2, steps_per_life=1)
        env = m.EpisodicLife(inner)
        env.reset()
        assert env.step(0).terminated
        before = inner.full_resets
        obs = env.reset()
        assert inner.full_resets == before + 1 and obs[0, 0, 0] == 0


def _frames():
    rng = np.random.default_rng(0)
    random = [rng.integers(0, 256, (210, 160, 3), dtype=np.uint8) for _ in range(64)]
    fake = envs(PKGS[1]).FakeAtariEnv(flicker=True)
    fake.reset()
    game = [fake.step(0).obs for _ in range(24)]
    return random + game


class _OneFrame:
    observation_shape = (210, 160, 3)
    num_actions = 1

    def __init__(self, frame):
        self.frame = frame

    def reset(self, seed=None):
        return self.frame


def test_obs_preprocess_is_cv2_byte_for_byte():
    """64 random RGB frames and 24 fake-atari frames through the JAX
    package's cv2 preprocess and the port's numpy one.  Tolerance stated:
    max |Δ| = 0 and 0 of the pixels differ."""
    pytest.importorskip("cv2")
    jm, tm = envs(PKGS[0]), envs(PKGS[1])
    differ = total = 0
    worst = 0
    for f in _frames():
        want = jm.ObsPreprocess(_OneFrame(f)).reset()
        got = tm.ObsPreprocess(_OneFrame(f)).reset()
        assert got.shape == want.shape == (84, 84, 1) and got.dtype == np.uint8
        delta = np.abs(got.astype(np.int16) - want.astype(np.int16))
        worst = max(worst, int(delta.max()))
        differ += int((delta > 0).sum())
        total += delta.size
    assert worst == 0 and differ == 0, f"max |Δ| {worst}, {differ} / {total} pixels differ"


def test_obs_preprocess_matches_the_golden_file():
    """The committed golden outputs (made with cv2), byte for byte, with no
    cv2 in the port."""
    tm = envs(PKGS[1])
    with np.load(GOLDEN) as z:
        n = 0
        while f"in_{n}" in z.files:
            got = tm.ObsPreprocess(_OneFrame(z[f"in_{n}"])).reset()
            np.testing.assert_array_equal(got, z[f"out_{n}"])
            n += 1
    assert n >= 2


@pytest.mark.parametrize("shape,out", [
    ((210, 160), (84, 84)), ((168, 168), (84, 84)), ((10, 8), (4, 4)),
    ((252, 252), (84, 84)), ((100, 90), (84, 84)), ((210, 160), (42, 42)),
    ((168, 252), (84, 84)), ((40, 40), (10, 10)),
])
def test_area_resize_is_cv2_at_fractional_and_integer_scales(shape, out):
    """cv2's general tap path and its integer-scale block path (2×2 rounds
    half up there).  Tolerance: exact."""
    cv2 = pytest.importorskip("cv2")
    from ape_x_dqn_tpu_torch.envs.atari import resize_area, rgb_to_gray

    rng = np.random.default_rng(sum(shape))
    for _ in range(8):
        img = rng.integers(0, 256, shape, dtype=np.uint8)
        want = cv2.resize(img, (out[1], out[0]), interpolation=cv2.INTER_AREA)
        np.testing.assert_array_equal(resize_area(img, *out), want)
        rgb = rng.integers(0, 256, (*shape, 3), dtype=np.uint8)
        np.testing.assert_array_equal(rgb_to_gray(rgb), cv2.cvtColor(rgb, cv2.COLOR_RGB2GRAY))


def test_obs_preprocess_refuses_an_enlarging_resize():
    from ape_x_dqn_tpu_torch.envs.atari import resize_area

    with pytest.raises(ValueError, match="shrinks only"):
        resize_area(np.zeros((10, 10), np.uint8), 20, 20)


@pytest.mark.parametrize("spec,kwargs,shape", [
    ("fake-atari", {}, (84, 84, 1)),
    ("fake-atari", {"frame_stack": 4}, (84, 84, 4)),
    ("fake-atari", {"frame_skip": 1, "episodic_life": False, "clip_rewards": False},
     (84, 84, 1)),
    ("chain:7", {}, (7,)),
    ("catch:36", {}, (36, 36, 1)),
    ("random:16x16x1", {}, (16, 16, 1)),
])
def test_make_env_specs_in_both_packages(spec, kwargs, shape):
    jenv = envs(PKGS[0]).make_env(spec, seed=3, **kwargs)
    tenv = envs(PKGS[1]).make_env(spec, seed=3, **kwargs)
    assert tuple(tenv.observation_shape) == tuple(jenv.observation_shape) == shape
    assert tenv.num_actions == jenv.num_actions
    assert type(tenv).__name__ == type(jenv).__name__
    np.testing.assert_array_equal(tenv.reset(seed=3), jenv.reset(seed=3))


def test_unknown_atari_id_needs_gymnasium_in_both():
    """A real Atari id goes to gymnasium in both packages and fails there
    the same way (no ROM, or no gymnasium)."""
    errors = []
    for pkg in PKGS:
        with pytest.raises(Exception) as e:
            envs(pkg).make_env("SeaquestNoFrameskip-v4")
        errors.append(type(e.value))
    assert errors[0] is errors[1]


def test_gym_cartpole_through_both_quantizes_equal():
    pytest.importorskip("gymnasium")
    jenv = envs(PKGS[0]).make_env("gym:CartPole-v1")
    tenv = envs(PKGS[1]).make_env("gym:CartPole-v1")
    assert tenv.observation_shape == jenv.observation_shape == (4,)
    np.testing.assert_array_equal(tenv.reset(seed=7), jenv.reset(seed=7))
    for a in np.random.default_rng(2).integers(0, 2, 60):
        t, j = tenv.step(int(a)), jenv.step(int(a))
        assert t.obs.dtype == np.uint8
        np.testing.assert_array_equal(t.obs, j.obs)
        assert (t.reward, t.terminated, t.truncated) == (j.reward, j.terminated, j.truncated)
        if t.terminated or t.truncated:
            np.testing.assert_array_equal(tenv.reset(seed=9), jenv.reset(seed=9))
