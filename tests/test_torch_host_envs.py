"""Port parity of the host envs the Ape-X actors step
(dist_dqn_tpu_torch/envs/gym_adapter.py, host_pong.py, host_breakout.py)
against the JAX package's copies: under the same seeds and actions the
trajectories are equal bit for bit (both are numpy). CartPole-v1 needs
gymnasium, which the card's machine does not have."""
import numpy as np
import pytest

from dist_dqn_tpu.envs import gym_adapter as jga
from dist_dqn_tpu_torch.envs import gym_adapter as tga


def _roll(make, name, lanes, steps, seed, num_actions, action_seed):
    env = make(name, lanes, seed=seed)
    rng = np.random.default_rng(action_seed)
    out = [env.reset()]
    for _ in range(steps):
        out.extend(env.step(rng.integers(0, num_actions, lanes)))
    return out


@pytest.mark.parametrize("name,actions,steps", [
    ("pong", 6, 400), ("breakout", 4, 400), ("synthstack", 4, 300)])
def test_host_env_trajectories_equal_jax(name, actions, steps):
    got = _roll(tga.make_host_env, name, 3, steps, 5, actions, 9)
    want = _roll(jga.make_host_env, name, 3, steps, 5, actions, 9)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    # The rollout saw episode ends, so the auto-reset path is covered.
    dones = [np.logical_or(te, tr) for te, tr in zip(got[4::5], got[5::5])]
    assert name == "pong" or any(d.any() for d in dones)


def test_host_envs_declare_what_jax_declares():
    for name in ("pong", "breakout", "synthstack"):
        t, j = tga.make_host_env(name, 2), jga.make_host_env(name, 2)
        assert t.num_actions == j.num_actions
        assert t.frame_stack == j.frame_stack
    for name in ("pong", "breakout", "ale:Pong", "dmc:cartpole:swingup",
                 "feeder:pixel", "CartPole-v1", "synthstack", "feeder:x"):
        assert tga.is_pixel_env(name) == jga.is_pixel_env(name)


class _FakeAtari:
    """A gymnasium-like env of RGB 210x160 frames with lives."""

    class _Space:
        n = 6

    action_space = _Space()

    def __init__(self, seed=0):
        self.rng = np.random.default_rng(seed)
        self.t = 0

    def reset(self, seed=None):
        if seed is not None:
            self.rng = np.random.default_rng(seed)
        self.t = 0
        return self._frame(), {"lives": 3}

    def _frame(self):
        return self.rng.integers(0, 256, (210, 160, 3)).astype(np.uint8)

    def step(self, action):
        self.t += 1
        lives = 3 - self.t // 7
        return (self._frame(), float(self.rng.normal() * 3),
                lives <= 0, False, {"lives": lives})


@pytest.mark.parametrize("episodic_life,clip", [(False, True), (True, False)])
def test_atari_preprocessing_equals_jax(episodic_life, clip):
    """Frame skip, max-pool, gray, the cached resize grid, stacking,
    reward clipping and episodic life, from the same raw frames."""
    t = tga.AtariPreprocessing(_FakeAtari(1), clip_rewards=clip,
                               episodic_life=episodic_life)
    j = jga.AtariPreprocessing(_FakeAtari(1), clip_rewards=clip,
                               episodic_life=episodic_life)
    assert t.frame_stack == j.frame_stack == 4
    np.testing.assert_array_equal(t.reset(seed=3), j.reset(seed=3))
    rng = np.random.default_rng(2)
    for _ in range(30):
        a = int(rng.integers(0, 6))
        got, want = t.step(a), j.step(a)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1:] == want[1:]
        if got[2] or got[3]:
            np.testing.assert_array_equal(t.reset(), j.reset())
    frame = np.random.default_rng(4).integers(0, 256, (210, 160),
                                              dtype=np.uint8)
    np.testing.assert_array_equal(tga._area_resize_84(frame),
                                  jga._area_resize_84(frame))


def test_ale_and_unported_host_envs_raise(monkeypatch):
    """The dmc: and feeder: names build the JAX package's envs (or, where
    GL is missing, raise its error), and ale: without ale-py or the fake
    still says it needs ale-py."""
    monkeypatch.delenv("DQN_FAKE_ALE", raising=False)
    for name in ("dmc:cartpole:swingup", "feeder:pixel"):
        try:
            want = jga.make_host_env(name, 1)
        except NotImplementedError as e:
            with pytest.raises(NotImplementedError) as got:
                tga.make_host_env(name, 1)
            assert str(got.value) == str(e)
            continue
        got = tga.make_host_env(name, 1)
        assert got.num_actions == want.num_actions
        assert got.reset().shape == want.reset().shape
    try:
        import ale_py  # noqa: F401
    except ImportError:
        with pytest.raises(NotImplementedError, match="needs ale-py"):
            tga.make_host_env("ale:Pong", 1)


def test_cartpole_v1_runs_through_gymnasium():
    pytest.importorskip("gymnasium")
    got = _roll(tga.make_host_env, "CartPole-v1", 3, 250, 0, 2, 1)
    want = _roll(jga.make_host_env, "CartPole-v1", 3, 250, 0, 2, 1)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert got[0].shape == (3, 4) and got[3].dtype == np.float32
