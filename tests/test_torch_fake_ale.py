"""The port's fake ALE (dist_dqn_tpu_torch/envs/fake_ale.py) against
dist_dqn_tpu/envs/fake_ale.py, mirroring tests/test_fake_ale.py: the raw
games' frames, rewards, lives and sticky actions, and the whole
``make_host_env("ale:<Game>")`` pipeline under ``DQN_FAKE_ALE=1``, equal to
JAX's exactly at the same seeds and actions."""
import os
import subprocess
import sys

import numpy as np
import pytest

from dist_dqn_tpu.envs import fake_ale as jfake
from dist_dqn_tpu.envs import gym_adapter as jga
from dist_dqn_tpu_torch.envs import fake_ale as tfake
from dist_dqn_tpu_torch.envs import gym_adapter as tga

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _actions(game, n, seed):
    """A policy that serves (FIRE) now and then and moves otherwise."""
    rng = np.random.default_rng(seed)
    k = 6 if game == "Pong" else 4
    return [1 if t % 40 == 0 else int(rng.integers(0, k)) for t in range(n)]


@pytest.mark.parametrize("sticky", [0.0, 0.25, 1.0])
@pytest.mark.parametrize("game", ["Pong", "Breakout", "Seaquest"])
def test_raw_games_step_like_jax(game, sticky):
    """Frames, rewards (raw, unclipped), flags, lives and the sticky rule,
    over whole episodes with resets; an unknown game plays Pong."""
    ours = tfake.FakeALEEnv(game, max_frames=3000,
                            repeat_action_probability=sticky)
    theirs = jfake.FakeALEEnv(game, max_frames=3000,
                              repeat_action_probability=sticky)
    assert type(ours).__name__ == type(theirs).__name__
    assert ours.action_space.n == theirs.action_space.n
    a, ia = ours.reset(seed=3)
    b, ib = theirs.reset(seed=3)
    np.testing.assert_array_equal(a, b)
    assert ia == ib
    rewards, lives = set(), set()
    for act in _actions(game, 6000, 5):
        got, want = ours.step(act), theirs.step(act)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1:] == want[1:]
        rewards.add(got[1])
        lives.add(got[4]["lives"])
        if got[2] or got[3]:
            np.testing.assert_array_equal(ours.reset()[0],
                                          theirs.reset()[0])
    if sticky < 1.0:         # p = 1 repeats the first NOOP for ever
        assert len(lives) > 1 if game == "Breakout" else len(rewards) > 1


def test_the_module_constants_equal_jax():
    for name in ("_H", "_W", "_WIN_SCORE", "_BK_LIVES", "_BK_ROW_COLOR"):
        assert getattr(tfake, name) == getattr(jfake, name)
    np.testing.assert_array_equal(tfake._ACTION_DY, jfake._ACTION_DY)
    np.testing.assert_array_equal(tfake._BK_ROW_REWARD,
                                  jfake._BK_ROW_REWARD)


@pytest.mark.parametrize("episodic,sticky,for_eval", [
    (False, "0", False), (True, "0.25", False), (True, "0.25", True)])
@pytest.mark.parametrize("game", ["Pong", "Breakout"])
def test_make_host_env_pipeline_like_jax(monkeypatch, game, episodic,
                                         sticky, for_eval):
    """``DQN_FAKE_ALE=1`` routes ale: names to the fake in both packages:
    frame skip, max-pool, gray, 84x84 resize, 4-stack, reward clipping and
    episodic life (training envs only) give the same observations,
    rewards and flags on 3 lanes."""
    monkeypatch.setenv("DQN_FAKE_ALE", "1")
    monkeypatch.setenv("DQN_ALE_STICKY", sticky)
    if episodic:
        monkeypatch.setenv("DQN_ALE_EPISODIC_LIFE", "1")
    else:
        monkeypatch.delenv("DQN_ALE_EPISODIC_LIFE", raising=False)
    ours = tga.make_host_env(f"ale:{game}", 3, seed=5, for_eval=for_eval)
    theirs = jga.make_host_env(f"ale:{game}", 3, seed=5, for_eval=for_eval)
    assert tga.is_pixel_env(f"ale:{game}")
    assert ours.num_actions == theirs.num_actions
    assert ours.envs[0].episodic_life == theirs.envs[0].episodic_life
    np.testing.assert_array_equal(ours.reset(), theirs.reset())
    rng = np.random.default_rng(1)
    for _ in range(300):
        act = rng.integers(0, ours.num_actions, 3)
        for got, want in zip(ours.step(act), theirs.step(act)):
            np.testing.assert_array_equal(got, want)


def test_without_the_fake_ale_names_need_ale_py(monkeypatch):
    monkeypatch.delenv("DQN_FAKE_ALE", raising=False)
    tga.set_ale_factory(None)
    try:
        import ale_py  # noqa: F401
    except ImportError:
        with pytest.raises(NotImplementedError, match="ale-py"):
            tga.make_host_env("ale:Pong", 1)


def test_the_fake_route_imports_no_gymnasium():
    """The card's machine has no gymnasium: the fake's route must not
    import it."""
    code = ("import sys; sys.modules['gymnasium'] = None\n"
            "from dist_dqn_tpu_torch.envs.gym_adapter import make_host_env\n"
            "env = make_host_env('ale:Breakout', 2)\n"
            "assert env.reset().shape == (2, 84, 84, 4)\n"
            "assert 'dist_dqn_tpu' not in sys.modules\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env={**os.environ, "DQN_FAKE_ALE": "1"},
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
