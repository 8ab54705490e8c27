"""The port's DM-Control pixel adapter (dist_dqn_tpu_torch/envs/
dmc_adapter.py and the ``dmc:`` route of envs/gym_adapter.py) against
dist_dqn_tpu/envs/dmc_adapter.py: where MuJoCo renders here the frames,
rewards and flags equal JAX's exactly at one seed and action stream;
where it does not, both raise the same ``NotImplementedError``. The name
format error and the 3^dim torque grid are held against JAX either way."""
import numpy as np
import pytest

pytest.importorskip("dm_control")

from dist_dqn_tpu.envs import gym_adapter as jga  # noqa: E402
from dist_dqn_tpu_torch.envs import gym_adapter as tga  # noqa: E402


def _build(module, name, n):
    """(env, None) or (None, the NotImplementedError text)."""
    try:
        return module.make_host_env(name, n, seed=3), None
    except NotImplementedError as e:
        return None, str(e)


@pytest.mark.parametrize("name", ["dmc:cartpole:swingup",
                                  "dmc:reacher:easy"])
def test_frames_equal_jax_or_the_same_gl_error(name):
    ours, our_err = _build(tga, name, 2)
    theirs, their_err = _build(jga, name, 2)
    assert our_err == their_err
    if ours is None:
        assert "MUJOCO_GL" in our_err
        return
    assert ours.num_actions == theirs.num_actions
    assert tga.is_pixel_env(name)
    np.testing.assert_array_equal(ours.reset(), theirs.reset())
    rng = np.random.default_rng(0)
    for _ in range(12):
        act = rng.integers(0, ours.num_actions, 2)
        for got, want in zip(ours.step(act), theirs.step(act)):
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", ["dmc:cartpole", "dmc::swingup",
                                  "dmc:cartpole:"])
def test_the_name_format_error_equals_jax(name):
    with pytest.raises(ValueError) as want:
        jga.make_host_env(name, 1)
    with pytest.raises(ValueError, match="dmc:<domain>:<task>") as got:
        tga.make_host_env(name, 1)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("domain,task,n", [("cartpole", "swingup", 3),
                                           ("reacher", "easy", 9)])
def test_the_torque_grid_equals_jax(domain, task, n):
    from dist_dqn_tpu.envs.dmc_adapter import DMCPixelEnv as JEnv
    from dist_dqn_tpu_torch.envs.dmc_adapter import DMCPixelEnv as TEnv
    try:
        theirs = JEnv(domain, task)
    except NotImplementedError as e:
        with pytest.raises(NotImplementedError) as got:
            TEnv(domain, task)
        assert str(got.value) == str(e)
        return
    ours = TEnv(domain, task)
    assert ours.num_actions == theirs.num_actions == n
    np.testing.assert_array_equal(ours._actions, theirs._actions)
    assert ours._actions.dtype == np.float32
