"""Port parity: PixelBreakout and PixelCatch step exactly like the JAX envs.

Same fixed random action sequences, and the port's envs are handed the
very serve / reset draws the JAX envs take from their keys
(tests/torch_parity.py), so observations, rewards, episode flags and every
state field match bit for bit (tolerance: none, uint8 frames and f32
physics alike).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dist_dqn_tpu.envs.pixel_breakout import _render as jax_breakout_render
from dist_dqn_tpu.envs.pixel_catch import _render as jax_catch_render
from dist_dqn_tpu_torch.envs.pixel_breakout import \
    _render as torch_breakout_render
from dist_dqn_tpu_torch.envs.pixel_catch import _render as torch_catch_render
from test_torch_envs import _FIELDS, _run, _state_fields


def test_pixel_breakout_render_exact():
    rng = np.random.default_rng(0)
    n = 32
    ball = np.stack([rng.uniform(0, 84, n), rng.uniform(0, 84, n),
                     rng.uniform(-2, 2, n), rng.uniform(-2, 2, n)],
                    axis=1).astype(np.float32)
    # Edges of the wall, the paddle row and the frame.
    ball[:5, :2] = [[0.0, 0.0], [83.0, 83.0], [42.0, 18.0], [83.5, 35.9],
                    [41.0, 78.0]]
    pad = rng.uniform(4, 79, n).astype(np.float32)
    bricks = (rng.uniform(size=(n, 6, 12)) < 0.6).astype(np.float32)
    in_play = rng.uniform(size=n) < 0.7
    want = np.asarray(jax.vmap(jax_breakout_render)(
        jnp.asarray(ball), jnp.asarray(pad), jnp.asarray(bricks),
        jnp.asarray(in_play)))
    got = torch_breakout_render(
        torch.from_numpy(ball), torch.from_numpy(pad),
        torch.from_numpy(bricks), torch.from_numpy(in_play)).numpy()
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


def test_pixel_catch_render_exact():
    rng = np.random.default_rng(1)
    n = 32
    ball_x = rng.uniform(0, 84, n).astype(np.float32)
    ball_y = rng.uniform(0, 84, n).astype(np.float32)
    ball_x[:3], ball_y[:3] = [0.0, 82.5, 41.5], [4.0, 80.0, 1.5]
    pad = rng.uniform(5, 78, n).astype(np.float32)
    want = np.asarray(jax.vmap(jax_catch_render)(
        jnp.asarray(ball_x), jnp.asarray(ball_y), jnp.asarray(pad)))
    got = torch_catch_render(torch.from_numpy(ball_x),
                             torch.from_numpy(ball_y),
                             torch.from_numpy(pad)).numpy()
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name,max_steps,steps", [
    ("pixel_breakout", 100, 240),   # serves, bricks, lost balls, truncation
    ("pixel_catch", 200, 120),      # ~26-step episodes: many auto-resets
])
def test_pixel_env_trajectory_exact(name, max_steps, steps):
    """Every output and state field equal, bit for bit, step by step."""
    dones = rewards = 0
    for k, jout, jstate, tout, tstate in _run(name, max_steps, steps,
                                              teacher_forced=False):
        for field in _FIELDS:
            np.testing.assert_array_equal(
                getattr(tout, field).numpy(), np.asarray(getattr(jout, field)),
                err_msg=f"step {k} field {field}")
        want = _state_fields(jstate)
        got = _state_fields(tstate)
        assert set(got) == set(want)
        for field, value in got.items():
            np.testing.assert_array_equal(value, want[field],
                                          err_msg=f"step {k} state {field}")
        dones += int(np.asarray(jout.terminated | jout.truncated).sum())
        rewards += int(np.abs(np.asarray(jout.reward)).sum())
    assert dones > 0 and rewards > 0


def test_pixel_breakout_loses_lives_and_serves_on_fire():
    """A lane that only FIREs serves once and then loses every life; a
    lane that never FIREs never moves the ball."""
    from dist_dqn_tpu_torch.envs import make_env

    env = make_env("pixel_breakout", device="cpu", max_steps=2000)
    gen = torch.Generator().manual_seed(0)
    state, _ = env.v_reset(2, gen)
    actions = torch.tensor([1, 0])
    lives_lost = 0
    for _ in range(400):
        prev_lives = state.lives.clone()
        state, out = env.v_step(state, actions, gen)
        lives_lost += int((prev_lives - state.lives).clamp(min=0)[0])
        assert not bool(state.in_play[1])
        if bool(out.terminated[0]):
            break
    assert bool(out.terminated[0]) and lives_lost == 4
    assert not bool(out.terminated[1])
