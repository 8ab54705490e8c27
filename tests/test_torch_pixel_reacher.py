"""Port parity: PixelReacher (the rainbow preset's ``dmc_pixels`` env) steps
like the JAX env.

Same fixed random action sequence, and the port's env is handed the very
reset draws the JAX env takes from its keys (tests/torch_parity.py).
Tolerances: the physics (theta, theta_dot) and the target agree to f32
rtol 1e-6 / atol 1e-6: XLA's CPU backend contracts a*b + c into fused
multiply-adds and evaluates sin/cos with its own polynomials, so single
values differ by an ulp from torch's plain operations (as in CartPole).
Rewards, episode flags and step counts are exact. Frames are equal but at
pixels whose distance test lies within float rounding of its threshold
(at most 1e-3 px^2 from it, in float64 from the JAX state); at most one
such pixel per thousand frames' pixels.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dist_dqn_tpu.envs import make_jax_env
from dist_dqn_tpu.envs.pixel_reacher import _render as jax_render
from dist_dqn_tpu_torch.envs import make_env
from dist_dqn_tpu_torch.envs.pixel_reacher import _render as torch_render
from torch_parity import RESET_DRAWS, STEP_DRAWS

_THRESHOLD_SLACK = 1e-3     # px^2
_MAX_BOUNDARY_SHARE = 1e-3


def _margins(theta, target):
    """[B, 84, 84] float64 distance, per pixel, of each of the frame's
    threshold tests from its threshold (the smallest over the tests)."""
    theta = np.asarray(theta, np.float64)
    target = np.asarray(target, np.float64)
    r = np.arange(84.0)[None, :, None]
    c = np.arange(84.0)[None, None, :]
    a1, a2 = theta[:, 0], theta[:, 0] + theta[:, 1]
    anchor = np.full((theta.shape[0], 2), 42.0)
    elbow = anchor + np.stack([18.0 * np.cos(a1), 18.0 * np.sin(a1)], -1)
    tip = elbow + np.stack([14.0 * np.cos(a2), 14.0 * np.sin(a2)], -1)

    def segment(a, b):
        ab = b - a
        denom = np.maximum((ab * ab).sum(-1), 1e-6)[:, None, None]
        t = ((c - a[:, 0, None, None]) * ab[:, 0, None, None]
             + (r - a[:, 1, None, None]) * ab[:, 1, None, None]) / denom
        t = np.clip(t, 0.0, 1.0)
        dx = c - (a[:, 0, None, None] + t * ab[:, 0, None, None])
        dy = r - (a[:, 1, None, None] + t * ab[:, 1, None, None])
        return np.abs(dx * dx + dy * dy - 2.25)

    def d2(p):
        return (c - p[:, 0, None, None]) ** 2 + (r - p[:, 1, None, None]) ** 2

    dt = d2(target)
    return np.minimum.reduce([segment(anchor, elbow), segment(elbow, tip),
                              np.abs(dt - 25.0), np.abs(dt - 9.0),
                              np.abs(d2(tip) - 4.0)])


def _check_frames(got, want, theta, target):
    """Equal but within rounding of a threshold; returns the count of
    differing pixels."""
    diff = got != want
    if not diff.any():
        return 0
    margins = _margins(theta, target)
    assert margins[diff].max() <= _THRESHOLD_SLACK, margins[diff].max()
    return int(diff.sum())


def test_pixel_reacher_render_matches():
    rng = np.random.default_rng(0)
    n = 64
    theta = rng.uniform(-np.pi, np.pi, (n, 2)).astype(np.float32)
    dist = rng.uniform(8, 29, n)
    ang = rng.uniform(0, 2 * np.pi, n)
    target = np.stack([42 + dist * np.cos(ang), 42 + dist * np.sin(ang)],
                      -1).astype(np.float32)
    target[:2] = [[42.0, 42.0], [10.0, 42.0]]      # pixel-centred targets
    want = np.asarray(jax.vmap(jax_render)(jnp.asarray(theta),
                                           jnp.asarray(target)))
    got = torch_render(torch.from_numpy(theta),
                       torch.from_numpy(target)).numpy()
    assert got.dtype == np.uint8 and got.shape == (n, 84, 84)
    assert (got > 0).sum(axis=(1, 2)).min() > 20     # arm + target drawn
    boundary = _check_frames(got, want, theta, target)
    assert boundary <= _MAX_BOUNDARY_SHARE * got.size


def _theta_after(state, actions):
    """The joint angles a step reaches from ``state`` (float64)."""
    torque = np.array([[i - 1, j - 1] for i in range(3) for j in range(3)],
                      np.float64)[actions]
    theta_dot = np.clip(np.asarray(state.theta_dot, np.float64) * 0.88
                        + torque * 0.5, -6.0, 6.0)
    return np.asarray(state.theta, np.float64) + theta_dot * 0.25


@pytest.mark.parametrize("max_steps,shaping", [(40, 0.0), (25, 0.5)])
def test_pixel_reacher_trajectory_matches(max_steps, shaping):
    """120 steps of 8 lanes, with truncation resets every ``max_steps``."""
    B, steps = 8, 120
    jenv = make_jax_env("dmc_pixels", max_steps=max_steps, shaping=shaping)
    tenv = make_env("dmc_pixels", device="cpu", max_steps=max_steps,
                    shaping=shaping)
    key = jax.random.PRNGKey(7)
    jstate, jobs = jax.jit(jenv.v_reset, static_argnums=1)(key, B)
    tstate, tobs = tenv.v_reset(B, draws=RESET_DRAWS["dmc_pixels"](key, B))
    boundary = _check_frames(tobs.numpy()[..., -1], np.asarray(jobs)[..., -1],
                             jstate.theta, jstate.target)
    actions = np.random.default_rng(1).integers(
        0, 9, (steps, B)).astype(np.int32)
    v_step = jax.jit(jenv.v_step)
    dones = 0
    for k in range(steps):
        draws = STEP_DRAWS["dmc_pixels"](jstate)
        prev = jstate
        jstate, jout = v_step(jstate, jnp.asarray(actions[k]))
        tstate, tout = tenv.v_step(tstate, torch.from_numpy(actions[k]),
                                   draws=draws)
        msg = f"step {k}"
        for field in ("terminated", "truncated"):
            np.testing.assert_array_equal(getattr(tout, field).numpy(),
                                          np.asarray(getattr(jout, field)),
                                          err_msg=f"{msg} {field}")
        tol = 1e-6 if shaping else 0.0
        np.testing.assert_allclose(tout.reward.numpy(),
                                   np.asarray(jout.reward), rtol=tol,
                                   atol=tol, err_msg=msg)
        for field in ("theta", "theta_dot", "target"):
            np.testing.assert_allclose(
                getattr(tstate, field).numpy(),
                np.asarray(getattr(jstate, field)), rtol=1e-6, atol=1e-6,
                err_msg=f"{msg} {field}")
        np.testing.assert_array_equal(tstate.t.numpy(), np.asarray(jstate.t))
        # The newest frame of next_obs is drawn at the stepped angles and
        # the old target; a reset lane's obs at its reset state.
        j_next, t_next = np.asarray(jout.next_obs), tout.next_obs.numpy()
        boundary += _check_frames(t_next[..., -1], j_next[..., -1],
                                  _theta_after(prev, actions[k]),
                                  prev.target)
        done = np.asarray(jout.truncated)
        j_obs, t_obs = np.asarray(jout.obs), tout.obs.numpy()
        boundary += _check_frames(t_obs[done][..., -1], j_obs[done][..., -1],
                                  np.asarray(jstate.theta)[done],
                                  np.asarray(jstate.target)[done])
        # Older frames are copies of newest frames checked before.
        stacked = int((t_next != j_next).sum() + (t_obs != j_obs).sum())
        assert stacked <= 8 * boundary, (k, stacked, boundary)
        dones += int(done.sum())
    assert dones == B * (steps // max_steps)
    assert boundary <= _MAX_BOUNDARY_SHARE * B * 84 * 84 * steps
