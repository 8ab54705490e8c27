"""Port parity: the batched torch envs step exactly like the JAX envs.

Same fixed action sequences, and the port's envs are handed the very
serve / reset draws the JAX envs take from their keys (tests/torch_parity.py),
so observations, rewards, episode flags and states match exactly (the
CartPole physics floats to an ulp, see its test).
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from dist_dqn_tpu.envs import make_jax_env
from dist_dqn_tpu.envs.pixel_pong import _render as jax_render
from dist_dqn_tpu_torch.envs import make_env
from dist_dqn_tpu_torch.envs.pixel_pong import _render as torch_render
from torch_parity import RESET_DRAWS, STEP_DRAWS


def test_pixel_pong_render_exact():
    rng = np.random.default_rng(0)
    n = 32
    ball = np.stack([rng.uniform(0, 84, n), rng.uniform(0, 84, n),
                     rng.uniform(-2, 2, n), rng.uniform(-2, 2, n)],
                    axis=1).astype(np.float32)
    ball[:4, :2] = [[0.0, 0.0], [83.0, 83.0], [42.0, 1.0], [78.5, 40.0]]
    pad = rng.uniform(4, 79, n).astype(np.float32)
    opp = rng.uniform(4, 79, n).astype(np.float32)
    want = np.asarray(jax.vmap(jax_render)(jnp.asarray(ball),
                                           jnp.asarray(pad),
                                           jnp.asarray(opp)))
    got = torch_render(torch.from_numpy(ball), torch.from_numpy(pad),
                       torch.from_numpy(opp)).numpy()
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


def _state_fields(state):
    return {k: np.asarray(v) for k, v in state._asdict().items()
            if k != "rng"}


def _run(name, max_steps, steps, teacher_forced):
    """Reset + ``steps`` auto-resetting steps of both envs under one fixed
    random action sequence, handing the port the JAX env's draws. Yields
    (step, jax out, jax state, port out, port state)."""
    B = 8
    jenv = make_jax_env(name, max_steps=max_steps)
    tenv = make_env(name, device="cpu", max_steps=max_steps)
    key = jax.random.PRNGKey(3)
    jstate, jobs = jax.jit(jenv.v_reset, static_argnums=1)(key, B)
    tstate, tobs = tenv.v_reset(B, draws=RESET_DRAWS[name](key, B))
    np.testing.assert_array_equal(tobs.numpy(), np.asarray(jobs))
    actions = np.random.default_rng(1).integers(
        0, jenv.num_actions, (steps, B)).astype(np.int32)
    v_step = jax.jit(jenv.v_step)
    for k in range(steps):
        if teacher_forced:
            tstate = type(tstate)(**{f: torch.from_numpy(np.array(v))
                                     for f, v in _state_fields(jstate).items()})
        draws = STEP_DRAWS[name](jstate)
        jstate, jout = v_step(jstate, jnp.asarray(actions[k]))
        tstate, tout = tenv.v_step(tstate, torch.from_numpy(actions[k]),
                                   draws=draws)
        yield k, jout, jstate, tout, tstate


_FIELDS = ("obs", "next_obs", "reward", "terminated", "truncated")


def test_pixel_pong_trajectory_exact():
    """320 steps with points, serves and truncation resets (max_steps
    150): every output and state field equal, bit for bit."""
    dones = points = 0
    for k, jout, jstate, tout, tstate in _run("pixel_pong", 150, 320,
                                              teacher_forced=False):
        for field in _FIELDS:
            np.testing.assert_array_equal(
                getattr(tout, field).numpy(), np.asarray(getattr(jout, field)),
                err_msg=f"step {k} field {field}")
        want = _state_fields(jstate)
        for field, value in _state_fields(tstate).items():
            np.testing.assert_array_equal(value, want[field],
                                          err_msg=f"step {k} state {field}")
        dones += int(np.asarray(jout.terminated | jout.truncated).sum())
        points += int(np.abs(np.asarray(jout.reward)).sum())
    assert dones > 0 and points > 0


def test_cartpole_step_matches():
    """Each of 120 steps from the JAX env's own state (terminations and
    auto-resets included). Episode flags, rewards, resets and step counts
    are exact. The physics floats agree to rtol 1e-6 / atol 1e-7, not bit
    for bit: XLA's CPU backend contracts a*b + c into fused multiply-adds
    and evaluates sin/cos with its own polynomials, so single steps differ
    by an ulp (measured max 3e-8) from torch's plain IEEE operations."""
    dones = 0
    for k, jout, jstate, tout, tstate in _run("cartpole", 500, 120,
                                              teacher_forced=True):
        msg = f"step {k}"
        for field in ("reward", "terminated", "truncated"):
            np.testing.assert_array_equal(
                getattr(tout, field).numpy(), np.asarray(getattr(jout, field)),
                err_msg=f"{msg} {field}")
        for field in ("obs", "next_obs"):
            np.testing.assert_allclose(
                getattr(tout, field).numpy(), np.asarray(getattr(jout, field)),
                rtol=1e-6, atol=1e-7, err_msg=f"{msg} {field}")
        np.testing.assert_allclose(tstate.phys.numpy(),
                                   np.asarray(jstate.phys), rtol=1e-6,
                                   atol=1e-7, err_msg=msg)
        np.testing.assert_array_equal(tstate.t.numpy(), np.asarray(jstate.t))
        done = np.asarray(jout.terminated | jout.truncated)
        # Reset lanes take the injected draws exactly.
        np.testing.assert_array_equal(tout.obs.numpy()[done],
                                      np.asarray(jout.obs)[done])
        dones += int(done.sum())
    assert dones > 0
