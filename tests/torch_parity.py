"""Helpers of the port's parity tests (tests/test_torch_*.py).

The JAX envs draw from per-env threefry keys inside ``vmap``; the port's
envs take their draws as explicit tensors. These helpers replay the JAX
envs' key splits to compute the exact numbers a JAX step or reset
consumes, so both packages step in lockstep on the same trajectory.
"""
from __future__ import annotations

import json
import jax
import jax.numpy as jnp
import numpy as np
import torch

from dist_dqn_tpu_torch.envs.cartpole import CartPoleDraws
from dist_dqn_tpu_torch.envs.pixel_breakout import BreakoutDraws
from dist_dqn_tpu_torch.envs.pixel_catch import CatchDraws
from dist_dqn_tpu_torch.envs.pixel_pong import PongDraws
from dist_dqn_tpu_torch.envs.pixel_reacher import ReacherDraws


# The port's CPU tests run many small torch ops. With torch's default of
# one intra-op thread per core, test workers that share the cores spin
# against each other: on an 8-core host with the other cores busy, a
# Breakout CLI test ran 12 times slower on eight threads than on one. Every
# test worker imports this module while it collects the port's tests.
torch.set_num_threads(1)


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def _pong_reset_key(key):
    # PixelPong.reset: rng, k_serve, k_side = split(rng, 3)
    _, k_serve, k_side = jax.random.split(key, 3)
    return (jax.random.bernoulli(k_side),
            jax.random.uniform(k_serve, (), jnp.float32, -1.0, 1.0))


def _pong_step_key(key):
    # PixelPong.env_step: rng, k_serve = split(state.rng); then JaxEnv.step
    # resets from the advanced rng.
    rng, k_serve = jax.random.split(key)
    serve_vy = jax.random.uniform(k_serve, (), jnp.float32, -1.0, 1.0)
    side, reset_vy = _pong_reset_key(rng)
    return serve_vy, side, reset_vy


def pong_reset_draws(rng, num_envs: int) -> PongDraws:
    side, vy = jax.vmap(_pong_reset_key)(jax.random.split(rng, num_envs))
    return PongDraws(serve_vy=torch.zeros(num_envs), reset_side=_t(side),
                     reset_vy=_t(vy))


def pong_step_draws(jax_state) -> PongDraws:
    serve_vy, side, reset_vy = jax.vmap(_pong_step_key)(jax_state.rng)
    return PongDraws(serve_vy=_t(serve_vy), reset_side=_t(side),
                     reset_vy=_t(reset_vy))


def _cartpole_reset_key(key):
    # CartPole.reset: rng, sub = split(rng); phys ~ U(-0.05, 0.05)^4
    _, sub = jax.random.split(key)
    return jax.random.uniform(sub, (4,), jnp.float32, -0.05, 0.05)


def _cartpole_step_key(key):
    # CartPole.env_step: rng, _ = split(state.rng); reset from rng.
    rng, _ = jax.random.split(key)
    return _cartpole_reset_key(rng)


def cartpole_reset_draws(rng, num_envs: int) -> CartPoleDraws:
    return CartPoleDraws(reset_phys=_t(jax.vmap(_cartpole_reset_key)(
        jax.random.split(rng, num_envs))))


def cartpole_step_draws(jax_state) -> CartPoleDraws:
    return CartPoleDraws(reset_phys=_t(jax.vmap(_cartpole_step_key)(
        jax_state.rng)))


def breakout_reset_draws(rng, num_envs: int) -> BreakoutDraws:
    # PixelBreakout.reset draws nothing: the ball waits for FIRE.
    return BreakoutDraws(serve_vx=torch.zeros(num_envs))


def _breakout_step_key(key):
    # PixelBreakout.env_step: rng, k_serve = split(state.rng); the serve's
    # vx ~ U(-1.2, 1.2). The auto-reset that follows draws nothing.
    _, k_serve = jax.random.split(key)
    return jax.random.uniform(k_serve, (), jnp.float32, -1.2, 1.2)


def breakout_step_draws(jax_state) -> BreakoutDraws:
    return BreakoutDraws(serve_vx=_t(jax.vmap(_breakout_step_key)(
        jax_state.rng)))


def _catch_reset_key(key):
    # PixelCatch.reset: rng, k_ball, k_pad = split(rng, 3)
    _, k_ball, k_pad = jax.random.split(key, 3)
    return (jax.random.uniform(k_ball, (), jnp.float32, 4.0, 79.0),
            jax.random.uniform(k_pad, (), jnp.float32, 5.0, 78.0))


def catch_reset_draws(rng, num_envs: int) -> CatchDraws:
    ball_x, pad_x = jax.vmap(_catch_reset_key)(
        jax.random.split(rng, num_envs))
    return CatchDraws(reset_ball_x=_t(ball_x), reset_pad_x=_t(pad_x))


def catch_step_draws(jax_state) -> CatchDraws:
    # PixelCatch.env_step leaves state.rng as it is; JaxEnv.step resets
    # from that very key.
    ball_x, pad_x = jax.vmap(_catch_reset_key)(jax_state.rng)
    return CatchDraws(reset_ball_x=_t(ball_x), reset_pad_x=_t(pad_x))


def _reacher_reset_key(key):
    # PixelReacher.reset: rng, k_theta, k_target = split(rng, 3); theta ~
    # U(-pi, pi)^2; _sample_target: k_r, k_a = split(k_target), dist ~
    # U(8, 29), angle ~ U(0, 2 pi).
    _, k_theta, k_target = jax.random.split(key, 3)
    theta = jax.random.uniform(k_theta, (2,), jnp.float32, -jnp.pi, jnp.pi)
    k_r, k_a = jax.random.split(k_target)
    dist = jax.random.uniform(k_r, (), jnp.float32, 8.0, 29.0)
    ang = jax.random.uniform(k_a, (), jnp.float32, 0.0, 2.0 * jnp.pi)
    return theta, dist, ang


def reacher_reset_draws(rng, num_envs: int) -> ReacherDraws:
    theta, dist, ang = jax.vmap(_reacher_reset_key)(
        jax.random.split(rng, num_envs))
    return ReacherDraws(reset_theta=_t(theta), reset_target_dist=_t(dist),
                        reset_target_ang=_t(ang))


def reacher_step_draws(jax_state) -> ReacherDraws:
    # PixelReacher.env_step leaves state.rng as it is; JaxEnv.step resets
    # from that very key.
    theta, dist, ang = jax.vmap(_reacher_reset_key)(jax_state.rng)
    return ReacherDraws(reset_theta=_t(theta), reset_target_dist=_t(dist),
                        reset_target_ang=_t(ang))


RESET_DRAWS = {"pixel_pong": pong_reset_draws,
               "cartpole": cartpole_reset_draws,
               "pixel_breakout": breakout_reset_draws,
               "pixel_catch": catch_reset_draws,
               "dmc_pixels": reacher_reset_draws}
STEP_DRAWS = {"pixel_pong": pong_step_draws, "cartpole": cartpole_step_draws,
              "pixel_breakout": breakout_step_draws,
              "pixel_catch": catch_step_draws,
              "dmc_pixels": reacher_step_draws}


def assert_trees_equal(a, b, path="state"):
    """Every tensor of two state trees equal bit for bit, every host value
    equal."""
    if isinstance(a, torch.Tensor):
        assert isinstance(b, torch.Tensor) and a.dtype == b.dtype, path
        assert torch.equal(a, b), path
    elif isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            assert_trees_equal(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_trees_equal(x, y, f"{path}[{i}]")
    else:
        assert a == b, path


def to_numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


class NormalRecorder:
    """Records, in call order, every array ``jax.random.normal`` returns
    while installed (``monkeypatch.setattr(jax.random, "normal", rec)``):
    the JAX NoisyDense layers draw their factorised noise through it, from
    keys flax derives from the module path, which the port cannot replay.
    Run the JAX code un-jitted so the draws are concrete."""

    def __init__(self):
        self.real = jax.random.normal
        self.draws = []

    def __call__(self, *args, **kwargs):
        out = self.real(*args, **kwargs)
        self.draws.append(np.asarray(out))
        return out

    def layer_noise(self, names, forwards=1):
        """The recorded draws as the port's per-forward noise mappings:
        each noisy layer of ``names`` (in call order) drew (eps_in,
        eps_out); ``forwards`` forwards ran one after the other."""
        per = 2 * len(names)
        assert len(self.draws) == per * forwards, len(self.draws)
        out = []
        for f in range(forwards):
            d = self.draws[f * per:(f + 1) * per]
            out.append({name: (_t(d[2 * i]), _t(d[2 * i + 1]))
                        for i, name in enumerate(names)})
        return out


def cli_rows(text: str) -> list:
    """The JSON rows a training CLI printed, less its one run-manifest
    line (``{"manifest": ...}``, printed first)."""
    rows = [json.loads(line) for line in text.splitlines()
            if line.startswith("{")]
    return [r for r in rows if "manifest" not in r]


def train_cli_in_fleet(argv, fleet_dir: str, timeout: float = 240.0):
    """Run ``python -m dist_dqn_tpu_torch.train *argv --fleet-dir D
    --telemetry-port 0`` and, once it announced its port, sweep D with the
    port's fleet aggregator. Returns (the CLI's JSON rows less its
    manifest, the aggregator's status taken while the run lived, the
    descriptors left in D after it ended)."""
    import os
    import subprocess
    import sys

    from dist_dqn_tpu_torch.telemetry import fleet

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", fleet.FLEET_ENV)}
    proc = subprocess.Popen(
        [sys.executable, "-m", "dist_dqn_tpu_torch.train", *argv,
         "--fleet-dir", fleet_dir, "--telemetry-port", "0"],
        cwd=repo, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    lines, status = [], None
    try:
        for line in proc.stdout:
            lines.append(line)
            if status is None and line.startswith('{"telemetry_port"'):
                agg = fleet.FleetAggregator(fleet_dir, scrape_timeout_s=10.0)
                agg.sweep_once()
                status = agg.status()
        _, err = proc.communicate(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err[-3000:]
    left = sorted(os.listdir(fleet_dir)) if os.path.isdir(fleet_dir) else []
    return cli_rows("".join(lines)), status, left
