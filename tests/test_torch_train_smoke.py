"""The port's learning bars on the CPU: the twins of the JAX package's
tests/test_train_smoke.py (CartPole eval >= 475 within 360k frames),
tests/test_pixel_learning.py (PixelCatch episode return >= +0.5 within
96k frames, from a start below -0.3, with uniform and prioritized
replay), tests/test_rainbow.py (the rainbow preset on CartPole, eval >=
475 within 300k frames) and the scaled-CartPole protocol of
tests/fused_cartpole.py (qrdqn, iqn and mdqn, eval >= 150 within 160k
frames). The runs are slow, not part of tier-1: they let one
reproduce on a CPU the learning phase ``chip_smoke.py`` runs on the card,
through the same entry point (``dist_dqn_tpu_torch.train.train``) and
the same settings (``learning_bars``), which also take the PixelCatch bar
through the sampler kernel's routing and a frame-dedup ring. A fast test
holds those settings to the JAX tests' own.
"""
import dataclasses

import pytest

from dist_dqn_tpu import config as jconfig
from dist_dqn_tpu_torch.learning_bars import (BARS, CARTPOLE_BAR, CATCH_BAR,
                                              CATCH_RANDOM_CEILING,
                                              RAINBOW_BAR, SCALED_BAR,
                                              SCALED_HEADS,
                                              cartpole_bar_config,
                                              catch_bar_config,
                                              rainbow_cartpole_bar_config,
                                              scaled_cartpole_bar_config)
from dist_dqn_tpu_torch.train import train
from test_pixel_learning import RANDOM_BASELINE, TARGET, _catch_cfg


@pytest.mark.parametrize("prioritized", [False, True],
                         ids=["uniform", "per"])
def test_learning_bar_settings_match_the_jax_tests(prioritized):
    """The bars and their configs are the JAX learning tests', field for
    field, but for the PixelCatch bar's dedup ring and kernel routing."""
    cfg, frames, chunk_iters = cartpole_bar_config()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        jconfig.CONFIGS["cartpole"])
    assert (CARTPOLE_BAR, frames, chunk_iters) == (475.0, 360_000, 1000)
    cfg, frames, chunk_iters = catch_bar_config(prioritized)
    want = dataclasses.asdict(_catch_cfg(prioritized))
    want["replay"].update(frame_dedup=True, pallas_sampler=prioritized)
    assert dataclasses.asdict(cfg) == want
    assert (CATCH_BAR, frames, chunk_iters) == (TARGET, 96_000, 250)
    assert CATCH_RANDOM_CEILING == RANDOM_BASELINE + 0.3


def _rainbow_test_cfg():
    """tests/test_rainbow.py:60-92's config, as that test builds it."""
    cfg = jconfig.CONFIGS["rainbow"]
    return dataclasses.replace(
        cfg, env_name="cartpole",
        network=dataclasses.replace(cfg.network, torso="mlp",
                                    mlp_features=(128,), hidden=0,
                                    num_atoms=21, v_min=0.0, v_max=200.0,
                                    compute_dtype="float32"),
        replay=dataclasses.replace(cfg.replay, capacity=20_000,
                                   min_fill=1_000),
        learner=dataclasses.replace(cfg.learner, batch_size=64,
                                    learning_rate=5e-4,
                                    target_update_period=250),
        actor=dataclasses.replace(cfg.actor, num_envs=16,
                                  epsilon_start=0.0, epsilon_end=0.0),
        train_every=1, eval_every_steps=25_000)


def _scaled_test_cfg(preset):
    """tests/fused_cartpole.py ``run_scaled_cartpole``'s config, as it
    builds it, with the head overrides of tests/test_{qrdqn,iqn,mdqn}.py."""
    cfg = jconfig.CONFIGS[preset]
    overrides = {"qrdqn": dict(num_atoms=11),
                 "iqn": dict(iqn_embed_dim=32, iqn_tau_samples=16,
                             iqn_tau_target_samples=16, iqn_tau_act=16),
                 "mdqn": {}}[preset]
    return dataclasses.replace(
        cfg, env_name="cartpole",
        network=dataclasses.replace(cfg.network, torso="mlp",
                                    mlp_features=(64, 64), hidden=0,
                                    compute_dtype="float32", **overrides),
        replay=dataclasses.replace(cfg.replay, capacity=20_000,
                                   min_fill=1_000, pallas_sampler=False),
        learner=dataclasses.replace(cfg.learner, batch_size=128,
                                    learning_rate=1e-3,
                                    target_update_period=250),
        actor=dataclasses.replace(cfg.actor, num_envs=16,
                                  epsilon_decay_steps=20_000),
        total_env_steps=150_000, train_every=1)


@pytest.mark.parametrize("preset", ["rainbow", *SCALED_HEADS])
def test_distributional_bar_settings_match_the_jax_tests(preset):
    """The rainbow bar is tests/test_rainbow.py's config field for field;
    the scaled bars are tests/fused_cartpole.py's but for the eval cadence
    (every 16,000-frame chunk, where the JAX protocol evaluates once after
    ten chunks)."""
    if preset == "rainbow":
        cfg, frames, chunk_iters = rainbow_cartpole_bar_config()
        want = dataclasses.asdict(_rainbow_test_cfg())
        assert (RAINBOW_BAR, frames, chunk_iters) == (475.0, 300_000, 1000)
    else:
        cfg, frames, chunk_iters = scaled_cartpole_bar_config(preset)
        want = dataclasses.asdict(_scaled_test_cfg(preset))
        want["eval_every_steps"] = 16_000
        assert (SCALED_BAR, frames, chunk_iters) == (150.0, 160_000, 1000)
    assert dataclasses.asdict(cfg) == want
    name = f"{preset}_cartpole"
    assert BARS[name][0]() == (cfg, frames, chunk_iters)
    assert BARS[name][1:] == (RAINBOW_BAR if preset == "rainbow"
                              else SCALED_BAR, "eval_return")


@pytest.mark.slow
@pytest.mark.parametrize("preset", ["rainbow", *SCALED_HEADS])
def test_distributional_bar_on_cpu(preset):
    config_fn, bar, key = BARS[f"{preset}_cartpole"]
    cfg, total, chunk_iters = config_fn()
    _, history = train(cfg, total_env_steps=total, chunk_iters=chunk_iters,
                       device="cpu", log_fn=lambda line: None,
                       stop_fn=lambda row: row.get(key, 0.0) >= bar)
    evals = [row[key] for row in history if key in row]
    assert evals and max(evals) >= bar, evals


@pytest.mark.slow
def test_cartpole_solves_on_cpu():
    cfg, total, chunk_iters = cartpole_bar_config()
    _, history = train(cfg, total_env_steps=total, chunk_iters=chunk_iters,
                       device="cpu", log_fn=lambda line: None,
                       stop_fn=lambda row: row.get("eval_return", 0.0)
                       >= CARTPOLE_BAR)
    evals = [row["eval_return"] for row in history if "eval_return" in row]
    assert evals and max(evals) >= CARTPOLE_BAR, evals
    assert all(abs(r["loss"]) < 1e3 for r in history)


@pytest.mark.slow
@pytest.mark.parametrize("prioritized", [False, True],
                         ids=["uniform", "per"])
def test_pixel_catch_beats_random_on_cpu(prioritized):
    cfg, total, chunk_iters = catch_bar_config(prioritized)
    _, history = train(cfg, total_env_steps=total, chunk_iters=chunk_iters,
                       device="cpu", log_fn=lambda line: None,
                       stop_fn=lambda row: row["episode_return"] >= CATCH_BAR)
    returns = [r["episode_return"] for r in history]
    assert returns[0] < CATCH_RANDOM_CEILING, returns
    assert max(returns) >= CATCH_BAR, returns
