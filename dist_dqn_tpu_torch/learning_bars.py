"""The learning bars the port is held to, as runnable settings.

Twins of the JAX package's learning tests: CartPole must reach a greedy
eval return of 475 (of the 500 cap) within 360,000 frames
(``tests/test_train_smoke.py``), and PixelCatch an episode return of +0.5
within 96,000 frames, starting from a random policy's return (about
-0.6), with the ``tests/test_pixel_learning.py`` ``_catch_cfg`` settings.
The port's PixelCatch bar also runs through a frame-dedup ring, and with
PER through the sampler kernel's routing. The distributional and
regularised heads have theirs: the rainbow preset cut to a CartPole MLP
must reach a greedy eval of 475 within 300,000 frames
(``tests/test_rainbow.py:60-92``), and the qrdqn, iqn and mdqn presets,
under the scaled-CartPole protocol of ``tests/fused_cartpole.py``, a
greedy eval of 150 within 160,000 frames (the JAX tests evaluate once, at
160,000 frames; the port evaluates every 16,000 and stops at the bar).
``chip_smoke.py`` runs every bar on the card,
``tests/test_torch_train_smoke.py`` on the CPU.

Each ``*_config`` returns (config, frame cap, iterations per chunk);
``BARS`` names them with their bar and the row key the bar reads.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

from dist_dqn_tpu_torch.config import CONFIGS, ExperimentConfig

CARTPOLE_BAR = 475.0
CARTPOLE_FRAMES = 360_000
CATCH_BAR = 0.5
CATCH_FRAMES = 96_000
# A first chunk at or above this is not a random policy's return.
CATCH_RANDOM_CEILING = -0.3
RAINBOW_BAR = 475.0
RAINBOW_FRAMES = 300_000
SCALED_BAR = 150.0
SCALED_FRAMES = 160_000
# The scaled-CartPole protocol's head overrides per preset.
SCALED_HEADS = {
    "qrdqn": dict(num_atoms=11),
    "iqn": dict(iqn_embed_dim=32, iqn_tau_samples=16,
                iqn_tau_target_samples=16, iqn_tau_act=16),
    "mdqn": {},
}


def cartpole_bar_config() -> Tuple[ExperimentConfig, int, int]:
    """The cartpole preset as it is, evaluated every 25,000 frames."""
    return CONFIGS["cartpole"], CARTPOLE_FRAMES, 1000


def catch_bar_config(prioritized: bool
                     ) -> Tuple[ExperimentConfig, int, int]:
    """The atari preset cut to PixelCatch: small CNN, 32 envs, a
    16,384-transition dedup ring, batch 32, n-step 5, a grad step every
    second iteration, no eval."""
    cfg = CONFIGS["atari"]
    cfg = dataclasses.replace(
        cfg,
        env_name="pixel_catch",
        network=dataclasses.replace(cfg.network, torso="small", hidden=128),
        actor=dataclasses.replace(cfg.actor, num_envs=32,
                                  epsilon_decay_steps=10_000),
        replay=dataclasses.replace(cfg.replay, capacity=16_384,
                                   min_fill=1_500, prioritized=prioritized,
                                   pallas_sampler=prioritized,
                                   frame_dedup=True),
        learner=dataclasses.replace(cfg.learner, batch_size=32,
                                    learning_rate=1e-3, n_step=5,
                                    target_update_period=250),
        train_every=2,
        eval_every_steps=0)
    return cfg, CATCH_FRAMES, 250


def rainbow_cartpole_bar_config() -> Tuple[ExperimentConfig, int, int]:
    """The rainbow preset (dueling, noisy, C51, PER, n-step double-Q, no
    epsilon) on CartPole: MLP (128,), 21 atoms on [0, 200], f32, a
    20,000-transition ring, batch 64, lr 5e-4, 16 envs, a grad step every
    iteration, eval every 25,000 frames."""
    cfg = CONFIGS["rainbow"]
    cfg = dataclasses.replace(
        cfg,
        env_name="cartpole",
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
        train_every=1,
        eval_every_steps=25_000)
    return cfg, RAINBOW_FRAMES, 1000


def scaled_cartpole_bar_config(preset: str
                               ) -> Tuple[ExperimentConfig, int, int]:
    """``preset`` (qrdqn, iqn or mdqn) under the scaled-CartPole protocol:
    MLP (64, 64), f32, the preset's head at ``SCALED_HEADS`` widths, a
    20,000-transition PER ring drawn through the cumsum twin, batch 128,
    lr 1e-3, 16 envs, epsilon decayed over 20,000 frames, a grad step
    every iteration; eval every 16,000 frames (one 1,000-iteration chunk).
    """
    cfg = CONFIGS[preset]
    cfg = dataclasses.replace(
        cfg,
        env_name="cartpole",
        network=dataclasses.replace(cfg.network, torso="mlp",
                                    mlp_features=(64, 64), hidden=0,
                                    compute_dtype="float32",
                                    **SCALED_HEADS[preset]),
        replay=dataclasses.replace(cfg.replay, capacity=20_000,
                                   min_fill=1_000, pallas_sampler=False),
        learner=dataclasses.replace(cfg.learner, batch_size=128,
                                    learning_rate=1e-3,
                                    target_update_period=250),
        actor=dataclasses.replace(cfg.actor, num_envs=16,
                                  epsilon_decay_steps=20_000),
        total_env_steps=150_000,
        train_every=1,
        eval_every_steps=16_000)
    return cfg, SCALED_FRAMES, 1000


# name -> (config function, bar, the row key the bar reads)
BARS: Dict[str, Tuple[Callable[[], Tuple[ExperimentConfig, int, int]],
                      float, str]] = {
    "cartpole": (cartpole_bar_config, CARTPOLE_BAR, "eval_return"),
    "catch": (lambda: catch_bar_config(prioritized=True), CATCH_BAR,
              "episode_return"),
    "rainbow_cartpole": (rainbow_cartpole_bar_config, RAINBOW_BAR,
                         "eval_return"),
    **{f"{preset}_cartpole": (
        lambda preset=preset: scaled_cartpole_bar_config(preset),
        SCALED_BAR, "eval_return") for preset in SCALED_HEADS},
}
