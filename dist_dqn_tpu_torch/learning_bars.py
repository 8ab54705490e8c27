"""The learning bars the port is held to, as runnable settings.

Twins of the JAX package's learning tests: CartPole must reach a greedy
eval return of 475 (of the 500 cap) within 360,000 frames
(``tests/test_train_smoke.py``), and PixelCatch an episode return of +0.5
within 96,000 frames, starting from a random policy's return (about
-0.6), with the ``tests/test_pixel_learning.py`` ``_catch_cfg`` settings.
The port's PixelCatch bar also runs through a frame-dedup ring, and with
PER through the sampler kernel's routing. ``chip_smoke.py`` runs both on
the card, ``tests/test_torch_train_smoke.py`` on the CPU.

Each ``*_config`` returns (config, frame cap, iterations per chunk).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

from dist_dqn_tpu_torch.config import CONFIGS, ExperimentConfig

CARTPOLE_BAR = 475.0
CARTPOLE_FRAMES = 360_000
CATCH_BAR = 0.5
CATCH_FRAMES = 96_000
# A first chunk at or above this is not a random policy's return.
CATCH_RANDOM_CEILING = -0.3


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
