"""The port's learning bars on the CPU: the twins of the JAX package's
tests/test_train_smoke.py (CartPole eval >= 475 within 360k frames) and
tests/test_pixel_learning.py (PixelCatch episode return >= +0.5 within
96k frames, from a start below -0.3, with uniform and prioritized
replay). The two runs are slow, not part of tier-1: they let one
reproduce on a CPU the learning phase ``chip_smoke.py`` runs on the card,
through the same entry point (``dist_dqn_tpu_torch.train.train``) and
the same settings (``learning_bars``), which also take the PixelCatch bar
through the sampler kernel's routing and a frame-dedup ring. A fast test
holds those settings to the JAX tests' own.
"""
import dataclasses

import pytest

from dist_dqn_tpu import config as jconfig
from dist_dqn_tpu_torch.learning_bars import (CARTPOLE_BAR, CATCH_BAR,
                                              CATCH_RANDOM_CEILING,
                                              cartpole_bar_config,
                                              catch_bar_config)
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
