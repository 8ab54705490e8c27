"""The port's Atari-57 suite runner (dist_dqn_tpu_torch/atari57.py and
atari57_refs.py) against dist_dqn_tpu/atari57.py, mirroring
tests/test_atari57.py: the game list, the reference table and the HNS
rollup equal JAX's exactly; per-game evaluation over the fake ALE (6-action
Pong and 4-action Breakout under one root), a train_suite -> evaluate_suite
round trip through the port's Ape-X service, and the CLI's list and eval
modes, all bounded in steps."""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from dist_dqn_tpu import atari57 as ja57
from dist_dqn_tpu import atari57_refs as jrefs
from dist_dqn_tpu_torch import atari57 as ta57
from dist_dqn_tpu_torch import atari57_refs as trefs
from dist_dqn_tpu_torch.agents.dqn import make_learner
from dist_dqn_tpu_torch.config import CONFIGS
from dist_dqn_tpu_torch.models import build_network
from dist_dqn_tpu_torch.utils.checkpoint import TrainCheckpointer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SMALL = ["network.torso=small", "network.hidden=32",
          "network.compute_dtype=float32"]


def test_atari57_list_is_the_canonical_set():
    assert ta57.ATARI_57 == ja57.ATARI_57
    assert len(set(ta57.ATARI_57)) == 57
    assert ta57.EXAMPLE_SCORES == ja57.EXAMPLE_SCORES


def test_shipped_reference_table_equals_jax_and_covers_all_57_games():
    assert trefs.HUMAN_RANDOM_SCORES == jrefs.HUMAN_RANDOM_SCORES
    assert set(trefs.HUMAN_RANDOM_SCORES) == set(ta57.ATARI_57)
    for game, ref in trefs.HUMAN_RANDOM_SCORES.items():
        assert ref["human"] > ref["random"], game
    at_human = {g: r["human"] for g, r in trefs.HUMAN_RANDOM_SCORES.items()}
    out = ta57.normalized_scores(at_human, trefs.HUMAN_RANDOM_SCORES)
    assert out["games"] == 57
    assert out["median_hns"] == pytest.approx(100.0)
    assert out["mean_hns"] == pytest.approx(100.0)


@pytest.mark.parametrize("returns", [
    {"Pong": 14.6, "Breakout": 1.7, "NoRef": 100.0},
    {"X": 1.0},
    {"Pong": -3.25, "Breakout": 17.0, "Skiing": -9000.0},
])
def test_normalized_scores_match_jax(returns):
    for ref in (ta57.EXAMPLE_SCORES, trefs.HUMAN_RANDOM_SCORES,
                {"Pong": {"random": 1.0, "human": 1.0}}):
        assert ta57.normalized_scores(returns, ref) == \
            ja57.normalized_scores(returns, ref)
    out = ta57.normalized_scores({"Pong": 14.6, "Breakout": 1.7,
                                  "NoRef": 100.0}, ta57.EXAMPLE_SCORES)
    assert out["per_game"]["Pong"] == pytest.approx(100.0)
    assert out["per_game"]["Breakout"] == pytest.approx(0.0)
    assert out["unreferenced"] == ["NoRef"] and out["games"] == 2
    assert out["median_hns"] == pytest.approx(50.0)


def _save_untrained_checkpoint(cfg, num_actions, path):
    net = build_network(cfg.network, num_actions, (84, 84, 4), device="cpu")
    init, _ = make_learner(cfg.learner, net)
    TrainCheckpointer(str(path)).save(1, init(net))


def _atari_cfg():
    from dist_dqn_tpu_torch.config import apply_overrides
    return apply_overrides(CONFIGS["atari"], _SMALL)


def test_evaluate_suite_over_fake_ale(tmp_path, monkeypatch):
    monkeypatch.setenv("DQN_FAKE_ALE", "1")
    cfg = _atari_cfg()
    _save_untrained_checkpoint(cfg, 6, tmp_path / "Pong")
    _save_untrained_checkpoint(cfg, 4, tmp_path / "Breakout")
    logs = []
    returns = ta57.evaluate_suite(cfg, str(tmp_path),
                                  games=("Pong", "Breakout", "Seaquest"),
                                  episodes=2, log_fn=logs.append,
                                  device="cpu")
    assert set(returns) == {"Pong", "Breakout"}
    assert all(np.isfinite(v) for v in returns.values())
    skipped = [json.loads(s) for s in logs if "skipped" in s]
    assert skipped == [{"game": "Seaquest", "skipped": "no checkpoint"}]
    rows = {r["game"]: r for r in map(json.loads, logs) if "frames" in r}
    assert rows["Pong"]["host_env"] == "ale:Pong"
    hns = ta57.normalized_scores(returns, ta57.EXAMPLE_SCORES)
    assert hns["games"] == 2 and "median_hns" in hns
    with pytest.raises(FileNotFoundError):
        ta57.evaluate_suite(cfg, str(tmp_path), games=("Seaquest",),
                            episodes=1, missing_ok=False, device="cpu")


def test_train_suite_roundtrips_into_evaluate_suite(tmp_path, monkeypatch):
    """train_suite writes the per-game checkpoint through a real Ape-X run
    (actor processes step the fake ALE, which they find through
    ``DQN_FAKE_ALE`` in their environment); evaluate_suite scores it."""
    from dist_dqn_tpu_torch.actors.service import ApexRuntimeConfig

    monkeypatch.setenv("DQN_FAKE_ALE", "1")
    cfg = CONFIGS["apex"]
    cfg = dataclasses.replace(
        cfg,
        network=dataclasses.replace(cfg.network, torso="small", hidden=32,
                                    dueling=False, compute_dtype="float32"),
        replay=dataclasses.replace(cfg.replay, capacity=2048, min_fill=64,
                                   pallas_sampler=False),
        learner=dataclasses.replace(cfg.learner, batch_size=8))
    rt = ApexRuntimeConfig(num_actors=1, envs_per_actor=2,
                           total_env_steps=150, inserts_per_grad_step=64)
    summaries = ta57.train_suite(cfg, rt, str(tmp_path), games=("Pong",),
                                 log_fn=lambda s: None, device="cpu")
    assert summaries["Pong"]["env_steps"] >= 150
    assert summaries["Pong"]["ring_dropped"] == 0
    assert summaries["Pong"]["bad_records"] == 0
    returns = ta57.evaluate_suite(cfg, str(tmp_path), games=("Pong",),
                                  episodes=2, log_fn=lambda s: None,
                                  device="cpu")
    assert np.isfinite(returns["Pong"])


def test_cli_list_mode():
    out = subprocess.run(
        [sys.executable, "-m", "dist_dqn_tpu_torch.atari57", "--mode",
         "list"], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-500:]
    payload = json.loads(out.stdout.strip().splitlines()[-1])
    assert payload == {"games": list(ja57.ATARI_57), "count": 57}


def test_cli_eval_mode_rolls_up_hns_with_shipped_table(tmp_path,
                                                       monkeypatch, capsys):
    monkeypatch.setenv("DQN_FAKE_ALE", "1")
    _save_untrained_checkpoint(_atari_cfg(), 6, tmp_path / "Pong")
    argv = ["--mode", "eval", "--config", "atari", "--device", "cpu",
            "--checkpoint-root", str(tmp_path), "--games", "Pong",
            "--episodes", "1"]
    for a in _SMALL:
        argv += ["--set", a]
    ta57.main(argv)
    rows = [json.loads(line) for line in
            capsys.readouterr().out.splitlines() if line.startswith("{")]
    rollup = rows[-1]
    assert rollup["games_evaluated"] == 1
    assert rollup["hns"] == ta57.normalized_scores(
        rollup["raw_returns"], trefs.HUMAN_RANDOM_SCORES)
    assert rollup["hns"]["per_game"]["Pong"] < 100.0
    with pytest.raises(SystemExit):
        ta57.main(["--mode", "eval", "--device", "cpu"])
