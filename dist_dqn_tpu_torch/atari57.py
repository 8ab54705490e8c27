"""Atari-57 suite runner of the port (twin of ``dist_dqn_tpu/atari57.py``):
per-game evaluation and training, and the human-normalised score rollup.

  * ``ATARI_57``: the canonical 57 game names of the ALE benchmark (the set
    of the DQN, Rainbow, Ape-X and R2D2 papers), usable as ``ale:<Game>``
    env names through envs/gym_adapter.py.
  * ``evaluate_suite`` / ``--mode eval``: greedy checkpoint evaluation
    (evaluate.py ``evaluate_checkpoint_host``, raw whole-game scores) of
    each game under a root laid out as ``<root>/<Game>/``.
  * ``train_suite`` / ``--mode train``: one Ape-X run per game
    (actors/service.py ``run_apex``), in turn, each with its own
    checkpoint directory.
  * ``normalized_scores``: human-normalised scores (HNS) and the median and
    mean over the games.

The human and random reference table (Wang et al. 2016) ships as
``atari57_refs.py``, so ``--mode eval`` reports median and mean HNS for all
57 games; ``--scores-json`` ({"Pong": {"random": -20.7, "human": 14.6},
...}) replaces it. Runs on ``cuda`` unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
from typing import Dict, Iterable, Optional

ATARI_57 = (
    "Alien", "Amidar", "Assault", "Asterix", "Asteroids", "Atlantis",
    "BankHeist", "BattleZone", "BeamRider", "Berzerk", "Bowling", "Boxing",
    "Breakout", "Centipede", "ChopperCommand", "CrazyClimber", "Defender",
    "DemonAttack", "DoubleDunk", "Enduro", "FishingDerby", "Freeway",
    "Frostbite", "Gopher", "Gravitar", "Hero", "IceHockey", "Jamesbond",
    "Kangaroo", "Krull", "KungFuMaster", "MontezumaRevenge", "MsPacman",
    "NameThisGame", "Phoenix", "Pitfall", "Pong", "PrivateEye", "Qbert",
    "Riverraid", "RoadRunner", "Robotank", "Seaquest", "Skiing", "Solaris",
    "SpaceInvaders", "StarGunner", "Surround", "Tennis", "TimePilot",
    "Tutankham", "UpNDown", "Venture", "VideoPinball", "WizardOfWor",
    "YarsRevenge", "Zaxxon",
)

# Well-known DQN-paper (Mnih et al. 2015) reference values for the two
# games the offline fake models — example/seed data, NOT the full table.
EXAMPLE_SCORES = {
    "Pong": {"random": -20.7, "human": 14.6},
    "Breakout": {"random": 1.7, "human": 30.5},
}


def normalized_scores(returns: Dict[str, float],
                      reference: Dict[str, Dict[str, float]]) -> dict:
    """Human-normalized scores: 100 * (score - random) / (human - random).

    Returns {"per_game": {game: hns}, "median_hns": m, "mean_hns": m,
    "games": n} over the games present in BOTH inputs; games without
    reference entries are listed in "unreferenced" instead of silently
    dropped.
    """
    import numpy as np

    per_game = {}
    unreferenced = []
    for game, score in returns.items():
        ref = reference.get(game)
        if not ref:
            unreferenced.append(game)
            continue
        denom = ref["human"] - ref["random"]
        if denom == 0:
            unreferenced.append(game)
            continue
        per_game[game] = 100.0 * (score - ref["random"]) / denom
    vals = np.asarray(sorted(per_game.values()), np.float64)
    out = {"per_game": per_game, "games": len(per_game),
           "unreferenced": sorted(unreferenced)}
    if len(vals):
        out["median_hns"] = float(np.median(vals))
        out["mean_hns"] = float(vals.mean())
    return out


def evaluate_suite(cfg, checkpoint_root: str,
                   games: Iterable[str] = ATARI_57, episodes: int = 10,
                   seed: int = 0, log_fn=print,
                   missing_ok: bool = True,
                   device=None) -> Dict[str, float]:
    """Greedy evaluation of ``<checkpoint_root>/<Game>`` for each game, on
    ``device`` (default: the card).

    Returns {game: raw mean whole-game return}. Games whose checkpoint
    dir is absent are skipped with a log line (``missing_ok=False``
    raises instead) — partial suites are the common case mid-training.
    """
    from dist_dqn_tpu_torch.evaluate import evaluate_checkpoint_host

    returns: Dict[str, float] = {}
    for game in games:
        ckpt_dir = os.path.join(checkpoint_root, game)
        if not os.path.isdir(ckpt_dir):
            if not missing_ok:
                raise FileNotFoundError(f"no checkpoint dir for {game} "
                                        f"under {checkpoint_root!r}")
            log_fn(json.dumps({"game": game, "skipped": "no checkpoint"}))
            continue
        out = evaluate_checkpoint_host(cfg, ckpt_dir, f"ale:{game}",
                                       episodes=episodes, seed=seed,
                                       device=device)
        returns[game] = out["eval_return"]
        log_fn(json.dumps({"game": game, **out}))
    return returns


def train_suite(cfg, rt, checkpoint_root: str,
                games: Iterable[str] = ATARI_57, log_fn=print,
                device=None) -> dict:
    """One Ape-X training run per game, in turn, each with its own
    checkpoint directory, on ``device`` (default: the card). Resumable:
    each game's run restores its own newest checkpoint, so a second call
    after an interruption continues where the suite left off."""
    from dist_dqn_tpu_torch.actors.service import run_apex

    summaries = {}
    for game in games:
        game_rt = dataclasses.replace(
            rt, host_env=f"ale:{game}",
            checkpoint_dir=os.path.join(checkpoint_root, game))
        log_fn(json.dumps({"game": game, "phase": "train_start"}))
        summaries[game] = run_apex(cfg, game_rt, log_fn=log_fn,
                                   device=device)
        log_fn(json.dumps({"game": game, "phase": "train_done",
                           **summaries[game]}))
    return summaries


def main(argv=None):
    from dist_dqn_tpu_torch.config import CONFIGS

    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--mode", choices=("eval", "train", "list"),
                        default="list",
                        help="list: print the 57 game names; eval: "
                             "evaluate <checkpoint-root>/<Game> per game "
                             "and print the suite rollup; train: "
                             "sequential per-game Ape-X runs with "
                             "per-game checkpoint dirs")
    parser.add_argument("--config", choices=sorted(CONFIGS),
                        default="apex")
    parser.add_argument("--checkpoint-root", default=None)
    parser.add_argument("--games", nargs="*", default=None,
                        help="subset of games (default: all 57)")
    parser.add_argument("--episodes", type=int, default=10)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--scores-json", default=None,
                        help="per-game {game: {random, human}} reference "
                             "table for the HNS rollup; default: the "
                             "shipped Wang et al. 2016 table "
                             "(atari57_refs.py)")
    parser.add_argument("--num-actors", type=int, default=8,
                        help="train mode: local actor processes per game")
    parser.add_argument("--envs-per-actor", type=int, default=16)
    parser.add_argument("--total-env-steps", type=int, default=0,
                        help="train mode: env-step budget PER GAME "
                             "(default: the config's total)")
    parser.add_argument("--device", choices=("cuda", "cpu"), default=None,
                        help="default: cuda, which must be present")
    parser.add_argument("--set", dest="overrides", action="append",
                        metavar="PATH=VALUE", default=[],
                        help="override config fields by dotted path "
                             "(applies to every game's run, e.g. "
                             "--set learner.batch_size=128)")
    args = parser.parse_args(argv)

    if args.mode == "list":
        print(json.dumps({"games": list(ATARI_57),
                          "count": len(ATARI_57)}))
        return
    if not args.checkpoint_root:
        parser.error(f"--mode {args.mode} requires --checkpoint-root")
    games = tuple(ATARI_57 if args.games is None else args.games)
    if not games:
        parser.error("--games was given with no game names")
    from dist_dqn_tpu_torch.config import apply_overrides
    try:
        cfg = apply_overrides(CONFIGS[args.config], args.overrides)
    except ValueError as e:
        parser.error(str(e))

    if args.mode == "train":
        from dist_dqn_tpu_torch.actors.service import ApexRuntimeConfig

        rt = ApexRuntimeConfig(
            num_actors=args.num_actors,
            envs_per_actor=args.envs_per_actor,
            total_env_steps=(args.total_env_steps
                             or cfg.total_env_steps))
        print(json.dumps({"suite": train_suite(
            cfg, rt, args.checkpoint_root, games=games,
            device=args.device)}))
        return

    # Load (and shape-check) the reference table BEFORE the suite eval:
    # a typo'd path must not surface only after hours of per-game runs.
    if args.scores_json:
        with open(args.scores_json) as fh:
            reference = json.load(fh)
        for game, ref in reference.items():
            if "random" not in ref or "human" not in ref:
                parser.error(f"--scores-json entry for {game!r} needs "
                             f"'random' and 'human' keys")
    else:
        from dist_dqn_tpu_torch.atari57_refs import HUMAN_RANDOM_SCORES
        reference = HUMAN_RANDOM_SCORES
    returns = evaluate_suite(cfg, args.checkpoint_root, games=games,
                             episodes=args.episodes, seed=args.seed,
                             device=args.device)
    rollup = {"raw_returns": returns, "games_evaluated": len(returns),
              "hns": normalized_scores(returns, reference)}
    print(json.dumps(rollup))


if __name__ == "__main__":
    main()
