"""Standalone checkpoint evaluation of the port (twin of
dist_dqn_tpu/evaluate.py):
``python -m dist_dqn_tpu_torch.evaluate --config apex --checkpoint-dir d``.

The deploy-side half of the checkpoint story: load the newest learner
checkpoint a training run saved with ``--checkpoint-dir`` (either kind)
and run greedy episodes on the config's env, with no training machinery
in the loop. Prints one JSON line with the mean undiscounted return (one
per retained step with ``--all-steps``). ``--member K`` plays member K of
a population run's stacked checkpoint (and is required there).
``--host-env NAME`` plays whole games with raw scores on a host env
(``ale:<Game>``, with ``DQN_FAKE_ALE=1`` the in-repo fake; gymnasium names;
``dmc:<domain>:<task>``), the deploy-side counterpart of an Ape-X run. Runs
on ``cuda`` unless ``--device cpu`` is given. ``--telemetry-port``,
``--telemetry-host`` and ``--telemetry-snapshot`` expose the process's
telemetry registry as the train CLI does; with ``--fleet-dir`` (or
``DQN_FLEET_DIR``) the endpoint joins the run's fleet as an ``eval``-role
member.
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import os

import torch

from dist_dqn_tpu_torch import telemetry
from dist_dqn_tpu_torch.config import CONFIGS, ExperimentConfig, \
    apply_overrides
from dist_dqn_tpu_torch.utils.checkpoint import (CheckpointMissingError,
                                                 TrainCheckpointer,
                                                 checkpoint_present,
                                                 params_prefix, save_pytree,
                                                 wait_for_checkpoint)
from dist_dqn_tpu_torch.utils.device import resolve_device


def _restore_latest(checkpoint_dir: str, example_params, step=None,
                    member=None):
    """(frames, net) from the newest checkpoint (or a retained ``step``),
    params only (``TrainCheckpointer.restore_params``; member ``member``
    of a population's): the training run's optimizer never constrains an
    eval, and a carry-kind directory needs no ring-sized template. Never
    creates the directory."""
    if not os.path.isdir(checkpoint_dir):
        raise CheckpointMissingError(
            f"no checkpoint found under {checkpoint_dir!r}")
    ckpt = TrainCheckpointer(checkpoint_dir)
    try:
        restored = ckpt.restore_params(example_params, step=step,
                                       prefix=params_prefix(checkpoint_dir),
                                       member=member)
    except FileNotFoundError as e:
        # Skippable only when the requested step is gone from the retained
        # set (live retention); anything else propagates.
        if step is not None and step not in ckpt.all_steps():
            raise CheckpointMissingError(str(e)) from e
        raise
    if restored is None:
        raise CheckpointMissingError(
            f"no checkpoint found under {checkpoint_dir!r}")
    return restored


def _build_eval(cfg: ExperimentConfig, episodes: int, epsilon: float,
                seed: int, device=None):
    """(example network, evaluator, eval generator) for the config's env:
    shared by the single-point and curve surfaces, so the env and net are
    built once either way. The generator is re-seeded with ``seed``
    before every evaluation (``_play``)."""
    from dist_dqn_tpu_torch.envs import make_env
    from dist_dqn_tpu_torch.models import build_network

    dev = resolve_device(device)
    env = make_env(cfg.env_name, device=dev)
    net = build_network(cfg.network, env.num_actions, env.observation_shape,
                        device=dev, seed=seed)
    if cfg.network.lstm_size:
        from dist_dqn_tpu_torch.r2d2_loop import make_r2d2_evaluator
        evaluator = make_r2d2_evaluator(cfg, env, num_episodes=episodes,
                                        epsilon=epsilon)
    else:
        from dist_dqn_tpu_torch.train_loop import make_evaluator
        evaluator = make_evaluator(cfg, env, num_episodes=episodes,
                                   epsilon=epsilon)
    return net, evaluator, torch.Generator(device=dev)


def _play(evaluator, net, generator: torch.Generator, seed: int) -> float:
    """Mean return of one evaluation, from the same draws every call, so
    curve points differ only by the restored parameters."""
    generator.manual_seed(seed)
    return float(evaluator(net, generator))


def evaluate_checkpoint(cfg: ExperimentConfig, checkpoint_dir: str,
                        episodes: int = 10, seed: int = 0,
                        epsilon: float = 0.001, step: int = None,
                        export_params: str = None, device=None,
                        member: int = None) -> dict:
    """Restore the newest checkpoint (or retained ``step``; member
    ``member`` of a population's) and play greedy episodes.

    ``export_params`` also writes the restored policy parameters as a
    standalone file (utils/checkpoint.py ``save_pytree``): the deploy
    artifact, the net's state dict with no optimizer state, loadable with
    ``restore_pytree(path, net)`` without the run's directory or flags.

    Returns {"eval_return": mean, "frames": checkpoint cursor, ...}.
    Raises FileNotFoundError if the directory holds no checkpoint.
    """
    net, evaluator, gen = _build_eval(cfg, episodes, epsilon, seed, device)
    frames, net = _restore_latest(checkpoint_dir, net, step=step,
                                  member=member)
    out = {"eval_return": _play(evaluator, net, gen, seed), "frames": frames,
           "episodes": episodes, "config": cfg.name}
    if member is not None:
        out["member"] = member
    if export_params:
        save_pytree(os.path.abspath(export_params), net)
        out["exported_params"] = os.path.abspath(export_params)
    return out


def evaluate_checkpoint_host(cfg: ExperimentConfig, checkpoint_dir: str,
                             host_env: str, episodes: int = 10,
                             seed: int = 0, epsilon: float = 0.001,
                             max_steps: int = 20_000, step: int = None,
                             member: int = None, device=None) -> dict:
    """Greedy checkpoint episodes on a host env (ALE, DM-Control,
    gymnasium): the deploy-side counterpart of an Ape-X run, which trains
    on host envs.

    The network takes the host env's action count (an ``ale:`` checkpoint
    trained on Breakout has 4 heads), one env lane per episode, whole-game
    episodes and raw game scores (``for_eval=True``: episodic life and
    reward clipping are training devices). Exploration draws come from a
    generator seeded with ``seed``; episodes stop at ``max_steps``.
    """
    from dist_dqn_tpu_torch.envs.gym_adapter import make_host_env
    from dist_dqn_tpu_torch.models import build_network
    from dist_dqn_tpu_torch.utils.host_eval import run_greedy_episodes

    dev = resolve_device(device)
    env = make_host_env(host_env, episodes, seed=10_000 + seed,
                        for_eval=True)
    obs_shape = env.reset().shape[1:]
    net = build_network(cfg.network, env.num_actions, obs_shape,
                        device=dev, seed=seed)
    frames, net = _restore_latest(checkpoint_dir, net, step=step,
                                  member=member)
    gen = torch.Generator(device=dev).manual_seed(seed)
    on_done = None
    if cfg.network.lstm_size > 0:
        from dist_dqn_tpu_torch.agents.r2d2 import make_recurrent_actor_step
        step_fn = make_recurrent_actor_step(env.num_actions)
        carry = [net.initial_state(episodes)]

        def act(obs, eps):
            carry[0], actions = step_fn(net, carry[0],
                                        torch.from_numpy(obs).to(dev), gen,
                                        eps)
            return actions.cpu().numpy()

        def on_done(done):
            # The carry of a lane whose episode ended restarts at zero.
            keep = torch.from_numpy(~done).float().to(dev)[:, None]
            carry[0] = (carry[0][0] * keep, carry[0][1] * keep)
    else:
        from dist_dqn_tpu_torch.agents.dqn import make_actor_step
        step_fn = make_actor_step(env.num_actions)

        def act(obs, eps):
            return step_fn(net, torch.from_numpy(obs).to(dev), gen,
                           eps).cpu().numpy()

    returns, truncated = run_greedy_episodes(
        env, act, episodes=episodes, epsilon=epsilon, max_steps=max_steps,
        on_done=on_done)
    out = {"eval_return": float(returns.mean()), "frames": frames,
           "episodes": episodes, "config": cfg.name, "host_env": host_env,
           "episodes_truncated": truncated}
    if member is not None:
        out["member"] = member
    return out


def _skip_row(step: int) -> dict:
    """The row --all-steps prints for a checkpoint a live training run's
    retention deleted mid-walk."""
    return {"frames": step,
            "skipped": "checkpoint deleted during walk (live retention)"}


def evaluate_checkpoint_curve(cfg: ExperimentConfig, checkpoint_dir: str,
                              episodes: int = 10, seed: int = 0,
                              epsilon: float = 0.001, log_fn=None,
                              device=None, member: int = None) -> list:
    """Evaluate every retained checkpoint step, oldest first: the learning
    curve of a run directory. One env/net build serves all steps, each
    played from the same draws. Steps deleted mid-walk by a live run's
    retention are skipped with a log row instead of ending the walk."""
    if not os.path.isdir(checkpoint_dir):
        raise FileNotFoundError(
            f"no checkpoint found under {checkpoint_dir!r}")
    prefix = params_prefix(checkpoint_dir)
    ckpt = TrainCheckpointer(checkpoint_dir)
    steps = ckpt.all_steps()
    if not steps:
        # The live-run-before-first-save shape, retryable by
        # --wait-for-checkpoint.
        raise CheckpointMissingError(
            f"no checkpoint found under {checkpoint_dir!r}")
    net, evaluator, gen = _build_eval(cfg, episodes, epsilon, seed, device)
    rows = []
    for step in steps:
        try:
            frames, net = ckpt.restore_params(net, step=step, prefix=prefix,
                                              member=member)
        except FileNotFoundError:
            # Only the restore is guarded, so an unrelated
            # FileNotFoundError cannot be mislabeled.
            if log_fn:
                log_fn(_skip_row(step))
            continue
        row = {"eval_return": _play(evaluator, net, gen, seed),
               "frames": frames, "episodes": episodes, "config": cfg.name}
        if member is not None:
            row["member"] = member
        rows.append(row)
        if log_fn:
            log_fn(row)
    return rows


def _apply_risk_eta(cfg: ExperimentConfig, eta) -> ExperimentConfig:
    """Evaluate an IQN checkpoint under another risk profile than it was
    trained with: one set of learned quantiles, a family of policies.
    Parameters are risk-agnostic, so any eta in (0, 1] restores."""
    if not cfg.network.iqn:
        raise ValueError(
            "--risk-cvar-eta only applies to IQN configs (the acting "
            f"fractions of {cfg.name!r} are not tau-conditioned)")
    return dataclasses.replace(
        cfg, network=dataclasses.replace(cfg.network, risk_cvar_eta=eta))


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--config", choices=sorted(CONFIGS), required=True)
    parser.add_argument("--checkpoint-dir", required=True)
    parser.add_argument("--episodes", type=int, default=10)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", choices=("cuda", "cpu"), default=None,
                        help="default: cuda, which must be present")
    parser.add_argument("--risk-cvar-eta", type=float, default=None,
                        help="IQN configs only: act on the lower-eta CVaR "
                             "tail of the learned return distribution "
                             "instead of the trained profile")
    parser.add_argument("--set", dest="overrides", action="append",
                        metavar="PATH=VALUE", default=[],
                        help="override config fields by dotted path (must "
                             "match how the checkpoint was trained, e.g. "
                             "--set network.dueling=true)")
    parser.add_argument("--all-steps", action="store_true",
                        help="evaluate every retained checkpoint step "
                             "(oldest first, one JSON line each)")
    parser.add_argument("--export-params", default=None, metavar="PATH",
                        help="also write the restored policy parameters "
                             "as a standalone file at PATH (newest or "
                             "single step)")
    parser.add_argument("--member", type=int, default=None, metavar="K",
                        help="population checkpoints (--population runs): "
                             "evaluate member K of the [M]-stacked tree "
                             "(0-based); required for population "
                             "directories and refused on solo ones")
    parser.add_argument("--wait-for-checkpoint", type=float, default=0.0,
                        metavar="SECONDS",
                        help="retry a missing checkpoint for up to this "
                             "many seconds instead of failing at once")
    parser.add_argument("--host-env", default=None,
                        help="evaluate on a host env (e.g. ale:Breakout, "
                             "CartPole-v1, dmc:reacher:easy) instead of "
                             "the config's batched env")
    parser.add_argument("--telemetry-port", type=int, default=None,
                        help="serve this process's telemetry registry "
                             "(/metrics, /metrics.json, /healthz, "
                             "/debug/*) on this port; 0 binds an "
                             "ephemeral port (reported as a "
                             "telemetry_port log line) — eval runs are "
                             "scrapable exactly like train runs "
                             "(docs/observability.md)")
    parser.add_argument("--telemetry-host", default="127.0.0.1",
                        help="bind address for --telemetry-port "
                             "(loopback by default; 0.0.0.0 exposes the "
                             "scrape surface outside the container/VM)")
    parser.add_argument("--telemetry-snapshot", default=None,
                        help="dump a JSON snapshot of the telemetry "
                             "registry to this path at exit (offline "
                             "runs; same data as /metrics.json)")
    parser.add_argument("--fleet-dir", default=None,
                        help="fleet registry directory: announce this eval "
                             "run's telemetry endpoint as an eval-role "
                             "member (requires --telemetry-port); "
                             "defaults to $DQN_FLEET_DIR")
    args = parser.parse_args(argv)
    # The train CLI's scrape and snapshot knobs.
    if args.telemetry_snapshot:
        telemetry.install_snapshot_dump(args.telemetry_snapshot)
    if args.fleet_dir:
        from dist_dqn_tpu_torch.telemetry import fleet
        os.environ[fleet.FLEET_ENV] = args.fleet_dir
    server = telemetry.serve_if_asked(
        args.telemetry_port, args.telemetry_host,
        functools.partial(print, flush=True), role="eval")
    if args.export_params and (args.all_steps or args.host_env):
        parser.error("--export-params applies to the single-point surface "
                     "of the config's env (not --all-steps or --host-env)")
    try:
        cfg = apply_overrides(CONFIGS[args.config], args.overrides)
    except ValueError as e:
        parser.error(str(e))
    if args.risk_cvar_eta is not None:
        cfg = _apply_risk_eta(cfg, args.risk_cvar_eta)

    def tag_and_print(out):
        if args.risk_cvar_eta is not None:
            out["risk_cvar_eta"] = args.risk_cvar_eta
        print(json.dumps(out), flush=True)

    def run_host(step=None):
        tag_and_print(evaluate_checkpoint_host(
            cfg, args.checkpoint_dir, args.host_env, episodes=args.episodes,
            seed=args.seed, step=step,
            member=args.member, device=args.device))

    def dispatch():
        # A cheap presence probe before any env/network build, so every
        # --wait-for-checkpoint retry of an empty or absent directory is
        # retryable and costs no build.
        if not checkpoint_present(args.checkpoint_dir):
            raise CheckpointMissingError(
                f"no checkpoint found under {args.checkpoint_dir!r}")
        if args.host_env and args.all_steps:
            # Host envs: one restore per retained step through the
            # single-point surface; a step deleted mid-walk is skipped.
            from dist_dqn_tpu_torch.utils.checkpoint import \
                list_checkpoint_steps

            steps = list_checkpoint_steps(args.checkpoint_dir)
            if not steps:
                raise CheckpointMissingError(
                    f"no checkpoint found under {args.checkpoint_dir!r}")
            for step in steps:
                try:
                    run_host(step)
                except CheckpointMissingError:
                    tag_and_print(_skip_row(step))
        elif args.host_env:
            run_host()
        elif args.all_steps:
            evaluate_checkpoint_curve(
                cfg, args.checkpoint_dir, episodes=args.episodes,
                seed=args.seed, log_fn=tag_and_print, device=args.device,
                member=args.member)
        else:
            tag_and_print(evaluate_checkpoint(
                cfg, args.checkpoint_dir, episodes=args.episodes,
                seed=args.seed, export_params=args.export_params,
                device=args.device, member=args.member))

    try:
        wait_for_checkpoint(dispatch, args.wait_for_checkpoint)
    finally:
        if server is not None:
            server.close()


if __name__ == "__main__":
    main()
