"""Training entrypoint of the port: ``python -m dist_dqn_tpu_torch.train
--config apex`` (or ``--config r2d2``).

The fused single-device branch of ``dist_dqn_tpu/train.py``: picks a
preset, builds the env / network / learner on the card, runs the fused
loop chunk by chunk with periodic greedy evaluation (train_loop.py, or
r2d2_loop.py for a recurrent network, ``network.lstm_size > 0``), and
prints one JSON row per chunk with the same keys as the JAX package
(``env_frames``, ``episode_return``, ``episodes``, ``loss``,
``env_steps_per_sec``, ``grad_steps_in_chunk``, ``grad_steps_per_sec``,
and ``eval_return`` on the eval cadence). ``--profile-dir`` traces one
chunk (the second, or ``--profile-chunk``) with ``torch.profiler``, as the
JAX CLI's flag does with ``jax.profiler``.

Runs on ``cuda`` unless ``--device cpu`` / ``device="cpu"`` is given.
``--replay-ratio N`` and ``--actor-dtype`` set ``replay.updates_per_chunk``
and ``network.actor_dtype`` as the JAX CLI does; ``replay.frame_dedup``
rides ``--set``. Checkpointing, meshes, populations, telemetry and the
other runtimes are not ported yet; asking for any of them raises instead
of being ignored. Recurrent configs refuse the replay ratio and the bf16
actor (and populations), where the JAX CLI warns and ignores them.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import torch
from torch.autograd import DeviceType

from dist_dqn_tpu_torch.config import CONFIGS, ExperimentConfig, \
    apply_overrides
from dist_dqn_tpu_torch.envs import make_env
from dist_dqn_tpu_torch.models import build_network
from dist_dqn_tpu_torch.r2d2_loop import make_r2d2_evaluator, make_r2d2_train
from dist_dqn_tpu_torch.train_loop import make_evaluator, make_fused_train
from dist_dqn_tpu_torch.utils.device import resolve_device


def check_ported(cfg: ExperimentConfig) -> None:
    """Refuse config features the port does not implement yet (the
    network, learner and env constructors refuse theirs)."""
    refused = []
    if cfg.population.size > 1 or cfg.population.spec_json:
        refused.append("population")
    if cfg.network.lstm_size and cfg.network.actor_dtype not in ("",
                                                                 "float32"):
        # Neither package's recurrent loop has the bf16 actor split.
        refused.append(f"network.actor_dtype={cfg.network.actor_dtype} "
                       "for a recurrent config")
    if refused:
        raise NotImplementedError(
            f"not ported yet: {', '.join(refused)} (ROADMAP.md lists the "
            "slices that bring them)")


def _device_spans(prof):
    """(start, end) of every device event (kernel, copy, memset) the
    profiler saw, sorted by start."""
    return sorted((e.time_range.start, e.time_range.end)
                  for e in prof.events() if e.device_type == DeviceType.CUDA)


def _busy_seconds(prof) -> float:
    """Seconds in which at least one kernel the profiler saw was running
    (the union of the kernels' intervals); 0.0 when it saw none."""
    spans = _device_spans(prof)
    busy_us, reach = 0.0, float("-inf")
    for start, end in spans:      # sorted by start: count only new time
        busy_us += max(0.0, end - max(start, reach))
        reach = max(reach, end)
    return busy_us / 1e6


def _write_profile(prof, profile_dir: str, wall_s: float, on_card: bool
                   ) -> dict:
    """Chrome trace + per-op table of one profiled chunk, and its summary
    row: the chunk's wall time and, on the card, the device busy share and
    the number of device events (kernels, copies, memsets)."""
    os.makedirs(profile_dir, exist_ok=True)
    trace = os.path.join(profile_dir, "trace.json")
    prof.export_chrome_trace(trace)
    sort_by = "self_device_time_total" if on_card else "self_cpu_time_total"
    with open(os.path.join(profile_dir, "ops.txt"), "w") as f:
        f.write(prof.key_averages().table(sort_by=sort_by, row_limit=-1))
    row = {"profile_trace": trace, "profile_wall_s": wall_s}
    if on_card:
        busy = _busy_seconds(prof)
        row.update(device_busy_s=busy, device_busy_share=busy / wall_s,
                   device_events=len(_device_spans(prof)))
    return row


def train(cfg: ExperimentConfig, total_env_steps: int = 0, seed: int = None,
          chunk_iters: int = 2000, log_fn=print, device=None, stop_fn=None,
          profile_dir: str = None, profile_chunk: int = None):
    """Run training on ``device`` (default: the card); returns
    (final_carry, history list of metric rows).

    ``stop_fn(row)`` may end the run early at a chunk boundary.
    ``profile_dir`` traces one chunk: ``profile_chunk`` (0-based), by
    default the second, or the only one.
    """
    dev = resolve_device(device)
    check_ported(cfg)
    seed = cfg.seed if seed is None else seed
    total = total_env_steps or cfg.total_env_steps
    env = make_env(cfg.env_name, device=dev)
    net = build_network(cfg.network, env.num_actions, env.observation_shape,
                        device=dev, seed=seed)
    if cfg.network.lstm_size:
        init, run_chunk = make_r2d2_train(cfg, env, net, device=dev)
        evaluate = make_r2d2_evaluator(cfg, env,
                                       num_episodes=cfg.eval_episodes)
    else:
        init, run_chunk = make_fused_train(cfg, env, net, device=dev)
        evaluate = make_evaluator(cfg, env, num_episodes=cfg.eval_episodes)
    eval_gen = torch.Generator(device=dev).manual_seed(seed + 1)
    carry = init(seed)

    B = cfg.actor.num_envs
    history = []
    frames = 0
    # 0 disables eval entirely; otherwise the first chunk gets a baseline.
    next_eval = frames if cfg.eval_every_steps else float("inf")
    # Trace the second chunk (the first pays one-time set-up), unless the
    # whole run is one chunk.
    if profile_chunk is None:
        profile_chunk = 1 if total > chunk_iters * B else 0
    on_card = dev.type == "cuda"
    chunk_index = 0
    while frames < total:
        prof = None
        if profile_dir is not None and chunk_index == profile_chunk:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if on_card:
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=activities)
            prof.start()
        t0 = time.perf_counter()
        carry, metrics = run_chunk(carry, chunk_iters)
        # One read of the chunk's device accumulators: the chunk fence.
        ep_ret, episodes, loss = torch.stack(
            [metrics["episode_return"], metrics["episodes"],
             metrics["loss"]]).tolist()
        dt = time.perf_counter() - t0
        if prof is not None:
            prof.stop()
            log_fn(json.dumps(_write_profile(prof, profile_dir, dt,
                                             on_card)))
        chunk_index += 1
        frames = metrics["env_frames"]
        grad_steps = float(metrics["grad_steps_in_chunk"])
        row = {
            "env_frames": frames,
            "episode_return": ep_ret,
            # Disambiguates episode_return's no-episodes sentinel (0.0 with
            # episodes == 0) from a genuine 0.0 average return.
            "episodes": episodes,
            "loss": loss,
            "env_steps_per_sec": chunk_iters * B / dt,
            "grad_steps_in_chunk": grad_steps,
            "grad_steps_per_sec": grad_steps / dt,
        }
        if frames >= next_eval:
            row["eval_return"] = float(evaluate(carry.learner.net, eval_gen))
            next_eval = frames + cfg.eval_every_steps
        history.append(row)
        log_fn(json.dumps({k: round(v, 3) if isinstance(v, float) else v
                           for k, v in row.items()}))
        if stop_fn is not None and stop_fn(row):
            break
    return carry, history


def _refuse_unported(args, cfg: ExperimentConfig) -> None:
    """Flags of the JAX CLI this port does not implement yet, and the two
    learner-utilization flags on recurrent configs (where the JAX CLI warns
    and ignores them)."""
    recurrent = bool(cfg.network.lstm_size)
    refused = [flag for flag, given in (
        ("--checkpoint-dir", args.checkpoint_dir is not None),
        ("--checkpoint-replay", args.checkpoint_replay),
        ("--save-every-frames", bool(args.save_every_frames)),
        ("--mesh-devices", args.mesh_devices != 1),
        ("--population", args.population not in (None, 1)),
        ("--population-spec", args.population_spec is not None),
        ("--runtime", args.runtime != "fused"),
        ("--replay-ratio for a recurrent config",
         recurrent and args.replay_ratio not in (None, 1)),
        ("--actor-dtype for a recurrent config",
         recurrent and args.actor_dtype not in (None, "float32")),
        ("--telemetry-port", args.telemetry_port is not None),
    ) if given]
    if refused:
        raise SystemExit(
            f"not ported yet: {', '.join(refused)} — the PyTorch port runs "
            "the fused single-device runtime only, and its recurrent loop "
            "has no replay-ratio scan or bf16 actor split (ROADMAP.md)")


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--config", choices=sorted(CONFIGS), required=True)
    parser.add_argument("--set", dest="overrides", action="append",
                        metavar="PATH=VALUE", default=[],
                        help="override any config field by dotted path, "
                             "repeatable (e.g. --set learner.batch_size=64)")
    parser.add_argument("--total-env-steps", type=int, default=0)
    parser.add_argument("--seed", type=int, default=None)
    parser.add_argument("--chunk-iters", type=int, default=2000)
    parser.add_argument("--eval-every-steps", type=int, default=None,
                        help="override eval_every_steps (0 disables eval)")
    parser.add_argument("--device", choices=("cuda", "cpu"), default=None,
                        help="default: cuda, which must be present")
    parser.add_argument("--profile-dir", default=None,
                        help="write a torch.profiler trace (trace.json) and "
                             "per-op table (ops.txt) of one chunk")
    parser.add_argument("--profile-chunk", type=int, default=None,
                        help="0-based index of the traced chunk (default: "
                             "the second, or the only one)")
    parser.add_argument("--replay-ratio", type=int, default=None,
                        help="grad steps per train event "
                             "(replay.updates_per_chunk)")
    parser.add_argument("--actor-dtype", default=None,
                        choices=("float32", "bfloat16"),
                        help="act on a bf16 snapshot of the online net, "
                             "taken once per chunk (network.actor_dtype)")
    # Flags of the JAX CLI that are not ported: accepted only to be refused
    # with a reason, never ignored.
    parser.add_argument("--checkpoint-dir", default=None)
    parser.add_argument("--checkpoint-replay", action="store_true")
    parser.add_argument("--save-every-frames", type=int, default=0)
    parser.add_argument("--mesh-devices", type=int, default=1)
    parser.add_argument("--population", type=int, default=None)
    parser.add_argument("--population-spec", default=None)
    parser.add_argument("--runtime", default="fused",
                        choices=("fused", "apex", "host-replay"))
    parser.add_argument("--telemetry-port", type=int, default=None)
    args = parser.parse_args(argv)

    cfg = apply_overrides(CONFIGS[args.config], args.overrides)
    _refuse_unported(args, cfg)
    if args.eval_every_steps is not None:
        cfg = dataclasses.replace(cfg, eval_every_steps=args.eval_every_steps)
    if args.replay_ratio is not None:
        cfg = dataclasses.replace(cfg, replay=dataclasses.replace(
            cfg.replay, updates_per_chunk=args.replay_ratio))
    if args.actor_dtype is not None:
        cfg = dataclasses.replace(cfg, network=dataclasses.replace(
            cfg.network, actor_dtype=args.actor_dtype))
    train(cfg, total_env_steps=args.total_env_steps, seed=args.seed,
          chunk_iters=args.chunk_iters, device=args.device,
          profile_dir=args.profile_dir, profile_chunk=args.profile_chunk)


if __name__ == "__main__":
    main()
