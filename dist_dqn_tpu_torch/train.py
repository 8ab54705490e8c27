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
and ``network.actor_dtype`` as the JAX CLI does; on a recurrent config
they print the JAX CLI's warning and are ignored, as there. (The
recurrent loop reads no ``network.actor_dtype``; a ``--set`` of it trains
in float32.) ``replay.frame_dedup`` rides ``--set``.

``--checkpoint-dir D`` saves the learner every ``--save-every-frames``
(default: the eval period, else 100,000) and at the end, and resumes from
the newest step in ``D`` when relaunched, continuing toward the same
total; ``--checkpoint-replay`` saves and resumes the whole fused carry
instead, bit-equal to a run that never stopped (utils/checkpoint.py).
``--stop-at-return R`` ends the run once ``eval_return`` reaches R.

``--population M --population-spec JSON`` trains M policies as one
program (population.py): each member with its own seed stream and its own
``epsilon``/``lr``/``gamma`` from the spec. The frame cursor and
``--total-env-steps`` count per member; ``env_steps_per_sec`` and
``grad_steps_per_sec`` are the aggregate over the members, and the rows
add ``population``, ``loss_members``, ``grad_steps_per_sec_member`` and
``eval_return_members``. Checkpoints hold the stacked tree and a
``POPULATION`` width marker. ``--population 1`` with a spec runs the plain
program with member 0's overrides applied. On a recurrent config the flag
prints the JAX CLI's warning and is ignored, as there.

``--runtime host-replay`` runs the host-replay runtime instead
(host_replay_loop.py): the replay window in host DRAM, collect chunks
evacuated to it through a background worker, batches prefetched to the
card, uniform or (``--per``) prioritized sampling through a host sum-tree
or (``--device-sampling``) a priority plane on the card; it prints the
JAX loop's per-chunk rows and its summary. ``--no-pipeline``,
``--evac-slices``, ``--no-prefetch``, ``--prefetch-depth`` and
``--no-double-buffer`` select its serial references and depths; under the
fused runtime they print the JAX CLI's "ignored" lines.

``--runtime apex`` runs the Ape-X actor/learner split instead
(actors/service.py): ``--num-actors`` actor processes step
``--envs-per-actor`` host envs each (``--host-env``: a gymnasium name such
as CartPole-v1, ``pong``, ``breakout`` or ``synthstack``) and stream their
records through shared memory to the learner service, which acts for them
in one batched call per pass and trains from the host PER shard
(``--device-sampling``: its priority plane on the card, drawn through the
sampler kernel). Insertion priorities come from the actors' q planes, or
with ``--no-actor-priorities`` (or ``--transport legacy``) from the
learner-side bootstrap on the card over the C++ n-step assembler. A
recurrent config (``--config r2d2``) assembles sequences with the act's
carries. ``--num-remote-actors`` adds TCP actors: spawned locally, or with
``--remote-actor-mode external`` left for workers started with ``python -m
dist_dqn_tpu_torch.actors.remote`` against ``--tcp-port``.
``--checkpoint-replay`` with ``--checkpoint-dir`` snapshots the replay
shard beside the learner checkpoint, and a resumed run starts from it warm.
A non-pixel host env swaps the config's torso for the MLP, as the JAX CLI
does; the summary prints as JSON. ``--host-env feeder:pixel`` or
``feeder:vector`` replaces the actors with feeder processes that pump
pre-encoded records (``--shm-batch N``: N records per slot publish), and
``DQN_FAKE_ALE=1`` routes ``ale:`` names to the in-repo fake ALE.
``--no-wire-dedup`` is the JAX CLI's.

Meshes, telemetry, and the options of the apex runtime that are not ported
yet (several learner devices or replay shards) raise instead of being
ignored.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import torch
from torch.autograd import DeviceType

from dist_dqn_tpu_torch import population as pop
from dist_dqn_tpu_torch.config import CONFIGS, ExperimentConfig, \
    apply_overrides
from dist_dqn_tpu_torch.envs import make_env
from dist_dqn_tpu_torch.models import build_network, stack_networks
from dist_dqn_tpu_torch.r2d2_loop import make_r2d2_evaluator, make_r2d2_train
from dist_dqn_tpu_torch.train_loop import make_evaluator, make_fused_train
from dist_dqn_tpu_torch.utils.checkpoint import (TrainCheckpointer,
                                                record_checkpoint_kind,
                                                record_population_size)
from dist_dqn_tpu_torch.utils.device import resolve_device


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
          profile_dir: str = None, profile_chunk: int = None,
          checkpoint_dir: str = None, save_every_frames: int = 0,
          checkpoint_replay: bool = False):
    """Run training on ``device`` (default: the card); returns
    (final_carry, history list of metric rows).

    ``stop_fn(row)`` may end the run early at a chunk boundary.
    ``profile_dir`` traces one chunk: ``profile_chunk`` (0-based), by
    default the second, or the only one. ``checkpoint_dir`` saves the
    learner (with ``checkpoint_replay``, the whole carry) every
    ``save_every_frames`` and at the end, and resumes from its newest
    step: toward the same total, so relaunching a finished run trains
    nothing. ``population.size`` M > 1 trains M members as one program
    (:func:`_train_population`); M = 1 with a spec applies member 0's
    overrides to the plain program.
    """
    dev = resolve_device(device)
    if cfg.population.size > 1:
        return _train_population(
            cfg, total_env_steps=total_env_steps, seed=seed,
            chunk_iters=chunk_iters, log_fn=log_fn, device=dev,
            stop_fn=stop_fn, profile_dir=profile_dir,
            profile_chunk=profile_chunk, checkpoint_dir=checkpoint_dir,
            save_every_frames=save_every_frames,
            checkpoint_replay=checkpoint_replay)
    if cfg.population.spec_json:
        cfg = pop.member_config(cfg, pop.resolve_spec(cfg), 0)
    seed = cfg.seed if seed is None else seed
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
    ckpt = _checkpointer(checkpoint_dir, save_every_frames, cfg,
                         checkpoint_replay)
    return _chunk_loop(cfg, init(seed), run_chunk, evaluate, eval_gen, ckpt,
                       total_env_steps or cfg.total_env_steps, chunk_iters,
                       log_fn, dev, stop_fn, profile_dir, profile_chunk,
                       checkpoint_replay)


def _train_population(cfg: ExperimentConfig, total_env_steps: int = 0,
                      seed: int = None, chunk_iters: int = 2000,
                      log_fn=print, device=None, stop_fn=None,
                      profile_dir: str = None, profile_chunk: int = None,
                      checkpoint_dir: str = None, save_every_frames: int = 0,
                      checkpoint_replay: bool = False):
    """The population twin of :func:`train` (dist_dqn_tpu/train.py:423-720,
    without the telemetry registry): M members advance as one program.

    Member k is the solo run of ``population.member_config(cfg, spec, k)``
    seeded with ``population.member_seeds(seed, M)[k]``: its net's weights,
    its loop's generators and its evaluation generator are those that run
    builds. The frame cursor (and ``total_env_steps``) is per member; the
    rate columns are the aggregate over the members. Checkpoints hold the
    [M]-stacked tree plus a ``POPULATION`` width marker, and a resume at
    another width is refused with the cause.
    """
    dev = resolve_device(device)
    M = cfg.population.size
    if cfg.network.lstm_size:
        raise ValueError(
            "--population is not supported by the recurrent (R2D2) fused "
            "loop yet (its sequence learner has no member axis)")
    pop.resolve_spec(cfg)
    seed = cfg.seed if seed is None else seed
    ckpt = _checkpointer(checkpoint_dir, save_every_frames, cfg,
                         checkpoint_replay)
    seeds = pop.member_seeds(seed, M)
    env = make_env(cfg.env_name, device=dev)
    net = stack_networks([build_network(cfg.network, env.num_actions,
                                        env.observation_shape, device=dev,
                                        seed=s) for s in seeds])
    init, run_chunk = pop.make_population_train(cfg, env, net, device=dev)
    evaluate = make_evaluator(cfg, env, num_episodes=cfg.eval_episodes)
    eval_gens = [torch.Generator(device=dev).manual_seed(s + 1)
                 for s in seeds]
    return _chunk_loop(cfg, init(seeds), run_chunk, evaluate, eval_gens,
                       ckpt, total_env_steps or cfg.total_env_steps,
                       chunk_iters, log_fn, dev, stop_fn, profile_dir,
                       profile_chunk, checkpoint_replay, members=M)


def _checkpointer(checkpoint_dir, save_every_frames, cfg, checkpoint_replay):
    """The run's checkpointer, or None; stamps the directory's kind (and a
    population's width), raising with the cause where the directory holds
    another."""
    if not checkpoint_dir:
        return None
    # The cadence never bottoms out at 0 (--eval-every-steps 0 zeroes the
    # eval period): that would save on every chunk.
    ckpt = TrainCheckpointer(
        checkpoint_dir,
        save_every_frames=save_every_frames or cfg.eval_every_steps
        or 100_000)
    record_checkpoint_kind(checkpoint_dir,
                           "carry" if checkpoint_replay else "learner")
    if cfg.population.size > 1:
        record_population_size(checkpoint_dir, cfg.population.size)
    return ckpt


def _chunk_loop(cfg, carry, run_chunk, evaluate, eval_gen, ckpt, total,
                chunk_iters, log_fn, dev, stop_fn, profile_dir, profile_chunk,
                checkpoint_replay, members: int = 0):
    """Resume from ``ckpt``, then run chunks until the frame cursor reaches
    ``total``, logging one row per chunk; returns (carry, history).
    ``members`` > 0: a population's [M] metrics and rows."""
    frames = 0            # the loop's frame cursor (per member)
    frame_offset = 0      # added to the carry's own frame count
    if ckpt is not None:
        restored = ckpt.restore_latest(
            carry if checkpoint_replay else carry.learner)
        if restored is not None:
            frames, tree = restored
            resumed = {"resumed_at_frames": frames,
                       "with_replay": checkpoint_replay}
            if members:
                resumed["population"] = members
            log_fn(json.dumps(resumed))
            log_fn(json.dumps(_checkpoint_row("restore", ckpt.last_restore)))
            if checkpoint_replay:
                # The carry's own iteration counter came back with it, so
                # env_frames already continues from the checkpoint.
                carry = tree
            else:
                # A fresh carry around the restored learner: the ring
                # refills, the exploration schedule starts over.
                carry.learner = tree
                frame_offset = frames

    def save_tree():
        return carry if checkpoint_replay else carry.learner

    B = cfg.actor.num_envs
    history = []
    # 0 disables eval entirely; otherwise the first chunk gets a baseline.
    next_eval = frames if cfg.eval_every_steps else float("inf")
    # Trace the second chunk (the first pays one-time set-up), unless the
    # whole run is one chunk.
    if profile_chunk is None:
        profile_chunk = 1 if total > frames + chunk_iters * B else 0
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
        frames = frame_offset + metrics["env_frames"]
        grad_steps = float(metrics["grad_steps_in_chunk"])
        if members:
            row = _population_row(members, frames, ep_ret, episodes, loss,
                                  chunk_iters * B, grad_steps, dt)
        else:
            row = {
                "env_frames": frames,
                "episode_return": ep_ret,
                # Disambiguates episode_return's no-episodes sentinel (0.0
                # with episodes == 0) from a genuine 0.0 average return.
                "episodes": episodes,
                "loss": loss,
                "env_steps_per_sec": chunk_iters * B / dt,
                "grad_steps_in_chunk": grad_steps,
                "grad_steps_per_sec": grad_steps / dt,
            }
        if frames >= next_eval:
            returns = evaluate(carry.learner.net, eval_gen).tolist()
            if members:
                row["eval_return_members"] = returns
                returns = sum(returns) / members
            row["eval_return"] = returns
            next_eval = frames + cfg.eval_every_steps
        history.append(row)
        log_fn(json.dumps({k: _rounded(v) for k, v in row.items()}))
        if ckpt is not None and ckpt.maybe_save(frames, save_tree()):
            log_fn(json.dumps(_checkpoint_row("save", ckpt.last_save)))
        if stop_fn is not None and stop_fn(row):
            break
    if ckpt is not None and ckpt.save(frames, save_tree()):
        log_fn(json.dumps(_checkpoint_row("save", ckpt.last_save)))
    return carry, history


def _population_row(members, frames, ep_ret, episodes, loss, frames_chunk,
                    grad_steps, dt) -> dict:
    """A population chunk's row (dist_dqn_tpu/train.py:661-674): per-member
    lists beside their means; rates are the aggregate over the members."""
    with_episodes = [r for r, n in zip(ep_ret, episodes) if n > 0]
    return {
        "env_frames": frames,
        "population": members,
        "episode_return": (sum(with_episodes) / len(with_episodes)
                           if with_episodes else 0.0),
        "episodes": sum(episodes),
        "loss": sum(loss) / members,
        "loss_members": loss,
        "env_steps_per_sec": members * frames_chunk / dt,
        "grad_steps_in_chunk": grad_steps,
        "grad_steps_per_sec": members * grad_steps / dt,
        "grad_steps_per_sec_member": grad_steps / dt,
    }


def _rounded(v):
    if isinstance(v, float):
        return round(v, 3)
    if isinstance(v, list):
        return [round(x, 3) if isinstance(x, float) else x for x in v]
    return v


def _checkpoint_row(what: str, record: dict) -> dict:
    """The log row of one checkpoint save or restore: its step, seconds
    and file bytes."""
    return {f"checkpoint_{what}_at_frames": record["step"],
            f"checkpoint_{what}_s": record["seconds"],
            "checkpoint_bytes": record["bytes"]}


def _refuse_unported(args) -> None:
    """Flags of the JAX CLI this port does not implement yet."""
    refused = [flag for flag, given in (
        ("--mesh-devices", args.mesh_devices != 1 and args.runtime != "apex"),
        ("--telemetry-port", args.telemetry_port is not None),
    ) if given]
    if refused:
        raise SystemExit(
            f"not ported yet: {', '.join(refused)} — the PyTorch port runs "
            "on one device only (ROADMAP.md A6, A10)")


def _main_apex(cfg: ExperimentConfig, args, parser) -> None:
    """``--runtime apex`` (dist_dqn_tpu/train.py:1225-1286): the JAX CLI's
    lines for the flags this runtime ignores, the MLP torso for a
    non-pixel host env, then the service and its summary."""
    from dist_dqn_tpu_torch.actors.service import (ApexLearnerService,
                                                   ApexRuntimeConfig)
    from dist_dqn_tpu_torch.envs.gym_adapter import is_pixel_env

    if args.mesh_devices != 1:
        print("# --mesh-devices applies to the fused/host-replay "
              "runtimes; use --learner-devices for apex batch "
              "sharding")
    if args.stop_at_return is not None:
        print("# --stop-at-return applies to the fused runtime only; "
              "ignored under --runtime apex")
    if args.no_double_buffer:
        print("# --no-double-buffer applies to --runtime host-replay "
              "only; the apex service staging knob is "
              "ApexRuntimeConfig.stage_depth — ignored")
    if args.no_pipeline \
            or args.evac_slices != parser.get_default("evac_slices"):
        print("# --no-pipeline/--evac-slices apply to --runtime "
              "host-replay only; ignored under --runtime apex")
    if args.no_prefetch or args.per \
            or args.prefetch_depth != parser.get_default(
                "prefetch_depth"):
        print("# --no-prefetch/--prefetch-depth/--per apply to "
              "--runtime host-replay only; the apex service is "
              "always prioritized and staged via "
              "ApexRuntimeConfig — ignored")
    if not is_pixel_env(args.host_env):
        # Non-pixel host env: the config's Nature-CNN torso can't eat
        # flat observations — swap in the MLP torso, keep the rest.
        print(f"# host env {args.host_env} is non-pixel: using MLP torso")
        cfg = dataclasses.replace(
            cfg, network=dataclasses.replace(
                cfg.network, torso="mlp", compute_dtype="float32"))
    rt = ApexRuntimeConfig(
        host_env=args.host_env, num_actors=args.num_actors,
        envs_per_actor=args.envs_per_actor,
        total_env_steps=args.total_env_steps or cfg.total_env_steps,
        checkpoint_dir=args.checkpoint_dir,
        checkpoint_replay=args.checkpoint_replay,
        save_every_steps=(args.save_every_frames or cfg.eval_every_steps
                          or 100_000),
        eval_every_steps=(args.eval_every_steps
                          if args.eval_every_steps is not None else 0),
        eval_episodes=cfg.eval_episodes,
        tcp_port=args.tcp_port,
        num_remote_actors=args.num_remote_actors,
        spawn_remote_actors=args.remote_actor_mode == "local",
        learner_devices=args.learner_devices,
        device_sampling=args.device_sampling,
        transport=args.transport,
        actor_priorities=not args.no_actor_priorities,
        ingest_shards=args.ingest_shards,
        wire_dedup=not args.no_wire_dedup,
        shm_batch=args.shm_batch,
        shard_sampling=args.shard_sampling,
        profile_dir=args.profile_dir)
    try:
        service = ApexLearnerService(cfg, rt, device=args.device)
    except NotImplementedError as e:
        raise SystemExit(str(e)) from e
    print(json.dumps(service.run()))


def _main_host_replay(cfg: ExperimentConfig, args) -> None:
    """``--runtime host-replay`` (dist_dqn_tpu/train.py:1160-1229): the
    JAX CLI's lines for the flags this runtime ignores, then the run and
    its summary."""
    from dist_dqn_tpu_torch.host_replay_loop import run_host_replay

    if args.stop_at_return is not None:
        print("# --stop-at-return is not supported by --runtime "
              "host-replay (prototype surface); ignored")
    if args.checkpoint_replay:
        print("# --checkpoint-replay is implied by --runtime "
              "host-replay --checkpoint-dir: its checkpoints are "
              "always whole-state (per-shard rings + PER sampler "
              "state + carry + learner) so resume is bit-identical "
              "at any --mesh-devices width; flag ignored")
    if args.save_every_frames and not args.checkpoint_dir:
        print("# --save-every-frames does nothing without "
              "--checkpoint-dir; ignored")
    if args.eval_every_steps:
        print("# periodic eval is not supported by --runtime "
              "host-replay; ignored")
    if args.seed is not None:
        cfg = dataclasses.replace(cfg, seed=args.seed)
    out = run_host_replay(
        cfg, total_env_steps=args.total_env_steps or cfg.total_env_steps,
        chunk_iters=args.chunk_iters, log_fn=print,
        double_buffer=not args.no_double_buffer,
        pipeline=not args.no_pipeline,
        evac_slices=args.evac_slices,
        prefetch=not args.no_prefetch,
        prefetch_depth=args.prefetch_depth,
        # None follows cfg.replay.prioritized; --per forces it on.
        prioritized=True if args.per else None,
        checkpoint_dir=args.checkpoint_dir,
        save_every_frames=args.save_every_frames,
        mesh_devices=args.mesh_devices,
        device_sampling=args.device_sampling,
        profile_dir=args.profile_dir, device=args.device)
    out.pop("history", None)
    out.pop("learner", None)
    print(json.dumps(out))


def _warn_host_replay_flags(args, parser) -> None:
    """The JAX CLI's lines for apex and host-replay flags under the fused
    runtime (dist_dqn_tpu/train.py:1287-1314), which ignores them."""
    if args.transport != parser.get_default("transport") \
            or args.no_actor_priorities \
            or args.ingest_shards != parser.get_default("ingest_shards") \
            or args.no_wire_dedup or args.shard_sampling \
            or args.shm_batch != parser.get_default("shm_batch"):
        print("# --transport/--no-actor-priorities/--ingest-shards/"
              "--no-wire-dedup/--shm-batch/--shard-sampling apply "
              "to --runtime apex only (the fused/host-replay runtimes "
              "have no actor transport); ignored")
    if args.no_double_buffer:
        print("# --no-double-buffer applies to --runtime host-replay only; "
              "ignored under the fused runtime (its replay never leaves "
              "the device)")
    if args.no_pipeline \
            or args.evac_slices != parser.get_default("evac_slices"):
        print("# --no-pipeline/--evac-slices apply to --runtime "
              "host-replay only; ignored under the fused runtime (its "
              "replay never leaves the device)")
    if args.no_prefetch or args.per \
            or args.prefetch_depth != parser.get_default("prefetch_depth"):
        print("# --no-prefetch/--prefetch-depth/--per apply to "
              "--runtime host-replay only; ignored under the fused "
              "runtime (its replay samples on device — "
              "replay.prioritized selects the device sampler there)")
    if args.device_sampling:
        print("# --device-sampling applies to the apex/host-replay "
              "runtimes; ignored under the fused runtime (its replay "
              "is device-resident already)")


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
    parser.add_argument("--checkpoint-dir", default=None,
                        help="save checkpoints here and resume from the "
                             "newest one when relaunched")
    parser.add_argument("--save-every-frames", type=int, default=0,
                        help="checkpoint period in env frames (default: "
                             "eval_every_steps, else 100,000)")
    parser.add_argument("--checkpoint-replay", action="store_true",
                        help="checkpoint the whole fused carry (ring, env "
                             "states, generators): the resumed run is "
                             "bit-equal to an uninterrupted one; under "
                             "--runtime apex, snapshot the replay shard "
                             "beside the learner and resume it warm")
    parser.add_argument("--stop-at-return", type=float, default=None,
                        help="stop early once eval_return reaches this "
                             "value (e.g. 475 = CartPole solved)")
    parser.add_argument("--population", type=int, default=None,
                        help="train M policies as one program "
                             "(population.size)")
    parser.add_argument("--population-spec", default=None, metavar="JSON",
                        help="per-member vectors: an object with any of "
                             "epsilon, lr, gamma, each of length M")
    parser.add_argument("--no-double-buffer", action="store_true",
                        help="--runtime host-replay only: sample -> upload "
                             "-> train serially instead of through the "
                             "double-buffered H2D staging (the "
                             "numerically identical reference)")
    parser.add_argument("--no-pipeline", action="store_true",
                        help="--runtime host-replay only: evacuate each "
                             "chunk with one blocking fetch instead of the "
                             "streamed background evacuation (the "
                             "numerically identical serial reference)")
    parser.add_argument("--evac-slices", type=int, default=4,
                        help="--runtime host-replay only: time slices each "
                             "chunk's D2H evacuation streams through. "
                             "Ignored under --no-pipeline")
    parser.add_argument("--no-prefetch", action="store_true",
                        help="--runtime host-replay only: sample train "
                             "batches on the main thread instead of the "
                             "background prefetcher (bit-identical under a "
                             "fixed seed in uniform mode)")
    parser.add_argument("--prefetch-depth", type=int, default=2,
                        help="--runtime host-replay only: batches the "
                             "prefetcher may stage ahead of the learner. "
                             "Ignored under --no-prefetch")
    parser.add_argument("--per", action="store_true",
                        help="--runtime host-replay only: force "
                             "prioritized sampling with IS weights and "
                             "batched TD-error write-backs (presets with "
                             "replay.prioritized=True enable it)")
    parser.add_argument("--device-sampling", action="store_true",
                        help="sample priorities from a plane on the card "
                             "(the sampler kernel at >= 100,000 cells): "
                             "the apex runtime's replay shard, or "
                             "--runtime host-replay with --per, instead "
                             "of the host sum-tree")
    parser.add_argument("--runtime", default="fused",
                        choices=("fused", "apex", "host-replay"),
                        help="fused: the on-device loop; host-replay: the "
                             "replay window in host DRAM; apex: actor "
                             "processes + the learner service over shared "
                             "memory (host envs)")
    parser.add_argument("--host-env", default="CartPole-v1",
                        help="apex runtime: host env actors step "
                             "(e.g. CartPole-v1, pong, breakout)")
    parser.add_argument("--num-actors", type=int, default=4)
    parser.add_argument("--envs-per-actor", type=int, default=8)
    parser.add_argument("--transport", choices=("zerocopy", "legacy"),
                        default="zerocopy",
                        help="apex runtime experience path: zerocopy = "
                             "schema-negotiated raw-array records through "
                             "shared-memory slot rings with actor-shipped "
                             "priorities; legacy = the JSON-header codec "
                             "with the learner-side bootstrap")
    parser.add_argument("--no-wire-dedup", action="store_true",
                        help="apex runtime: actors on frame-stacked pixel "
                             "envs ship full stacks instead of each frame "
                             "once")
    parser.add_argument("--shm-batch", type=int, default=1,
                        help="apex runtime: feeder processes "
                             "(--host-env feeder:pixel|feeder:vector) put "
                             "this many step records into one shared-"
                             "memory slot publish; 1 = one record per "
                             "publish; rollout actors are lock-step and "
                             "unaffected")
    parser.add_argument("--num-remote-actors", type=int, default=0,
                        help="apex runtime: remote (TCP) actor slots")
    parser.add_argument("--tcp-port", type=int, default=None,
                        help="apex runtime: listen for remote actors "
                             "(actors/remote.py) on this port on every "
                             "interface; 0 = an ephemeral port. Without "
                             "it, remote actors use an ephemeral loopback "
                             "port (logged as tcp_address)")
    parser.add_argument("--remote-actor-mode", choices=("local", "external"),
                        default="local",
                        help="local: the service spawns its remote actors "
                             "as local processes; external: it waits for "
                             "workers started with python -m "
                             "dist_dqn_tpu_torch.actors.remote")
    parser.add_argument("--no-actor-priorities", action="store_true",
                        help="apex runtime: seed insertion priorities with "
                             "the learner-side bootstrap on the card "
                             "instead of the actors' q planes")
    # Flags of the JAX CLI that are not ported: accepted only to be refused
    # with a reason, never ignored.
    parser.add_argument("--mesh-devices", type=int, default=1)
    parser.add_argument("--telemetry-port", type=int, default=None)
    parser.add_argument("--learner-devices", type=int, default=1)
    parser.add_argument("--ingest-shards", type=int, default=1)
    parser.add_argument("--shard-sampling", action="store_true")
    args = parser.parse_args(argv)

    cfg = apply_overrides(CONFIGS[args.config], args.overrides)
    _refuse_unported(args)
    if args.eval_every_steps is not None:
        cfg = dataclasses.replace(cfg, eval_every_steps=args.eval_every_steps)
    # The learner-utilization knobs, with the JAX CLI's ignored-flag
    # warnings on a recurrent config of the fused runtime.
    recurrent = bool(cfg.network.lstm_size) and args.runtime == "fused"
    if args.replay_ratio is not None:
        if recurrent:
            print("# --replay-ratio is not supported by the recurrent "
                  "(R2D2) fused loop yet (its sequence learner has no "
                  "scan-ratio path); ignored")
        else:
            cfg = dataclasses.replace(cfg, replay=dataclasses.replace(
                cfg.replay, updates_per_chunk=args.replay_ratio))
    if args.actor_dtype is not None:
        if args.runtime == "apex":
            print("# --actor-dtype applies to the fused/host-replay "
                  "runtimes only; the apex service acts on the live "
                  "learner params — ignored")
        elif recurrent:
            print("# --actor-dtype is not supported by the recurrent "
                  "(R2D2) fused loop yet; ignored")
        else:
            cfg = dataclasses.replace(cfg, network=dataclasses.replace(
                cfg.network, actor_dtype=args.actor_dtype))
    # The population plane, with the JAX CLI's checks
    # (dist_dqn_tpu/train.py:1110-1146).
    if args.population is not None or args.population_spec is not None:
        if args.population is not None and args.population < 1:
            parser.error(f"--population must be >= 1, got "
                         f"{args.population}")
        if args.runtime != "fused":
            print("# --population/--population-spec apply to the fused "
                  "runtime only (the apex/host-replay runtimes have no "
                  "stacked-member plane yet); ignored")
        elif recurrent:
            print("# --population is not supported by the recurrent "
                  "(R2D2) fused loop yet (its sequence learner has no "
                  "member axis); ignored")
        else:
            cfg = dataclasses.replace(cfg, population=dataclasses.replace(
                cfg.population,
                size=(args.population if args.population is not None
                      else cfg.population.size),
                spec_json=(args.population_spec
                           if args.population_spec is not None
                           else cfg.population.spec_json)))
            try:
                pop.resolve_spec(cfg)
            except ValueError as e:
                parser.error(str(e))
    if args.runtime == "host-replay":
        _main_host_replay(cfg, args)
        return
    if args.runtime == "apex":
        _main_apex(cfg, args, parser)
        return
    _warn_host_replay_flags(args, parser)
    stop_fn = None
    if args.stop_at_return is not None:
        target = args.stop_at_return
        stop_fn = lambda row: row.get("eval_return",  # noqa: E731
                                      -float("inf")) >= target
    train(cfg, total_env_steps=args.total_env_steps, seed=args.seed,
          chunk_iters=args.chunk_iters, device=args.device, stop_fn=stop_fn,
          profile_dir=args.profile_dir, profile_chunk=args.profile_chunk,
          checkpoint_dir=args.checkpoint_dir,
          save_every_frames=args.save_every_frames,
          checkpoint_replay=args.checkpoint_replay)


if __name__ == "__main__":
    main()
