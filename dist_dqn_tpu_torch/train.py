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
JAX CLI's flag does with ``jax.profiler``; its row's ``layers`` split the
chunk by the loop's profiler spans (utils/trace.py ``FUSED_SPANS``), and
the utilization ledger files that chunk's measured device-busy time.

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
``--no-wire-dedup`` is the JAX CLI's. ``--ingest-shards N`` splits the
store into N item shards, each actor's stream in its sticky shard (with
``--device-sampling`` one plane per shard), and ``--shard-sampling`` draws
from them in one worker thread per shard. ``--learner-devices N`` makes the
service rank 0 of N learner ranks, one per card (``0``: every card; CPU
ranks over ``gloo`` with ``--device cpu``), each training on its rows of
every batch. ``--coordinator host:port --num-processes P --process-id i``
joins P service processes, one per card, each with its own actors and
store, training in lockstep (actors/multihost.py); rank 0 alone logs rows,
evaluates and saves the learner.

``--mesh-devices N`` trains the fused runtime (R2D2 included) as a
data-parallel mesh of N ranks, one process per device (parallel/): each
rank steps ``num_envs / N`` env lanes into its own replay shard, draws its
own rows of the batch (PER through the sampler kernel on its own plane)
and averages its gradients with the others' in one all-reduce per grad
step, over NCCL on cards (``0`` means every card) or ``gloo`` with
``--device cpu`` (N CPU ranks). ``--coordinator host:port --num-processes
P --process-id i`` joins P such processes, each with its local ranks, into
one mesh numbered process by process. Rank 0 alone logs rows, evaluates,
profiles and reads and writes the learner's checkpoints, and broadcasts
what it resumed from to the other ranks. With ``--checkpoint-replay`` every
rank also writes its own carry shard (``<dir>/rank<r>/``) before rank 0
commits the step, and restores it at the step rank 0 picked; a resume at
another mesh width raises naming both. ``--runtime host-replay
--mesh-devices N`` runs the host-replay runtime's ranks the same way
(host_replay_loop.py); ``--coordinator`` is refused there.

Every runtime records into the process telemetry registry;
``--telemetry-port P`` serves it at ``/metrics`` (also ``/metrics.json``,
``/healthz``, ``/debug/config`` and ``/debug/stacks``; ``0`` binds an
ephemeral port, logged as ``{"telemetry_port": N}``; rank 0 alone under a
mesh), ``--telemetry-host`` picks the bind address and
``--telemetry-snapshot F`` dumps the registry to F at exit or SIGTERM. One
``{"manifest": ...}`` line per run records the git sha, versions, config
and its hash. Every runtime keeps the program table of the chip-time plane
(telemetry/devtime.py: FLOPs, dispatches and device seconds per program,
the utilization ledger, ``dqn_learner_mfu`` on a known card, device
memory), served at ``/debug/profile?seconds=N`` too. ``--trace-path F``
writes the apex runtime's host-loop spans to F as a Chrome trace; the
fused and host-replay runtimes ignore it, as the JAX CLI does.

Crash forensics and the fleet plane (telemetry/watchdog.py, flight.py,
fleet.py): ``--forensics-dir D`` arms the stall watchdog (stage
heartbeats past ``--watchdog-deadline-s``) and the divergence sentinel,
which write forensics bundles under D and flip ``/healthz`` to 503;
``--watchdog-abort`` then saves an emergency checkpoint and ends the run;
``--no-flight-recorder`` turns the in-memory event ring off;
``--fleet-dir F`` announces the process's telemetry endpoint in F for the
aggregator (``python -m dist_dqn_tpu_torch.telemetry.fleet``). Each is
exported through the environment, so spawned actors and ranks follow.

Chaos, sizing and cleanup: ``DQN_CHAOS_PLAN`` (inline JSON or a file
path) arms a fault plan after the manifest line, which it annotates
(``chaos_plan``); spawned actors, feeders and mesh ranks arm their own
copy from the same variable. On the card the fused runtime prints its
predicted wall (``{"sizing_predicted_s": ..., "wall_budget_s": ...}``,
utils/sizing.py) and, with ``--wall-budget-s S``, refuses (exit 4) a run
not predicted to finish inside 60 % of S; the host-replay and apex
runtimes say the flag is not modeled there. A SIGTERM (or a normal exit)
releases the card (utils/device_cleanup.py).
"""
from __future__ import annotations

import argparse
import bisect
import contextlib
import dataclasses
import functools
import json
import os
import sys
import tempfile
import time
from typing import Optional

import numpy as np
import torch
from torch.autograd import DeviceType

from dist_dqn_tpu_torch import loop_common
from dist_dqn_tpu_torch import population as pop
from dist_dqn_tpu_torch import telemetry
from dist_dqn_tpu_torch.config import CONFIGS, ExperimentConfig, \
    apply_overrides
from dist_dqn_tpu_torch.envs import make_env
from dist_dqn_tpu_torch.models import build_network, stack_networks
from dist_dqn_tpu_torch.parallel import distributed
from dist_dqn_tpu_torch.r2d2_loop import make_r2d2_evaluator, make_r2d2_train
from dist_dqn_tpu_torch.telemetry import collectors as tmc
from dist_dqn_tpu_torch.telemetry import watchdog as tm_watchdog
from dist_dqn_tpu_torch.train_loop import make_evaluator, make_fused_train
from dist_dqn_tpu_torch.utils.checkpoint import (RankCarryShards,
                                                TrainCheckpointer,
                                                check_mesh_width,
                                                record_checkpoint_kind,
                                                record_population_size,
                                                save_emergency)
from dist_dqn_tpu_torch.utils.device import resolve_device
from dist_dqn_tpu_torch.utils.trace import FUSED_SPANS

# Why --coordinator cannot carry the host-replay runtime.
HOST_REPLAY_COORDINATOR = (
    "--coordinator with --runtime host-replay: the host-replay mesh is the "
    "local ranks of one process (--mesh-devices N on this machine), whose "
    "shards share one checkpoint sidecar on local disk; the JAX runtime "
    "likewise places every shard's carry from one process. Run it on one "
    "machine with --mesh-devices instead")


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


def _layers(prof, averages, on_card: bool) -> dict:
    """Per fused-loop span (utils/trace.py ``FUSED_SPANS``) the profiler
    saw: its host self ms and, on the card, its device ms, the kernel time
    of every op that starts inside one of its intervals, on any thread
    (autograd launches a backward from its own thread while the caller
    waits in ``learner.backward``). An op's kernels are its own by
    correlation id."""
    intervals = {}
    launched = []          # (start us, self device us) of launching ops
    for e in prof.events():
        if e.name in FUSED_SPANS:
            intervals.setdefault(e.name, []).append(
                (e.time_range.start, e.time_range.end))
        if on_card and e.device_type == DeviceType.CPU:
            own = e.self_device_time_total
            if own > 0:
                launched.append((e.time_range.start, own))
    layers = {avg.key: {"host_self_ms": avg.self_cpu_time_total / 1e3}
              for avg in averages if avg.key in intervals}
    if on_card:
        launched.sort()
        starts = [t for t, _ in launched]
        for name, spans in intervals.items():
            device_us = 0.0
            for start, end in spans:
                lo = bisect.bisect_left(starts, start)
                hi = bisect.bisect_right(starts, end)
                device_us += sum(own for _, own in launched[lo:hi])
            layers[name]["device_ms"] = device_us / 1e3
    return layers


def _write_profile(prof, profile_dir: str, wall_s: float, on_card: bool
                   ) -> dict:
    """Chrome trace + per-op table of one profiled chunk, and its summary
    row: the chunk's wall time, ``layers`` (:func:`_layers`) and, on the
    card, the device busy seconds and share and the number of device
    events (kernels, copies, memsets)."""
    os.makedirs(profile_dir, exist_ok=True)
    trace = os.path.join(profile_dir, "trace.json")
    prof.export_chrome_trace(trace)
    sort_by = "self_device_time_total" if on_card else "self_cpu_time_total"
    averages = prof.key_averages()
    with open(os.path.join(profile_dir, "ops.txt"), "w") as f:
        f.write(averages.table(sort_by=sort_by, row_limit=-1))
    row = {"profile_trace": trace, "profile_wall_s": wall_s,
           "layers": _layers(prof, averages, on_card)}
    if on_card:
        busy = _busy_seconds(prof)
        row.update(device_busy_s=busy, device_busy_share=busy / wall_s,
                   device_events=len(_device_spans(prof)))
    return row


class _FusedTelemetry:
    """The fused loop's registry instruments (dist_dqn_tpu/train.py:99-155),
    or with ``members`` > 0 a population's (:481-515): the shared families
    count aggregate member-steps, and per-member loss and eval gauges sit
    beside them. Every update is host arithmetic on values the chunk's
    one stacked read already brought back."""

    def __init__(self, cfg: ExperimentConfig, members: int = 0):
        reg = telemetry.get_registry()
        fl = {"loop": "fused"}
        self.members = members
        if members:
            reg.gauge(tmc.POPULATION_SIZE,
                      "vmap-stacked members in this run", fl).set(members)
            self.member_loss = [
                reg.gauge(tmc.POPULATION_LOSS,
                          "chunk-mean TD loss per member",
                          {**fl, "member": str(k)}) for k in range(members)]
            self.member_eval = [
                reg.gauge(tmc.POPULATION_EVAL_RETURN,
                          "greedy eval return per member",
                          {**fl, "member": str(k)}) for k in range(members)]
        self.env_steps = reg.counter(tmc.ENV_STEPS, "env frames processed")
        self.env_rate = reg.gauge(tmc.ENV_RATE, "env-steps/sec (last chunk)")
        self.grad_steps = reg.counter(tmc.GRAD_STEPS,
                                      "learner grad steps taken")
        if not members:
            self.grad_latency = reg.histogram(
                tmc.GRAD_LATENCY,
                "per-grad-step share of the fused chunk wall")
            self.staleness = reg.histogram(
                tmc.PARAM_STALENESS,
                "age of the host-visible params at each chunk boundary "
                "(the fused loop refreshes them once per chunk)")
        self.chunk = reg.histogram("dqn_chunk_seconds",
                                   "fused chunk wall time")
        self.loss = reg.gauge("dqn_loss", "chunk-mean TD loss")
        self.episodes = reg.counter("dqn_episodes_completed_total",
                                    "training episodes finished")
        self.ep_return = reg.gauge("dqn_episode_return",
                                   "chunk-mean finished-episode return")
        self.grad_rate = reg.gauge(tmc.LEARNER_GRAD_RATE,
                                   "grad steps per second (last chunk)", fl)
        # The chunk stamps of the fused loop's experience lineage.
        self.lineage = None if members else tmc.FusedLineageTable()
        reg.gauge(tmc.LEARNER_REPLAY_RATIO, "grad sub-steps per train event",
                  fl).set(loop_common.resolve_replay_ratio(cfg))
        reg.gauge(tmc.LEARNER_TRAIN_BATCH,
                  "effective (bucketed) train batch width",
                  fl).set(loop_common.resolve_train_batch(cfg))
        if not members:
            reg.gauge(tmc.LEARNER_ACTOR_DTYPE_INFO,
                      "1 for the active actor inference dtype",
                      {**fl, "dtype": cfg.network.actor_dtype
                       or "float32"}).set(1)
        # The chip-time plane (dist_dqn_tpu/train.py:206-208, :546-548):
        # the chunk is the loop's one train program; its device seconds
        # are the dispatch-to-fence span of each chunk. The ledger files
        # the chunks whose device-busy time a profiler measured.
        self.reg = reg
        self.program = telemetry.register_program(
            "population.chunk" if members else "fused.chunk", loop="fused",
            role="train")
        self.ledger = telemetry.UtilizationLedger("fused", reg)

    def observe_chunk(self, frames_delta: int, dt: float, grad_steps: float,
                      loss, episodes, ep_ret, replay, max_priority,
                      chunk_iters: int) -> None:
        """One chunk boundary: ``grad_steps`` per member, and for a
        population per-member lists of ``loss``, ``episodes`` and
        ``ep_ret``; ``max_priority`` is the host value of a prioritized
        ring's running max (or None)."""
        M = self.members or 1
        self.env_steps.inc(frames_delta * M)
        self.env_rate.set(frames_delta * M / dt)
        self.grad_steps.inc(grad_steps * M)
        self.chunk.observe(dt)
        if self.members:
            self.grad_rate.set(grad_steps * M / dt)
            for g, v in zip(self.member_loss, loss):
                g.set(v)
            self.loss.set(sum(loss) / M)
            self.episodes.inc(max(sum(episodes), 0.0))
            done = [r for r, n in zip(ep_ret, episodes) if n > 0]
            if done:
                self.ep_return.set(sum(done) / len(done))
            return
        # Host-visible params refresh once per chunk boundary, so the chunk
        # wall bounds their staleness; grad-step latency is the per-step
        # share of the chunk.
        self.staleness.observe(dt)
        if grad_steps:
            self.grad_latency.observe(dt / grad_steps)
        self.grad_rate.set(grad_steps / dt)
        self.loss.set(loss)
        self.episodes.inc(max(episodes, 0.0))
        if episodes:
            self.ep_return.set(ep_ret)
        _, ring_slots = tmc.observe_device_ring(replay,
                                                max_priority=max_priority)
        self.lineage.on_chunk(self.grad_steps.value,
                              max(1, ring_slots // chunk_iters))

    def observe_device(self, dt: float, device,
                       busy_s: Optional[float] = None) -> None:
        """A chunk fenced ``dt`` s after its dispatch: one dispatch of the
        chunk program with ``dt`` device seconds; with ``busy_s``, the
        device-busy seconds a profiler measured in it, the ledger files
        the chunk (``other`` holds its idle rest), and an unmeasured
        chunk files nothing there: the loop's host launches the card's
        work, so its wall is not the card's. Then the MFU and the memory
        sweep."""
        self.program.count_dispatch()
        self.program.add_device_seconds(dt)
        if busy_s is not None:
            self.ledger.observe_chunk(dt, busy_s)
        telemetry.set_learner_mfu("fused", device=device, reg=self.reg)
        telemetry.sweep_device_memory(self.reg)

    def observe_eval(self, returns) -> None:
        """A population's per-member eval returns."""
        for g, v in zip(self.member_eval, returns):
            g.set(v)


def train(cfg: ExperimentConfig, total_env_steps: int = 0, seed: int = None,
          chunk_iters: int = 2000, log_fn=print, device=None, stop_fn=None,
          profile_dir: str = None, profile_chunk: int = None,
          checkpoint_dir: str = None, save_every_frames: int = 0,
          checkpoint_replay: bool = False, mesh=None,
          telemetry_port: int = None, telemetry_host: str = "127.0.0.1"):
    """Run training on ``device`` (default: the card); returns
    (final_carry, history list of metric rows).

    Every chunk records into the process telemetry registry (the JAX
    loop's families, :class:`_FusedTelemetry`); ``telemetry_port`` serves
    it at ``/metrics`` for the run (0: an ephemeral port, logged as a
    ``telemetry_port`` row), on rank 0 alone under a ``mesh``.

    ``mesh`` (a ``parallel.mesh.Mesh``) runs this call as one rank of the
    data-parallel mesh, on ``mesh.device``: the rank's lanes and replay
    shard, the replicated learner (parallel/learner.py), global rows. Rank
    0 alone logs, evaluates (from its replica), profiles and reads and
    writes checkpoints: it broadcasts the learner and frame cursor it
    resumed from, and at each chunk boundary whether ``stop_fn`` ended
    the run, so every rank continues from the same state whatever
    storage it sees. With ``checkpoint_replay`` every rank saves and
    restores its own carry shard besides (utils/checkpoint.py
    ``RankCarryShards``). A population under a mesh raises.

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
    if mesh is not None:
        _check_mesh_run(cfg)
    dev = mesh.device if mesh is not None else resolve_device(device)
    if cfg.population.size > 1:
        return _train_population(
            cfg, total_env_steps=total_env_steps, seed=seed,
            chunk_iters=chunk_iters, log_fn=log_fn, device=dev,
            stop_fn=stop_fn, profile_dir=profile_dir,
            profile_chunk=profile_chunk, checkpoint_dir=checkpoint_dir,
            save_every_frames=save_every_frames,
            checkpoint_replay=checkpoint_replay,
            telemetry_port=telemetry_port, telemetry_host=telemetry_host)
    if cfg.population.spec_json:
        cfg = pop.member_config(cfg, pop.resolve_spec(cfg), 0)
    seed = cfg.seed if seed is None else seed
    env = make_env(cfg.env_name, device=dev)
    net = build_network(cfg.network, env.num_actions, env.observation_shape,
                        device=dev, seed=seed)
    # Every branch builds the loop's one chunk program. devtime: each is
    # registered as fused.chunk by _FusedTelemetry below, and _chunk_loop
    # attaches its census at the first chunk that takes grad steps.
    if mesh is not None:
        from dist_dqn_tpu_torch.parallel import (make_mesh_fused_train,
                                                 make_mesh_r2d2_train)
        if cfg.network.lstm_size:
            # devtime: fused.chunk (above).
            init, run_chunk = make_mesh_r2d2_train(cfg, env, net, mesh)
        else:
            # devtime: fused.chunk (above).
            init, run_chunk = make_mesh_fused_train(cfg, env, net, mesh)
    elif cfg.network.lstm_size:
        # devtime: fused.chunk (above).
        init, run_chunk = make_r2d2_train(cfg, env, net, device=dev)
    else:
        # devtime: fused.chunk (above).
        init, run_chunk = make_fused_train(cfg, env, net, device=dev)
    evaluate = (make_r2d2_evaluator if cfg.network.lstm_size
                else make_evaluator)(cfg, env, num_episodes=cfg.eval_episodes)
    eval_gen = torch.Generator(device=dev).manual_seed(seed + 1)
    ckpt = shards = None
    if mesh is not None:
        log_fn = distributed.main_process_log(log_fn)
    if mesh is None or mesh.rank == 0:
        ckpt = _checkpointer(checkpoint_dir, save_every_frames, cfg,
                             checkpoint_replay)
    elif checkpoint_dir and checkpoint_replay:
        shards = RankCarryShards(checkpoint_dir, mesh.rank)
    tm = _FusedTelemetry(cfg)
    server = telemetry.serve_if_asked(
        telemetry_port if mesh is None or mesh.rank == 0 else None,
        telemetry_host, log_fn, role="learner", labels={"loop": "fused"})
    try:
        with _chunk_heartbeat() as hb:
            return _chunk_loop(cfg, init(seed), run_chunk, evaluate,
                               eval_gen, ckpt,
                               total_env_steps or cfg.total_env_steps,
                               chunk_iters, log_fn, dev, stop_fn,
                               profile_dir, profile_chunk, checkpoint_replay,
                               tm, hb, mesh=mesh, shards=shards)
    finally:
        if server is not None:
            server.close()


def _train_population(cfg: ExperimentConfig, total_env_steps: int = 0,
                      seed: int = None, chunk_iters: int = 2000,
                      log_fn=print, device=None, stop_fn=None,
                      profile_dir: str = None, profile_chunk: int = None,
                      checkpoint_dir: str = None, save_every_frames: int = 0,
                      checkpoint_replay: bool = False,
                      telemetry_port: int = None,
                      telemetry_host: str = "127.0.0.1"):
    """The population twin of :func:`train` (dist_dqn_tpu/train.py:423-720):
    M members advance as one program.

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
    # devtime: registered as population.chunk by _FusedTelemetry(members=M)
    # below; _chunk_loop attaches its census.
    init, run_chunk = pop.make_population_train(cfg, env, net, device=dev)
    evaluate = make_evaluator(cfg, env, num_episodes=cfg.eval_episodes)
    eval_gens = [torch.Generator(device=dev).manual_seed(s + 1)
                 for s in seeds]
    tm = _FusedTelemetry(cfg, members=M)
    server = telemetry.serve_if_asked(telemetry_port, telemetry_host,
                                      log_fn, role="learner",
                                      labels={"loop": "fused"})
    try:
        with _chunk_heartbeat(M) as hb:
            return _chunk_loop(cfg, init(seeds), run_chunk, evaluate,
                               eval_gens, ckpt,
                               total_env_steps or cfg.total_env_steps,
                               chunk_iters, log_fn, dev, stop_fn,
                               profile_dir, profile_chunk, checkpoint_replay,
                               tm, hb, members=M)
    finally:
        if server is not None:
            server.close()


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
        try:
            record_population_size(checkpoint_dir, cfg.population.size)
        except ValueError:
            # A stacked tree's member axis is structural: the refusal is
            # counted under the family of the host-replay sidecar pins.
            telemetry.get_registry().counter(
                tmc.CHECKPOINT_REFUSED,
                "resume attempts refused at the sidecar pins",
                {"loop": "fused", "reason": "population"}).inc()
            raise
    return ckpt


def _chunk_stage(members: int, part: str = ".chunk") -> str:
    """The fused loop's heartbeat stage (``part`` ".checkpoint": its
    emergency hook), JAX's names."""
    return ("population" if members else "fused") + part


@contextlib.contextmanager
def _chunk_heartbeat(members: int = 0):
    """The fused loop's stage heartbeat, registered WITH startup grace (the
    first chunk carries the one-time set-up), and deregistered with the
    loop's emergency hook even when the loop raises: a leaked heartbeat
    would read as a permanent stall in a process that caught the
    exception and lived on."""
    # Literal stage names, JAX's: the heartbeat-stages check matches
    # them against the runbook's table.
    if members:
        hb = tm_watchdog.heartbeat(
            "population.chunk", startup_grace_s=tm_watchdog.STARTUP_GRACE_S)
    else:
        hb = tm_watchdog.heartbeat(
            "fused.chunk", startup_grace_s=tm_watchdog.STARTUP_GRACE_S)
    try:
        yield hb
    finally:
        hb.close()
        tm_watchdog.unregister_emergency_hook(
            _chunk_stage(members, ".checkpoint"))


def _chunk_loop(cfg, carry, run_chunk, evaluate, eval_gen, ckpt, total,
                chunk_iters, log_fn, dev, stop_fn, profile_dir, profile_chunk,
                checkpoint_replay, tm, hb_chunk, members: int = 0, mesh=None,
                shards=None):
    """Resume from ``ckpt``, then run chunks until the frame cursor reaches
    ``total``, logging one row per chunk and recording it into ``tm`` (a
    :class:`_FusedTelemetry`); returns (carry, history).
    ``members`` > 0: a population's [M] metrics and rows. Under a
    ``mesh``, rank 0 alone holds ``ckpt``, evaluates and profiles; the
    other ranks take its resume point and its stop decisions by broadcast
    (their rows carry no eval_return). With ``checkpoint_replay`` under a
    mesh the other ranks hold ``shards``, their own carry shards, written
    before rank 0 commits each step and restored at the step it picked."""
    main = mesh is None or mesh.rank == 0
    if not main:
        profile_dir = None
    # Crash forensics (null-safe no-ops until --forensics-dir /
    # --no-flight-recorder arm or disarm them): the caller's stage
    # heartbeat (:func:`_chunk_heartbeat`) beaten per chunk, a per-chunk
    # flight event, and the divergence sentinel on every chunk's loss (the
    # host value the chunk's one read already brought back: no read of its
    # own).
    stage = _chunk_stage(members)
    flight = telemetry.get_flight()
    frames = 0            # the loop's frame cursor (per member)
    frame_offset = 0      # added to the carry's own frame count
    restored = None
    refusal = None
    if ckpt is not None:
        try:
            if checkpoint_replay:
                check_mesh_width(ckpt.directory,
                                 mesh.size if mesh is not None else 1,
                                 record=mesh is not None)
            restored = ckpt.restore_latest(
                carry if checkpoint_replay else carry.learner)
        except Exception as e:  # noqa: BLE001 — re-raised on every rank
            if mesh is None:
                raise
            refusal = e
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
    if mesh is not None:
        frames, carry = _resume_from_rank0(
            mesh, carry, restored is not None, frames, refusal,
            shards if checkpoint_replay else None)
        frame_offset = 0 if checkpoint_replay else frames

    def save_tree():
        return carry if checkpoint_replay else carry.learner

    # Emergency checkpoint on a watchdog abort: the newest chunk-boundary
    # state, so a wedged run loses at most one chunk instead of a whole
    # save period. The optimiser updates in place, so the hook copies
    # under the fence lock the loop holds from its chunk's first launch
    # to its fence (never a state torn between two steps), and writes a
    # side file rather than through the checkpointer the main thread may
    # be wedged inside.
    fence = tm_watchdog.FenceLock()
    if ckpt is not None:
        tm_watchdog.register_emergency_hook(
            _chunk_stage(members, ".checkpoint"),
            lambda: save_emergency(
                os.path.join(ckpt.directory, "emergency_learner.pt"),
                lambda: {"learner": save_tree()}, fence,
                tm_watchdog.EMERGENCY_FENCE_WAIT_S))

    def save(final: bool) -> None:
        """A save at this chunk boundary (``final``: the run's last). A
        mesh's carry-kind save is rank 0's decision on every rank: each
        other rank writes its shard first, then rank 0 commits the
        step."""
        if mesh is not None and checkpoint_replay and (
                ckpt is not None or shards is not None):
            due = torch.tensor(
                [int(ckpt is not None and (final or ckpt.is_due(frames)))],
                dtype=torch.int32, device=mesh.device)
            mesh.broadcast_([due])
            if not due.item():
                return
            if shards is not None:
                shards.save(frames, carry)
            mesh.barrier()
        if ckpt is None:
            return
        if (ckpt.save if final else ckpt.maybe_save)(frames, save_tree()):
            log_fn(json.dumps(_checkpoint_row("save", ckpt.last_save)))

    B = cfg.actor.num_envs
    history = []
    # 0 disables eval entirely; otherwise the first chunk gets a baseline.
    next_eval = frames if cfg.eval_every_steps else float("inf")
    # Trace the second chunk (the first pays one-time set-up), unless the
    # whole run is one chunk.
    if profile_chunk is None:
        profile_chunk = 1 if total > frames + chunk_iters * B else 0
    on_card = dev.type == "cuda"
    tracer = telemetry.maybe_trace_first_chunk(profile_dir)
    # The fused chunk's census: a training chunk's (train_loop.py
    # make_fused_train chunk_cost), attached at the first chunk that
    # trains; unknown under a mesh.
    chunk_cost = getattr(run_chunk, "chunk_cost", None)
    chunk_index = 0
    while frames < total:
        if chunk_index == profile_chunk:
            tracer.start()
        t0 = time.perf_counter()
        # The chunk is one block of device work (telemetry/devtime.py
        # LaunchGate): a /debug/profile capture starts between chunks. The
        # fence lock spans its launches to its fence.
        with fence.held(), telemetry.device_work():
            carry, metrics = run_chunk(carry, chunk_iters)
            # One read of the chunk's device accumulators: the chunk
            # fence. A prioritized solo ring's running max priority (a
            # device scalar) rides it for the telemetry.
            fetch = [metrics["episode_return"], metrics["episodes"],
                     metrics["loss"]]
            max_prio = None if members else getattr(
                carry.replay, "max_priority", None)
            if max_prio is not None:
                fetch.append(max_prio.to(fetch[0].dtype))
            ep_ret, episodes, loss, *max_prio = \
                torch.stack(fetch).tolist()
        dt = time.perf_counter() - t0
        busy = None
        if tracer.stop():
            profile_row = _write_profile(tracer.profile, profile_dir, dt,
                                         on_card)
            busy = profile_row.get("device_busy_s")
            log_fn(json.dumps(profile_row))
        chunk_index += 1
        prev_frames = frames
        frames = frame_offset + metrics["env_frames"]
        grad_steps = float(metrics["grad_steps_in_chunk"])
        tm.observe_chunk(max(frames - prev_frames, 0), dt, grad_steps, loss,
                         episodes, ep_ret, carry.replay,
                         max_prio[0] if max_prio else None, chunk_iters)
        tm.observe_device(dt, dev, busy)
        hb_chunk.beat()
        mean_loss = sum(loss) / members if members else loss
        flight.record("chunk", stage, frames=frames, loss=mean_loss,
                      wall_s=round(dt, 4))
        # A population's sentinel watches the member MEAN: one diverged
        # member shifts it enough to trip, and the bundle's registry
        # carries the per-member losses.
        tm_watchdog.observe_divergence(loss=mean_loss, step=frames)
        if grad_steps and not tm.program.cost_attached:
            with telemetry.device_work():
                tm.program.attach_cost(
                    (lambda: chunk_cost(carry, chunk_iters)) if chunk_cost
                    else {})
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
        # The frame cursor is global, so every rank keeps the same
        # evaluation schedule; rank 0 alone runs it.
        if frames >= next_eval:
            if main:
                with telemetry.device_work():
                    returns = evaluate(carry.learner.net, eval_gen).tolist()
                if members:
                    tm.observe_eval(returns)
                    row["eval_return_members"] = returns
                    returns = sum(returns) / members
                row["eval_return"] = returns
            next_eval = frames + cfg.eval_every_steps
        history.append(row)
        log_fn(json.dumps({k: _rounded(v) for k, v in row.items()}))
        with telemetry.device_work():
            save(final=False)
            stop = stop_fn is not None and _rank0_stops(
                mesh, main and stop_fn(row))
        if stop:
            break
    with telemetry.device_work():
        save(final=True)
    return carry, history


def _rank0_stops(mesh, stop: bool) -> bool:
    """Rank 0's ``stop`` on every rank of ``mesh`` (one broadcast): a
    rank that stopped alone would leave the others waiting in the next
    all-reduce."""
    if mesh is None:
        return stop
    t = torch.tensor([int(stop)], dtype=torch.int32, device=mesh.device)
    mesh.broadcast_([t])
    return bool(t.item())


def _resume_from_rank0(mesh, carry, restored: bool, frames: int,
                       refusal=None, shards=None):
    """Rank 0's resume point on every rank of ``mesh``: its frame cursor
    and, where it restored one, its learner (weights, target, optimizer
    moments and counts, the step's generator). With ``shards`` (a
    carry-kind checkpoint) every other rank first restores its own carry
    shard at that step. A rank 0 ``refusal``, or a rank that cannot
    restore, raises on every rank. Returns (frames, carry)."""
    from dist_dqn_tpu_torch.parallel.learner import sync_learner_from_rank0

    head = torch.tensor([2 if refusal is not None else int(restored),
                         frames], dtype=torch.int64, device=mesh.device)
    mesh.broadcast_([head])
    status, frames = head.tolist()
    if status == 2:
        if refusal is not None:
            raise refusal
        raise RuntimeError("rank 0 could not resume the mesh's checkpoint; "
                           "its error names the cause")
    if not status:
        return frames, carry
    failure = None
    if shards is not None:
        try:
            carry = shards.restore(frames, carry)
        except Exception as e:  # noqa: BLE001 — re-raised below
            failure = e
    failed = mesh.gather([failure is not None])[:, 0]
    if failed.any():
        if failure is not None:
            raise failure
        raise RuntimeError(
            f"rank(s) {np.flatnonzero(failed).tolist()} could not restore "
            f"their carry shard of step {frames}")
    sync_learner_from_rank0(mesh, carry.learner)
    return frames, carry


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


def _pick_mesh_devices(num_devices: int, multiprocess: bool,
                       device=None, num_processes: int = 1) -> int:
    """Local ranks of the dp mesh (twin of dist_dqn_tpu/train.py:24-45),
    one per device: on ``cuda`` one per card (``0``: every card), with
    ``device="cpu"`` ``num_devices`` CPU ranks (a process of a
    multi-process run is one CPU rank, as a JAX CPU process is one device).
    A multi-process mesh spans the GLOBAL device list, every process's
    local ranks; a single-process request larger than the machine raises
    instead of silently truncating."""
    on_card = torch.device(device or "cuda").type == "cuda"
    if on_card:
        resolve_device("cuda")
        local = torch.cuda.device_count()
    else:
        local = 1 if multiprocess else max(num_devices or 1, 1)
    if multiprocess:
        total = local * num_processes
        if num_devices not in (0, 1, total):
            raise ValueError(
                f"multi-process runs use all {total} global devices; "
                f"--mesh-devices {num_devices} is not meaningful (pass 0)")
        return local
    if num_devices in (0, None):
        return local
    if local < num_devices:
        raise ValueError(f"--mesh-devices {num_devices} requested but only "
                         f"{local} available")
    return num_devices


def run_mesh(cfg: ExperimentConfig, num_devices: int = 0, device=None,
             coordinator: str = None, num_processes: int = 1,
             process_id: int = 0, runtime: str = "fused", **train_kwargs):
    """Train as a data-parallel mesh: :func:`_pick_mesh_devices` local
    ranks, each running :func:`train` (``runtime="host-replay"``:
    ``host_replay_loop.run_host_replay``) on its device with the mesh
    (rank 0 prints the rows). One local rank runs in this process; more
    are spawned and joined, and a rank that fails ends the others and
    re-raises here. With ``coordinator`` (``host:port``) and
    ``num_processes`` > 1 this process's ranks are those of process
    ``process_id`` in a world numbered process by process (the fused
    runtime only); else the ranks meet on a free local port. Nothing waits
    for ever: a collective raises after ``distributed.DEFAULT_TIMEOUT_S``
    without its peers, and once one rank has ended cleanly the others must
    end within ``distributed.SPAWN_FINISH_S``.
    ``train_kwargs`` must pickle when ranks are spawned (``stop_fn`` and
    ``log_fn`` module-level functions or partials of them). Returns rank
    0's host-replay summary (without ``learner`` from a spawned rank), or
    None for the fused runtime."""
    host_replay = runtime == "host-replay"
    if host_replay and coordinator is not None:
        raise ValueError(HOST_REPLAY_COORDINATOR)
    if not host_replay:
        _check_mesh_run(cfg)
    multiprocess = coordinator is not None and num_processes > 1
    local = _pick_mesh_devices(num_devices, multiprocess, device,
                               num_processes)
    address = coordinator or f"127.0.0.1:{distributed.free_port()}"
    world = local * (num_processes if multiprocess else 1)
    first = local * process_id if multiprocess else 0
    kind = torch.device(device or "cuda").type
    # CPU ranks of one process share its cores.
    threads = (max(torch.get_num_threads() // local, 1)
               if kind == "cpu" and local > 1 else 0)
    if local == 1:
        return _rank_main(0, cfg, address, world, first, kind, threads,
                          runtime, train_kwargs, None)
    # Spawned ranks start from a fresh import: they take this process's
    # run manifest (rank 0 serves it and hashes it into LATEST).
    with tempfile.TemporaryDirectory() as out:
        distributed.spawn(_rank_main, (cfg, address, world, first, kind,
                                       threads, runtime, train_kwargs, out,
                                       telemetry.get_run_manifest()),
                          local)
        path = os.path.join(out, "rank0.pt")
        if os.path.exists(path):
            return torch.load(path, weights_only=False)
    return None


def _check_mesh_run(cfg: ExperimentConfig) -> None:
    """What a fused mesh run refuses: a population (JAX's text)."""
    if cfg.population.size > 1:
        raise ValueError(
            "--population composes with the single-device fused runtime "
            "only for now: the population fills ONE chip by vmap-stacking "
            "members; run one population process per device instead of "
            "--mesh-devices")


def _rank_main(local_rank: int, cfg, address: str, world: int, first: int,
               kind: str, threads: int, runtime: str, train_kwargs: dict,
               out_dir, manifest: dict = None) -> object:
    """One rank of :func:`run_mesh`: join the group, run, leave. A spawned
    rank 0 leaves its host-replay summary in ``out_dir``; ``manifest`` is
    the parent's run manifest."""
    from dist_dqn_tpu_torch.parallel import make_mesh

    if manifest is not None:
        telemetry.set_run_manifest(manifest)
    # A spawned rank arms its own watchdog and sentinel from the
    # environment --forensics-dir exported (the rank in this process has
    # the CLI's already).
    if tm_watchdog.get_watchdog() is None:
        tm_watchdog.maybe_install_from_env()
    # ...and its own copy of the run's chaos plan (DQN_CHAOS_PLAN, which
    # chaos.install(..., export_env=True) sets): every rank counts its
    # own seam hits.
    from dist_dqn_tpu_torch import chaos
    chaos.maybe_install_from_env()
    if threads:
        torch.set_num_threads(threads)
    dev = distributed.initialize(address, world, first + local_rank,
                                 [local_rank], device=kind)
    kwargs = dict(train_kwargs)
    kwargs.setdefault("log_fn", functools.partial(print, flush=True))
    try:
        mesh = make_mesh(device=dev)
        if runtime != "host-replay":
            train(cfg, mesh=mesh, **kwargs)
            return None
        from dist_dqn_tpu_torch.host_replay_loop import run_host_replay
        out = run_host_replay(cfg, mesh=mesh, mesh_devices=0, **kwargs)
        if out_dir is not None:
            out.pop("learner")
            if mesh.rank == 0:
                torch.save(out, os.path.join(out_dir, "rank0.pt"))
        return out
    finally:
        distributed.shutdown()


def add_forensics_flags(parser) -> None:
    """The JAX CLI's crash-forensics and fleet flags, with its help
    texts."""
    parser.add_argument("--fleet-dir", default=None,
                        help="fleet registry directory: this "
                             "process writes a role-labeled endpoint "
                             "descriptor next to every other member of "
                             "the run so the fleet aggregator (python "
                             "-m dist_dqn_tpu_torch.telemetry.fleet) can "
                             "federate one /metrics pane + /fleet/"
                             "status rollup. Exported as DQN_FLEET_DIR "
                             "so spawned actor/feeder processes "
                             "register their own endpoints. Requires "
                             "--telemetry-port")
    parser.add_argument("--forensics-dir", default=None,
                        help="arm the stall watchdog + divergence "
                             "sentinel (telemetry/watchdog.py): a "
                             "pipeline stage missing its heartbeat "
                             "deadline, or a NaN/Inf loss, dumps a "
                             "forensics bundle (named thread stacks, "
                             "flight-recorder tail, registry snapshot, "
                             "run manifest) under this directory and "
                             "flips /healthz to 503. Exported as "
                             "DQN_FORENSICS_DIR so spawned actor/feeder "
                             "processes arm their own. See the hang "
                             "runbook in README.md")
    parser.add_argument("--watchdog-deadline-s", type=float, default=120.0,
                        help="heartbeat staleness that counts as a stall "
                             "(per stage; requires --forensics-dir)")
    parser.add_argument("--watchdog-abort", action="store_true",
                        help="after dumping the forensics bundle, "
                             "SIGTERM the process (graceful: the "
                             "telemetry flush chains off SIGTERM) with a "
                             "bounded hard-exit fallback — for "
                             "supervisors that restart on exit rather "
                             "than scrape /healthz")
    parser.add_argument("--no-flight-recorder", action="store_true",
                        help="disable the in-memory flight-recorder "
                             "ring (telemetry/flight.py; ~1µs/event "
                             "when on). Forensics bundles and "
                             "/debug/flight then carry no event tail")


def _reached_return(target: float, row: dict) -> bool:
    """``--stop-at-return``'s test of a row."""
    return row.get("eval_return", -float("inf")) >= target


def _refuse_unported(args) -> None:
    """What the CLI refuses before anything starts."""
    if args.coordinator is not None and args.runtime == "host-replay":
        raise SystemExit(HOST_REPLAY_COORDINATOR)


def arm_forensics(args) -> None:
    """The crash-forensics and fleet flags (JAX ``train.py:1049-1068``),
    before any loop wires its recorder or heartbeats, and through the
    environment so spawned actor, feeder and rank processes follow."""
    from dist_dqn_tpu_torch.telemetry import flight as tm_flight

    if args.no_flight_recorder:
        os.environ[tm_flight.ENABLE_ENV] = "0"
        tm_flight.configure(enabled=False)
    if args.fleet_dir:
        from dist_dqn_tpu_torch.telemetry import fleet
        os.environ[fleet.FLEET_ENV] = args.fleet_dir
    if args.forensics_dir:
        os.environ[tm_watchdog.FORENSICS_ENV] = args.forensics_dir
        os.environ[tm_watchdog.DEADLINE_ENV] = str(args.watchdog_deadline_s)
        tm_watchdog.install_watchdog(forensics_dir=args.forensics_dir,
                                     deadline_s=args.watchdog_deadline_s,
                                     abort=args.watchdog_abort)
        tm_watchdog.install_sentinel(forensics_dir=args.forensics_dir,
                                     abort=args.watchdog_abort)


def _run_manifest(cfg: ExperimentConfig, device) -> dict:
    """The run manifest (telemetry/manifest.py) with what only torch
    knows: the card's name and CUDA version on a card run."""
    extra = None
    if torch.device(device or "cuda").type == "cuda":
        try:
            extra = {"device": {"name": torch.cuda.get_device_name(0),
                                "cuda": torch.version.cuda}}
        except (AssertionError, RuntimeError):
            pass    # no card: the run itself says so
    return telemetry.build_manifest(cfg, argv=sys.argv, extra=extra)


def _main_apex(cfg: ExperimentConfig, args, parser) -> None:
    """``--runtime apex`` (dist_dqn_tpu/train.py:1225-1286): the JAX CLI's
    lines for the flags this runtime ignores, the MLP torso for a
    non-pixel host env, then the service and its summary. With
    ``--coordinator`` this process joins the group first (JAX
    ``train.py:943-950``), one card per process, and leaves it after."""
    from dist_dqn_tpu_torch.actors.service import (ApexLearnerService,
                                                   ApexRuntimeConfig)
    from dist_dqn_tpu_torch.envs.gym_adapter import is_pixel_env

    if args.mesh_devices != 1:
        print("# --mesh-devices applies to the fused/host-replay "
              "runtimes; use --learner-devices for apex batch "
              "sharding")
    if args.wall_budget_s is not None:
        print("# --wall-budget-s is not modeled for --runtime apex: size "
              "the run manually (worst case = start-up + the fill + grad "
              "steps x measured grad-step wall; chip_smoke.py's service "
              "phases print it) — a run SIGTERM'd mid-chunk loses its "
              "work")
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
        trace_path=args.trace_path,
        device_sampling=args.device_sampling,
        transport=args.transport,
        actor_priorities=not args.no_actor_priorities,
        ingest_shards=args.ingest_shards,
        wire_dedup=not args.no_wire_dedup,
        shm_batch=args.shm_batch,
        shard_sampling=args.shard_sampling,
        telemetry_port=args.telemetry_port,
        telemetry_host=args.telemetry_host,
        profile_dir=args.profile_dir)
    # At world size 1 with learner ranks the group would hold this process
    # alone, and the learner ranks form the process's one group instead.
    if args.coordinator is not None and (args.num_processes > 1
                                         or args.learner_devices == 1):
        distributed.initialize(args.coordinator, args.num_processes,
                               args.process_id, device=args.device or "cuda")
    try:
        service = ApexLearnerService(cfg, rt, device=args.device)
        print(json.dumps(service.run()))
    finally:
        distributed.shutdown()


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
    if args.wall_budget_s is not None:
        # No calibrated time model exists for this loop (it is
        # host-bound, not chunk-count-bound), so the fused sizing gate
        # cannot vet the budget — say so rather than silently dropping
        # the flag.
        print("# --wall-budget-s is not modeled for --runtime "
              "host-replay: size the run manually (worst case = "
              "start-up + chunks x measured chunk wall; chip_smoke.py's "
              "host-replay phases print it) — a run SIGTERM'd "
              "mid-chunk loses its work")
    if args.seed is not None:
        cfg = dataclasses.replace(cfg, seed=args.seed)
    # --mesh-devices N > 1 spawns N ranks (run_mesh); rank 0 prints the
    # rows and this process the summary.
    out = run_host_replay(
        cfg, total_env_steps=args.total_env_steps or cfg.total_env_steps,
        chunk_iters=args.chunk_iters,
        log_fn=functools.partial(print, flush=True),
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
        profile_dir=args.profile_dir, device=args.device,
        telemetry_port=args.telemetry_port,
        telemetry_host=args.telemetry_host)
    out.pop("history", None)
    out.pop("learner", None)
    print(json.dumps(out))


def _gate_sizing(cfg: ExperimentConfig, args) -> None:
    """The pre-flight sizing gate of a fused run on the card (JAX
    ``train.py:1321-1361``): print the predicted wall beside the budget;
    with ``--wall-budget-s``, refuse (exit 4) a run the gate refuses;
    without it, only warn (nothing will kill the run mid-chunk)."""
    from dist_dqn_tpu_torch.utils.sizing import fused_gate_args, gate_fused

    env = make_env(cfg.env_name, device="cpu")
    verdict = gate_fused(
        budget_s=args.wall_budget_s or float("inf"),
        **fused_gate_args(cfg, env,
                          args.total_env_steps or cfg.total_env_steps,
                          args.chunk_iters))
    print(json.dumps({"sizing_predicted_s": round(verdict.predicted_s, 1),
                      "wall_budget_s": args.wall_budget_s}))
    if not verdict.ok:
        if args.wall_budget_s is None:
            print(json.dumps({"sizing_gate": "warning",
                              "reason": verdict.reason}))
        else:
            print(json.dumps({"sizing_gate": "refused",
                              "reason": verdict.reason}))
            raise SystemExit(4)


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
    parser.add_argument("--mesh-devices", type=int, default=1,
                        help="fused and host-replay runtimes: train as a "
                             "data-parallel mesh of this many ranks, one "
                             "process per device "
                             "(0 = every card; with --device cpu, CPU "
                             "ranks over gloo); multi-process runs use "
                             "every process's ranks")
    parser.add_argument("--coordinator", default=None,
                        help="multi-process mesh, or multi-host apex "
                             "service: host:port of rank 0's rendezvous. "
                             "Every process runs this same command with "
                             "its own --process-id; rank 0 alone reads "
                             "and writes the learner in --checkpoint-dir "
                             "(apex: every process snapshots its own "
                             "replay store there)")
    parser.add_argument("--num-processes", type=int, default=1,
                        help="multi-process mesh: total process count")
    parser.add_argument("--process-id", type=int, default=0,
                        help="multi-process mesh: this process's id "
                             "(0-based)")
    parser.add_argument("--learner-devices", type=int, default=1,
                        help="apex runtime: shard train batches over this "
                             "many learner ranks, one per card (0 = every "
                             "card; with --device cpu, CPU ranks over "
                             "gloo); gradients averaged in one "
                             "all-reduce per grad step")
    parser.add_argument("--ingest-shards", type=int, default=1,
                        help="apex runtime: replay-shard count; every "
                             "actor's stream lands in its sticky shard. "
                             "N > 1 needs the zerocopy transport with "
                             "actor priorities (or a recurrent config); "
                             "with --device-sampling one plane per shard")
    parser.add_argument("--shard-sampling", action="store_true",
                        help="apex runtime (--ingest-shards > 1): draw and "
                             "gather in one worker thread per shard and "
                             "hand the learner pre-packed batches")
    parser.add_argument("--telemetry-port", type=int, default=None,
                        help="serve the process telemetry registry's "
                             "/metrics endpoint (Prometheus text format) "
                             "on this port; 0 binds an ephemeral port "
                             "(reported as a telemetry_port log line). "
                             "Works on both runtimes; see "
                             "docs/observability.md")
    parser.add_argument("--telemetry-host", default="127.0.0.1",
                        help="bind address for --telemetry-port: loopback "
                             "by default (the metric/debug surface is "
                             "unauthenticated); 0.0.0.0 makes /metrics "
                             "and /healthz scrapeable from outside the "
                             "container/VM. All runtimes")
    parser.add_argument("--telemetry-snapshot", default=None,
                        help="dump a JSON snapshot of the telemetry "
                             "registry to this path at exit (offline "
                             "runs; same data as /metrics.json)")
    parser.add_argument("--trace-path", default=None,
                        help="apex runtime: write a Chrome trace-event "
                             "file of the host loop (ingest/sample/train "
                             "spans; open in Perfetto) to this path")
    add_forensics_flags(parser)
    # JAX's --wall-budget-s (dist_dqn_tpu/train.py:924), with the card's
    # reason.
    parser.add_argument("--wall-budget-s", type=float, default=None,
                        help="card runs: refuse to start unless the "
                             "predicted wall time fits comfortably inside "
                             "this kill budget (set it to the external "
                             "`timeout` you wrap the run in; a run killed "
                             "mid-chunk loses its work)")
    args = parser.parse_args(argv)
    # SIGTERM/exit device release: a killed run leaves the card to the
    # next process (utils/device_cleanup.py).
    from dist_dqn_tpu_torch.utils.device_cleanup import \
        install as _install_cleanup
    _install_cleanup()

    cfg = apply_overrides(CONFIGS[args.config], args.overrides)
    _refuse_unported(args)
    if args.telemetry_snapshot:
        telemetry.install_snapshot_dump(args.telemetry_snapshot)
    arm_forensics(args)
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
        elif args.mesh_devices != 1 and (args.population or 1) > 1:
            parser.error(
                "--population and --mesh-devices are mutually exclusive: "
                "the population fills ONE chip by vmap-stacking members; "
                "run one population process per device (or drop one "
                "flag)")
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
    # The run manifest: one provenance line per run, served at
    # /debug/config and hashed into the checkpoint's LATEST pointer.
    manifest = _run_manifest(cfg, args.device)
    telemetry.set_run_manifest(manifest)
    print(json.dumps({"manifest": manifest}))
    # Game-day runs arm a fault plan via DQN_CHAOS_PLAN — AFTER the
    # manifest is set so the armed plan annotates it (the provenance line
    # above already printed; /debug/config and the forensics bundles
    # read the annotated copy).
    from dist_dqn_tpu_torch import chaos
    chaos.maybe_install_from_env()
    if args.runtime == "host-replay":
        _main_host_replay(cfg, args)
        return
    if args.runtime == "apex":
        _main_apex(cfg, args, parser)
        return
    _warn_host_replay_flags(args, parser)
    stop_fn = None
    if args.stop_at_return is not None:
        stop_fn = functools.partial(_reached_return, args.stop_at_return)
    if args.device != "cpu" and torch.cuda.is_available():
        # A run on the card (JAX gates every non-CPU backend); without a
        # card, train() raises with the reason as before.
        _gate_sizing(cfg, args)
    kwargs = dict(total_env_steps=args.total_env_steps, seed=args.seed,
                  chunk_iters=args.chunk_iters, stop_fn=stop_fn,
                  profile_dir=args.profile_dir,
                  profile_chunk=args.profile_chunk,
                  checkpoint_dir=args.checkpoint_dir,
                  save_every_frames=args.save_every_frames,
                  checkpoint_replay=args.checkpoint_replay,
                  telemetry_port=args.telemetry_port,
                  telemetry_host=args.telemetry_host)
    if args.mesh_devices != 1 or (args.coordinator is not None
                                  and args.num_processes > 1):
        run_mesh(cfg, num_devices=args.mesh_devices, device=args.device,
                 coordinator=args.coordinator,
                 num_processes=args.num_processes,
                 process_id=args.process_id, **kwargs)
        return
    train(cfg, device=args.device, **kwargs)


if __name__ == "__main__":
    main()
