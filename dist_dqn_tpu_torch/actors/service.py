"""The Ape-X learner service of the port (the single-learner path of
``dist_dqn_tpu/actors/service.py``): one process owns the card and runs,
in one loop,

  * the inference server: it drains the actors' step records (same-host
    actors through shared memory: zero-copy slot rings, or the shared
    request ring with the legacy codec; remote actors over TCP), runs one
    batched epsilon-greedy act on the card per ingest pass (the per-actor
    Ape-X epsilon ladder, rows padded to a power-of-two bucket) and posts
    the actions to each actor's mailbox or connection;
  * the assembler: it folds each actor's lanes into n-step transitions
    (``actors/assembler.py``; the C++ assembler on the learner-side
    bootstrap path) or, for a recurrent (R2D2) config, into sequences with
    the carries the act held;
  * the priority seeding: from the q planes the zero-copy actors echo on
    their frames (numpy, no dispatch), from the recurrent act's q planes
    (``initial_sequence_priorities``), or on the card by the learner-side
    bootstrap ``|Q(s,a) - (r + d max Q_target(s'))|``, fused into the act
    dispatch and read back a pass later through pinned memory and an event;
  * the learner: it draws from the host PER shard (``replay/host.py
    PrioritizedHostReplay``; with ``device_sampling`` its mass plane lives
    on the card and each draw is one launch of the sampler kernel at or
    above 100,000 cells), stages batch g+1 while step g trains, keeps
    ``pipeline_depth`` steps in flight and writes their priorities back in
    batches, guarded by the slots' write generations; with
    ``checkpoint_replay`` it snapshots the shard beside the learner
    checkpoint and resumes with it warm.

Actor processes (``actors/actor.py``) start with the ``spawn`` method and
import no torch; a ``feeder:`` host env spawns feeder processes
(``actors/feeder.py``) in their place, which pump pre-encoded records,
``shm_batch`` to a slot publish.

The distributed paths:

  * ``ingest_shards`` > 1 splits the store into that many item shards
    (``replay/sharded.py ShardedPrioritizedReplay``), every actor's stream
    landing in its sticky shard; with ``device_sampling`` each shard has
    its own plane; ``shard_sampling`` moves the draw and gather into one
    worker thread per shard (``ShardSampleService``);
  * ``learner_devices`` > 1 makes this process rank 0 of a group of
    learner ranks that each hold a replica and train on their rows of
    every batch (``actors/learner_ranks.py``);
  * in a process group of more than one rank (``--coordinator``) every
    process runs its own service, with its own actors and store, and
    trains in lockstep with the others through the counter agreement and
    the collective step of ``actors/multihost.py``; rank 0 alone logs,
    saves the learner and evaluates, in a thread of its own.

The loop records the JAX service's telemetry families into the process
registry (:meth:`ApexLearnerService._init_telemetry`), logs its rows
through ``utils/metrics.py MetricLogger`` (mirrored into the registry),
and with ``telemetry_port`` serves them at ``/metrics``. Every update is
host arithmetic on values the loop already holds. The chip-time plane
(telemetry/devtime.py) holds one program record per device-call kind
(``apex.train_step``/``apex.train_scan``, ``apex.act``, ...), their
device seconds at the retirement fences, and a utilization ledger closed
at the log cadence; ``trace_path`` writes the host loop's spans as a
Chrome trace (utils/trace.py), the JAX service's span names.
"""
from __future__ import annotations

import copy
import dataclasses
import json
import os
import shutil
import sys
import threading
import time
import types
import uuid
from collections import deque
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from dist_dqn_tpu_torch import chaos, ingest
from dist_dqn_tpu_torch.actors.act_dispatch import pack_act_rows
from dist_dqn_tpu_torch.actors.assembler import NStepAssembler
from dist_dqn_tpu_torch.actors.transport import (ShmMailbox, ShmRing,
                                                 decode_arrays, encode_arrays,
                                                 shm_dir)
from dist_dqn_tpu_torch.config import ExperimentConfig
from dist_dqn_tpu_torch.envs.gym_adapter import make_host_env
from dist_dqn_tpu_torch.telemetry import collectors as tmc
from dist_dqn_tpu_torch.telemetry import devtime
from dist_dqn_tpu_torch.telemetry import get_registry, serve_if_asked
from dist_dqn_tpu_torch.telemetry import watchdog as tm_watchdog
from dist_dqn_tpu_torch.utils import flops
from dist_dqn_tpu_torch.utils.device import resolve_device
from dist_dqn_tpu_torch.utils.metrics import MetricLogger
from dist_dqn_tpu_torch.utils.trace import make_tracer

# The learner-side bootstrap takes up to _PRIO_MAX_ROWS pending transitions
# per dispatch, padded to one of two row buckets: _PRIO_CHUNK (a few rows
# per pass) or _PRIO_MAX_ROWS (a saturated backlog). With fused_ingest off
# it goes out in _PRIO_CHUNK pieces, the JAX service's split baseline.
_PRIO_CHUNK = 256
_PRIO_MAX_ROWS = 2048
# The parts of one service-loop pass that the summary's loop_s times: the
# slot and request rings read, the batched act with the actor-priority
# inserts, the learner-side bootstrap with its inserts, the grad steps with
# their priority write-back, the stop and export of the first train event's
# trace (profile_dir only), and the sleep of a pass that found no record.
LOOP_PARTS = ("drain", "act", "bootstrap", "train", "trace", "idle")


@dataclasses.dataclass
class ApexRuntimeConfig:
    """Host-side knobs of the actor/learner split: every field and default
    of the JAX package's."""

    host_env: str = "CartPole-v1"   # host env actors step (ale:<Game> for ALE)
    num_actors: int = 2
    envs_per_actor: int = 4
    total_env_steps: int = 10_000
    # Learner cadence: one grad step per this many inserted transitions.
    inserts_per_grad_step: int = 64
    ring_mb: int = 64
    log_every_s: float = 5.0
    # Learner checkpoint/resume: the learner is the recovery point; actors
    # and replay are stateless and refill.
    checkpoint_dir: Optional[str] = None
    save_every_steps: int = 100_000    # env steps between checkpoints
    # Snapshot the replay shard beside the learner checkpoint on every save
    # and restore it at start: a resumed run starts warm, not at min_fill.
    checkpoint_replay: bool = False
    # Periodic greedy evaluation on a service-owned host env.
    eval_every_steps: int = 0          # 0 disables
    eval_episodes: int = 5
    # Remote (TCP) actors: tcp_port None with remote actors listens on an
    # ephemeral loopback port; a given port listens on every interface.
    # Remote ids are [num_actors, num_actors + num_remote_actors); with
    # spawn_remote_actors the service starts them as local processes, else
    # external workers (actors/remote.py) connect to tcp_address.
    tcp_port: Optional[int] = None
    num_remote_actors: int = 0
    spawn_remote_actors: bool = True
    # Train batches sharded over this many learner ranks, one per card,
    # gradients averaged in one all-reduce per grad step (0 = every card).
    learner_devices: int = 1
    # C++ n-step assembly on the learner-side bootstrap path (feed-forward
    # configs); falls back to the Python assembler with a log line.
    native_assembly: bool = True
    # Host-loop Chrome trace of the service thread's spans (utils/trace.py).
    trace_path: Optional[str] = None
    # The shard's priority plane on the card, drawn through the sampler
    # kernel; items stay in host memory.
    device_sampling: bool = False
    # Warn once when no actor record arrived for this many seconds.
    stall_warn_s: float = 30.0
    # Multi-host: the least period between two counter agreements
    # (actors/multihost.py); each blocks until every process joins.
    sync_every_s: float = 0.05
    # At most this many train steps per service-loop pass: the cadence
    # debt persists, and ingestion keeps the actors fed meanwhile.
    train_steps_per_pass: int = 4
    # Train steps kept in flight before their priorities are read back.
    pipeline_depth: int = 2
    # One call per pass serves the batched act and one pending chunk's
    # priority bootstrap (the learner-side bootstrap path; with actor
    # priorities there is no bootstrap to fuse).
    fused_ingest: bool = True
    # Train steps whose |TD| write-backs apply as one batched update.
    prio_writeback_batch: int = 8
    # Double-buffered H2D staging (replay/staging.py); 0 = serial.
    stage_depth: int = 2
    # "zerocopy": schema-negotiated raw-array records; "legacy": the
    # JSON-header codec (the deprecated A/B fallback).
    transport: str = "zerocopy"
    # Frame-stack dedup on the wire for frame-stacked pixel envs.
    wire_dedup: bool = True
    # Records per shared-memory slot publish of feeder processes (rollout
    # actors are lock-step and publish one record per slot).
    shm_batch: int = 1
    # Ingest-side per-shard sampling (ingest_shards > 1): a worker thread
    # per shard draws and gathers, the learner pops pre-packed batches.
    shard_sampling: bool = False
    # Insertion priorities from the actors' q planes (zerocopy only);
    # False seeds them with the learner-side bootstrap on the card.
    actor_priorities: bool = True
    # Replay shards: > 1 splits the store, each actor's stream landing in
    # its sticky shard.
    ingest_shards: int = 1
    # Prometheus scrape endpoint (telemetry/server.py): serve the process
    # registry on this port; 0 binds an ephemeral port (logged as
    # telemetry_port). None disables.
    telemetry_port: Optional[int] = None
    telemetry_host: str = "127.0.0.1"
    # torch.profiler trace of the first train event into this directory.
    profile_dir: Optional[str] = None


def _refuse(cfg: ExperimentConfig, rt: ApexRuntimeConfig, log_fn) -> None:
    """The JAX service's constructor refusals, word for word."""
    if rt.ingest_shards < 1:
        raise ValueError(
            f"ingest_shards must be >= 1, got {rt.ingest_shards}")
    if rt.shm_batch < 1:
        raise ValueError(f"shm_batch must be >= 1, got "
                         f"{rt.shm_batch}")
    if rt.shard_sampling and rt.ingest_shards < 2:
        raise ValueError(
            "shard_sampling requires ingest_shards > 1: the "
            "per-shard sampling threads live where the sharded "
            "store's data lives — a single store has no shard "
            "workers to move the draw into")
    if rt.transport == "legacy":
        log_fn("# DEPRECATION: --transport legacy is the bit-pinned"
               " A/B fallback only and is scheduled for removal "
               "after one release of zerocopy A/B parity "
               "(docs/ingest_pipeline.md §7; apex_feeder_bench "
               "--ab rows are the parity evidence)")
    if rt.device_sampling and rt.transport == "legacy":
        raise ValueError(
            "--transport legacy with --device-sampling is not "
            "supported: the legacy concatenated bootstrap path is "
            "the bit-pinned A/B fallback and stays on the host "
            "tree sampler — use --transport zerocopy for the "
            "device priority planes")
    if rt.device_sampling and rt.shard_sampling:
        raise ValueError(
            "--shard-sampling with --device-sampling is redundant: "
            "the per-shard worker threads exist to move HOST tree "
            "draws off the learner thread, and the device planes "
            "already run each shard's draw on its own chip — pick "
            "one")
    if rt.ingest_shards > 1:
        if cfg.network.lstm_size <= 0 and not (
                rt.transport == "zerocopy" and rt.actor_priorities):
            raise ValueError(
                "ingest_shards > 1 requires per-actor insert "
                "attribution: run --transport zerocopy with actor "
                "priorities (the default), or a recurrent (R2D2) "
                "config — the legacy bootstrap path concatenates "
                "transitions across actors before inserting, so "
                "sticky placement would be a lie there")
    if rt.transport not in ("zerocopy", "legacy"):
        raise ValueError(f"unknown transport {rt.transport!r} "
                         f"(expected 'zerocopy' or 'legacy')")


def _spawn_process(target, args, kwargs):
    """Start ``target`` in a ``spawn`` child that does not re-import the
    parent's ``__main__``: the child then imports the target's module
    alone, so an actor process loads no torch (and no CUDA) even when the
    service was started from a script or module that imports torch."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    p = ctx.Process(target=target, args=args, kwargs=kwargs, daemon=True)
    main = sys.modules["__main__"]
    # The spawn preparation data names the parent's main module by its
    # __spec__ or __file__; a bare module in its place names neither.
    sys.modules["__main__"] = types.ModuleType("__main__")
    try:
        p.start()
    finally:
        sys.modules["__main__"] = main
    return p


class _HostCopy:
    """A device tensor's copy into host memory that the caller may read a
    pass later: on the card, into pinned memory with ``non_blocking`` and
    an event recorded after it, so :meth:`ready` polls without waiting; on
    the CPU, the tensor itself."""

    def __init__(self, t: torch.Tensor):
        if t.device.type == "cuda":
            self.host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self.host.copy_(t, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host, self.event = t, None

    def ready(self) -> bool:
        return self.event is None or self.event.query()

    def numpy(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()
        return self.host.numpy()


class _SaveCadence:
    """The save schedule of ``TrainCheckpointer`` without its writes: a
    multi-host process other than rank 0 keeps it to snapshot its replay
    store at the steps rank 0 saves the learner (every process sees the
    same agreed cursors, so they decide alike)."""

    def __init__(self, directory: str, save_every_frames: int,
                 resumed: Optional[int] = None):
        os.makedirs(directory, exist_ok=True)
        self.save_every_frames = save_every_frames
        self._next_save = (0 if resumed is None
                           else resumed + save_every_frames)

    def maybe_save(self, frames: int, tree) -> bool:
        if frames < self._next_save:
            return False
        self._next_save = frames + self.save_every_frames
        return True

    def save(self, frames: int, tree) -> bool:
        return True


@torch.no_grad()
def _bootstrap_priorities(net, target_net, obs, action, reward, discount,
                          next_obs):
    """The learner-side priority bootstrap ``|Q(s, a) - (r + discount *
    max_a' Q_target(s', a'))|`` through the head's scalar ``q_values`` view,
    so C51, QR and IQN heads seed a meaningful |TD| too (the learner's own
    priorities take over after the first update)."""
    q = net.q_values(obs).float()
    qa = q.gather(-1, action.long()[:, None])[:, 0]
    boot = target_net.q_values(next_obs).float().amax(dim=-1)
    return torch.abs(qa - (reward + discount * boot))


def _make_act_q(num_actions: int):
    """Epsilon-greedy act with the inference-time q planes: ``act(net,
    obs, generator, epsilon) -> (actions, q_sel, q_max)``, ``q_sel`` the Q
    of the taken action (exploratory or greedy) and ``q_max`` the greedy
    value, both f32; ``epsilon`` is one value per row. The draws are those
    of ``agents/dqn.make_actor_step``."""

    @torch.no_grad()
    def act(net, obs, generator, epsilon):
        noise = generator if getattr(net, "noisy", False) else None
        q = net.q_values(obs, noise).float()
        greedy = q.argmax(dim=-1)
        random_a = torch.randint(0, num_actions, greedy.shape,
                                 generator=generator, device=obs.device)
        explore = torch.rand(greedy.shape, generator=generator,
                             device=obs.device) < epsilon
        actions = torch.where(explore, random_a, greedy)
        q_sel = q.gather(-1, actions[:, None])[:, 0]
        return actions, q_sel, q.amax(dim=-1)

    return act


class ApexLearnerService:
    """The learner service: build it, :meth:`run` it (which spawns the
    actors and ends with :meth:`shutdown`), read the summary it returns."""

    class HelloRejectedError(ValueError):
        """Protocol, transport or schema drift detected at connect: on the
        same-host path a drifted build is a deploy bug, so the shared-memory
        drain re-raises it; over TCP it is one counted bad record, and the
        peer gets a NACK."""

    def __init__(self, cfg: ExperimentConfig, rt: ApexRuntimeConfig,
                 log_fn=print, device=None, learner_backend=None):
        """``learner_backend`` names the learner ranks' backend
        (``learner_devices`` > 1): by default NCCL on cards and ``gloo`` on
        the CPU; ``"gloo"`` on a card puts every learner rank on this
        service's card, the two-ranks-on-one-card check of a machine with
        one card (NCCL refuses two ranks on one card)."""
        from dist_dqn_tpu_torch import loop_common

        # Every refusal comes before any shared-memory segment exists.
        _refuse(cfg, rt, log_fn)
        self.device = resolve_device(device)
        self.cfg, self.rt = cfg, rt
        self.run_id = uuid.uuid4().hex[:8]
        self.log = MetricLogger(log_fn=log_fn)
        # Actor ids: [0, num_actors) local (shared memory), [num_actors,
        # total_actors) remote (TCP).
        self.total_actors = rt.num_actors + rt.num_remote_actors
        self.replay_ratio = loop_common.resolve_replay_ratio(cfg)
        self.train_batch = loop_common.resolve_train_batch(cfg)
        # What shutdown() releases, so that it may run at any point.
        self.procs: Dict[int, object] = {}
        self._zc_rings: Dict[int, ingest.ShmSlotRing] = {}
        self.act_boxes: List[ShmMailbox] = []
        self.tcp_server = None
        self.req_ring = None
        self.run_dir = None
        self._learners = None
        self._shard_sampler = None
        self._clean_exit = False
        self.telemetry_server = None

        # Multi-host: a process group of more than one rank (--coordinator)
        # makes every process a host with its own service, actors and
        # store, training collectively (actors/multihost.py); rank 0
        # reports.
        self.distributed = (dist.is_available() and dist.is_initialized()
                            and dist.get_world_size() > 1)
        if self.distributed:
            from dist_dqn_tpu_torch.parallel.distributed import \
                main_process_log
            self.log = MetricLogger(log_fn=main_process_log(log_fn))
        # Several learner ranks: batches shard over them, gradients are
        # averaged across them, the learner is replicated.
        from dist_dqn_tpu_torch.actors.learner_ranks import (
            LearnerRanks, pick_learner_devices)
        if self.distributed:
            if rt.learner_devices != 1:
                log_fn("# distributed mode: the train mesh spans every "
                       "global device; --learner-devices ignored")
            self.n_learners = 1
        else:
            self.n_learners = pick_learner_devices(
                rt.learner_devices, self.device,
                share_card=learner_backend == "gloo")
        if not self.distributed and cfg.learner.batch_size % self.n_learners:
            raise ValueError(
                f"batch_size={cfg.learner.batch_size} not divisible by "
                f"learner_devices={self.n_learners}")
        if not self.distributed and self.train_batch % self.n_learners:
            raise ValueError(
                f"train batch {self.train_batch} not divisible by "
                f"learner_devices={self.n_learners} (rows shard evenly "
                "over the learner mesh)")

        # Probe a host env for the action count, an obs example and the
        # frame-stack depth the slot rings must fit dedup records for.
        probe = make_host_env(rt.host_env, 1)
        self.num_actions = probe.num_actions
        obs_example = probe.reset()[0]
        self._probe_frame_stack = int(getattr(probe, "frame_stack", 0)
                                      or 0)
        del probe

        self.router = ingest.StickyShardRouter(rt.ingest_shards)
        self._decoders: Dict[int, object] = {}
        self._dedup_retired = (0, 0)     # counters of replaced decoders
        slot = 0
        if rt.transport == "zerocopy":
            # A slot fits the larger of a step record and the hello
            # ([lanes, obs] plus its JSON header), the dedup worst case
            # where the env stacks frames, and shm_batch records of a
            # batching feeder.
            schema = ingest.step_schema(obs_example.shape, obs_example.dtype,
                                        rt.envs_per_actor)
            slot = max(ingest.max_record_bytes(schema),
                       rt.envs_per_actor * obs_example.nbytes + 4096)
            if rt.wire_dedup and self._probe_frame_stack >= 2:
                try:
                    slot = max(slot, ingest.max_dedup_record_bytes(
                        schema, self._probe_frame_stack))
                except ValueError:
                    pass    # the obs layout does not carry the stack
            if rt.shm_batch > 1:
                from dist_dqn_tpu_torch.ingest.shm_ring import batch_bytes
                slot = max(slot, batch_bytes([slot] * rt.shm_batch))

        # The learner's data-parallel axis: the multi-host group, or the
        # learner ranks this process starts and leads as rank 0.
        self._mh = None
        axis = None
        if self.distributed:
            from dist_dqn_tpu_torch.actors.multihost import MultihostLearner
            self._mh = MultihostLearner(device=self.device)
            axis = self._mh.mesh
        elif self.n_learners > 1:
            self._learners = LearnerRanks(self.n_learners, self.device,
                                          backend=learner_backend)
            try:
                axis = self._learners.start(cfg, self.num_actions,
                                            obs_example.shape,
                                            _spawn_process)
            except BaseException:
                self._learners.close(clean=False)
                raise

        try:
            self._build(log_fn, obs_example, axis, slot)
            # Every process of a multi-host group binds its own.
            self.telemetry_server = serve_if_asked(
                rt.telemetry_port, rt.telemetry_host, log_fn,
                role="learner", labels={"loop": "apex"})
        except BaseException:
            self.shutdown()
            raise
        self._last_record = time.perf_counter()

    def _build(self, log_fn, obs_example: np.ndarray, axis, slot: int
               ) -> None:
        """The constructor's part after the learner's axis exists: the
        network, learner and assembly, the store, the checkpoint restore
        and the transport endpoints (``slot``: the zero-copy slot size)."""
        from dist_dqn_tpu_torch.models import build_network
        from dist_dqn_tpu_torch.replay.host import PrioritizedHostReplay

        cfg, rt = self.cfg, self.rt
        # The network, the learner and the assembly of this config.
        self.net = build_network(cfg.network, self.num_actions,
                                 obs_example.shape, device=self.device,
                                 seed=cfg.seed)
        self._act_gen = torch.Generator(device=self.device).manual_seed(
            cfg.seed + 2)
        self.recurrent = cfg.network.lstm_size > 0
        self._prio_fn = None
        self._act_q = None
        self._act_rec = None
        self.assembler_kind = "python"
        if self.recurrent:
            # The sequence learner, the carry-threaded act and the sequence
            # assembler; the transport, actors and store are shared.
            from dist_dqn_tpu_torch.actors.assembler import SequenceAssembler
            from dist_dqn_tpu_torch.agents.r2d2 import (
                make_r2d2_learner, make_recurrent_actor_step)

            init, train_step = make_r2d2_learner(cfg.learner, cfg.replay,
                                                 axis=axis)
            init_args = (self.net,)
            self._act_rec = make_recurrent_actor_step(self.num_actions,
                                                      return_q=True)
            self.seq_len = (cfg.replay.burn_in + cfg.replay.unroll_length
                            + cfg.learner.n_step)
            stride = cfg.replay.sequence_stride or cfg.replay.unroll_length
            self._asm_factory = (
                lambda lanes: SequenceAssembler(lanes, self.seq_len, stride))
            # Carries on the host in f32, in actor order: the carry of the
            # next act, and the carry that entered the last one.
            self._carry: List = [None] * self.total_actors
            self._prev_carry: List = [None] * self.total_actors
            self._prev_q: List = [None] * self.total_actors
            # The sequences seed their priorities from the act's q planes
            # service-side; the frame-shipped planes are feed-forward only.
            self.actor_prio = False
            self._fused = False
        else:
            from dist_dqn_tpu_torch.agents.dqn import make_learner

            init, train_step = make_learner(cfg.learner, self.net,
                                            axis=axis)
            init_args = (self.net, torch.Generator(
                device=self.device).manual_seed(cfg.seed + 1))
            self._act_q = _make_act_q(self.num_actions)
            self.actor_prio = (rt.transport == "zerocopy"
                               and rt.actor_priorities)
            asm_cls = NStepAssembler
            if rt.native_assembly and not self.actor_prio:
                try:
                    from dist_dqn_tpu_torch.actors.assembler import (
                        NativeNStepAssembler, _assembler_lib)

                    _assembler_lib()  # build now, not mid-run
                    asm_cls = NativeNStepAssembler
                    self.assembler_kind = "native"
                except Exception as e:  # noqa: BLE001 — logged fallback
                    log_fn(f"# native assembler unavailable "
                           f"({type(e).__name__}: {e}); using Python path")
            elif rt.native_assembly and self.actor_prio:
                log_fn("# actor-side priorities thread q planes through "
                       "the Python assembler; native assembly applies "
                       "to the legacy/bootstrap path only")
            self._asm_factory = (
                lambda lanes: asm_cls(lanes, cfg.learner.n_step,
                                      cfg.learner.gamma))
            # The bootstrap also serves legacy-codec actors that join a
            # zero-copy service; it fuses into the act only without actor
            # priorities.
            self._prio_fn = _bootstrap_priorities
            self._fused = rt.fused_ingest and not self.actor_prio
        self.assemblers = [self._asm_factory(rt.envs_per_actor)
                           for _ in range(self.total_actors)]
        self._host_params = None
        self._local_batch = cfg.learner.batch_size
        if self.distributed:
            from dist_dqn_tpu_torch.parallel.learner import train_step_specs

            # Every process inits, then takes rank 0's learner: the
            # group's first collective, before any actor spawns.
            self.state = self._mh.wrap_init(init)(*init_args)
            self._local_batch, _ = self._mh.shard_batch_size(
                cfg.learner.batch_size)
            self._train_step = self._mh.wrap_train_step(
                train_step, *train_step_specs(self.recurrent))
        else:
            self.state = init(*init_args)
            self._train_step = train_step
        # The learner's step as built: the program the census counts.
        self._learner_step = train_step
        if self.replay_ratio > 1 and (self.recurrent or self.distributed):
            log_fn("# replay.updates_per_chunk > 1 is not supported "
                   "on the recurrent / multi-host apex paths yet; "
                   "running at replay ratio 1")
            self.replay_ratio = 1
        # The chip-time plane (JAX actors/service.py:579-602): one program
        # record per device-call kind, created at its first dispatch
        # (_count_device_call); the train program registers now, with
        # role="train" (the MFU's numerator) and one sub-step's census per
        # execution, at its first dispatch. Its device seconds are the
        # retirement intervals (_finalize_train); the ledger closes a
        # window at the log cadence (_flush_ledger_window).
        self._prog_train = devtime.register_program(
            "apex.train_scan" if self.replay_ratio > 1
            else "apex.train_step", loop="apex", role="train",
            execs_per_dispatch=self.replay_ratio)
        self._prog_by_kind: Dict[str, object] = {"train": self._prog_train}
        self._devtime_anchor = time.perf_counter()
        self._census_args = None        # the first event's, until retired
        self._ledger = devtime.UtilizationLedger("apex")
        self._ledger_busy_seen = 0.0
        self._ledger_t_last = time.perf_counter()
        if self.distributed and self.train_batch != cfg.learner.batch_size:
            log_fn("# replay.train_batch widening is single-host only "
                   "(multi-host batches shard from learner.batch_size); "
                   "ignored")
            self.train_batch = cfg.learner.batch_size
        self.actor_dtype = "float32"
        if cfg.network.actor_dtype not in ("", "float32"):
            log_fn("# network.actor_dtype is not applied by the apex "
                   "service yet (acting uses the live learner params); "
                   "running actor inference in float32")
        # The store's draw stream takes the default seed, as the JAX
        # service's does: it does not follow cfg.seed.
        if rt.ingest_shards > 1:
            # N item shards, inserts routed by the sticky shard id every
            # frame header carries, one global ladder over the shards' mass
            # and slot ids encoded globally, so the write-backs work
            # unchanged; with device_sampling each shard draws on its own
            # plane, the cards round-robin (shard i on card i % count, as
            # JAX assigns its devices), or this process's device on the CPU
            # and under multi-host.
            from dist_dqn_tpu_torch.replay.sharded import \
                ShardedPrioritizedReplay
            self.replay = ShardedPrioritizedReplay(
                rt.ingest_shards, cfg.replay.capacity,
                alpha=cfg.replay.priority_exponent,
                priority_eps=cfg.replay.priority_eps,
                sampler="device" if rt.device_sampling else "tree",
                sampler_device=(None if self.device.type == "cuda"
                                and not self.distributed else self.device))
        else:
            self.replay = PrioritizedHostReplay(
                cfg.replay.capacity, alpha=cfg.replay.priority_exponent,
                priority_eps=cfg.replay.priority_eps,
                sampler="device" if rt.device_sampling else "tree",
                sampler_device=self.device)
        if rt.shard_sampling:
            # The draw and gather move into per-shard worker threads; the
            # learner pops pre-packed batches.
            from dist_dqn_tpu_torch.replay.sharded import ShardSampleService
            self._shard_sampler = ShardSampleService(
                self.replay, depth=max(rt.pipeline_depth, 1))
        self._init_telemetry()
        # The Ape-X epsilon ladder: eps_i = base ** (1 + i/(N-1) alpha).
        n_act = max(self.total_actors - 1, 1)
        self.actor_eps = np.array([
            cfg.actor.apex_epsilon_base
            ** (1 + i / n_act * cfg.actor.apex_epsilon_alpha)
            for i in range(self.total_actors)], np.float32)

        self._prev_obs: List[Optional[np.ndarray]] = [None] * \
            self.total_actors
        self._prev_actions: List[Optional[np.ndarray]] = [None] * \
            self.total_actors
        self._pending: List[Dict[str, np.ndarray]] = []
        self._pending_count = 0
        self._boot_inflight = deque()   # (_HostCopy, items, count)
        self._req_seq = 0
        self._prio_await: List = []          # (actor, rid, emitted)
        self._flush_q: Dict[int, np.ndarray] = {}    # rid -> q_max rows
        self._last_flush_q: Dict[int, np.ndarray] = {}
        self._in_flight = deque()    # (idx, gen, metrics, t_dispatch)
        self._act_queue: List = []   # (actor, obs, t, rid)
        self._prio_pending: List = []
        self._obs_spec = None
        self._stall_warned = False
        self.env_steps = 0
        self.grad_steps = 0
        self.bad_records = 0
        self.hello_rejects = 0
        self.actor_restarts = 0
        self.episodes_completed = 0
        self.records_by_actor: Dict[int, int] = {}
        self._ep_accum: Dict[int, np.ndarray] = {}
        self._ep_returns: deque = deque(maxlen=64)
        self.device_calls: Dict[str, int] = {}
        self._replay_draws_counted = 0
        self.ingest_passes = 0
        self._last_loss = 0.0
        # Held over each train event's launches (the emergency hook's
        # side of it: telemetry/watchdog.py FenceLock).
        self._fence = tm_watchdog.FenceLock()
        self.replay_snapshot: Optional[dict] = None
        self.learner_replicas_equal: Optional[bool] = None
        # Wall clock marks of the summary: the run, the first train event.
        self._t_run = self._t_end = None
        self._t_first_train = None
        # Host seconds of the service thread by part of the loop, and the
        # passes that took a grad step (the summary's loop_s, train_passes).
        self.loop_s = dict.fromkeys(LOOP_PARTS, 0.0)
        self.train_passes = 0
        self._eval_env = None
        self._eval_gen = None
        self._next_eval = rt.eval_every_steps or float("inf")
        # Async eval (multi-host): the worker thread and its results; the
        # thread appends, the loop pops (deque operations are atomic).
        self._eval_thread: Optional[threading.Thread] = None
        self._eval_results: deque = deque()
        self._ckpt = None
        # torch.profiler over the first train event: started at its first
        # dispatch, stopped at its retirement (_finalize_train).
        self._profile_tracer = devtime.maybe_trace_first_chunk(
            rt.profile_dir)
        self._profile_t0 = 0.0
        self.profile_row: Optional[dict] = None
        # The host loop's spans (a Chrome trace at trace_path), JAX's
        # names and places.
        self.tracer = make_tracer(rt.trace_path,
                                  process_name="apex-learner")
        # Multi-host cursors: the agreed global env steps, a resumed run's
        # saved global count, and the next agreement's earliest time.
        self.global_env_steps = 0
        self._resume_global = 0
        self._next_sync = 0.0
        # Double-buffered H2D staging: one learner only; the learner ranks
        # and the multi-host step take host batches of their own.
        self._stager = None
        if rt.stage_depth > 0 and not self.distributed \
                and self.n_learners == 1:
            from dist_dqn_tpu_torch.replay.staging import \
                DoubleBufferedStager
            self._stager = DoubleBufferedStager(depth=rt.stage_depth,
                                                device=self.device,
                                                name="apex_service")
        if rt.checkpoint_dir:
            self._restore_learner()
        if self._learners is not None:
            # Every learner rank takes rank 0's learner, restored or not.
            self._learners.bind(self.state, train_step, self.recurrent)
        self._refresh_host_params()

        # The transport endpoints, created before the actors spawn: the
        # request ring, the act mailboxes and the stop file in a directory
        # of this run's own (removed whole by shutdown), the slot rings
        # as POSIX shared memory named after the run, and the TCP
        # listener of the remote actors.
        self.ingest_torn_reads = 0
        self.tcp_address = None
        self._actor_conn: Dict[int, int] = {}   # remote actor -> conn id
        self.run_dir = shm_dir() / self.run_id
        self.run_dir.mkdir()
        self.stop_path = str(self.run_dir / "stop")
        self.req_ring = ShmRing(f"{self.run_id}/req",
                                capacity=rt.ring_mb * 1024 * 1024,
                                create=True)
        for i in range(rt.num_actors):
            self.act_boxes.append(ShmMailbox(
                f"{self.run_id}/act_{i}", max_size=1 << 20, create=True))
            if rt.transport == "zerocopy":
                self._zc_rings[i] = ingest.ShmSlotRing(
                    f"req_{self.run_id}_zc_{i}", slot_size=slot,
                    nslots=8, create=True)
        if rt.tcp_port is not None or rt.num_remote_actors:
            from dist_dqn_tpu_torch.actors.transport import TcpRecordServer
            # Loopback unless a port was asked for: the record stream is
            # unauthenticated.
            host = "0.0.0.0" if rt.tcp_port is not None else "127.0.0.1"
            self.tcp_server = TcpRecordServer(host=host,
                                              port=rt.tcp_port or 0)
            self.tcp_address = self.tcp_server.address
            log_fn(json.dumps({"tcp_address": list(self.tcp_address)}))

    def _init_telemetry(self) -> None:
        """Registry instruments of the service loop (JAX
        ``actors/service.py:747-860``): pipeline queue depths, throughput
        counters, and the grad-step latency and param-mirror staleness
        histograms that localize a learner-utilization drop."""
        reg = get_registry()
        self._tm_env_steps = reg.counter(
            tmc.ENV_STEPS, "env transitions ingested from actors")
        self._tm_grad_steps = reg.counter(
            tmc.GRAD_STEPS, "learner train steps dispatched")
        self._tm_grad_latency = reg.histogram(
            tmc.GRAD_LATENCY,
            "train-step dispatch -> priority materialization")
        self._tm_param_staleness = reg.histogram(
            tmc.PARAM_STALENESS,
            "age of the host param mirror at each refresh")
        self._tm_act_queue = reg.gauge(
            "dqn_service_act_queue_requests",
            "actor act requests awaiting the batched device call")
        self._tm_pending = reg.gauge(
            "dqn_service_pending_transitions",
            "assembled transitions awaiting priority bootstrap dispatch")
        self._tm_boot_inflight = reg.gauge(
            "dqn_service_bootstrap_inflight",
            "priority-bootstrap chunks dispatched, not yet inserted")
        self._tm_train_inflight = reg.gauge(
            "dqn_service_train_inflight",
            "pipelined train steps awaiting priority write-back")
        # Experience-lineage staleness: every sampled batch ages its
        # records' lineage stamps into the shared families.
        self._tm_sample_age, self._tm_sample_staleness = \
            tmc.lineage_histograms("apex")
        # Dispatch accounting: one counter series per dispatched-program
        # kind, cached on first use.
        self._tm_device_calls: Dict[str, object] = {}
        self._tm_fanin = reg.histogram(
            tmc.DISPATCH_FANIN,
            "obs rows per batched act/fused dispatch",
            buckets=tmc.FANIN_BUCKETS)
        self._tm_ingest_passes = reg.counter(
            tmc.INGEST_PASSES,
            "drain bursts that ingested at least one actor record")
        self._tm_prio_pending = reg.gauge(
            tmc.PRIO_WRITEBACK_PENDING,
            "train steps accumulated toward the next batched priority "
            "write-back")
        self._tm_bad_records = reg.counter(
            "dqn_service_bad_records_total",
            "malformed/misrouted records rejected at the TCP boundary")
        self._tm_actor_prio = reg.counter(
            tmc.INGEST_ACTOR_PRIO_TRANSITIONS,
            "transitions inserted with actor-shipped |TD| priorities "
            "(zero learner-side bootstrap dispatches)")
        # The frame-dedup plane: swept from the decoders' plain-int
        # counters on the log cadence (no registry calls on the decode
        # path).
        self._tm_dedup_frames = reg.counter(
            tmc.INGEST_DEDUP_FRAMES_REUSED,
            "frame-stack slots served by dedup back-references instead "
            "of wire bytes")
        self._tm_dedup_bytes = reg.counter(
            tmc.INGEST_DEDUP_BYTES_SAVED,
            "wire bytes the dedup plane avoided vs the undeduped "
            "zero-copy layout")
        self._dedup_swept = (0, 0)
        self._tm_ring_dropped = reg.gauge(
            "dqn_transport_ring_dropped",
            "records the shm ring dropped (producer overrun)")
        self._tm_ring_pending = reg.gauge(
            "dqn_transport_ring_pending_bytes",
            "bytes queued in the shm ring awaiting drain")
        self._tm_record_age = reg.gauge(
            "dqn_ingest_last_record_age_seconds",
            "seconds since the last valid actor record")
        self._tm_stalls = reg.counter(
            "dqn_ingest_stalls_total", "watchdog-detected ingest stalls")
        self._tm_actor_restarts = reg.counter(
            "dqn_actor_restarts_total",
            "dead actor processes restarted by supervision")
        self._tm_degraded = reg.gauge(
            tmc.INGEST_DEGRADED,
            "1 while supervision sees at least half the actor fleet "
            "dead (degraded, not wedged)")
        # A new service starts with its whole fleet to come: the gauge
        # must not keep an earlier service's verdict in the same process
        # (a game day's scenarios share it).
        self._tm_degraded.set(0.0)
        self._degraded = False
        self._tm_actor_alive: Dict[int, object] = {}
        self._tm_episodes = reg.counter(
            "dqn_episodes_completed_total", "training episodes finished")
        # The learner-utilization config surface: which replay ratio /
        # batch width / actor dtype shaped this learner's rate.
        _ll = {"loop": "apex"}
        reg.gauge(tmc.LEARNER_REPLAY_RATIO,
                  "grad sub-steps per scanned train dispatch",
                  _ll).set(self.replay_ratio)
        reg.gauge(tmc.LEARNER_TRAIN_BATCH,
                  "effective (bucketed) train batch width",
                  _ll).set(self.train_batch)
        reg.gauge(tmc.LEARNER_ACTOR_DTYPE_INFO,
                  "1 for the active actor inference dtype",
                  {**_ll, "dtype": self.actor_dtype}).set(1)
        # Checkpoint/resume: replay-snapshot save wall + bytes; resumes
        # count at the restore site.
        self._tm_ckpt_save = reg.histogram(
            tmc.CHECKPOINT_SAVE_SECONDS,
            "replay-snapshot save wall (flushes + npz write)", _ll)
        self._tm_ckpt_bytes = reg.counter(
            tmc.CHECKPOINT_BYTES,
            "checkpoint bytes written (replay snapshot)", _ll)
        reg.gauge(tmc.CHECKPOINT_SHARDS_SAVED,
                  "replay shards carried by each snapshot",
                  _ll).set(getattr(self.replay, "num_shards", 1))
        # None until the FIRST mirror exists: construction -> first
        # refresh is not mirror staleness.
        self._last_param_refresh = None

    def _dedup_totals(self):
        """(frames_reused, bytes_saved) summed over every LIVE dedup
        decoder plus the retired accumulator (a re-hello replaces an
        actor's decoder with zeroed counters, and its totals fold into
        ``_dedup_retired`` first), so the sum stays monotone."""
        frames, saved = self._dedup_retired
        for dec in self._decoders.values():
            frames += getattr(dec, "frames_reused", 0)
            saved += getattr(dec, "bytes_saved", 0)
        return frames, saved

    def _sweep_dedup_counters(self) -> None:
        frames, saved = self._dedup_totals()
        seen_f, seen_b = self._dedup_swept
        if frames > seen_f:
            self._tm_dedup_frames.inc(frames - seen_f)
        if saved > seen_b:
            self._tm_dedup_bytes.inc(saved - seen_b)
        self._dedup_swept = (frames, saved)

    def _actor_alive_gauge(self, actor_id: int):
        g = self._tm_actor_alive.get(actor_id)
        if g is None:
            g = get_registry().gauge(
                "dqn_actor_alive", "1 while the actor process is alive",
                labels={"actor": str(actor_id)})
            self._tm_actor_alive[actor_id] = g
        return g

    # -- learner state and checkpoints --------------------------------------
    @property
    def _rank(self) -> int:
        """This process's rank in the multi-host group (0 outside one)."""
        return self._mh.mesh.rank if self.distributed else 0

    def _restore_learner(self) -> None:
        """Rank 0 (the only process outside a group) holds the learner's
        checkpointer and restores the newest step; in a multi-host group it
        broadcasts the resumed cursor, every process takes its learner, and
        the other processes keep the save cadence for their own replay
        snapshots. The saved cursor of a multi-host run is the global
        agreed count: local env steps restart at 0 and the offset folds
        into the agreement (else each host's copy would be summed N
        times)."""
        from dist_dqn_tpu_torch.utils.checkpoint import (
            TrainCheckpointer, record_checkpoint_kind)

        resumed = None
        if self._rank == 0:
            self._ckpt = TrainCheckpointer(
                self.rt.checkpoint_dir,
                save_every_frames=self.rt.save_every_steps)
            record_checkpoint_kind(self.rt.checkpoint_dir, "learner")
            restored = self._ckpt.restore_latest(self.state)
            if restored is not None:
                resumed, self.state = restored
        if self.distributed:
            from dist_dqn_tpu_torch.parallel.learner import \
                sync_learner_from_rank0

            mesh = self._mh.mesh
            head = torch.tensor([-1 if resumed is None else resumed],
                                dtype=torch.int64, device=mesh.device)
            mesh.broadcast_([head])
            resumed = None if int(head[0]) < 0 else int(head[0])
            if self._rank != 0:
                self._ckpt = _SaveCadence(self.rt.checkpoint_dir,
                                          self.rt.save_every_steps, resumed)
            if resumed is not None:
                sync_learner_from_rank0(mesh, self.state)
        if resumed is None:
            return
        # The run continues toward the same total_env_steps; the replay
        # refills from the live actors unless its snapshot restores below.
        if self.distributed:
            self._resume_global = resumed
            self.global_env_steps = resumed
        else:
            self.env_steps = resumed
        if self.rt.eval_every_steps:
            self._next_eval = resumed + self.rt.eval_every_steps
        self.log.log_fn(f'{{"resumed_at_env_steps": {resumed}}}')
        if self.rt.checkpoint_replay:
            self._load_replay_snapshot()

    def _refresh_host_params(self) -> None:
        """Multi-host: refresh the copy of the learner's net (and of its
        target, which the feed-forward priority bootstrap reads) that the
        act, bootstrap and eval programs use, after each train burst. The
        optimizer and a restore write the learner in place, so acting reads
        this copy, as JAX's act reads its host mirror: params as stale as
        the last burst."""
        if not self.distributed:
            return
        # Param-broadcast staleness: how old the previous mirror got
        # before this refresh replaced it.
        now = time.perf_counter()
        if self._last_param_refresh is not None:
            self._tm_param_staleness.observe(now - self._last_param_refresh)
        self._last_param_refresh = now
        live = (self.state.net,
                self.state.target_net if self._prio_fn is not None else None)
        if self._host_params is None:
            self._host_params = tuple(
                None if m is None else copy.deepcopy(m).requires_grad_(False)
                for m in live)
            return
        with torch.no_grad():
            for mirror, net in zip(self._host_params, live):
                if mirror is None:
                    continue
                for a, b in zip(mirror.state_dict().values(),
                                net.state_dict().values()):
                    a.copy_(b)

    @property
    def _policy_params(self):
        """The net the act and eval programs read."""
        return self._host_params[0] if self.distributed else self.state.net

    @property
    def _target_policy_params(self):
        """The target net the priority bootstrap reads."""
        return (self._host_params[1] if self.distributed
                else self.state.target_net)

    def _replay_snapshot_path(self) -> str:
        # Multi-host: each process owns its store and snapshots its own
        # file beside the learner checkpoint.
        suffix = f"_p{self._rank}" if self.distributed else ""
        return os.path.join(self.rt.checkpoint_dir,
                            f"replay_shard{suffix}.npz")

    def _emergency_save(self) -> None:
        """The ``apex.checkpoint`` emergency hook (a watchdog abort runs
        it on a side thread): the learner as the last launched train
        event leaves it (``_fence`` is held over each event's launches,
        and the copy queues behind them on the same stream), to a side
        file, and with ``--checkpoint-replay`` the raw store snapshot
        without the quiescing flushes of the periodic save (those touch
        service state the wedged main thread may hold): a salvage
        artifact whose newest in-flight priorities may be missing."""
        from dist_dqn_tpu_torch.utils.checkpoint import (atomic_savez,
                                                        save_emergency)

        save_emergency(os.path.join(self.rt.checkpoint_dir,
                                    "emergency_learner.pt"),
                       lambda: {"learner": self.state}, self._fence,
                       tm_watchdog.EMERGENCY_FENCE_WAIT_S)
        if self.rt.checkpoint_replay and len(self.replay):
            atomic_savez(os.path.join(self.rt.checkpoint_dir,
                                      "emergency_replay.npz"),
                         **self.replay.state_dict())

    def _save_replay_snapshot(self) -> None:
        """Snapshot the shard beside the learner checkpoint, atomically.
        First the transitions still waiting for a priority land (actor
        priorities of this pass, then the pending and in-flight
        bootstraps), then the learner's deferred write-backs apply, so the
        snapshot holds the newest experience and the freshest mass."""
        if not (self.rt.checkpoint_replay and self.rt.checkpoint_dir):
            return
        self._insert_actor_prio()
        self._flush_pending(force=True)
        self._flush_prio_writebacks(force=True)
        if not len(self.replay):
            return
        from dist_dqn_tpu_torch.utils.checkpoint import atomic_savez

        path = self._replay_snapshot_path()
        t0 = time.perf_counter()
        atomic_savez(path, **self.replay.state_dict())
        wall = time.perf_counter() - t0
        self._tm_ckpt_save.observe(wall)
        self._tm_ckpt_bytes.inc(os.path.getsize(path))
        self.log.log_fn(json.dumps({
            "replay_snapshot_s": round(wall, 3),
            "replay_snapshot_mb": round(os.path.getsize(path) / 2**20, 1),
            "replay_snapshot_items": len(self.replay),
            "replay_snapshot_shards": getattr(self.replay, "num_shards",
                                              1)}))

    def _load_replay_snapshot(self) -> None:
        """Restore the snapshot beside the learner checkpoint, if any,
        through ``replay/sharded.py restore_replay_snapshot``: exact at the
        same shard count, a migration across shard counts (every record
        once, its priority kept; write generations reset)."""
        from dist_dqn_tpu_torch.replay.sharded import restore_replay_snapshot

        path = self._replay_snapshot_path()
        if not os.path.exists(path):
            return
        t0 = time.perf_counter()
        with np.load(path) as state:
            info = restore_replay_snapshot(self.replay, dict(state))
        get_registry().counter(
            tmc.CHECKPOINT_RESUMES,
            "successful whole-state resumes",
            {"loop": "apex"}).inc()
        self.replay_snapshot = {
            "replay_snapshot_restored_items": len(self.replay),
            "replay_snapshot_restore_s":
                round(time.perf_counter() - t0, 3),
            "replay_snapshot_resharded": bool(info["resharded"]),
            "replay_snapshot_from_shards": info["from_shards"],
            "replay_snapshot_to_shards": info["to_shards"]}
        self.log.log_fn(json.dumps(self.replay_snapshot))

    # -- actor lifecycle ------------------------------------------------------
    def _spawn_one(self, actor_id: int):
        """(Re)start one actor process; returns its Process handle."""
        from dist_dqn_tpu_torch.actors.actor import run_actor, \
            run_remote_actor

        kwargs = {"transport": self.rt.transport, "dedup": self.rt.wire_dedup}
        if actor_id < self.rt.num_actors:
            # A zero-copy actor attaches its slot ring, POSIX shared memory
            # named "{req}_zc_{id}"; a legacy one the shared request ring
            # in the run's directory. A feeder: host env spawns the feeder
            # in the actor's place, with the same arguments; feeders take
            # the slot batching, actors the dedup switch.
            req = (f"req_{self.run_id}" if self.rt.transport == "zerocopy"
                   else f"{self.run_id}/req")
            target = run_actor
            if self.rt.host_env.startswith("feeder:"):
                from dist_dqn_tpu_torch.actors.feeder import run_feeder
                target = run_feeder
                kwargs = {"transport": self.rt.transport,
                          "shm_batch": self.rt.shm_batch}
            return _spawn_process(
                target,
                (actor_id, self.rt.host_env, self.rt.envs_per_actor,
                 1000 + 7 * actor_id, req, f"{self.run_id}/act_{actor_id}",
                 self.stop_path), kwargs)
        return _spawn_process(
            run_remote_actor,
            (actor_id, self.rt.host_env, self.rt.envs_per_actor,
             1000 + 7 * actor_id, ("127.0.0.1", self.tcp_address[1]),
             self.stop_path), kwargs)

    def spawn_actors(self) -> None:
        for i in range(self.rt.num_actors):
            self.procs[i] = self._spawn_one(i)
        # Locally spawned remote actors: the single-host stand-in for
        # workers on other hosts (actors/remote.py).
        if self.rt.spawn_remote_actors:
            for j in range(self.rt.num_remote_actors):
                actor_id = self.rt.num_actors + j
                self.procs[actor_id] = self._spawn_one(actor_id)

    def supervise_actors(self) -> None:
        """Restart dead actors: they are stateless, and a restarted one's
        hello resets its assembly lanes and recurrent carry. Half the
        fleet dead at once is a degradation, not one death: it sets
        ``dqn_ingest_degraded`` and logs one line per episode of it, as
        the JAX service does."""
        dead = 0
        for actor_id, p in list(self.procs.items()):
            alive = p.is_alive()
            self._actor_alive_gauge(actor_id).set(float(alive))
            if not alive:
                dead += 1
                self.actor_restarts += 1
                self._tm_actor_restarts.inc()
                self.procs[actor_id] = self._spawn_one(actor_id)
        fleet = max(len(self.procs), 1)
        decimated = fleet > 1 and dead * 2 >= fleet
        self._tm_degraded.set(float(decimated))
        if decimated and not self._degraded:
            self._degraded = True
            self.log.log_fn(json.dumps(
                {"ingest_degraded": True, "dead_actors": dead,
                 "fleet": fleet, "env_steps": self.env_steps}))
            self.tracer.instant("ingest_degraded", dead=dead, fleet=fleet)
        elif not decimated and self._degraded:
            self._degraded = False
            self.log.log_fn(json.dumps(
                {"ingest_degraded": False, "env_steps": self.env_steps}))

    def shutdown(self) -> None:
        """Stop the shard sampler, the learner ranks and the actors, close
        the listener (joining its threads), unlink every segment this
        service created and remove its run directory (idempotent; run on
        every exit path of :meth:`run` and of a failed construction). The
        learner ranks are told to stop after a clean run and terminated
        otherwise."""
        if self._shard_sampler is not None:
            self._shard_sampler.close()
        if hasattr(self, "_tm_dedup_frames"):
            self._sweep_dedup_counters()   # final partial-period deltas
        if self.telemetry_server is not None:
            self.telemetry_server.close()
            self.telemetry_server = None
        if self._learners is not None:
            self._learners.close(clean=self._clean_exit)
            self._learners = None
        if self.run_dir is not None:
            try:
                with open(self.stop_path, "w") as f:
                    f.write("stop")
            except OSError:
                pass
        # Closing the listener first ends the remote actors' waits for a
        # reply at once (they see EOF, then the stop file).
        if self.tcp_server is not None:
            self.tcp_server.close()
        for p in self.procs.values():
            p.join(timeout=10)
            if p.is_alive():
                p.terminate()
                p.join(timeout=5)
        self.procs = {}
        if self.req_ring is not None:
            self.req_ring.unlink()
        for ring in self._zc_rings.values():
            self.ingest_torn_reads += ring.torn_reads
            ring.close()
            ring.unlink()
        self._zc_rings = {}
        for b in self.act_boxes:
            b.unlink()
        self.act_boxes = []
        if self.run_dir is not None:
            shutil.rmtree(self.run_dir, ignore_errors=True)

    # -- acting ----------------------------------------------------------------
    def _count_device_call(self, kind: str,
                           rows: Optional[int] = None) -> None:
        """One dispatched device program of ``kind`` (act / fused /
        bootstrap / train / replay_sample). ``rows`` feeds the fan-in
        histogram for the act-path dispatches."""
        self.device_calls[kind] = self.device_calls.get(kind, 0) + 1
        c = self._tm_device_calls.get(kind)
        if c is None:
            c = get_registry().counter(
                tmc.SERVICE_DEVICE_CALLS,
                "device programs dispatched by the service loop",
                labels={"call": kind})
            self._tm_device_calls[kind] = c
        c.inc()
        prog = self._prog_by_kind.get(kind)
        if prog is None:
            prog = devtime.register_program(f"apex.{kind}", loop="apex",
                                            role=kind)
            self._prog_by_kind[kind] = prog
        prog.count_dispatch()
        if rows is not None:
            self._tm_fanin.observe(float(rows))

    def _reply_actions(self, actor: int, obs: np.ndarray, t: int) -> int:
        """Queue one actor's act request for this pass's batched flush;
        returns its request id (the key of its q_max rows)."""
        self._req_seq += 1
        self._act_queue.append((actor, obs, t, self._req_seq))
        return self._req_seq

    def _fused_act_bootstrap(self, obs, eps, boot):
        """The fused ingest call: the batched act of this pass, then one
        pending chunk's priority bootstrap queued behind it on the device,
        its result copied to pinned memory with an event (read on a later
        pass by ``_drain_bootstraps``). One dispatch."""
        b_batch, b_items, b_count = boot
        out = self._act_q(self._policy_params, obs, self._act_gen, eps)
        prios = self._prio_fn(self._policy_params,
                              self._target_policy_params,
                              *self._boot_tensors(b_batch))
        self._boot_inflight.append((_HostCopy(prios), b_items, b_count))
        return out

    def _boot_tensors(self, batch: Dict[str, np.ndarray]):
        dev = self.device
        return tuple(torch.from_numpy(np.ascontiguousarray(batch[k])).to(dev)
                     for k in ("obs", "action", "reward", "discount",
                               "next_obs"))

    def _flush_act_queue(self) -> None:
        """One batched act on the card for every actor that reported this
        pass (a recurrent act threads each actor's carry; a fused one also
        dispatches a pending bootstrap chunk); the actions, and the q
        planes on the actor-priority path, go back to each actor."""
        if not self._act_queue:
            return
        burst, self._act_queue = self._act_queue, []
        obs_cat, eps, rows, total = pack_act_rows(
            [obs for _, obs, _, _ in burst],
            [self.actor_eps[actor] for actor, _, _, _ in burst])
        dev = self.device
        obs_t = torch.from_numpy(obs_cat).to(dev)
        eps_t = torch.from_numpy(eps).to(dev)
        boot = self._pop_boot_batch() if self._fused else None
        with self.tracer.span("act.batched", actors=len(burst), rows=total,
                              fused_bootstrap=boot is not None):
            if self.recurrent:
                lstm = self.cfg.network.lstm_size
                cs, hs = [], []
                for (actor, _, _, _), r in zip(burst, rows):
                    carry = self._carry[actor]
                    if carry is None:
                        carry = (np.zeros((r, lstm), np.float32),) * 2
                    # The assembler stores the carry entering this step.
                    self._prev_carry[actor] = carry
                    cs.append(carry[0])
                    hs.append(carry[1])
                pad = np.zeros((obs_cat.shape[0] - total, lstm),
                               np.float32)
                carry_t = tuple(
                    torch.from_numpy(np.concatenate(x + [pad])).to(dev)
                    for x in (cs, hs))
                (c, h), actions, q_sel, q_max = self._act_rec(
                    self._policy_params, carry_t, obs_t, self._act_gen,
                    eps_t)
                self._count_device_call("act", rows=total)
                out = torch.cat([c.float(), h.float(),
                                 torch.stack([actions.float(), q_sel, q_max],
                                             dim=1)], dim=1).cpu().numpy()
                c_np = out[:, :lstm]
                h_np = out[:, lstm:2 * lstm]
                acts_np, qs_np, qm_np = (out[:, 2 * lstm + j]
                                         for j in range(3))
            else:
                if boot is not None:
                    actions, q_sel, q_max = self._fused_act_bootstrap(
                        obs_t, eps_t, boot)
                    self._count_device_call("fused_act_bootstrap",
                                            rows=total)
                else:
                    actions, q_sel, q_max = self._act_q(
                        self._policy_params, obs_t, self._act_gen, eps_t)
                    self._count_device_call("act", rows=total)
                out = torch.stack([actions.float(), q_sel,
                                   q_max]).cpu().numpy()
                acts_np, qs_np, qm_np = out
            acts_np = acts_np.astype(np.int32)
            qs_np = np.ascontiguousarray(qs_np, np.float32)
            qm_np = np.ascontiguousarray(qm_np, np.float32)
            off = 0
            for (actor, obs, t, rid), r in zip(burst, rows):
                sl = slice(off, off + r)
                off += r
                if self.recurrent:
                    self._carry[actor] = (c_np[sl], h_np[sl])
                    self._prev_q[actor] = (qs_np[sl], qm_np[sl])
                self._prev_actions[actor] = acts_np[sl]
                self._prev_obs[actor] = obs
                q_rows = None
                if self.actor_prio:
                    # Transitions the same record emitted bootstrap from
                    # these rows: their bootstrap obs is the obs acted on
                    # here.
                    q_rows = (qs_np[sl], qm_np[sl])
                    self._flush_q[rid] = qm_np[sl]
                    self._last_flush_q[actor] = qm_np[sl]
                if actor in self._decoders:
                    payload = ingest.encode_reply(
                        acts_np[sl], actor=actor, t=t,
                        shard=self.router.shard_for(actor),
                        q_sel=q_rows[0] if q_rows else None,
                        q_max=q_rows[1] if q_rows else None,
                        params_version=int(self.grad_steps))
                else:
                    payload = encode_arrays({"action": acts_np[sl]})
                if actor < self.rt.num_actors:
                    self.act_boxes[actor].write(payload, version=t + 1)
                else:
                    conn = self._actor_conn.get(actor)
                    if conn is not None:
                        self.tcp_server.send(conn, payload)

    # -- ingest ----------------------------------------------------------------
    def _hello_reject(self, detail: str, conn_id: Optional[int] = None):
        """Refuse a hello: a TCP peer gets a structured NACK (it raises
        rather than reconnecting), then the error surfaces as one counted
        bad record on TCP and as a service error on shared memory."""
        from dist_dqn_tpu_torch.actors.transport import \
            PROTO_MISMATCH_NACK_KIND

        self.hello_rejects += 1
        if conn_id is not None and self.tcp_server is not None:
            self.tcp_server.send(conn_id, encode_arrays(
                {}, {"kind": PROTO_MISMATCH_NACK_KIND, "detail": detail}))
        raise self.HelloRejectedError(f"hello rejected: {detail}")

    def _validate_hello(self, actor: int, meta: Dict,
                        conn_id: Optional[int] = None) -> None:
        """Protocol version and transport negotiation; a zero-copy hello
        also registers the decoder every later frame of the session goes
        through, and sizes the actor's assembler to its declared lanes."""
        proto = meta.get("proto")
        if proto is not None and int(proto) != ingest.PROTOCOL_VERSION:
            self._hello_reject(
                f"actor {actor} speaks wire protocol {proto}, service "
                f"speaks {ingest.PROTOCOL_VERSION} — upgrade in lockstep",
                conn_id)
        peer_transport = meta.get("transport", "legacy")
        if peer_transport == "zerocopy" and self.rt.transport != "zerocopy":
            self._hello_reject(
                f"actor {actor} wants zerocopy transport but the "
                f"service runs --transport legacy", conn_id)
        if peer_transport != "zerocopy":
            return
        if "schema" not in meta:
            self._hello_reject(
                f"zerocopy hello from actor {actor} without a "
                f"trajectory schema", conn_id)
        schema = ingest.TrajectorySchema.from_dict(meta["schema"])
        obs_field = schema.fields[0] if schema.fields else None
        if (obs_field is None or obs_field.name != "obs"
                or schema != ingest.step_schema(obs_field.shape,
                                                obs_field.dtype,
                                                schema.lanes)):
            self._hello_reject(
                f"actor {actor} declared a non-canonical step "
                f"schema {schema.to_dict()}", conn_id)
        old = self._decoders.get(actor)
        if old is not None and hasattr(old, "bytes_saved"):
            # A re-hello replaces the decoder: keep its savings counted.
            frames, saved = self._dedup_retired
            self._dedup_retired = (frames + old.frames_reused,
                                   saved + old.bytes_saved)
        dedup_fs = int(meta.get("dedup", 0) or 0)
        if dedup_fs and not self.rt.wire_dedup:
            self._hello_reject(
                f"actor {actor} declared frame dedup but the "
                f"service runs --no-wire-dedup — restart the "
                f"worker with --no-wire-dedup", conn_id)
        if dedup_fs:
            try:
                ingest.validate_dedup_stack(schema, dedup_fs)
            except ValueError as e:
                self._hello_reject(
                    f"actor {actor} declared frame dedup the "
                    f"schema cannot carry: {e}", conn_id)
            # Decoded stacks are views into the decoder's rolling frame
            # history; the n-step or sequence assembler holds them
            # longest, so the history outlives its window even if every
            # record reseeds.
            hold = (self.seq_len + (self.cfg.replay.sequence_stride
                                    or self.cfg.replay.unroll_length)
                    if self.recurrent else self.cfg.learner.n_step)
            self._decoders[actor] = ingest.DedupStepDecoder(
                schema, dedup_fs, t0=int(meta["t"]),
                history=max(32, (hold + 4) * dedup_fs + 2 * dedup_fs))
        else:
            self._decoders[actor] = ingest.StepDecoder(schema)
        asm = self.assemblers[actor]
        cur_lanes = getattr(asm, "num_lanes", None) \
            or len(getattr(asm, "lanes", ()))
        if self.actor_prio and (not getattr(asm, "with_q", False)
                                or cur_lanes != schema.lanes):
            # The q planes ride this actor's frames: a q-aware assembler
            # at the declared lane count (swapped on the first
            # negotiation or a lane change only, so a re-hello keeps the
            # drained-but-uninserted output).
            self.assemblers[actor] = NStepAssembler(
                schema.lanes, self.cfg.learner.n_step,
                self.cfg.learner.gamma, with_q=True)
        elif not self.actor_prio and cur_lanes != schema.lanes:
            self.assemblers[actor] = self._asm_factory(schema.lanes)

    def _handle_record(self, payload: bytes, conn_id: Optional[int] = None,
                       transport_kind: str = "legacy") -> None:
        if ingest.is_zc(payload):
            try:
                hdr = ingest.peek_header(payload)
                dec = self._decoders.get(hdr["actor"])
                if dec is None:
                    raise ingest.WireFormatError(
                        f"zero-copy record for actor {hdr['actor']} "
                        f"before a schema hello")
                arrays, meta = dec.decode(payload, hdr=hdr)
            except ingest.WireFormatError as e:
                self.router.decode_error(type(e).__name__)
                if conn_id is not None and self.tcp_server is not None:
                    # The lock-step sender's action will never come: NACK
                    # so it reconnects now.
                    from dist_dqn_tpu_torch.actors.transport import \
                        CORRUPT_FRAME_NACK_KIND
                    self.tcp_server.send(conn_id, encode_arrays(
                        {}, {"kind": CORRUPT_FRAME_NACK_KIND}))
                raise
        else:
            arrays, meta = decode_arrays(payload)
            # The ingest labels name the codec, not the channel.
            transport_kind = "legacy"
        actor, t = int(meta["actor"]), int(meta["t"])
        if conn_id is not None:
            # Only the remote id range is valid over TCP, and replies go
            # to the connection the actor's latest record came on.
            if not self.rt.num_actors <= actor < self.total_actors:
                raise ValueError(f"TCP record for out-of-range actor id "
                                 f"{actor}")
            self._actor_conn[actor] = conn_id
        elif not 0 <= actor < self.rt.num_actors:
            raise ValueError(f"shm record for out-of-range actor id {actor}")
        for key in ("obs", "next_obs"):
            arr = arrays.get(key)
            if arr is None:
                continue
            if self._obs_spec is None:
                self._obs_spec = (arr.shape[1:], arr.dtype)
            elif (arr.shape[1:] != self._obs_spec[0]
                  or arr.dtype != self._obs_spec[1]):
                raise ValueError(
                    f"actor {actor} {key} {arr.shape[1:]}/{arr.dtype} does "
                    f"not match the session spec {self._obs_spec}")
        self.router.record(actor, len(payload), transport_kind)
        self.records_by_actor[actor] = self.records_by_actor.get(actor,
                                                                 0) + 1
        if meta["kind"] == "hello":
            self._validate_hello(actor, meta, conn_id)
            self._record_seen()
            if self._prev_obs[actor] is not None:
                # A re-hello is a reconnect: drop the partial windows, the
                # partial episode returns and the recurrent carry (the
                # next act restarts it from zeros) rather than bridge the
                # gap.
                self.assemblers[actor].reset()
                self._ep_accum.pop(actor, None)
                if self.recurrent:
                    self._carry[actor] = None
            self._reply_actions(actor, arrays["obs"], t)
            return
        if self._prev_obs[actor] is None:
            raise ValueError(f"step record for actor {actor} before hello")
        self._record_seen()
        terminated = arrays["terminated"].astype(bool)
        truncated = arrays["truncated"].astype(bool)
        self._track_episode_returns(actor, arrays["reward"], terminated,
                                    truncated)
        asm = self.assemblers[actor]
        if self.recurrent:
            asm.step(self._prev_obs[actor], self._prev_actions[actor],
                     arrays["reward"], terminated, truncated,
                     *self._prev_carry[actor], *self._prev_q[actor])
            # Zero the carry of lanes whose episode just ended, before the
            # next act (their incoming obs rows are post-reset).
            done = np.logical_or(terminated, truncated)
            if done.any():
                keep = (~done).astype(np.float32)[:, None]
                c = self._carry[actor]
                self._carry[actor] = (c[0] * keep, c[1] * keep)
        elif getattr(asm, "with_q", False):
            q_sel = meta.get("q_sel")
            if q_sel is None:
                raise ValueError(
                    f"actor {actor} negotiated actor-side "
                    f"priorities but shipped a frame without q "
                    f"planes")
            asm.step(self._prev_obs[actor], self._prev_actions[actor],
                     arrays["reward"], terminated, truncated,
                     arrays["next_obs"], q_sel=q_sel, q_max=meta["q_max"])
        else:
            asm.step(self._prev_obs[actor], self._prev_actions[actor],
                     arrays["reward"], terminated, truncated,
                     arrays["next_obs"])
        self.env_steps += arrays["reward"].shape[0]
        self._tm_env_steps.inc(arrays["reward"].shape[0])
        if not self.recurrent and getattr(asm, "with_q", False):
            # This record's emissions bootstrap from the obs the act
            # request below flushes q planes for: park them under its id.
            rid = self._reply_actions(actor, arrays["obs"], t)
            emitted = asm.drain()
            if emitted is not None:
                self._stamp_lineage(emitted, meta)
                self._prio_await.append((actor, rid, emitted))
            return
        emitted = asm.drain()
        if emitted is not None:
            if self.recurrent:
                # The R2D2 seeding rule: TD magnitudes from the act's q
                # planes the assembler recorded, no extra device pass.
                from dist_dqn_tpu_torch.actors.assembler import \
                    initial_sequence_priorities
                prios = initial_sequence_priorities(
                    emitted, self.cfg.replay.burn_in,
                    self.cfg.replay.unroll_length, self.cfg.learner.gamma,
                    self.cfg.replay.priority_mix,
                    self.cfg.learner.value_rescale)
                emitted.pop("q_sel")
                emitted.pop("q_max")
                self.replay.add(emitted, priorities=prios,
                                shard=self.router.shard_for(actor))
            else:
                self._stamp_lineage(emitted, meta)
                self._pending.append(emitted)
                self._pending_count += emitted["action"].shape[0]
        self._reply_actions(actor, arrays["obs"], t)

    def _stamp_lineage(self, emitted: Dict, meta: Dict) -> None:
        """Attach the record's wire lineage stamp to every transition it
        emitted (JAX ``_stamp_lineage``). Record granularity: an n-step
        window spans at most n_step actor steps, so the completing
        record's birth time and acting-params version bound the whole
        window. The stores are field-generic (add, sample, snapshot and
        reshard carry any key) and every path to the card names its
        fields (``_host_batch``, ``_boot_tensors``; the learner ranks
        broadcast what ``_host_batch`` selected), so the two host lanes
        ride to sample time and never reach the card or a collective."""
        bt = meta.get("birth_time")
        if bt is None:
            return
        n = emitted["action"].shape[0]
        emitted["lineage_birth_time"] = np.full(n, bt, np.float64)
        emitted["lineage_params_version"] = np.full(
            n, int(meta.get("params_version", 0)), np.int64)

    def _insert_actor_prio(self) -> None:
        """Insert the transitions parked this pass with priorities
        ``|q_start - (R + discount * q_max[boot_lane])|`` in numpy: the
        frames shipped ``q_start``, this pass's act flush produced the
        bootstrap's ``q_max``, and episode-end windows carry their own
        in-band ``boot_q``. Terminal windows have discount 0."""
        if not self._prio_await:
            self._flush_q.clear()
            return
        pend, self._prio_await = self._prio_await, []
        for actor, rid, emitted in pend:
            q_max = self._flush_q.get(rid)
            if q_max is None:
                # The loop ended between drain and flush: the actor's
                # last planes stand in for one record.
                q_max = self._last_flush_q.get(actor)
            q_start = emitted.pop("q_start")
            boot_lane = emitted.pop("boot_lane")
            boot_q = emitted.pop("boot_q")
            boot = (q_max[boot_lane] if q_max is not None
                    else np.zeros_like(q_start))
            boot = np.where(np.isnan(boot_q), boot, boot_q)
            prios = np.abs(q_start - (emitted["reward"]
                                      + emitted["discount"] * boot))
            with self.tracer.span("priority.actor_insert",
                                  count=int(prios.shape[0])):
                self.replay.add(emitted, priorities=prios,
                                shard=self.router.shard_for(actor))
            self._tm_actor_prio.inc(int(prios.shape[0]))
        self._flush_q.clear()

    # -- the learner-side bootstrap ----------------------------------------
    def _pop_boot_batch(self, force: bool = False):
        """Take up to ``_PRIO_MAX_ROWS`` pending transitions for one
        bootstrap dispatch -> (padded batch, true items, count), or None
        below ``_PRIO_CHUNK`` unless forced. The batch pads to
        ``_PRIO_CHUNK`` or ``_PRIO_MAX_ROWS`` rows by repeating its last row,
        whose priorities are computed and then discarded."""
        if self._pending_count == 0:
            return None
        if not force and self._pending_count < _PRIO_CHUNK:
            return None
        # One concatenation per backlog; a stored remainder is sliced into
        # views, so draining a backlog copies each byte once.
        if len(self._pending) == 1:
            cat = self._pending[0]
        else:
            cat = {k: np.concatenate([p[k] for p in self._pending])
                   for k in self._pending[0]}
        n = cat["action"].shape[0]
        take = min(n, _PRIO_MAX_ROWS)
        if n > take:
            self._pending = [{k: v[take:] for k, v in cat.items()}]
            self._pending_count = n - take
        else:
            self._pending, self._pending_count = [], 0
        items = {k: v[:take] for k, v in cat.items()}
        padded = _PRIO_CHUNK if take <= _PRIO_CHUNK else _PRIO_MAX_ROWS
        if padded != take:
            pad = padded - take
            batch = {k: np.concatenate([v, np.repeat(v[-1:], pad, axis=0)])
                     for k, v in items.items()}
        else:
            batch = items
        return batch, items, take

    def _flush_pending(self, force: bool = False) -> None:
        """Dispatch the priority bootstraps of the pending transitions and
        insert those whose priorities are back. Pipelined as the train
        steps are: a chunk's result is read on a later pass, so its items
        enter the shard a few passes late and the device round trip stays
        off the ingest path."""
        self._drain_bootstraps(force)
        if self._pending_count == 0:
            return
        if self.rt.fused_ingest and self._prio_fn is not None:
            # Whatever the fused act did not take this pass goes out in
            # bucketed batches of up to _PRIO_MAX_ROWS.
            while True:
                popped = self._pop_boot_batch(force)
                if popped is None:
                    break
                batch, items, count = popped
                with self.tracer.span("priority.bootstrap.dispatch",
                                      count=count,
                                      rows=batch["action"].shape[0]):
                    prios = self._prio_fn(self._policy_params,
                                          self._target_policy_params,
                                          *self._boot_tensors(batch))
                    self._count_device_call("bootstrap")
                self._boot_inflight.append((_HostCopy(prios), items, count))
        else:
            if not force and self._pending_count < _PRIO_CHUNK:
                return
            cat = {k: np.concatenate([p[k] for p in self._pending])
                   for k in self._pending[0]}
            self._pending, self._pending_count = [], 0
            n = cat["action"].shape[0]
            with self.tracer.span("priority.bootstrap.dispatch", count=n):
                self._dispatch_bootstraps(cat, n)
        if force:
            self._drain_bootstraps(True)

    def _dispatch_bootstraps(self, cat: Dict[str, np.ndarray],
                             n: int) -> None:
        """The split path: one bootstrap dispatch per ``_PRIO_CHUNK`` rows,
        the last chunk padded by repeating its last row."""
        for lo in range(0, n, _PRIO_CHUNK):
            hi = min(lo + _PRIO_CHUNK, n)
            pad = _PRIO_CHUNK - (hi - lo)
            batch = {k: (np.concatenate([v[lo:hi],
                                         np.repeat(v[hi - 1:hi], pad,
                                                   axis=0)])
                         if pad else v[lo:hi])
                     for k, v in cat.items()}
            prios = self._prio_fn(self._policy_params,
                                  self._target_policy_params,
                                  *self._boot_tensors(batch))
            self._count_device_call("bootstrap")
            self._boot_inflight.append(
                (_HostCopy(prios), {k: v[lo:hi] for k, v in cat.items()},
                 hi - lo))

    def _drain_bootstraps(self, block: bool = False) -> None:
        """Insert the chunks whose priorities are on the host. Polls each
        chunk's event unless ``block``; past ``pipeline_depth + 2`` chunks
        the oldest is waited for, so the backlog stays bounded."""
        limit = self.rt.pipeline_depth + 2
        while self._boot_inflight:
            prios, items, count = self._boot_inflight[0]
            if not block and len(self._boot_inflight) <= limit \
                    and not prios.ready():
                return
            self._boot_inflight.popleft()
            with self.tracer.span("priority.bootstrap.insert", count=count):
                self.replay.add(items, priorities=prios.numpy()[:count])

    def _record_seen(self) -> None:
        self._last_record = time.perf_counter()
        self._stall_warned = False

    def _watchdog(self, now: float) -> None:
        """Warn once per ingest stall (actors alive but silent)."""
        if not self.rt.stall_warn_s:
            return
        silent = now - self._last_record
        if silent >= self.rt.stall_warn_s and not self._stall_warned:
            self._stall_warned = True
            self._tm_stalls.inc()
            self.log.log_fn(f'{{"ingest_stalled_s": {silent:.1f}, '
                            f'"env_steps": {self.env_steps}}}')
            self.tracer.instant("ingest_stalled", silent_s=round(silent, 1))

    def _track_episode_returns(self, actor: int, reward: np.ndarray,
                               terminated: np.ndarray,
                               truncated: np.ndarray) -> None:
        """Per-lane raw-reward sums -> completed episode returns."""
        acc = self._ep_accum.get(actor)
        if acc is None or acc.shape != reward.shape:
            acc = np.zeros_like(reward, dtype=np.float64)
        acc = acc + reward
        done = np.logical_or(terminated, truncated)
        if done.any():
            self._ep_returns.extend(acc[done].tolist())
            self.episodes_completed += int(done.sum())
            self._tm_episodes.inc(int(done.sum()))
            acc = np.where(done, 0.0, acc)
        self._ep_accum[actor] = acc

    def _count_bad_record(self, where: str, e: Exception) -> None:
        self.bad_records += 1
        self._tm_bad_records.inc()
        if self.bad_records <= 5:
            self.log.log_fn(f"# bad {where} record ({self.bad_records}): "
                            f"{type(e).__name__}: {e}")

    def _drain_transports(self, burst: int = 256) -> bool:
        """One ingest pass over every local actor's slot ring, the shared
        request ring (legacy codec) and the TCP listener; returns whether
        a record arrived. A record the codec or a check rejects costs one
        ``bad_records``, not the run; a rejected same-host hello raises."""
        drained = False
        for actor_id, ring in self._zc_rings.items():
            for _ in range(burst):
                rec = ring.pop()
                if rec is None:
                    break
                drained = True
                try:
                    with self.tracer.span("ingest.shm_record"):
                        self._handle_record(rec, transport_kind="shm")
                except self.HelloRejectedError:
                    raise
                except Exception as e:  # noqa: BLE001 — counted, logged
                    self._count_bad_record(f"shm actor {actor_id}", e)
        for _ in range(burst):
            rec = self.req_ring.pop()
            if rec is None:
                break
            drained = True
            with self.tracer.span("ingest.shm_record"):
                self._handle_record(rec)
        if self.tcp_server is not None:
            for _ in range(burst):
                rec = self.tcp_server.pop()
                if rec is None:
                    break
                drained = True
                conn_id, payload = rec
                try:
                    with self.tracer.span("ingest.tcp_record"):
                        self._handle_record(payload, conn_id=conn_id,
                                            transport_kind="tcp")
                except Exception as e:  # noqa: BLE001 — untrusted input
                    self._count_bad_record("TCP", e)
        if drained:
            self.ingest_passes += 1
            self._tm_ingest_passes.inc()
        return drained

    # -- learner ---------------------------------------------------------------
    def _min_fill_items(self) -> int:
        """min_fill counts transitions; sequences cover unroll_length
        loss steps each."""
        if not self.recurrent:
            return self.cfg.replay.min_fill
        per_seq = max(self.cfg.replay.unroll_length, 1)
        return max(self.cfg.replay.min_fill // per_seq,
                   2 * self.cfg.learner.batch_size)

    def _inserts_per_grad(self) -> int:
        """inserts_per_grad_step counts transitions; in sequence mode the
        store counts sequences of unroll_length loss transitions."""
        inserts = self.rt.inserts_per_grad_step
        if self.recurrent:
            inserts = max(
                inserts // max(self.cfg.replay.unroll_length, 1), 1)
        return inserts

    def _sample_replay(self, batch_size: int, beta: float):
        """One draw -> (items, idx, IS weights, generations): through the
        per-shard sampling service when armed (a pre-packed batch whose
        generations were read at draw time under the shard locks), else
        the store's inline draw, counting one ``replay_sample`` device call
        per plane draw dispatched (one per shard that takes rows)."""
        if self._shard_sampler is not None:
            out = self._shard_sampler.sample(batch_size, beta)
        else:
            items, idx, weights = self.replay.sample(batch_size, beta)
            if self.rt.device_sampling:
                seen = (self.replay.device_sample_dispatches
                        if hasattr(self.replay, "device_sample_dispatches")
                        else self.replay.device_sampler.draw_dispatches)
                for _ in range(seen - self._replay_draws_counted):
                    self._count_device_call("replay_sample")
                self._replay_draws_counted = seen
            out = items, idx, weights, self.replay.generation(idx)
        # Batches without lineage keys are a silent no-op.
        tmc.observe_sample_lineage(out[0], self.grad_steps,
                                   self._tm_sample_age,
                                   self._tm_sample_staleness)
        return out

    def _host_sequence_sample(self, items, weights):
        """Host [S, L, ...] arrays -> a time-major numpy SequenceSample."""
        from dist_dqn_tpu_torch.types import SequenceSample

        def tm(x):  # [S, L, ...] -> [L, S, ...]
            return np.moveaxis(x, 0, 1)

        S = items["action"].shape[0]
        return SequenceSample(
            obs=tm(items["obs"]), action=tm(items["action"]),
            reward=tm(items["reward"]), done=tm(items["done"]),
            reset=tm(items["reset"]),
            start_state=(np.asarray(items["state_c"], np.float32),
                         np.asarray(items["state_h"], np.float32)),
            weights=np.asarray(weights, np.float32),
            t_idx=np.zeros((S,), np.int32),     # the store keeps its own
            b_idx=np.zeros((S,), np.int32))     # indices (idx)

    def _host_batch(self, batch_size: int, beta: float):
        """The train event's host arguments and (idx, gen): one sequence
        batch, or ``replay_ratio`` independent transition draws stacked on
        a leading axis with (idx, gen) concatenated in draw order."""
        from dist_dqn_tpu_torch.types import Transition

        if self.recurrent:
            with self.tracer.span("replay.sample", batch=batch_size):
                items, idx, weights, gen = self._sample_replay(batch_size,
                                                               beta)
            return (self._host_sequence_sample(items, weights),), (idx, gen)
        span = {"substeps": self.replay_ratio} if self.replay_ratio > 1 \
            else {}
        with self.tracer.span("replay.sample", batch=batch_size, **span):
            draws = [self._sample_replay(batch_size, beta)
                     for _ in range(self.replay_ratio)]
        cols = []
        for k in ("obs", "action", "reward", "discount", "next_obs"):
            arr = np.stack([d[0][k] for d in draws])
            cols.append(arr.astype(np.int64) if k == "action" else arr)
        weights = np.stack([np.asarray(d[2], np.float32) for d in draws])
        aux = (np.concatenate([d[1] for d in draws]),
               np.concatenate([d[3] for d in draws]))
        return (Transition(*cols), weights), aux

    def _to_device(self, host):
        from dist_dqn_tpu_torch.replay.staging import tree_map

        return tree_map(lambda x: torch.from_numpy(np.ascontiguousarray(x))
                        .to(self.device), host)

    def _train_event(self, *args):
        """One train event: the sequence learner's step, or
        ``replay_ratio`` steps over the stacked batches (the JAX service's
        scan over ``train_step``; priorities stacked in sub-step order,
        loss the sub-step mean). With learner ranks the event runs on
        every rank, each on its rows, and the priorities come back in
        global row order."""
        from dist_dqn_tpu_torch.actors.learner_ranks import make_scan_step

        if self.recurrent:
            sample = args[0]
            if sample.action.dtype != torch.int64:
                sample = sample._replace(action=sample.action.long())
            args = (sample,)
        if self._census_args is None and not self._prog_train.cost_attached:
            # Taken after this event retires (_finalize_train), off the
            # retirement intervals the train program's seconds come from.
            self._census_args = args
        if self._learners is not None:
            self.state, m = self._learners.train(
                self.state, args, scan=not self.recurrent)
        elif self.recurrent:
            self.state, m = self._train_step(self.state, *args)
        else:
            self.state, m = make_scan_step(self._train_step)(self.state,
                                                             *args)
        return m

    def _attach_train_cost(self, args) -> None:
        """The train program's one-shot census (JAX ``_attach_train_cost``,
        actors/service.py:924): one event on copies of the learner and
        the first event's batch, over ``replay_ratio`` (one execution is
        one sub-step). The learner ranks' and the multi-host steps
        all-reduce, which cannot run on one process alone: their cost is
        left unknown, exactly once."""
        from dist_dqn_tpu_torch.actors.learner_ranks import make_scan_step

        if self._learners is not None or self.distributed:
            self._prog_train.attach_cost({})
            return
        step = (self._learner_step if self.recurrent
                else make_scan_step(self._learner_step))
        self._prog_train.attach_cost(lambda: flops.scaled_sum([(
            1.0 / self.replay_ratio,
            flops.census(step, self.state, *args))]))

    def _maybe_train(self) -> None:
        if self.distributed:
            return self._maybe_train_distributed()
        if len(self.replay) < self._min_fill_items():
            return
        target = (self.replay.added * self.replay_ratio
                  // self._inserts_per_grad())
        self._train_to_target(target, self.env_steps, self.train_batch)

    def _maybe_train_distributed(self) -> None:
        """Multi-host cadence (actors/multihost.py): agree on the global
        counters at most every ``sync_every_s``, then every process runs
        the same number of collective train steps, each on its own store's
        rows. Ingestion stays asynchronous; only this is lockstep."""
        if time.perf_counter() < self._next_sync:
            return
        ready = int(len(self.replay) >= self._min_fill_items())
        agreed = self._mh.agree(np.array(
            [self.replay.added, ready, self.env_steps], np.int64))
        self._next_sync = time.perf_counter() + self.rt.sync_every_s
        g_added, ready_count, g_env = (int(v) for v in agreed)
        # A resumed run's saved cursor re-enters here, once.
        self.global_env_steps = g_env + self._resume_global
        if ready_count < self._mh.nprocs:
            return  # some host's store is still below min_fill
        target = g_added // self._inserts_per_grad()
        before = self.grad_steps
        self._train_to_target(target, self.global_env_steps,
                              self._local_batch)
        if self.grad_steps > before:
            # A fresh copy for the act, bootstrap and eval programs.
            self._refresh_host_params()

    def _train_to_target(self, target_grad_steps: int, progress_steps: int,
                         batch_size: int) -> None:
        cfg = self.cfg
        target_grad_steps = min(
            target_grad_steps,
            self.grad_steps + max(self.rt.train_steps_per_pass, 1))
        beta = min(1.0, cfg.replay.importance_exponent
                   + (1 - cfg.replay.importance_exponent)
                   * progress_steps / max(self.rt.total_env_steps, 1))
        while self.grad_steps < target_grad_steps:
            if self._t_first_train is None:
                self._t_first_train = time.perf_counter()
            self._profile_start()
            span = ({"substeps": self.replay_ratio}
                    if self.replay_ratio > 1 else {})
            if self._stager is not None:
                # Batch g comes off the stager (uploaded while step g-1
                # trained); batch g+1 is staged right after g's dispatch.
                if len(self._stager) == 0:
                    self._stage_batch(batch_size, beta)
                args, (idx, gen) = self._stager.pop()
                with self.tracer.span("train_step.dispatch", **span), \
                        self._fence.held():
                    metrics = self._train_event(*args)
                if self.grad_steps + self.replay_ratio < target_grad_steps:
                    self._stage_batch(batch_size, beta)
            else:
                host, (idx, gen) = self._host_batch(batch_size, beta)
                with self.tracer.span("train_step.dispatch", **span), \
                        self._fence.held():
                    metrics = self._train_event(*self._to_device(host))
            self._count_device_call("train")
            self.grad_steps += self.replay_ratio
            self._tm_grad_steps.inc(self.replay_ratio)
            self._in_flight.append((idx, gen, metrics, time.perf_counter()))
            while len(self._in_flight) > self.rt.pipeline_depth:
                self._finalize_train()

    def _stage_batch(self, batch_size: int, beta: float) -> None:
        """Sample one event's batch and begin its upload behind the
        stager: the sample and upload of event g+1 overlap event g."""
        host, aux = self._host_batch(batch_size, beta)
        span = ({"substeps": self.replay_ratio} if self.replay_ratio > 1
                else {})
        with self.tracer.span("h2d.stage", batch=batch_size, **span):
            self._stager.stage(host, aux)

    def _profile_start(self) -> None:
        if self._profile_tracer.start():
            self._profile_t0 = time.perf_counter()

    def _profile_stop(self) -> None:
        """End the trace at the first train event's retirement: from its
        first dispatch to its priorities on the host."""
        t0 = time.perf_counter()
        if not self._profile_tracer.stop():
            return
        from dist_dqn_tpu_torch.train import _write_profile

        self.profile_row = _write_profile(
            self._profile_tracer.profile, self.rt.profile_dir,
            time.perf_counter() - self._profile_t0,
            self.device.type == "cuda")
        self.loop_s["trace"] += time.perf_counter() - t0
        self.log.log_fn(json.dumps(self.profile_row))

    def _flush_ledger_window(self) -> None:
        """Close the current utilization-ledger window: wall since the
        last flush against the train program's device-seconds delta
        (JAX actors/service.py:2032-2043); unattributed wall lands in
        the `other` bucket."""
        now = time.perf_counter()
        busy_total = self._prog_train.device_seconds
        self._ledger.observe_chunk(now - self._ledger_t_last,
                                   busy_total - self._ledger_busy_seen)
        self._ledger_t_last = now
        self._ledger_busy_seen = busy_total

    def _finalize_train(self) -> None:
        """Read the oldest in-flight event's priorities back and queue
        them for the next batched write-back."""
        if not self._in_flight:
            return
        idx, gen, metrics, t_dispatch = self._in_flight.popleft()
        # One read: the priorities, then the loss (and the grad norm of a
        # step that reports one; a scanned event reports the mean loss).
        scalars = [metrics[k] for k in ("loss", "grad_norm") if k in metrics]
        prios = metrics["priorities"].float().reshape(-1)
        out = torch.cat([prios] + [x.float().reshape(1) for x in scalars]
                        ).cpu().numpy()
        n = prios.shape[0]
        # Dispatch -> materialized: the read above waited for this step
        # (and up to pipeline_depth - 1 queued before it).
        t_retire = time.perf_counter()
        self._tm_grad_latency.observe(t_retire - t_dispatch)
        # Device seconds at this fence the loop already holds: the wall
        # from max(dispatch, previous retirement) to now is the interval
        # this event occupied the device queue, so overlapping in-flight
        # events never count twice (queue-occupied, not kernel-active).
        busy = t_retire - max(t_dispatch, self._devtime_anchor)
        self._prog_train.add_device_seconds(busy)
        if self.distributed:
            self._mh.program.add_device_seconds(busy)
        self._devtime_anchor = t_retire
        if self._census_args is not None:
            self._attach_train_cost(self._census_args)
            self._census_args = None
            self._devtime_anchor = time.perf_counter()
        self._last_loss = float(out[n])
        # The divergence sentinel on every retired event's loss (and grad
        # norm), from the one read above, no device read of its own:
        # NaN/Inf dumps a forensics bundle once instead of the run
        # training on to garbage.
        tm_watchdog.observe_divergence(
            loss=self._last_loss,
            grad_norm=float(out[n + 1]) if len(scalars) > 1 else None,
            step=self.grad_steps)
        self._prio_pending.append((idx, out[:n], gen))
        self._profile_stop()
        self._flush_prio_writebacks()

    def _flush_prio_writebacks(self, force: bool = False) -> None:
        """Apply the queued priorities as one update once
        ``prio_writeback_batch`` events are pending (or when forced); the
        generation guard drops slots overwritten since their draw, and
        the draw-order concatenation keeps the last write of a slot."""
        if not self._prio_pending:
            return
        if not force and len(self._prio_pending) < max(
                self.rt.prio_writeback_batch, 1):
            return
        pending, self._prio_pending = self._prio_pending, []
        idx = np.concatenate([e[0] for e in pending])
        with self.tracer.span("replay.update_priorities",
                              steps=len(pending), rows=idx.shape[0]):
            self.replay.update_priorities(
                idx, np.concatenate([e[1] for e in pending]),
                expected_gen=np.concatenate([e[2] for e in pending]))

    def _finalize_all_train(self) -> None:
        while self._in_flight:
            self._finalize_train()
        self._flush_prio_writebacks(force=True)

    def _evaluate_impl(self, net) -> tuple:
        """Greedy episodes of ``net`` on a service-owned host env; the
        recurrent policy threads its own eval carry. Returns (mean
        undiscounted return, step-capped episode count). Touches only the
        eval's own env and generator and the given net, so the async eval
        thread may run it while the loop trains."""
        from dist_dqn_tpu_torch.utils.host_eval import run_greedy_episodes

        n = self.rt.eval_episodes
        if self._eval_env is None:
            self._eval_env = make_host_env(self.rt.host_env, n,
                                           for_eval=True,
                                           seed=10_000 + self.cfg.seed)
            self._eval_gen = torch.Generator(
                device=self.device).manual_seed(self.cfg.seed + 991)

        on_done = None
        if self.recurrent:
            # The recurrent policy threads its own eval carry, zeroed
            # where an episode ended.
            carry = [self.net.initial_state(n)]

            def act(obs, epsilon):
                with devtime.device_work():
                    carry[0], actions, _, _ = self._act_rec(
                        net, carry[0], torch.from_numpy(obs).to(self.device),
                        self._eval_gen, epsilon)
                    return actions.cpu().numpy()

            def on_done(done):
                with devtime.device_work():
                    keep = torch.from_numpy(~done).float().to(
                        self.device)[:, None]
                    carry[0] = (carry[0][0] * keep, carry[0][1] * keep)
        else:
            def act(obs, epsilon):
                with devtime.device_work():
                    actions, _, _ = self._act_q(
                        net, torch.from_numpy(obs).to(self.device),
                        self._eval_gen, epsilon)
                    return actions.cpu().numpy()

        returns, truncated = run_greedy_episodes(self._eval_env, act,
                                                 episodes=n, on_done=on_done)
        return float(returns.mean()), float(truncated)

    def _evaluate(self) -> float:
        """Synchronous eval (one host); a step-capped count is recorded,
        so a low return is not mistaken for a regression."""
        ret, truncated = self._evaluate_impl(self._policy_params)
        if truncated:
            self.log.record(eval_episodes_truncated=truncated)
        return ret

    def _start_async_eval(self) -> None:
        """Multi-host eval must not stall the group: an inline eval on rank
        0 would hold every peer at its next agreement for the whole eval.
        A thread plays the episodes on its own copy of the policy net,
        taken now (the only learner state it touches), issues no
        collective, and its result is logged when it ends."""
        if self._eval_thread is not None and self._eval_thread.is_alive():
            self.log.record(eval_skipped=1.0)  # the last one still runs
            return
        with devtime.device_work():
            net = copy.deepcopy(self._policy_params)
        at_steps = self._progress()
        dev = self._mh.mesh.device

        def work():
            try:
                if dev.type == "cuda":
                    # A new thread starts on card 0.
                    torch.cuda.set_device(dev)
                self._eval_results.append((at_steps,
                                           self._evaluate_impl(net)))
            except Exception as e:  # noqa: BLE001 — surfaced by the poller
                self._eval_results.append((at_steps, e))

        self._eval_thread = threading.Thread(target=work, daemon=True,
                                             name="apex-eval")
        self._eval_thread.start()

    def _poll_async_eval(self) -> None:
        while True:
            try:
                at_steps, res = self._eval_results.popleft()
            except IndexError:
                return
            if isinstance(res, Exception):
                self.log.log_fn(f"# async eval failed: {res!r}")
                continue
            ret, truncated = res
            if truncated:
                self.log.record(eval_episodes_truncated=truncated)
            self.log.record(env_steps=at_steps, eval_return=ret)
            self.log.flush()

    def _progress(self) -> int:
        """The run's cursor: local env steps, or the group's agreed global
        count in multi-host mode (the same on every process at each
        agreement, so every process takes its termination, eval and
        checkpoint decisions in the same order)."""
        return self.global_env_steps if self.distributed else self.env_steps

    def _check_replicas(self) -> Optional[bool]:
        """Whether every learner replica equals rank 0's, bit for bit (a
        collective of the learner ranks or of the multi-host group; None
        for a single learner)."""
        if self._learners is not None:
            return self._learners.check(self.state)
        if self.distributed:
            from dist_dqn_tpu_torch.parallel.learner import \
                learner_replicas_equal
            return learner_replicas_equal(self._mh.mesh, self.state)
        return None

    # -- the loop --------------------------------------------------------------
    def run(self) -> dict:
        """The service loop until ``total_env_steps`` env steps have been
        ingested; returns the summary (the JAX service's keys)."""
        # Stall-watchdog heartbeats (null-safe until --forensics-dir arms
        # them): "apex.ingest" proves the drain/act half of the loop turns
        # over, "apex.learner" the train half. A pass wedged inside a
        # device wait, a transport lock or the sum tree leaves both stale
        # and the forensics stacks show where. Startup grace covers the
        # spawn and the first pass's one-time set-up.
        hb_ingest = tm_watchdog.heartbeat(
            "apex.ingest", startup_grace_s=tm_watchdog.STARTUP_GRACE_S)
        hb_learner = tm_watchdog.heartbeat(
            "apex.learner", startup_grace_s=tm_watchdog.STARTUP_GRACE_S)
        if self.rt.checkpoint_dir:
            tm_watchdog.register_emergency_hook("apex.checkpoint",
                                                self._emergency_save)
        try:
            self.spawn_actors()
            self._t_run = self._last_record = time.perf_counter()
            last_log = time.perf_counter()
            clock, loop_s = time.perf_counter, self.loop_s
            while self._progress() < self.rt.total_env_steps:
                # Chaos seam: the learner-process kill for game days —
                # die with SIGKILL semantics (no cleanup, no stop file,
                # no device release) at a plan-determined loop pass, so
                # the learner-restart invariant (actors re-attach via
                # re-hello, trajectory resumes from the checkpoint) is
                # exercised at a reproducible dataflow position.
                cev = chaos.fire("service.loop")
                if cev is not None and cev.fault == "crash":
                    os._exit(137)
                # One block of device work a pass (telemetry/devtime.py
                # LaunchGate): a profiler starts between passes.
                with devtime.device_work():
                    t0 = clock()
                    drained = self._drain_transports()
                    t1 = clock()
                    self._flush_act_queue()
                    self._insert_actor_prio()
                    t2 = clock()
                    self._flush_pending()
                    hb_ingest.beat()
                    t3 = clock()
                    grad_steps, trace_s = self.grad_steps, loop_s["trace"]
                    self._maybe_train()
                    hb_learner.beat()
                    t4 = clock()
                loop_s["drain"] += t1 - t0
                loop_s["act"] += t2 - t1
                loop_s["bootstrap"] += t3 - t2
                loop_s["train"] += t4 - t3 - (loop_s["trace"] - trace_s)
                self.train_passes += self.grad_steps > grad_steps
                if self._ckpt is not None:
                    with devtime.device_work():
                        if self._ckpt.maybe_save(self._progress(),
                                                 self.state):
                            self._save_replay_snapshot()
                if self._progress() >= self._next_eval:
                    self._next_eval = self._progress() \
                        + self.rt.eval_every_steps
                    with devtime.device_work():
                        self._finalize_all_train()
                    # Multi-host: rank 0 alone plays, in a thread; every
                    # process advances _next_eval alike (agreed cursor).
                    if self.distributed:
                        if self._rank == 0:
                            self._start_async_eval()
                    else:
                        with self.tracer.span("eval"):
                            eval_return = self._evaluate()
                        self.log.record(env_steps=self.env_steps,
                                        eval_return=eval_return)
                        self.log.flush()
                    last_log = time.perf_counter()
                self._poll_async_eval()
                if not drained:
                    time.sleep(0.0002)
                    loop_s["idle"] += clock() - t4
                now = time.perf_counter()
                if now - last_log > self.rt.log_every_s:
                    self.supervise_actors()
                    self._watchdog(now)
                    # Queue-depth sweep (off the per-record path; one
                    # gauge write each per log period).
                    self._tm_act_queue.set(len(self._act_queue))
                    self._tm_pending.set(self._pending_count)
                    self._tm_boot_inflight.set(len(self._boot_inflight))
                    self._tm_train_inflight.set(len(self._in_flight))
                    self._tm_prio_pending.set(len(self._prio_pending))
                    self._tm_ring_dropped.set(self.req_ring.dropped)
                    self._tm_ring_pending.set(self.req_ring.pending_bytes)
                    self._tm_record_age.set(now - self._last_record)
                    self._sweep_dedup_counters()
                    # The chip-time plane once per log period: the
                    # window's wall against the train program's device
                    # seconds (the loop has no chunk boundary), the MFU
                    # and the memory sweep; the trace's counter tracks.
                    self._flush_ledger_window()
                    devtime.set_learner_mfu("apex", device=self.device)
                    devtime.sweep_device_memory()
                    self.tracer.counter("replay_size", len(self.replay))
                    self.tracer.counter("env_steps", self.env_steps)
                    self.tracer.flush()
                    self.log.record(env_steps=self.env_steps,
                                    grad_steps=self.grad_steps,
                                    replay_size=float(len(self.replay)),
                                    loss=self._last_loss,
                                    actor_restarts=float(
                                        self.actor_restarts),
                                    ring_dropped=float(
                                        self.req_ring.dropped))
                    if self._ep_returns:
                        self.log.record(
                            episode_return=float(
                                np.mean(self._ep_returns)),
                            episodes_completed=float(
                                self.episodes_completed))
                    self.log.flush()
                    last_log = now
            with devtime.device_work():
                self._insert_actor_prio()
                self._flush_pending(force=True)
                self._finalize_all_train()
            if self._eval_thread is not None:
                self._eval_thread.join(timeout=60)
                self._poll_async_eval()
            with devtime.device_work():
                self._profile_stop()
                self.learner_replicas_equal = self._check_replicas()
                if self._ckpt is not None:
                    self._ckpt.save(self._progress(), self.state)
                    self._save_replay_snapshot()
            ring_dropped = self.req_ring.dropped
            self._t_end = time.perf_counter()
            self._clean_exit = True
        finally:
            tm_watchdog.unregister_emergency_hook("apex.checkpoint")
            hb_ingest.close()
            hb_learner.close()
            self._profile_tracer.stop()
            self.tracer.close()
            self.shutdown()
        self._flush_ledger_window()
        return self.summary(ring_dropped)

    def summary(self, ring_dropped: int = 0) -> dict:
        """The run's summary under the JAX service's keys."""
        frames, saved = self._dedup_totals()
        ingest_calls = sum(self.device_calls.get(k, 0) for k in (
            "act", "fused_act_bootstrap", "bootstrap"))
        tcp = self.tcp_server
        return {"env_steps": self.env_steps, "grad_steps": self.grad_steps,
                "transport": self.rt.transport,
                "actor_priorities": self.actor_prio,
                "ingest_bytes": dict(self.router.bytes_by_transport),
                "bytes_on_wire": int(
                    sum(self.router.bytes_by_transport.values())),
                "dedup_frames_reused": int(frames),
                "dedup_bytes_saved": int(saved),
                "shm_batch": self.rt.shm_batch,
                "shard_sampling": self._shard_sampler is not None,
                "sampler": ("device" if self.rt.device_sampling
                            else "tree"),
                "shard_sample_batches": (self._shard_sampler.batches
                                         if self._shard_sampler else 0),
                "records_by_shard": dict(self.router.records_by_shard),
                "replay_added_by_shard": dict(self.replay.added_by_shard),
                "ingest_decode_errors": self.router.decode_errors,
                "replay_ratio": self.replay_ratio,
                "train_batch": self.train_batch,
                "actor_dtype": self.actor_dtype,
                "global_env_steps": self.global_env_steps,
                "episodes_completed": self.episodes_completed,
                "episode_return_recent":
                    (float(np.mean(self._ep_returns))
                     if self._ep_returns else None),
                "replay_size": len(self.replay),
                "ring_dropped": int(ring_dropped),
                # Records the slot rings dropped as torn (the zero-copy
                # path's loss count: its actors never write the request
                # ring that ring_dropped reads).
                "ingest_torn_reads": self.ingest_torn_reads + sum(
                    r.torn_reads for r in self._zc_rings.values()),
                "device_calls": dict(self.device_calls),
                "ingest_passes": self.ingest_passes,
                "ingest_device_calls_per_pass": round(
                    ingest_calls / max(self.ingest_passes, 1), 3),
                "tcp_backpressure": (tcp.backpressure_events
                                     if tcp is not None else 0),
                "chip_time": self._ledger.snapshot(),
                "programs": devtime.programs_snapshot("apex"),
                "bad_records": self.bad_records,
                "actor_restarts": self.actor_restarts,
                # The port's additions: the assembler that ran, the TCP
                # listener's loss counts, rejected hellos, records per
                # actor, the replay snapshot restored at start, the last
                # retired loss, the wall of the run and of its training
                # part (from the first train event to the end), the
                # thread's seconds by part of the loop, the passes that
                # trained, and the learner's ranks with whether their
                # replicas ended bit-equal (None for one learner).
                "assembler": self.assembler_kind,
                "tcp_corrupt_frames": (tcp.corrupt_frames
                                       if tcp is not None else 0),
                "tcp_shed_records": (tcp.shed_records
                                     if tcp is not None else 0),
                "hello_rejects": self.hello_rejects,
                "records_by_actor": {str(k): v for k, v in sorted(
                    self.records_by_actor.items())},
                "replay_snapshot": self.replay_snapshot,
                "loss": self._last_loss,
                "run_s": (self._t_end - self._t_run
                          if self._t_end is not None else None),
                "train_s": (self._t_end - self._t_first_train
                            if self._t_end is not None
                            and self._t_first_train is not None else None),
                "loop_s": dict(self.loop_s),
                "train_passes": self.train_passes,
                "learner_devices": self.n_learners,
                "learner_replicas_equal": self.learner_replicas_equal}


def run_apex(cfg: ExperimentConfig, rt: ApexRuntimeConfig, log_fn=print,
             device=None) -> dict:
    """Build the service on ``device`` (default: the card) and run it to
    completion; returns its summary. A SIGTERM'd service releases the card
    (utils/device_cleanup.py)."""
    from dist_dqn_tpu_torch.utils.device_cleanup import \
        install as _install_cleanup

    _install_cleanup()
    return ApexLearnerService(cfg, rt, log_fn=log_fn, device=device).run()
