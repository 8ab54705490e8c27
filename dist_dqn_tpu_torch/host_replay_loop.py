"""The host-replay runtime: a collect/train loop with the replay window in
host DRAM (twin of ``dist_dqn_tpu/host_replay_loop.py`` at one device).

The fused loop keeps its replay window in device memory. This loop splits
the program at the replay boundary and runs the split as a three-stage
pipeline:

  device: [act -> env.v_step] x chunk_iters, writing records into one
     |    device buffer per chunk (no replay); chunk g+1 is dispatched
     |    BEFORE chunk g's train event, so its device work overlaps chunk
     |    g's evacuation and training, and it acts on the params as they
     |    stand before that event (in the serial reference path too, so
     |    the two stay bit-identical)
  d2h:    the records leave as ``evac_slices`` time slices
     |    (replay/staging.py StreamedEvacuator: pinned host buffers, a
     |    side stream, an event per slice), drained by a background
     |    evacuation worker into the ring
  host:   HostTimeRing in DRAM (replay/host_ring.py); slice appends
     |    publish under the ring's generation fence, and the train event
     |    fences on the chunk's completion handle before it samples
  device: the learner's train steps on batches sampled from the ring,
          uploaded through pinned buffers on a side stream (a background
          SamplePrefetcher, or the main-thread double buffer)

Batch k's numpy RNG is a per-index stream split from the seed
(``_batch_rng``), so prefetched and serial runs draw bit-identical batches
(uniform sampling; PER draws race the batched write-backs under
prefetch, as in the JAX package). Sampling is uniform, or prioritized
through the ring's sum-tree (``RingPrioritySampler``) or through a device
plane (``device_sampling``: ``RingDevicePrioritySampler``, whose draws on
the card go through the sampler kernel at or above 100,000 cells).
|TD| write-backs batch ``prio_writeback_batch`` train steps into one
update. ``checkpoint_dir`` saves whole state at a quiesced chunk boundary
(learner and collect carry through utils/checkpoint.py, plus the npz
sidecar of utils/ckpt_schema.py), and a run killed at chunk k resumes
bit-identically.

``mesh_devices != 1`` and ``sharded_collect=True`` (the data-parallel
runtime) are not ported yet, nor are the JAX loop's telemetry registry,
heartbeats, flight records, watchdog hooks and chaos seams.
"""
from __future__ import annotations

import dataclasses
import glob
import json
import math
import os
import time
import zipfile
from typing import NamedTuple, Optional

import numpy as np
import torch

from dist_dqn_tpu_torch import loop_common
from dist_dqn_tpu_torch.agents.dqn import (LearnerState, make_actor_step,
                                           make_learner)
from dist_dqn_tpu_torch.config import ExperimentConfig
from dist_dqn_tpu_torch.envs import make_env
from dist_dqn_tpu_torch.envs.base import TorchEnv
from dist_dqn_tpu_torch.models import build_network
from dist_dqn_tpu_torch.replay.host_ring import (HostTimeRing, PerSample,
                                                 RingDevicePrioritySampler,
                                                 RingPrioritySampler)
from dist_dqn_tpu_torch.replay.staging import (DoubleBufferedStager,
                                               EvacuationWorker,
                                               SamplePrefetcher,
                                               StreamedEvacuator, tree_map)
from dist_dqn_tpu_torch.types import Transition
from dist_dqn_tpu_torch.utils import ckpt_schema
from dist_dqn_tpu_torch.utils.checkpoint import (TrainCheckpointer,
                                                atomic_savez,
                                                record_checkpoint_kind)
from dist_dqn_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass
class CollectCarry:
    """The collect program's state across chunks (the JAX carry's ``rng``
    is the two generators here)."""

    env_state: NamedTuple
    obs: torch.Tensor
    gen_env: torch.Generator     # env draws (serves, resets)
    gen_act: torch.Generator     # exploration (and actor noise) draws
    iteration: int               # env vector steps taken
    ep_return: torch.Tensor      # [B]


class _HostLoopState(NamedTuple):
    """What a checkpoint step holds besides the sidecar."""

    learner: LearnerState
    carry: CollectCarry


class _UniformTag(NamedTuple):
    """Uniform-mode sample bookkeeping: the ring generation the batch was
    drawn against (the prefetcher's staleness handshake)."""

    generation: int


def make_collect_chunk(cfg: ExperimentConfig, env: TorchEnv,
                       frame_stack: int):
    """(init, collect): a device chunk of act -> step that RETURNS its
    transitions (time-major [C, B, ...] in one buffer per field, allocated
    at the chunk's start) plus its episode stats, and writes no ring.

    ``init(gen_env, gen_act)`` resets the env lanes; ``collect(carry,
    actor_net, num_iters)`` returns ``(carry, records, (completed_return,
    completed_count))``, the records a dict of obs (the newest frame under
    dedup), action, reward, terminated and truncated. ``actor_net`` is the
    net the chunk acts on (the bf16 snapshot with ``network.actor_dtype``).
    """
    B = cfg.actor.num_envs
    act = make_actor_step(env.num_actions)
    epsilon, _ = loop_common.make_schedules(cfg, B)
    slice_newest = ((lambda o: o[..., -1:]) if frame_stack
                    else (lambda o: o))

    def init(gen_env: torch.Generator, gen_act: torch.Generator
             ) -> CollectCarry:
        env_state, obs = env.v_reset(B, gen_env)
        return CollectCarry(env_state=env_state, obs=obs.clone(),
                            gen_env=gen_env, gen_act=gen_act, iteration=0,
                            ep_return=torch.zeros(B, dtype=torch.float32,
                                                  device=env.device))

    def collect(carry: CollectCarry, actor_net, num_iters: int):
        dev = env.device
        newest = slice_newest(carry.obs)
        records = {
            "obs": torch.empty((num_iters,) + tuple(newest.shape),
                               dtype=newest.dtype, device=dev),
            "action": torch.empty((num_iters, B), dtype=torch.int64,
                                  device=dev),
            "reward": torch.empty((num_iters, B), dtype=torch.float32,
                                  device=dev),
            "terminated": torch.empty((num_iters, B), dtype=torch.bool,
                                      device=dev),
            "truncated": torch.empty((num_iters, B), dtype=torch.bool,
                                     device=dev),
        }
        completed_return = torch.zeros((), dtype=torch.float32, device=dev)
        completed_count = torch.zeros((), dtype=torch.float32, device=dev)
        for i in range(num_iters):
            actions = act(actor_net, carry.obs, carry.gen_act,
                          epsilon(carry.iteration))
            carry.env_state, out = env.v_step(carry.env_state, actions,
                                              carry.gen_env)
            records["obs"][i] = slice_newest(carry.obs)
            records["action"][i] = actions
            records["reward"][i] = out.reward
            records["terminated"][i] = out.terminated
            records["truncated"][i] = out.truncated
            carry.ep_return, completed_return, completed_count = \
                loop_common.episode_stats_update(
                    carry.ep_return, completed_return, completed_count,
                    out.reward, out.terminated | out.truncated)
            carry.obs = out.obs
            carry.iteration += 1
        return carry, records, (completed_return, completed_count)

    return init, collect


class _ResumedEvacHandle:
    """Completion-handle stand-in installed on resume: the chunk it fences
    was already appended to the ring inside the checkpoint."""

    stats = {"evac_s": 0.0, "bytes": 0, "slices": 0}
    done = True

    def wait(self, timeout=None) -> bool:
        return True


def _host(x) -> np.ndarray:
    """A record field on the host: a device tensor read back, or a restored
    numpy array as it is."""
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def run_host_replay(cfg: ExperimentConfig, total_env_steps: int,
                    chunk_iters: int = 200, log_fn=print,
                    env: Optional[TorchEnv] = None,
                    double_buffer: bool = True,
                    pipeline: bool = True,
                    evac_slices: int = 4,
                    prefetch: bool = True,
                    prefetch_depth: int = 2,
                    prioritized: Optional[bool] = None,
                    prio_writeback_batch: int = 8,
                    checkpoint_dir: Optional[str] = None,
                    save_every_frames: int = 0,
                    mesh_devices: int = 1,
                    sharded_collect: Optional[bool] = None,
                    device_sampling: bool = False,
                    profile_dir: Optional[str] = None,
                    device=None):
    """Run the host-replay loop on ``device`` (default: the card); returns
    the summary dict under the JAX loop's keys, plus ``history`` (the
    per-chunk rows) and ``learner`` (the final LearnerState).

    The cadence is the fused loop's: one train event every
    ``cfg.train_every`` env iterations (the remainder carried across
    chunks), ``cfg.updates_per_train * replay.updates_per_chunk`` grad
    steps each, batches of ``replay.train_batch`` width drawn from the host
    ring: uniformly, or by priority when ``prioritized`` (default:
    ``cfg.replay.prioritized``), through a device plane with
    ``device_sampling``.

    ``pipeline=False`` is the serial reference: one blocking fetch and one
    ``add_chunk`` per chunk, then the look-ahead dispatch, so the schedule
    (and every number) equals the pipeline's. ``prefetch=False`` samples on
    the main thread (with ``double_buffer`` through the main-thread stager,
    else sample -> upload -> train one at a time). ``profile_dir`` traces
    the first chunk after warm-up with torch.profiler. ``checkpoint_dir``
    saves whole state every ``save_every_frames`` (default: the eval
    period, at least one chunk) and at the end, and resumes from the newest
    step whose sidecar reads.
    """
    if cfg.network.lstm_size > 0:
        raise ValueError(
            "host-replay runs the feed-forward collect/train split; "
            "recurrent (R2D2, network.lstm_size>0) configs need the "
            "sequence learner — use the apex runtime or the fused loop")
    if evac_slices < 1:
        raise ValueError(f"--evac-slices must be >= 1, got {evac_slices}")
    if prio_writeback_batch < 1:
        raise ValueError("prio_writeback_batch must be >= 1, got "
                         f"{prio_writeback_batch}")
    per_enabled = (cfg.replay.prioritized if prioritized is None
                   else prioritized)
    if device_sampling and not per_enabled:
        raise ValueError(
            "--device-sampling without --per has nothing to sample on "
            "device: the priority planes hold p^alpha mass (uniform "
            "draws never touch a tree). Add --per or drop "
            "--device-sampling")
    if mesh_devices != 1 or sharded_collect:
        raise ValueError(
            "not ported yet: the data-parallel host-replay runtime "
            "(--mesh-devices != 1, sharded_collect); the PyTorch port runs "
            "it at one device (ROADMAP.md)")
    dev = resolve_device(device)
    dp = 1

    if env is None:
        env = make_env(cfg.env_name, device=dev)
    B = cfg.actor.num_envs
    obs_shape = tuple(env.observation_shape)
    stack = (cfg.replay.frame_dedup
             and getattr(env, "frame_stack", 0)) or 0
    if cfg.replay.frame_dedup and stack < 2:
        raise ValueError(
            "replay.frame_dedup=True but this env declares no rolling "
            "frame stack (envs/base.py JaxEnv.frame_stack)")
    stored_shape = obs_shape[:-1] + (1,) if stack else obs_shape
    # The floor covers the n-step window and the dedup rebuild context.
    num_slots = max(cfg.replay.capacity // B,
                    cfg.learner.n_step + max(stack - 1, 0) + 2)
    if chunk_iters > num_slots:
        raise ValueError(
            f"--chunk-iters {chunk_iters} exceeds the host ring's "
            f"{num_slots} slots (replay.capacity={cfg.replay.capacity} "
            f"/ num_envs={B}); lower --chunk-iters or raise "
            "replay.capacity (one chunk == the whole window would make "
            "the ring a FIFO of the last chunk — keep chunk_iters well "
            "below the slot count)")

    net = build_network(cfg.network, env.num_actions, obs_shape,
                        device=dev, seed=cfg.seed)
    init_collect, collect = make_collect_chunk(cfg, env, stack)
    init_learner, train_step = make_learner(cfg.learner, net)
    replay_ratio = loop_common.resolve_replay_ratio(cfg)
    train_batch = loop_common.resolve_train_batch(cfg)
    # The bf16 actor snapshot: one cast per chunk; the learner's f32
    # masters stay as they are.
    actor_snapshot = loop_common.make_actor_param_cast(
        cfg.network.actor_dtype)

    ring = HostTimeRing(num_slots, B, stored_shape,
                        torch.empty((), dtype=env.observation_dtype)
                        .numpy().dtype, frame_stack=stack)
    gen_env, gen_act, gen_learn = loop_common.generators(cfg.seed, dev, 3)
    carry = init_collect(gen_env, gen_act)
    state = init_learner(net, gen_learn)

    per_sampler = None
    if per_enabled and device_sampling:
        per_sampler = RingDevicePrioritySampler(
            ring, n_step=cfg.learner.n_step,
            alpha=cfg.replay.priority_exponent,
            beta=cfg.replay.importance_exponent,
            eps=cfg.replay.priority_eps, device=dev)
        log_fn("# host-replay sampler: prioritized device plane "
               f"({dev.type}, "
               f"alpha={cfg.replay.priority_exponent}, "
               f"beta={cfg.replay.importance_exponent}, "
               f"prio_writeback_batch={prio_writeback_batch})")
    elif per_enabled:
        per_sampler = RingPrioritySampler(
            ring, n_step=cfg.learner.n_step,
            alpha=cfg.replay.priority_exponent,
            beta=cfg.replay.importance_exponent,
            eps=cfg.replay.priority_eps)
        log_fn("# host-replay sampler: prioritized sum-tree "
               f"({type(per_sampler.tree).__name__}, "
               f"alpha={cfg.replay.priority_exponent}, "
               f"beta={cfg.replay.importance_exponent}, "
               f"prio_writeback_batch={prio_writeback_batch})")
    else:
        log_fn("# host-replay sampler: uniform")

    def _batch_rng(k: int) -> np.random.Generator:
        # Batch k's content is a pure function of (k, ring window), never
        # of which thread drew it or when.
        return np.random.default_rng(
            np.random.SeedSequence(cfg.seed, spawn_key=(k,)))

    def _transition(hb) -> Transition:
        return Transition(obs=hb.obs, action=hb.action.astype(np.int64),
                          reward=hb.reward, discount=hb.discount,
                          next_obs=hb.next_obs)

    def sample_host(k: int):
        """Batch k's host-side sample + gather -> (host tree, aux)."""
        rng_k = _batch_rng(k)
        if per_sampler is not None:
            hb, aux = per_sampler.sample(rng_k, train_batch,
                                         cfg.learner.gamma)
            # IS weights travel with the batch through the staging.
            return (_transition(hb), aux.weights), aux
        hs = ring.sample(rng_k, train_batch, cfg.learner.n_step,
                         cfg.learner.gamma)
        return _transition(hs.batch), _UniformTag(generation=hs.generation)

    def put_batch(tree):
        return tree_map(lambda a: torch.from_numpy(np.asarray(a)).to(dev),
                        tree)

    def ring_append(tree, lo, hi):
        ring.add_chunk(tree["obs"], tree["action"], tree["reward"],
                       tree["terminated"], tree["truncated"])

    prefetcher = stager = None
    if prefetch:
        prefetcher = SamplePrefetcher(sample_host, depth=prefetch_depth,
                                      wait_generation=ring.wait_generation,
                                      device=dev)
    elif double_buffer:
        stager = DoubleBufferedStager(depth=2, device=dev)

    evacuator = worker = None
    if pipeline:
        evacuator = StreamedEvacuator(num_slices=evac_slices)
        worker = EvacuationWorker(evacuator, ring_append)

    # The train-event cadence carries its remainder across chunks, so the
    # average is exactly one event per train_every iterations.
    updates_per_train = max(cfg.updates_per_train, 1) * replay_ratio
    train_debt_iters = 0
    weights = torch.ones((train_batch,), dtype=torch.float32, device=dev)

    # Batched priority write-backs (PER only): each train step's |TD| stays
    # a device tensor in this list and lands as one update per
    # prio_writeback_batch steps, chronological, last write winning.
    wb_pending = []
    is_w_sum, is_w_count, is_w_min = 0.0, 0, 1.0

    def _wb_add(aux, metrics):
        nonlocal is_w_sum, is_w_count, is_w_min
        if per_sampler is None:
            return
        wb_pending.append((aux, metrics["priorities"]))
        is_w_sum += float(aux.weights.sum())
        is_w_count += int(aux.weights.shape[0])
        is_w_min = min(is_w_min, float(aux.weights.min()))
        if len(wb_pending) >= prio_writeback_batch:
            _wb_flush()

    def _prios(p) -> np.ndarray:
        return _host(p).astype(np.float64)

    def _wb_flush():
        if per_sampler is None or not wb_pending:
            return
        pending, wb_pending[:] = wb_pending[:], []
        leaf = np.concatenate([a.leaf for a, _ in pending])
        prios = np.concatenate([_prios(p) for _, p in pending])
        gens = np.concatenate([a.slot_gen for a, _ in pending])
        per_sampler.update_priorities(leaf, prios, expected_gen=gens)

    num_chunks = max(0, math.ceil(total_env_steps / (chunk_iters * B)))
    env_steps = 0
    grad_steps = 0
    sample_k = 0          # global batch index: the RNG-stream cursor

    # -- whole-state checkpoint/resume ---------------------------------------
    ckpt = None
    next_save = float("inf")
    start_chunk = 0
    resumed = False
    resume_stats = resume_pending = None
    if checkpoint_dir:
        # Each save copies the whole ring window, so the default cadence
        # is never finer than one chunk.
        save_period = save_every_frames or max(cfg.eval_every_steps,
                                               chunk_iters * B)
        ckpt = TrainCheckpointer(checkpoint_dir,
                                 save_every_frames=save_period)
        record_checkpoint_kind(checkpoint_dir, "host_loop")
        next_save = save_period

        def _sidecar_path(step: int) -> str:
            return os.path.join(checkpoint_dir, f"host_loop_{step}.npz")

        # The newest step whose sidecar reads wins; a step whose sidecar
        # is torn or missing is deleted and the next older one tried.
        side = step = None
        for cand in sorted(ckpt.all_steps(), reverse=True):
            try:
                with np.load(_sidecar_path(cand)) as f:
                    side = {k: f[k] for k in f.files}
                step = cand
                break
            except (FileNotFoundError, ValueError, EOFError, KeyError,
                    zipfile.BadZipFile) as e:
                log_fn(f"# checkpoint step {cand}: sidecar unreadable "
                       f"({type(e).__name__}: {e}) — deleting the "
                       "unusable step and falling back to the previous "
                       "one")
                ckpt.delete(cand)
                try:
                    os.remove(_sidecar_path(cand))
                except OSError:
                    pass
        if side is not None:
            ver = int(side.get("sidecar_version", 0))
            if ver != ckpt_schema.SIDECAR_VERSION:
                raise ValueError(
                    f"checkpoint at {checkpoint_dir!r} carries sidecar "
                    f"schema v{ver}, this build reads "
                    f"v{ckpt_schema.SIDECAR_VERSION} — resume with a "
                    "matching build (utils/ckpt_schema.py documents the "
                    "history), or start a fresh --checkpoint-dir")
            if int(side["chunk_iters"]) != chunk_iters:
                raise ValueError(
                    f"checkpoint at {checkpoint_dir!r} was written with "
                    f"--chunk-iters {int(side['chunk_iters'])}, this "
                    f"run uses {chunk_iters} — resume with the same "
                    "loop shape (the ring/env config is already "
                    "validated by the snapshot shapes)")
            if int(side["dp"]) != dp:
                raise ValueError(
                    f"checkpoint at {checkpoint_dir!r} was written at "
                    f"--mesh-devices {int(side['dp'])}, this run uses "
                    f"{dp} — resume with the same mesh width "
                    "(re-sharding a lane-striped host-replay window is "
                    "not supported; docs/fault_tolerance.md 'resuming "
                    "a sharded run')")
            if bool(side["sharded_collect"]):
                raise ValueError(
                    f"checkpoint at {checkpoint_dir!r} was written "
                    f"with sharded_collect="
                    f"{bool(side['sharded_collect'])}, this run "
                    f"resolves sharded_collect=False — resume "
                    "with the same collect mode (the collect carries "
                    "are stored per mode)")
            if per_enabled and \
                    int(side["prio_writeback_batch"]) \
                    != prio_writeback_batch:
                raise ValueError(
                    f"checkpoint at {checkpoint_dir!r} was written "
                    f"with prio_writeback_batch="
                    f"{int(side['prio_writeback_batch'])}, this run "
                    f"uses {prio_writeback_batch} — resume with the "
                    "same PER write-back cadence")
            if int(side.get("population", 1)) != 1:
                raise ValueError(
                    f"checkpoint at {checkpoint_dir!r} was written with "
                    f"population={int(side['population'])} stacked "
                    "members, but --runtime host-replay trains a single "
                    "policy — the member axis is checkpoint structure. "
                    "Resume it under the fused --population runtime, or "
                    "start a fresh --checkpoint-dir")
            if bool(side["per"]) != per_enabled:
                raise ValueError(
                    f"checkpoint at {checkpoint_dir!r} was written with "
                    f"prioritized={bool(side['per'])}, this run "
                    f"configures prioritized={per_enabled} — a uniform "
                    "snapshot cannot honestly seed a sum-tree (and vice "
                    "versa); resume with the same sampler, or start a "
                    "fresh --checkpoint-dir")
            if per_enabled and \
                    int(side["per_sampler_kind"]) != int(device_sampling):
                _kinds = {0: "host sum-tree", 1: "device plane"}
                raise ValueError(
                    f"checkpoint at {checkpoint_dir!r} was written with "
                    f"the {_kinds[int(side['per_sampler_kind'])]} PER "
                    f"backend, this run configures the "
                    f"{_kinds[int(device_sampling)]} — resume with the "
                    "same --device-sampling setting, or start a fresh "
                    "--checkpoint-dir")
            _, tree = ckpt.restore_latest(_HostLoopState(state, carry),
                                          step=step)
            state, carry = tree.learner, tree.carry
            ring.load_state_dict({k[len("ring_"):]: v for k, v in
                                  side.items() if k.startswith("ring_")})
            if per_sampler is not None:
                per_sampler.load_state_dict(
                    {k[len("per_"):]: v for k, v in side.items()
                     if k.startswith("per_")})
            env_steps = int(side["env_steps"])
            grad_steps = int(side["grad_steps"])
            ring.current_params_version = grad_steps
            sample_k = int(side["sample_k"])
            if prefetcher is not None:
                # Per-index batch RNG: continue the killed run's indices.
                prefetcher.seek(sample_k)
            train_debt_iters = int(side["train_debt_iters"])
            start_chunk = int(side["next_chunk"])
            next_save = env_steps + save_period
            resumed = True
            # Deferred write-backs ride the sidecar as they were, and flush
            # on the killed run's schedule.
            for j in range(int(side.get("wb_count", 0))):
                leaf = np.asarray(side["wb0_leaf"][j], np.int64)
                aux = PerSample(
                    leaf=leaf, t_idx=np.zeros_like(leaf, np.int32),
                    b_idx=np.zeros_like(leaf, np.int32),
                    slot_gen=np.asarray(side["wb0_slot_gen"][j], np.int64),
                    weights=np.zeros(leaf.shape[0], np.float32),
                    generation=0)
                wb_pending.append(
                    (aux, np.asarray(side["wb_prios"][j], np.float64)))
            if bool(side["has_stats"]):
                resume_stats = tuple(
                    torch.tensor(float(side[k]), dtype=torch.float32,
                                 device=dev)
                    for k in ("stats_cr", "stats_cc"))
            if bool(side["has_pending"]):
                resume_pending = {
                    k[len("pending_"):]: v for k, v in side.items()
                    if k.startswith("pending_")}
            log_fn(json.dumps({"resumed_at_frames": env_steps,
                               "resumed_at_chunk": start_chunk,
                               "resumed_dp": dp,
                               "resumed_per": per_enabled}))

    d2h_bytes_total = 0
    fence_wait_total = 0.0
    sample_s_total = 0.0
    prefetch_wait_s_total = 0.0
    chip_time = {"chunks": 0.0, "busy": 0.0, "sample": 0.0,
                 "evac_fence": 0.0, "prefetch_wait": 0.0, "h2d": 0.0,
                 "other": 0.0}
    overlap_fracs = []
    history = []
    metrics = None
    t_start = time.perf_counter()
    records = stats = handle = records_ready = None
    # The restored step already exists on disk: resuming a completed run
    # must not save it again.
    last_saved = env_steps if resumed else -1

    def _save_checkpoint(g: int) -> None:
        """Quiesced whole-state save at the end of chunk ``g``'s body: the
        in-flight evacuation is fenced first, and the serial path's
        un-appended records, the dispatched chunk's episode stats and the
        deferred write-backs go into the checkpoint as they are (reads
        only, so the continuing run stays bit-identical)."""
        nonlocal last_saved
        if env_steps <= last_saved:
            return
        t_save = time.perf_counter()
        if pipeline and handle is not None:
            handle.wait()
        side = {f"ring_{k}": v for k, v in ring.state_dict().items()}
        if per_sampler is not None:
            side.update({f"per_{k}": v for k, v in
                         per_sampler.state_dict().items()})
        side.update(
            sidecar_version=np.int64(ckpt_schema.SIDECAR_VERSION),
            env_steps=np.int64(env_steps),
            grad_steps=np.int64(grad_steps),
            sample_k=np.int64(sample_k),
            train_debt_iters=np.int64(train_debt_iters),
            next_chunk=np.int64(g + 1),
            chunk_iters=np.int64(chunk_iters),
            dp=np.int64(dp),
            per=np.bool_(per_enabled),
            per_sampler_kind=np.int64(int(device_sampling)),
            population=np.int64(1),
            sharded_collect=np.bool_(False),
            prio_writeback_batch=np.int64(prio_writeback_batch),
            wb_count=np.int64(len(wb_pending)),
            has_stats=np.bool_(stats is not None),
            has_pending=np.bool_(records is not None))
        if wb_pending:
            side["wb0_leaf"] = np.stack([a.leaf for a, _ in wb_pending])
            side["wb0_slot_gen"] = np.stack(
                [a.slot_gen for a, _ in wb_pending])
            side["wb_prios"] = np.stack([_prios(p) for _, p in wb_pending])
        if stats is not None:
            s_cr, s_cc = (float(x) for x in stats)
            side.update(stats_cr=np.float32(s_cr), stats_cc=np.float32(s_cc))
        if records is not None:
            side.update({f"pending_{k}": _host(v)
                         for k, v in records.items()})
        ckpt_schema.validate_sidecar(side.keys())
        # The sidecar lands before the step: a committed step implies its
        # sidecar exists.
        atomic_savez(_sidecar_path(env_steps), **side)
        ckpt.save(env_steps, _HostLoopState(state, carry))
        last_saved = env_steps
        # Prune sidecars with the retained steps: each holds a window.
        keep = set(ckpt.all_steps())
        for old in glob.glob(os.path.join(checkpoint_dir,
                                          "host_loop_*.npz")):
            try:
                old_step = int(os.path.basename(old)[len("host_loop_"):-4])
            except ValueError:
                continue
            if old_step not in keep:
                os.remove(old)
        log_fn(json.dumps({"host_replay_checkpoint": env_steps,
                           "save_s": round(time.perf_counter() - t_save, 3),
                           "shards_saved": dp}))

    def _dispatch_chunk():
        """One chunk's collect, queued on the device with the params as
        they stand now. Returns (records, stats); on the card also records
        the event the records are complete at (the evacuation's start)."""
        nonlocal carry, records_ready
        carry, r, st = collect(carry, actor_snapshot(state.net),
                               chunk_iters)
        if dev.type == "cuda":
            records_ready = torch.cuda.Event()
            records_ready.record()
        return r, st

    def submit_evac(recs):
        return worker.submit(recs, ready=records_ready)

    profile_chunk = (min(start_chunk + 1, num_chunks - 1)
                     if profile_dir else -1)
    prof = None
    try:
        # Extending a finished run: its checkpoint is a final save (no
        # chunk in flight), so it dispatches as a fresh start does.
        extension = (resumed and start_chunk < num_chunks
                     and resume_stats is None and resume_pending is None)
        if (num_chunks and not resumed) or extension:
            # Chunk 0: the prologue dispatch and its evacuation.
            records, stats = _dispatch_chunk()
            if pipeline:
                handle = submit_evac(records)
                records = None
        elif resumed:
            # Re-establish the loop invariants at the top of body
            # start_chunk as the killed run held them.
            stats = resume_stats
            if pipeline:
                handle = _ResumedEvacHandle()
            else:
                records = resume_pending
        for g in range(start_chunk, num_chunks):
            if g == profile_chunk:
                activities = [torch.profiler.ProfilerActivity.CPU]
                if dev.type == "cuda":
                    activities.append(torch.profiler.ProfilerActivity.CUDA)
                prof = torch.profiler.profile(activities=activities)
                prof.start()
            t0 = time.perf_counter()
            next_records = next_stats = None
            if pipeline:
                # Stage 1: chunk g+1's collect, overlapping chunk g's
                # evacuation tail and training.
                if g + 1 < num_chunks:
                    next_records, next_stats = _dispatch_chunk()
                t_dispatch = time.perf_counter()
                # Stage 2: fence on chunk g's evacuation.
                handle.wait()
                t_fence = time.perf_counter()
                fence_wait_s = t_fence - t_dispatch
                evac_s = handle.stats["evac_s"]
                d2h_bytes = handle.stats["bytes"]
                overlap = max(0.0, min(1.0, 1.0 - fence_wait_s
                                       / max(evac_s, 1e-9)))
                t_evac_parts = None
            else:
                # Serial reference: one blocking fetch, one append, then
                # the look-ahead dispatch (the same pre-train params).
                host = {k: _host(v) for k, v in records.items()}
                t_mono_fetch = time.perf_counter()
                ring.add_chunk(host["obs"], host["action"], host["reward"],
                               host["terminated"], host["truncated"])
                t_fence = time.perf_counter()
                d2h_bytes = int(sum(v.nbytes for v in host.values()))
                del host
                fence_wait_s = evac_s = t_fence - t0
                overlap = 0.0
                t_evac_parts = (t_mono_fetch - t0, t_fence - t_mono_fetch)
                if g + 1 < num_chunks:
                    next_records, next_stats = _dispatch_chunk()
            records = next_records
            env_steps += chunk_iters * B
            d2h_bytes_total += d2h_bytes
            fence_wait_total += fence_wait_s
            overlap_fracs.append(overlap)
            # Occupancy after chunk g's fence, before chunk g+1's appends.
            ring_transitions = ring.size * B

            # Stage 3: chunk g's train event.
            did = 0
            ev_sample_s = ev_wait_s = 0.0
            ev_depth_sum = ev_stale = 0
            if (ring.can_sample(cfg.learner.n_step)
                    and ring_transitions >= cfg.replay.min_fill):
                train_debt_iters += chunk_iters
                events = train_debt_iters // max(cfg.train_every, 1)
                train_debt_iters -= events * max(cfg.train_every, 1)
                grads_this_chunk = events * updates_per_train
                if grads_this_chunk:
                    # Chunk g is published and chunk g+1's appends wait
                    # until this event's samples are drawn: the generation
                    # is stable across the event.
                    fence_gen = ring.generation

                    def _unpack(dev_tree):
                        return dev_tree if per_sampler is not None \
                            else (dev_tree, weights)

                    if prefetcher is not None:
                        s0 = (prefetcher.sample_s_total,
                              prefetcher.wait_s_total,
                              prefetcher.stale_total)
                        prefetcher.request(grads_this_chunk, fence_gen)
                        for _ in range(grads_this_chunk):
                            dev_tree, aux = prefetcher.pop(fence_gen)
                            ev_depth_sum += len(prefetcher)
                            batch, w = _unpack(dev_tree)
                            state, metrics = train_step(state, batch, w)
                            _wb_add(aux, metrics)
                        ev_sample_s = prefetcher.sample_s_total - s0[0]
                        ev_wait_s = prefetcher.wait_s_total - s0[1]
                        ev_stale = prefetcher.stale_total - s0[2]
                        sample_k = prefetcher.next_k
                    elif stager is not None:
                        # Main-thread double buffering: batch i+1's gather
                        # and upload overlap step i's device time.
                        t_s = time.perf_counter()
                        host, aux = sample_host(sample_k)
                        stager.stage(host, aux=aux)
                        ev_sample_s += time.perf_counter() - t_s
                        sample_k += 1
                        for i in range(grads_this_chunk):
                            dev_tree, aux = stager.pop()
                            batch, w = _unpack(dev_tree)
                            state, metrics = train_step(state, batch, w)
                            _wb_add(aux, metrics)
                            if i + 1 < grads_this_chunk:
                                t_s = time.perf_counter()
                                host, nxt = sample_host(sample_k)
                                stager.stage(host, aux=nxt)
                                ev_sample_s += time.perf_counter() - t_s
                                sample_k += 1
                    else:
                        # Fully serial: sample -> upload -> train.
                        t_s = time.perf_counter()
                        host, aux = sample_host(sample_k)
                        dev_tree = put_batch(host)
                        ev_sample_s += time.perf_counter() - t_s
                        sample_k += 1
                        for i in range(grads_this_chunk):
                            batch, w = _unpack(dev_tree)
                            state, metrics = train_step(state, batch, w)
                            _wb_add(aux, metrics)
                            if i + 1 < grads_this_chunk:
                                t_s = time.perf_counter()
                                host, aux = sample_host(sample_k)
                                dev_tree = put_batch(host)
                                ev_sample_s += time.perf_counter() - t_s
                                sample_k += 1
                    did = grads_this_chunk
                    grad_steps += did
                    ring.current_params_version = grad_steps
                    sample_s_total += ev_sample_s
                    prefetch_wait_s_total += ev_wait_s
            # Chunk g+1's evacuation: every sample of chunk g's event is
            # drawn, so its slices may publish from here on.
            if pipeline and records is not None:
                handle = submit_evac(records)
                records = None
            if did and dev.type == "cuda":
                # The train section ends at its stream's fence.
                torch.cuda.current_stream(dev).synchronize()
            t_train = time.perf_counter()

            cr, cc = torch.stack(list(stats)).tolist()
            stats = next_stats
            t_stats = time.perf_counter()
            ep = float(cr) / max(float(cc), 1.0)

            # The train section ends at a device fence, so minus its
            # host-blocked share it is the chunk's train device time.
            sample_blocked = 0.0 if prefetcher is not None else ev_sample_s
            wall = t_stats - t0
            train_busy = min(max((t_train - t_fence) - sample_blocked
                                 - ev_wait_s, 0.0), wall)
            idle_other = max(wall - train_busy - sample_blocked
                             - fence_wait_s - ev_wait_s, 0.0)
            for key, secs in (("busy", train_busy),
                              ("sample", sample_blocked),
                              ("evac_fence", fence_wait_s),
                              ("prefetch_wait", ev_wait_s),
                              ("other", idle_other)):
                chip_time[key] += secs
            chip_time["chunks"] += 1

            row = {
                "env_frames": env_steps, "grad_steps": grad_steps,
                "episode_return": round(ep, 3),
                "env_steps_per_sec": round(
                    chunk_iters * B / max(t_train - t0, 1e-9), 1),
                "env_steps_per_sec_loop": round(
                    env_steps / max(t_stats - t_start, 1e-9), 1),
                "chunk_train_s": round(t_train - t_fence, 4),
                "chunk_stats_fetch_s": round(t_stats - t_train, 4),
                "evac_s": round(evac_s, 4),
                "evac_fence_wait_s": round(fence_wait_s, 4),
                "evac_overlap_frac": round(overlap, 4),
                # Upper bound on device idle attributable to evacuation:
                # the fence wait (pipelined) or the whole evacuation
                # (serial).
                "device_idle_est_s": round(fence_wait_s, 4),
                "d2h_bytes": d2h_bytes,
                "ring_transitions": ring_transitions,
                "ring_gb": round(ring.nbytes / 1e9, 3),
                "sample_s": round(ev_sample_s, 4),
                "chip_busy_s": round(train_busy, 4),
                "idle_other_s": round(idle_other, 4),
                "prefetch_wait_s": round(ev_wait_s, 4),
                "prefetch_depth": round(ev_depth_sum / (did * dp), 2)
                if did else 0.0,
                "stale_batches": ev_stale,
            }
            if t_evac_parts is not None:
                row["chunk_collect_fetch_s"] = round(t_evac_parts[0], 4)
                row["chunk_ring_s"] = round(t_evac_parts[1], 4)
            if prefetcher is not None:
                row["h2d_staged_bytes"] = prefetcher.bytes_staged
            elif stager is not None:
                row["h2d_staged_bytes"] = stager.bytes_staged
            if did:
                row["loss"] = round(float(metrics["loss"]), 4)
            history.append(row)
            log_fn(json.dumps(row))
            if prof is not None and g == profile_chunk:
                prof.stop()
                from dist_dqn_tpu_torch.train import _write_profile
                log_fn(json.dumps(_write_profile(
                    prof, profile_dir, wall, dev.type == "cuda")))
                prof = None
            if ckpt is not None and env_steps >= next_save:
                next_save = env_steps + save_period
                _save_checkpoint(g)
        if ckpt is not None and num_chunks:
            # The final whole-state save: resuming a completed run is a
            # pass straight to the summary.
            _save_checkpoint(num_chunks - 1)
    finally:
        if prof is not None:
            prof.stop()
        if worker is not None:
            worker.close()
        if prefetcher is not None:
            prefetcher.close()
        if ckpt is not None:
            ckpt.close()

    # Land any accumulated write-backs before the summary counts them.
    _wb_flush()
    wall = time.perf_counter() - t_start
    # The pipelined-vs-serial pin's anchor: a float64 fold of the params.
    param_checksum = float(sum(
        np.float64(np.sum(p.detach().cpu().numpy().astype(np.float64)))
        for p in state.net.parameters()))
    n = max(len(overlap_fracs), 1)
    samplers = [per_sampler] if per_sampler is not None else []
    return {
        "env_steps": env_steps, "grad_steps": grad_steps,
        "wall_s": round(wall, 1),
        "env_steps_per_sec": round(env_steps / wall, 1),
        "grad_steps_per_sec": round(grad_steps / wall, 1),
        "dp_size": dp,
        "replay_ratio": replay_ratio,
        "train_batch": train_batch,
        "actor_dtype": cfg.network.actor_dtype or "float32",
        "sharded_collect": False,
        "collect_lane_block": B,
        "collect_dispatch_s_total": 0.0,
        "d2h_bytes_by_shard": None,
        "ring_bytes_by_shard": None,
        "ring_transitions": ring.size * B,
        "ring_gb": round(ring.nbytes / 1e9, 3),
        "window_transitions_max": num_slots * B,
        "pipeline": pipeline,
        "evac_slices": evac_slices if evacuator is not None else 0,
        "d2h_bytes_total": d2h_bytes_total,
        "evac_fence_wait_s_total": round(fence_wait_total, 4),
        "evac_overlap_frac_mean": round(sum(overlap_fracs) / n, 4),
        "param_checksum": param_checksum,
        "double_buffer": stager is not None or prefetcher is not None,
        "h2d_staged_bytes": (
            prefetcher.bytes_staged if prefetcher is not None
            else stager.bytes_staged if stager is not None else 0),
        "prefetch": prefetcher is not None,
        "prefetch_depth": prefetch_depth if prefetcher is not None else 0,
        "prioritized": bool(samplers),
        "sampler": ("device" if (samplers and device_sampling)
                    else "tree" if samplers else "uniform"),
        "sample_s_total": round(sample_s_total, 4),
        "prefetch_wait_s_total": round(prefetch_wait_s_total, 4),
        "stale_batches": (prefetcher.stale_total
                          if prefetcher is not None else 0),
        "prio_writeback_flushes": sum(s.writeback_flushes
                                      for s in samplers),
        "prio_writeback_rows": sum(s.writeback_rows for s in samplers),
        "prio_writeback_dropped": sum(s.writeback_dropped
                                      for s in samplers),
        "is_weight_mean": round(is_w_sum / is_w_count, 6)
        if is_w_count else 1.0,
        "is_weight_min": round(is_w_min, 6) if is_w_count else 1.0,
        "chip_time": chip_time,
        "history": history,
        "learner": state,
    }
