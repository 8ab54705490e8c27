"""The host-replay runtime: a collect/train loop with the replay window in
host DRAM (twin of ``dist_dqn_tpu/host_replay_loop.py``).

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

**Data-parallel mode** (``mesh``: a ``parallel.mesh.Mesh``, one process per
device). JAX drives its dp shards from one process; here rank r is shard r
and holds everything of it: its ``B / dp`` lane block and collect carry,
its own ``HostTimeRing`` of ``num_slots x B / dp``, its evacuation worker
and prefetcher, its priority sampler (a sum-tree, or a plane on its own
device; the ring draws at explicit uniforms, so JAX's per-shard plane
seed has no twin) and its ``train_batch / dp`` rows of every batch,
drawn from stream ``(k, r)`` (a 1-shard mesh keeps ``(k,)``). Its rows are the global rows
``Mesh.rows``; the learner step is the data-parallel one (agents/dqn.py
with ``axis``): one flat gradient all-reduce. What JAX's one-process
mechanism makes observable is reproduced with one reduction per chunk
(``Mesh.gather``): ``evac_s`` and the fence wait are the slowest shard's,
bytes and sampling columns are sums, ``d2h_bytes_by_shard`` and
``ring_bytes_by_shard`` list every shard, so rank 0's rows and summary
carry JAX's keys with JAX's meanings (``chip_time`` is rank 0's own
device ledger). JAX's ``replicated_device_views`` has no counterpart:
each rank casts its own bf16 actor snapshot once per chunk. Rank 0
alone logs. ``sharded_collect=True`` at one device runs this machinery on
a world-size-1 mesh, bit-identical to the plain program.

At dp > 1 the checkpoint is still one ``host_loop_<step>.npz`` in the
schema's per-shard layout (``ring_shard{i}_*``, ``carry{s}_leaf{i}``,
``pending{s}_*``, ``wb{s}_*``), and ring bytes never cross the process
group: every rank fences its evacuation and writes its shard's entries to
a part file beside the step, and rank 0 copies the parts' members into the
one sidecar, then commits the learner step. On resume rank 0 picks the
step and checks the pins, every rank loads only its own shard's keys, and
a rank that cannot makes every rank raise.

Every rank records the JAX loop's telemetry families into its process
registry (``{loop="host_replay"}``: the evacuation overlap and fence
wait, D2H bytes, the learner config gauges and grad rate, the per-shard
collect dispatch wall under the mesh, and the checkpoint saves, resumes
and refusals by reason), beside those of its ring, samplers and staging.
``telemetry_port`` serves rank 0's registry at ``/metrics`` (and
announces it to the run's fleet under ``DQN_FLEET_DIR``).

Crash forensics (null-safe until the CLI arms them): the collect and
train stages beat their heartbeats (``host_replay.collect``, or
``host_replay.collect.s{rank}`` on a mesh rank, which is a process of its
own with its own watchdog; ``host_replay.train``), each chunk records a
``fence`` and a ``train`` flight event, the divergence sentinel sees every
train event's loss and a non-finite end-of-run param checksum, and the
``host_replay.checkpoint`` emergency hook saves the learner at its last
fence plus this rank's ring as a side snapshot.

Chaos seams (chaos/plan.py): ``host_replay.collect`` before each collect
dispatch (crash or stall), ``sidecar.write`` on the composed sidecar
(torn) and ``host_replay.chunk`` after each chunk's save (crash). A
resume marks the crash seams recovered, and ``sidecar.write`` too when it
fell back past a torn sidecar. On a mesh every rank is a process with an
injector of its own (armed from ``DQN_CHAOS_PLAN`` in a spawned rank):
each counts the ``dp`` collect dispatches of a chunk, as JAX's one process
counts its shards', so a plan's ``at_hit`` names the same (chunk, shard)
on every rank; only that shard's rank sleeps a stall, and a crash ends
every rank, as it ends JAX's one process.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import re
import shutil
import time
import zipfile
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from dist_dqn_tpu_torch import chaos, loop_common
from dist_dqn_tpu_torch.agents.dqn import (LearnerState, broadcast_learner,
                                           make_actor_step, make_learner)
from dist_dqn_tpu_torch.config import ExperimentConfig
from dist_dqn_tpu_torch.envs import make_env
from dist_dqn_tpu_torch.envs.base import TorchEnv
from dist_dqn_tpu_torch.models import build_network
from dist_dqn_tpu_torch.parallel.learner import sync_learner_from_rank0
from dist_dqn_tpu_torch.replay.host_ring import (HostTimeRing, PerSample,
                                                 RingDevicePrioritySampler,
                                                 RingPrioritySampler)
from dist_dqn_tpu_torch.replay.sharded import (shard_state,
                                               split_shard_state)
from dist_dqn_tpu_torch.telemetry import collectors as tmc
from dist_dqn_tpu_torch.telemetry import devtime
from dist_dqn_tpu_torch.telemetry import get_registry, serve_if_asked
from dist_dqn_tpu_torch.telemetry import flight as tm_flight
from dist_dqn_tpu_torch.telemetry import watchdog as tm_watchdog
from dist_dqn_tpu_torch.replay.staging import (DoubleBufferedStager,
                                               EvacuationWorker,
                                               SamplePrefetcher,
                                               StreamedEvacuator, tree_map)
from dist_dqn_tpu_torch.types import Transition
from dist_dqn_tpu_torch.utils import ckpt_schema, flops
from dist_dqn_tpu_torch.utils.checkpoint import (TrainCheckpointer,
                                                atomic_savez,
                                                load_state_tree,
                                                record_checkpoint_kind,
                                                save_emergency, state_tree,
                                                tree_leaves)
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


class _MeshLoopState(NamedTuple):
    """A data-parallel run's checkpoint step (rank 0's): the learner; the
    collect carries ride the sidecar, one per shard."""

    learner: LearnerState


class _UniformTag(NamedTuple):
    """Uniform-mode sample bookkeeping: the ring generation the batch was
    drawn against (the prefetcher's staleness handshake)."""

    generation: int


def make_collect_chunk(cfg: ExperimentConfig, env: TorchEnv,
                       frame_stack: int, lanes: Optional[int] = None,
                       num_shards: int = 1):
    """(init, collect): a device chunk of act -> step that RETURNS its
    transitions (time-major [C, B, ...] in one buffer per field, allocated
    at the chunk's start) plus its episode stats, and writes no ring.

    ``init(gen_env, gen_act)`` resets the env lanes; ``collect(carry,
    actor_net, num_iters)`` returns ``(carry, records, (completed_return,
    completed_count))``, the records a dict of obs (the newest frame under
    dedup), action (int32, as JAX's), reward, terminated and truncated.
    ``actor_net`` is the net the chunk acts on (the bf16 snapshot with
    ``network.actor_dtype``).

    ``lanes``/``num_shards`` build one shard's program of a data-parallel
    run: ``lanes`` env lanes (the shard's block), with epsilon decaying in
    per-shard iteration units (``make_schedules`` divides the horizon by
    ``lanes * num_shards``), so the shards together walk the schedule the
    whole-B program walks at the same global frame count.
    """
    B = cfg.actor.num_envs if lanes is None else int(lanes)
    act = make_actor_step(env.num_actions)
    epsilon, _ = loop_common.make_schedules(cfg, B, num_shards)
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
            "action": torch.empty((num_iters, B), dtype=torch.int32,
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


def host_replay_generators(seed: int, device, rank: int = 0
                           ) -> List[torch.Generator]:
    """(env, exploration, learner) generators of the host-replay loop.
    Rank 0 (and a single-device run) takes ``SeedSequence(seed)``'s first
    three words, ``loop_common.generators(seed, device, 3)``; rank r > 0
    its own env and exploration streams, the first two words of
    ``SeedSequence(seed, spawn_key=(r,))``. The learner's is the same on
    every rank: the replicated learner draws the same noise everywhere."""
    base = np.random.SeedSequence(seed).generate_state(3, dtype=np.uint64)
    own = (base if rank == 0 else np.random.SeedSequence(
        seed, spawn_key=(rank,)).generate_state(2, dtype=np.uint64))
    return [torch.Generator(device=device).manual_seed(int(s))
            for s in (own[0], own[1], base[2])]


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


# --------------------------------------------------------------------------
# The data-parallel sidecar's pieces.
# --------------------------------------------------------------------------

# Keys of one shard in the sidecar (the shard id in group 1); every other
# key is shared by the shards.
_SHARD_KEY = re.compile(
    r"^(?:ring_shard(\d+)_|carry(\d+)_leaf|wb(\d+)_|pending(\d+)_)")


def _key_shard(key: str) -> Optional[int]:
    m = _SHARD_KEY.match(key)
    if m is None:
        return None
    return int(next(g for g in m.groups() if g is not None))


def carry_leaves(carry: CollectCarry) -> List[np.ndarray]:
    """A collect carry as the sidecar's ``carry{s}_leaf{i}`` arrays: the
    leaves of its state tree (env state, obs, generator states, iteration,
    episode returns) in walk order."""
    out = []
    for leaf in tree_leaves(state_tree(carry)):
        if isinstance(leaf, torch.Tensor):
            if leaf.dtype == torch.bfloat16:
                raise TypeError("a collect carry holds no bf16 leaves")
            out.append(leaf.cpu().numpy())
        else:
            out.append(np.asarray(leaf))
    return out


def carry_from_leaves(template: CollectCarry, leaves: List[np.ndarray]
                      ) -> CollectCarry:
    """Read :func:`carry_leaves` arrays back into ``template`` (a freshly
    initialized carry of the same config), checking every leaf."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(v) for k, v in t.items()}
        if isinstance(t, list):
            return [build(v) for v in t]
        if t is None:
            return None
        leaf = next(it)
        if isinstance(t, torch.Tensor):
            return torch.from_numpy(np.array(leaf))
        return type(t)(leaf.item() if isinstance(leaf, np.ndarray)
                       else leaf)

    tree = build(state_tree(template))
    if next(it, None) is not None:
        raise ValueError("the sidecar holds more collect-carry leaves than "
                         "this config's carry")
    return load_state_tree(template, tree, "carry")


def compose_sidecar(path: str, shared: Dict[str, np.ndarray],
                    parts: List[str]) -> None:
    """Write the one sidecar ``path`` (atomically, through ``path.tmp``):
    ``shared`` arrays plus every member of each part file, whose ``.npy``
    bytes are streamed across unchanged (an npz is an uncompressed zip of
    ``.npy`` members, as ``np.savez`` writes it)."""
    tmp = f"{path}.tmp"
    with zipfile.ZipFile(tmp, "w", zipfile.ZIP_STORED,
                         allowZip64=True) as zout:
        for k, v in shared.items():
            with zout.open(f"{k}.npy", "w", force_zip64=True) as fo:
                np.lib.format.write_array(fo, np.asanyarray(v),
                                          allow_pickle=False)
        for part in parts:
            with zipfile.ZipFile(part) as zin:
                for info in zin.infolist():
                    with zin.open(info) as fi, \
                            zout.open(info.filename, "w",
                                      force_zip64=True) as fo:
                        shutil.copyfileobj(fi, fo, 1 << 24)
    os.replace(tmp, path)


def _chaos_sidecar_seam(path: str) -> None:
    """The ``sidecar.write`` chaos seam on a sidecar just composed at
    ``path``: "torn" leaves a truncated sidecar at the final path (a crash
    mid-write on a filesystem without atomic-rename semantics) while the
    learner step still commits — resume must detect the unreadable
    sidecar, delete the unusable step and fall back to the previous one."""
    cev = chaos.fire("sidecar.write")
    if cev is not None and cev.fault == "torn":
        os.truncate(path, max(16, os.path.getsize(path) // 7))


def prune_sidecars(checkpoint_dir: str, keep, upto: int) -> None:
    """Delete the sidecars (``host_loop_<step>.npz``) and rank part files
    (``host_loop_<step>.part<r>.npz``) of every step up to ``upto`` that
    is not in ``keep``: each holds a ring window. A run killed between its
    ranks' part writes and rank 0's compose leaves parts of a step that
    never committed; they go here too."""
    pat = re.compile(r"^host_loop_(\d+)(\.part\d+)?\.npz$")
    for name in os.listdir(checkpoint_dir):
        m = pat.match(name)
        if m is not None and int(m.group(1)) <= upto and \
                int(m.group(1)) not in keep:
            os.remove(os.path.join(checkpoint_dir, name))


def _npz_keys(path: str) -> List[str]:
    with zipfile.ZipFile(path) as z:
        return [n[:-len(".npy")] for n in z.namelist()]


def _refused(reason: str, msg: str) -> ValueError:
    """A resume refused at a sidecar pin: the ValueError of the JAX loop's
    text, whose ``resume_refusal`` labels the
    ``dqn_checkpoint_refused_resumes_total`` series it counts in."""
    err = ValueError(msg)
    err.resume_refusal = reason
    return err


def _check_resume_pins(side: dict, checkpoint_dir: str, chunk_iters: int,
                       dp: int, mesh_mode: bool, per_enabled: bool,
                       prio_writeback_batch: int,
                       device_sampling: bool) -> None:
    """The sidecar pins a resume must match, with the JAX loop's texts
    (``host_replay_loop.py:1062-1159``)."""
    ver = int(side.get("sidecar_version", 0))
    if ver != ckpt_schema.SIDECAR_VERSION:
        raise _refused(
            "sidecar_version",
            f"checkpoint at {checkpoint_dir!r} carries sidecar "
            f"schema v{ver}, this build reads "
            f"v{ckpt_schema.SIDECAR_VERSION} — resume with a "
            "matching build (utils/ckpt_schema.py documents the "
            "history), or start a fresh --checkpoint-dir")
    if int(side["chunk_iters"]) != chunk_iters:
        raise _refused(
            "chunk_iters",
            f"checkpoint at {checkpoint_dir!r} was written with "
            f"--chunk-iters {int(side['chunk_iters'])}, this "
            f"run uses {chunk_iters} — resume with the same "
            "loop shape (the ring/env config is already "
            "validated by the snapshot shapes)")
    if int(side["dp"]) != dp:
        raise _refused(
            "dp",
            f"checkpoint at {checkpoint_dir!r} was written at "
            f"--mesh-devices {int(side['dp'])}, this run uses "
            f"{dp} — resume with the same mesh width "
            "(re-sharding a lane-striped host-replay window is "
            "not supported; docs/fault_tolerance.md 'resuming "
            "a sharded run')")
    if bool(side["sharded_collect"]) != mesh_mode:
        raise _refused(
            "sharded_collect",
            f"checkpoint at {checkpoint_dir!r} was written "
            f"with sharded_collect="
            f"{bool(side['sharded_collect'])}, this run "
            f"resolves sharded_collect={mesh_mode} — resume "
            "with the same collect mode (the collect carries "
            "are stored per mode)")
    if per_enabled and \
            int(side["prio_writeback_batch"]) != prio_writeback_batch:
        raise _refused(
            "prio_writeback_batch",
            f"checkpoint at {checkpoint_dir!r} was written "
            f"with prio_writeback_batch="
            f"{int(side['prio_writeback_batch'])}, this run "
            f"uses {prio_writeback_batch} — resume with the "
            "same PER write-back cadence")
    if int(side.get("population", 1)) != 1:
        raise _refused(
            "population",
            f"checkpoint at {checkpoint_dir!r} was written with "
            f"population={int(side['population'])} stacked "
            "members, but --runtime host-replay trains a single "
            "policy — the member axis is checkpoint structure. "
            "Resume it under the fused --population runtime, or "
            "start a fresh --checkpoint-dir")
    if bool(side["per"]) != per_enabled:
        raise _refused(
            "per",
            f"checkpoint at {checkpoint_dir!r} was written with "
            f"prioritized={bool(side['per'])}, this run "
            f"configures prioritized={per_enabled} — a uniform "
            "snapshot cannot honestly seed a sum-tree (and vice "
            "versa); resume with the same sampler, or start a "
            "fresh --checkpoint-dir")
    if per_enabled and \
            int(side["per_sampler_kind"]) != int(device_sampling):
        kinds = {0: "host sum-tree", 1: "device plane"}
        raise _refused(
            "sampler_kind",
            f"checkpoint at {checkpoint_dir!r} was written with "
            f"the {kinds[int(side['per_sampler_kind'])]} PER "
            f"backend, this run configures the "
            f"{kinds[int(device_sampling)]} — resume with the "
            "same --device-sampling setting, or start a fresh "
            "--checkpoint-dir")


def resolve_mesh_width(mesh_devices: int, device=None) -> int:
    """The data-parallel width a ``mesh_devices`` request means, with the
    JAX loop's refusals (``host_replay_loop.py:358-363``): 0 is every card
    (one CPU rank with ``device="cpu"``); more than the machine's cards
    raises. CPU ranks are processes, so any positive count is allowed."""
    if mesh_devices < 0:
        raise ValueError(f"mesh_devices must be >= 0, got {mesh_devices}")
    on_card = torch.device(device or "cuda").type == "cuda"
    count = None
    if on_card:
        resolve_device("cuda")
        count = torch.cuda.device_count()
    dp = (count or 1) if mesh_devices == 0 else int(mesh_devices)
    if count is not None and dp > count:
        raise ValueError(f"--mesh-devices {dp} requested but only "
                         f"{count} devices are available")
    return dp


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
                    device=None, mesh=None,
                    telemetry_port: Optional[int] = None,
                    telemetry_host: str = "127.0.0.1"):
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

    ``mesh`` runs this call as one rank of the data-parallel runtime (the
    module docstring), on ``mesh.device``; ``mesh_devices`` must then be 0,
    1 or the mesh's size. Without a mesh, ``mesh_devices`` > 1 (or
    ``sharded_collect=True``) starts the ranks itself through
    ``train.run_mesh`` and returns rank 0's summary without ``learner``
    (``log_fn`` must then pickle, and ``env`` must be None); a world-size-1
    mesh runs in this process and keeps it. The mesh always runs the
    sharded collect: ``sharded_collect=False`` at dp > 1 raises, as in
    JAX. Under the mesh, ``prefetch=False`` runs the fully serial
    per-shard reference (JAX's main-thread stager is single-chip only).
    ``telemetry_port`` serves rank 0's telemetry registry at ``/metrics``
    for the run (0: an ephemeral port, logged as a ``telemetry_port``
    row).
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
    if mesh is not None:
        dp = mesh.size
        if mesh_devices not in (0, 1, dp):
            raise ValueError(f"mesh_devices={mesh_devices} does not match "
                             f"the mesh's {dp} ranks")
    else:
        dp = resolve_mesh_width(mesh_devices, device)
    if sharded_collect is False and dp > 1:
        raise ValueError(
            "--mesh-devices > 1 always runs the sharded collect path; "
            "sharded_collect=False is only meaningful at mesh width 1")
    mesh_mode = dp > 1 or bool(sharded_collect) or mesh is not None
    B = cfg.actor.num_envs
    if dp > 1 and B % dp:
        raise ValueError(
            f"actor.num_envs={B} not divisible by --mesh-devices {dp}: "
            "each dp shard owns one env-lane block of the collect chunk")
    train_batch = loop_common.resolve_train_batch(cfg)
    if dp > 1 and train_batch % dp:
        raise ValueError(
            f"train batch {train_batch} not divisible by --mesh-devices "
            f"{dp}: each dp shard draws and uploads an equal row block "
            "(widen replay.train_batch or change the mesh size)")
    if mesh_mode and mesh is None:
        if env is not None:
            raise ValueError("a data-parallel run builds each rank's env "
                             "on its own device; pass env=None")
        from dist_dqn_tpu_torch.train import run_mesh
        return run_mesh(
            cfg, num_devices=dp, device=device, runtime="host-replay",
            total_env_steps=total_env_steps, chunk_iters=chunk_iters,
            log_fn=log_fn, double_buffer=double_buffer, pipeline=pipeline,
            evac_slices=evac_slices, prefetch=prefetch,
            prefetch_depth=prefetch_depth, prioritized=prioritized,
            prio_writeback_batch=prio_writeback_batch,
            checkpoint_dir=checkpoint_dir,
            save_every_frames=save_every_frames,
            device_sampling=device_sampling, profile_dir=profile_dir,
            telemetry_port=telemetry_port, telemetry_host=telemetry_host)
    dev = mesh.device if mesh_mode else resolve_device(device)
    rank = mesh.rank if mesh_mode else 0
    main = rank == 0
    if not main:
        log_fn = lambda *a, **k: None  # noqa: E731 — rank 0 alone logs
        profile_dir = None

    if env is None:
        env = make_env(cfg.env_name, device=dev)
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
    lanes = B // dp

    net = build_network(cfg.network, env.num_actions, obs_shape,
                        device=dev, seed=cfg.seed)
    if mesh_mode:
        init_collect, collect = make_collect_chunk(
            cfg, env, stack, lanes=lanes, num_shards=dp)
    else:
        init_collect, collect = make_collect_chunk(cfg, env, stack)
    init_learner, train_step = make_learner(
        cfg.learner, net, axis=mesh if mesh_mode else None)
    # The chip-time plane (dist_dqn_tpu/host_replay_loop.py:422-462): both
    # hot programs in the process program table, their census taken on
    # copies of their arguments outside any chunk's train section (the
    # collect's at the prologue dispatch, the train step's after the
    # first training chunk), their device seconds at the fences the loop
    # already holds. The collect overlaps the evacuation and training in
    # pipeline mode, so only the serial reference fences it. The
    # data-parallel step's all-reduce cannot run on one rank alone: its
    # census is left unknown.
    prog_collect = devtime.register_program(
        "host_replay.collect", loop="host_replay", role="collect")
    prog_train = devtime.register_program(
        "host_replay.train_step", loop="host_replay", role="train")
    if mesh_mode:
        prog_train.attach_cost({})

    def _train(state, batch, w):
        """Every train-step launch: one dispatch of the train program."""
        prog_train.count_dispatch()
        with devtime.device_work():
            return train_step(state, batch, w)
    replay_ratio = loop_common.resolve_replay_ratio(cfg)
    lb = train_batch // dp
    # The bf16 actor snapshot: one cast per chunk; the learner's f32
    # masters stay as they are.
    actor_snapshot = loop_common.make_actor_param_cast(
        cfg.network.actor_dtype)

    ring = HostTimeRing(num_slots, lanes, stored_shape,
                        torch.empty((), dtype=env.observation_dtype)
                        .numpy().dtype, frame_stack=stack)
    ring_bytes = 0          # bytes appended into this rank's ring
    gen_env, gen_act, gen_learn = host_replay_generators(cfg.seed, dev,
                                                         rank)
    carry = init_collect(gen_env, gen_act)
    state = init_learner(net, gen_learn)
    if mesh_mode:
        # The replicas start equal whatever each rank's init did.
        broadcast_learner(state, mesh)

    per_sampler = None
    sampler_kw = dict(n_step=cfg.learner.n_step,
                      alpha=cfg.replay.priority_exponent,
                      beta=cfg.replay.importance_exponent,
                      eps=cfg.replay.priority_eps)
    # Telemetry names: a mesh rank's pipeline objects are shard ``rank``'s
    # of the JAX loop's per-shard ones.
    tm_name = f"host_replay_s{rank}" if dp > 1 else "host_replay"
    tm_shard = rank if mesh_mode else None
    if per_enabled and device_sampling:
        per_sampler = RingDevicePrioritySampler(ring, device=dev,
                                                name=tm_name, **sampler_kw)
    elif per_enabled:
        per_sampler = RingPrioritySampler(ring, name=tm_name, **sampler_kw)
    knobs = (f"alpha={cfg.replay.priority_exponent}, "
             f"beta={cfg.replay.importance_exponent}, "
             f"prio_writeback_batch={prio_writeback_batch}")
    if per_sampler is None:
        log_fn("# host-replay sampler: uniform"
               + (f" x {dp} shards" if dp > 1 else ""))
    elif mesh_mode:
        kind = ("device plane" if device_sampling else
                f"sum-tree ({type(per_sampler.tree).__name__})")
        log_fn(f"# host-replay sampler: prioritized {kind} x {dp} "
               f"shards ({knobs})")
    elif device_sampling:
        log_fn(f"# host-replay sampler: prioritized device plane "
               f"({dev.type}, {knobs})")
    else:
        log_fn(f"# host-replay sampler: prioritized sum-tree "
               f"({type(per_sampler.tree).__name__}, {knobs})")

    def _batch_rng(k: int) -> np.random.Generator:
        # Batch k's content is a pure function of (k, ring window), never
        # of which thread drew it or when; stream (k, r) is shard r's
        # block of batch k (a 1-shard mesh keeps (k,)).
        key = (k, rank) if dp > 1 else (k,)
        return np.random.default_rng(
            np.random.SeedSequence(cfg.seed, spawn_key=key))

    def _transition(hb) -> Transition:
        return Transition(obs=hb.obs, action=hb.action.astype(np.int64),
                          reward=hb.reward, discount=hb.discount,
                          next_obs=hb.next_obs)

    def sample_host(k: int):
        """Batch k's host-side sample + gather (this rank's ``lb`` rows)
        -> (host tree, aux)."""
        rng_k = _batch_rng(k)
        if per_sampler is not None:
            hb, aux = per_sampler.sample(rng_k, lb, cfg.learner.gamma)
            # IS weights travel with the batch through the staging.
            return (_transition(hb), aux.weights), aux
        hs = ring.sample(rng_k, lb, cfg.learner.n_step, cfg.learner.gamma)
        return _transition(hs.batch), _UniformTag(generation=hs.generation)

    def put_batch(tree):
        with devtime.device_work():
            return tree_map(
                lambda a: torch.from_numpy(np.asarray(a)).to(dev), tree)

    def ring_append(tree, lo, hi):
        nonlocal ring_bytes
        ring.add_chunk(tree["obs"], tree["action"], tree["reward"],
                       tree["terminated"], tree["truncated"])
        ring_bytes += sum(np.asarray(tree[k]).nbytes for k in (
            "obs", "action", "reward", "terminated", "truncated"))

    prefetcher = stager = None
    if prefetch:
        prefetcher = SamplePrefetcher(sample_host, depth=prefetch_depth,
                                      name=tm_name,
                                      wait_generation=ring.wait_generation,
                                      device=dev)
    elif double_buffer and not mesh_mode:
        stager = DoubleBufferedStager(depth=2, device=dev,
                                      name="host_replay")
    elif double_buffer:
        log_fn("# --no-prefetch with --mesh-devices > 1 runs the fully "
               "serial per-shard reference (sample -> per-device upload "
               "-> assemble); the double-buffered stager is single-chip "
               "only — ignored")

    evacuator = worker = None
    if pipeline:
        evacuator = StreamedEvacuator(num_slices=evac_slices, name=tm_name,
                                      shard=tm_shard)
        worker = EvacuationWorker(evacuator, ring_append, name=tm_name,
                                  shard=tm_shard)

    reg = get_registry()
    _labels = {"loop": "host_replay"}
    g_overlap = reg.gauge(tmc.HOST_REPLAY_OVERLAP,
                          "share of the last chunk's evacuation hidden "
                          "off the training critical path", _labels)
    h_fence = reg.histogram(tmc.HOST_REPLAY_FENCE_WAIT_SECONDS,
                            "main-thread wait on the chunk publication "
                            "fence (evacuation on the critical path)",
                            _labels)
    c_d2h = reg.counter(tmc.HOST_REPLAY_D2H_BYTES,
                        "bytes evacuated device->host by the replay "
                        "pipeline", _labels)
    reg.gauge(tmc.LEARNER_REPLAY_RATIO,
              "grad sub-steps per train event", _labels).set(replay_ratio)
    reg.gauge(tmc.LEARNER_TRAIN_BATCH,
              "effective (bucketed) train batch width",
              _labels).set(train_batch)
    reg.gauge(tmc.LEARNER_ACTOR_DTYPE_INFO,
              "1 for the active actor inference dtype",
              {**_labels, "dtype": cfg.network.actor_dtype
               or "float32"}).set(1)
    g_grad_rate = reg.gauge(tmc.LEARNER_GRAD_RATE,
                            "grad steps per second (whole loop)",
                            _labels)
    # Under the mesh: the lane block this rank's collect acts over, its
    # collect dispatch wall, and (serial path) its shard's D2H bytes.
    h_collect_disp = c_shard_d2h = None
    if mesh_mode:
        reg.gauge(tmc.HOST_REPLAY_COLLECT_LANE_BLOCK,
                  "env lanes per shard collect dispatch",
                  _labels).set(lanes)
        h_collect_disp = reg.histogram(
            tmc.HOST_REPLAY_COLLECT_SECONDS,
            "per-shard collect dispatch enqueue wall",
            {**_labels, "shard": str(rank)})
        c_shard_d2h = reg.counter(
            tmc.HOST_REPLAY_SHARD_D2H_BYTES,
            "bytes evacuated from this shard's own device into its "
            "own ring (zero cross-shard lane scatter)",
            {**_labels, "shard": str(rank)})

    # The train-event cadence carries its remainder across chunks, so the
    # average is exactly one event per train_every iterations.
    updates_per_train = max(cfg.updates_per_train, 1) * replay_ratio
    train_debt_iters = 0
    weights = torch.ones((lb,), dtype=torch.float32, device=dev)

    # Batched priority write-backs (PER only): each train step's |TD| (this
    # rank's rows) stays a device tensor in this list and lands as one
    # update per prio_writeback_batch steps, chronological, last write
    # winning.
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
        gens = np.concatenate([a.slot_gen for a, _ in pending])
        with devtime.device_work():
            prios = np.concatenate([_prios(p) for _, p in pending])
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
        h_ckpt_save = reg.histogram(
            tmc.CHECKPOINT_SAVE_SECONDS,
            "whole quiesced checkpoint save wall (fence + sidecar + "
            "orbax commit)", _labels)
        c_ckpt_bytes = reg.counter(
            tmc.CHECKPOINT_BYTES,
            "checkpoint bytes written (sidecar + learner/carry tree)",
            _labels)
        reg.gauge(tmc.CHECKPOINT_SHARDS_SAVED,
                  "replay shards carried by each whole-state save",
                  _labels).set(dp)

        def _count_refused(reason: str) -> None:
            reg.counter(tmc.CHECKPOINT_REFUSED,
                        "resume attempts refused at the sidecar pins",
                        {**_labels, "reason": reason}).inc()

        # Each save copies the whole ring window, so the default cadence
        # is never finer than one chunk.
        save_period = save_every_frames or max(cfg.eval_every_steps,
                                               chunk_iters * B)
        if main:
            ckpt = TrainCheckpointer(checkpoint_dir,
                                     save_every_frames=save_period)
            record_checkpoint_kind(checkpoint_dir, "host_loop")
        next_save = save_period

        def _sidecar_path(step: int) -> str:
            return os.path.join(checkpoint_dir, f"host_loop_{step}.npz")

        def _part_path(step: int, shard: int) -> str:
            return os.path.join(checkpoint_dir,
                                f"host_loop_{step}.part{shard}.npz")

        # Rank 0 picks the step: the newest whose sidecar reads (a step
        # whose sidecar is torn or missing is deleted and the next older
        # one tried) and whose pins match this run. Under the mesh it
        # reads only the shared keys; each rank reads its own below.
        side = step = None
        refusal = None
        fell_back = False
        if main:
            try:
                for cand in sorted(ckpt.all_steps(), reverse=True):
                    try:
                        with np.load(_sidecar_path(cand)) as f:
                            side = {k: f[k] for k in f.files
                                    if not mesh_mode
                                    or _key_shard(k) is None}
                        step = cand
                        break
                    except (FileNotFoundError, ValueError, EOFError,
                            KeyError, zipfile.BadZipFile) as e:
                        _count_refused("torn_sidecar")
                        fell_back = True
                        log_fn(f"# checkpoint step {cand}: sidecar "
                               f"unreadable ({type(e).__name__}: {e}) — "
                               "deleting the unusable step and falling "
                               "back to the previous one")
                        ckpt.delete(cand)
                        try:
                            os.remove(_sidecar_path(cand))
                        except OSError:
                            pass
                if side is not None:
                    try:
                        _check_resume_pins(side, checkpoint_dir,
                                           chunk_iters, dp, mesh_mode,
                                           per_enabled,
                                           prio_writeback_batch,
                                           device_sampling)
                    except ValueError as e:
                        _count_refused(e.resume_refusal)
                        raise
            except Exception as e:  # noqa: BLE001 — re-raised below
                if not mesh_mode:
                    raise
                refusal = e
        if mesh_mode:
            # Rank 0's verdict on every rank: 0 = fresh start, 1 = resume
            # step, 2 = rank 0 refused (every rank raises, none waits).
            head = torch.tensor(
                [2 if refusal is not None else int(step is not None),
                 step if step is not None else -1], dtype=torch.int64,
                device=dev)
            mesh.broadcast_([head])
            status, step = head.tolist()
            if status == 2:
                if refusal is not None:
                    raise refusal
                raise RuntimeError(
                    f"rank 0 refused to resume from {checkpoint_dir!r}; "
                    "its error names the cause")
        if step is not None and step >= 0:
            failure = None
            try:
                if mesh_mode:
                    # The shared keys and this rank's shard, nothing else.
                    with np.load(_sidecar_path(step)) as f:
                        side = {k: f[k] for k in f.files
                                if _key_shard(k) in (None, rank)}
                if main:
                    tree = (_HostLoopState(state, carry) if not mesh_mode
                            else _MeshLoopState(state))
                    _, tree = ckpt.restore_latest(tree, step=step)
                    state = tree.learner
                    if not mesh_mode:
                        carry = tree.carry
                if mesh_mode:
                    ring_sub, per_sub = split_shard_state(
                        {k[len("ring_"):]: v for k, v in side.items()
                         if k.startswith("ring_shard")}, rank + 1)
                    ring_state, per_state = ring_sub[rank], per_sub[rank]
                    n_leaves = sum(1 for k in side
                                   if k.startswith(f"carry{rank}_leaf"))
                    carry = carry_from_leaves(
                        carry, [side[f"carry{rank}_leaf{i}"]
                                for i in range(n_leaves)])
                else:
                    ring_state = {k[len("ring_"):]: v for k, v in
                                  side.items() if k.startswith("ring_")}
                    per_state = {k[len("per_"):]: v for k, v in
                                 side.items() if k.startswith("per_")}
                ring.load_state_dict(ring_state)
                if per_sampler is not None:
                    per_sampler.load_state_dict(per_state)
            except Exception as e:  # noqa: BLE001 — re-raised below
                if not mesh_mode:
                    raise
                failure = e
            if mesh_mode:
                failed = mesh.gather([failure is not None])[:, 0]
                if failed.any():
                    if failure is not None:
                        raise failure
                    raise RuntimeError(
                        f"rank(s) {np.flatnonzero(failed).tolist()} could "
                        f"not restore their shard of step {step} from "
                        f"{checkpoint_dir!r}")
                sync_learner_from_rank0(mesh, state)
            env_steps = int(side["env_steps"])
            grad_steps = int(side["grad_steps"])
            ring.current_params_version = grad_steps
            sample_k = int(side["sample_k"])
            if prefetcher is not None:
                # Per-index batch RNG: continue the killed run's indices
                # (every shard's prefetcher shares the one cursor).
                prefetcher.seek(sample_k)
            train_debt_iters = int(side["train_debt_iters"])
            start_chunk = int(side["next_chunk"])
            next_save = env_steps + save_period
            resumed = True
            # Deferred write-backs ride the sidecar as they were, and flush
            # on the killed run's schedule; this rank's block of each
            # entry's priorities.
            wb = rank if mesh_mode else 0
            for j in range(int(side.get("wb_count", 0))):
                leaf = np.asarray(side[f"wb{wb}_leaf"][j], np.int64)
                aux = PerSample(
                    leaf=leaf, t_idx=np.zeros_like(leaf, np.int32),
                    b_idx=np.zeros_like(leaf, np.int32),
                    slot_gen=np.asarray(side[f"wb{wb}_slot_gen"][j],
                                        np.int64),
                    weights=np.zeros(leaf.shape[0], np.float32),
                    generation=0)
                prios = np.asarray(side["wb_prios"][j], np.float64)
                wb_pending.append((aux, prios[rank * lb:(rank + 1) * lb]))
            if bool(side["has_stats"]):
                cr, cc = (np.asarray(side[k]).reshape(-1)[rank]
                          for k in ("stats_cr", "stats_cc"))
                resume_stats = tuple(
                    torch.tensor(float(x), dtype=torch.float32, device=dev)
                    for x in (cr, cc))
            if bool(side["has_pending"]):
                prefix = f"pending{rank}_" if mesh_mode else "pending_"
                resume_pending = {k[len(prefix):]: v for k, v in
                                  side.items() if k.startswith(prefix)}
            del side
            log_fn(json.dumps({"resumed_at_frames": env_steps,
                               "resumed_at_chunk": start_chunk,
                               "resumed_dp": dp,
                               "resumed_per": per_enabled}))
            reg.counter(tmc.CHECKPOINT_RESUMES,
                        "successful whole-state resumes", _labels).inc()
            # Resuming from the checkpoint IS the recovery proof for an
            # injected mid-run crash (in-process chaos replay); a
            # resume that fell back past an injected torn sidecar
            # proves that seam recovered too.
            chaos.mark_recovered("host_replay.chunk")
            # ...and for a crash injected at a shard's collect dispatch:
            # the resumed process restores that shard's carry from the
            # sidecar, which is the surviving path.
            chaos.mark_recovered("host_replay.collect")
            if fell_back:
                chaos.mark_recovered("sidecar.write")

    d2h_bytes_total = 0
    d2h_bytes_by_shard = [0] * dp if mesh_mode else None
    collect_dispatch_s = 0.0
    fence_wait_total = 0.0
    sample_s_total = 0.0
    prefetch_wait_s_total = 0.0
    # The utilization ledger: each chunk's wall as the train section's
    # device time and the named host-blocked buckets (this rank's device).
    ledger = devtime.UtilizationLedger("host_replay", reg)
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
        only, so the continuing run stays bit-identical). Under the mesh
        every rank writes its shard's part and rank 0 composes the one
        sidecar before it commits the learner step."""
        nonlocal last_saved
        if env_steps <= last_saved:
            return
        t_save = time.perf_counter()
        if pipeline and handle is not None:
            handle.wait()
        shared = dict(
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
            sharded_collect=np.bool_(mesh_mode),
            prio_writeback_batch=np.int64(prio_writeback_batch),
            wb_count=np.int64(len(wb_pending)),
            has_stats=np.bool_(stats is not None),
            has_pending=np.bool_(records is not None))
        if not mesh_mode:
            own = {f"ring_{k}": v for k, v in ring.state_dict().items()}
            if per_sampler is not None:
                own.update({f"per_{k}": v for k, v in
                            per_sampler.state_dict().items()})
        else:
            own = {f"ring_{k}": v for k, v in shard_state(
                rank, ring, per_sampler).items()}
            for i, leaf in enumerate(carry_leaves(carry)):
                own[f"carry{rank}_leaf{i}"] = leaf
        wb = rank if mesh_mode else 0
        if wb_pending:
            own[f"wb{wb}_leaf"] = np.stack([a.leaf for a, _ in wb_pending])
            own[f"wb{wb}_slot_gen"] = np.stack(
                [a.slot_gen for a, _ in wb_pending])
            prios = np.stack([_prios(p) for _, p in wb_pending])
            if mesh_mode:
                # [dp, wb_count, lb] -> the global [wb_count, train_batch].
                prios = mesh.gather(prios).transpose(1, 0, 2).reshape(
                    prios.shape[0], -1)
            shared["wb_prios"] = prios
        if stats is not None:
            pair = [float(x) for x in stats]
            if mesh_mode:
                table = mesh.gather(pair)
                shared.update(stats_cr=table[:, 0].astype(np.float32),
                              stats_cc=table[:, 1].astype(np.float32))
            else:
                shared.update(stats_cr=np.float32(pair[0]),
                              stats_cc=np.float32(pair[1]))
        if records is not None:
            prefix = f"pending{rank}_" if mesh_mode else "pending_"
            own.update({f"{prefix}{k}": _host(v)
                        for k, v in records.items()})
        path = _sidecar_path(env_steps)
        if not mesh_mode:
            side = {**own, **shared}
            ckpt_schema.validate_sidecar(side.keys())
            compose_sidecar(path, side, [])
            _chaos_sidecar_seam(path)
        else:
            part = _part_path(env_steps, rank)
            compose_sidecar(part, own, [])
            mesh.barrier()
            if main:
                shared["ring_num_shards"] = np.int64(dp)
                parts = [_part_path(env_steps, s) for s in range(dp)]
                ckpt_schema.validate_sidecar(
                    list(shared) + [k for p in parts for k in _npz_keys(p)])
                # The sidecar lands before the step: a committed step
                # implies its sidecar exists.
                compose_sidecar(path, shared, parts)
                _chaos_sidecar_seam(path)
                for p in parts:
                    os.remove(p)
        last_saved = env_steps
        if not main:
            return
        ckpt.save(env_steps, _HostLoopState(state, carry) if not mesh_mode
                  else _MeshLoopState(state))
        prune_sidecars(checkpoint_dir, set(ckpt.all_steps()), env_steps)
        save_s = time.perf_counter() - t_save
        h_ckpt_save.observe(save_s)
        c_ckpt_bytes.inc(os.path.getsize(path) + ckpt.last_save["bytes"])
        log_fn(json.dumps({"host_replay_checkpoint": env_steps,
                           "save_s": round(save_s, 3),
                           "shards_saved": dp}))

    def _dispatch_chunk():
        """One chunk's collect, queued on the device with the params as
        they stand now. Returns (records, stats); on the card also records
        the event the records are complete at (the evacuation's start)."""
        nonlocal carry, records_ready, collect_dispatch_s
        # Chaos seam: per-shard crash/stall at the dispatch site, before
        # any launch. Stall recovery = the completed dispatch below;
        # crash recovery = the next process's resume (anchored beside
        # host_replay.chunk's). Every rank counts all dp shards' fires.
        stalled = False
        for s in range(dp):
            cev = chaos.fire("host_replay.collect")
            if cev is not None:
                if cev.fault == "crash":
                    raise chaos.ChaosInjectedError("host_replay.collect",
                                                   cev.fault)
                if s == rank:
                    chaos.sleep_for(cev)
                stalled = True
        with devtime.device_work():
            actor = actor_snapshot(state.net)
            if not prog_collect.cost_attached:
                prog_collect.attach_cost(
                    lambda: flops.census(collect, carry, actor, chunk_iters))
            t_d = time.perf_counter()
            carry, r, st = collect(carry, actor, chunk_iters)
            prog_collect.count_dispatch()
            if mesh_mode:
                dt = time.perf_counter() - t_d
                collect_dispatch_s += dt
                h_collect_disp.observe(dt)
            if dev.type == "cuda":
                records_ready = torch.cuda.Event()
                records_ready.record()
        if stalled:
            chaos.mark_recovered("host_replay.collect")
        return r, st

    def submit_evac(recs):
        return worker.submit(recs, ready=records_ready)

    profile_chunk = (min(start_chunk + 1, num_chunks - 1)
                     if profile_dir else -1)
    tracer = devtime.maybe_trace_first_chunk(profile_dir)
    server = serve_if_asked(telemetry_port if main else None,
                            telemetry_host, log_fn, role="learner",
                            labels={"loop": "host_replay"})
    # Crash forensics: per-stage heartbeats (the evacuation and prefetch
    # stages beat inside their workers) with startup grace for the first
    # chunk's one-time set-up, per-chunk flight events, the sentinel on
    # each train event's loss. A mesh rank names its shard in its stage.
    fr = tm_flight.get_flight()
    if mesh_mode:
        hb_collect = tm_watchdog.heartbeat(
            f"host_replay.collect.s{rank}",
            startup_grace_s=tm_watchdog.STARTUP_GRACE_S)
    else:
        hb_collect = tm_watchdog.heartbeat(
            "host_replay.collect",
            startup_grace_s=tm_watchdog.STARTUP_GRACE_S)
    hb_train = tm_watchdog.heartbeat(
        "host_replay.train", startup_grace_s=tm_watchdog.STARTUP_GRACE_S)
    # The train section mutates the learner in place from its first step
    # to its stream's fence; the emergency hook copies it only between.
    fence = tm_watchdog.FenceLock()
    if checkpoint_dir:
        def _emergency_save():
            """The learner at its last fence (rank 0) plus this rank's
            ring and PER sampler under the ring's own fence: a redeploy
            and forensics artifact, not a bit-identical resume point (the
            loop cursors are not quiesced, so the sidecar carries none of
            the resume schema's fields)."""
            if main:
                save_emergency(
                    os.path.join(checkpoint_dir, "emergency_learner.pt"),
                    lambda: {"learner": state}, fence,
                    tm_watchdog.EMERGENCY_FENCE_WAIT_S)
            # Ring and sampler under one hold of the ring's fence: appends
            # may still be in flight, and a publish between the two
            # snapshots would tear sampler mass against ring state.
            eside = {f"ring_{k}": v for k, v in shard_state(
                rank, ring, per_sampler).items()}
            eside.update(dp=np.int64(dp), per=np.bool_(per_enabled),
                         env_steps=np.int64(env_steps))
            name = (f"emergency_sidecar.s{rank}.npz" if mesh_mode
                    else "emergency_sidecar.npz")
            atomic_savez(os.path.join(checkpoint_dir, name), **eside)

        tm_watchdog.register_emergency_hook("host_replay.checkpoint",
                                            _emergency_save)
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
                tracer.start()
            t0 = time.perf_counter()
            next_records = next_stats = None
            if pipeline:
                # Stage 1: chunk g+1's collect, overlapping chunk g's
                # evacuation tail and training.
                if g + 1 < num_chunks:
                    next_records, next_stats = _dispatch_chunk()
                hb_collect.beat()
                t_dispatch = time.perf_counter()
                # Stage 2: fence on chunk g's evacuation.
                handle.wait()
                t_fence = time.perf_counter()
                fence_wait_s = t_fence - t_dispatch
                evac_s = handle.stats["evac_s"]
                d2h_bytes = handle.stats["bytes"]
                t_evac_parts = None
            else:
                # Serial reference: one blocking fetch, one append, then
                # the look-ahead dispatch (the same pre-train params).
                with devtime.device_work():
                    host = {k: _host(v) for k, v in records.items()}
                t_mono_fetch = time.perf_counter()
                ring_append(host, 0, chunk_iters)
                t_fence = time.perf_counter()
                d2h_bytes = int(sum(v.nbytes for v in host.values()))
                del host
                c_d2h.inc(d2h_bytes)
                if c_shard_d2h is not None:
                    c_shard_d2h.inc(d2h_bytes)
                fence_wait_s = evac_s = t_fence - t0
                t_evac_parts = (t_mono_fetch - t0, t_fence - t_mono_fetch)
                if g + 1 < num_chunks:
                    next_records, next_stats = _dispatch_chunk()
                hb_collect.beat()
            local_fence_wait_s = fence_wait_s
            records = next_records
            fr.record("fence", "host_replay.chunk", chunk=g,
                      fence_wait_s=round(fence_wait_s, 4),
                      evac_s=round(evac_s, 4), d2h_bytes=d2h_bytes)
            env_steps += chunk_iters * B
            # Occupancy after chunk g's fence, before chunk g+1's appends.
            ring_transitions = ring.size * B

            # Stage 3: chunk g's train event.
            # The fence lock spans the learner's in-place updates.
            with fence.held():
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
                                state, metrics = _train(state, batch, w)
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
                                state, metrics = _train(state, batch, w)
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
                                state, metrics = _train(state, batch, w)
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
                # Chunk g+1's evacuation: every sample of chunk g's event is
                # drawn, so its slices may publish from here on.
                if pipeline and records is not None:
                    handle = submit_evac(records)
                    records = None
                if did and dev.type == "cuda":
                    # The train section ends at its stream's fence.
                        torch.cuda.current_stream(dev).synchronize()
            hb_train.beat()
            t_train = time.perf_counter()
            fr.record("train", "host_replay.train_event", chunk=g,
                      grad_steps=did)

            with devtime.device_work():
                cr, cc = torch.stack(list(stats)).tolist()
            stats = next_stats
            h2d = (prefetcher.bytes_staged if prefetcher is not None
                   else stager.bytes_staged if stager is not None else 0)
            if mesh_mode:
                # The chunk's columns over every shard, in one reduction:
                # the slowest shard's evacuation and fence wait, the sums
                # of bytes, sampling walls, depths, staleness and episode
                # stats (JAX's _MultiEvacHandle and per-shard loops).
                with devtime.device_work():
                    table = mesh.gather([evac_s, fence_wait_s, d2h_bytes,
                                         ev_sample_s, ev_wait_s, ev_stale,
                                         ev_depth_sum, cr, cc, h2d])
                evac_s, fence_wait_s = (float(table[:, i].max())
                                        for i in (0, 1))
                for s in range(dp):
                    d2h_bytes_by_shard[s] += int(table[s, 2])
                d2h_bytes = int(table[:, 2].sum())
                ev_sample_s, ev_wait_s = (float(table[:, i].sum())
                                          for i in (3, 4))
                ev_stale, ev_depth_sum = (int(table[:, i].sum())
                                          for i in (5, 6))
                cr, cc = (float(table[:, i].sum()) for i in (7, 8))
                h2d = int(table[:, 9].sum())
            t_stats = time.perf_counter()
            ep = float(cr) / max(float(cc), 1.0)
            overlap = (0.0 if not pipeline else
                       max(0.0, min(1.0, 1.0 - fence_wait_s
                                    / max(evac_s, 1e-9))))
            d2h_bytes_total += d2h_bytes
            fence_wait_total += fence_wait_s
            overlap_fracs.append(overlap)
            g_overlap.set(overlap)
            h_fence.observe(fence_wait_s)
            if did:
                sample_s_total += ev_sample_s
                prefetch_wait_s_total += ev_wait_s

            # The train section ends at a device fence, so minus its
            # host-blocked share it is the chunk's train device time (this
            # rank's device); `sample` blocks only without a prefetcher.
            sample_blocked = 0.0 if prefetcher is not None else ev_sample_s
            wall = t_stats - t0
            train_busy = max((t_train - t_fence) - sample_blocked
                             - ev_wait_s, 0.0)
            if did:
                prog_train.add_device_seconds(train_busy)
            if t_evac_parts is not None:
                # Serial reference: the blocking fetch waits out the
                # collect, the one place its device time is fenced.
                prog_collect.add_device_seconds(t_evac_parts[0])
            chip = ledger.observe_chunk(
                wall, train_busy, sample=sample_blocked,
                evac_fence=local_fence_wait_s, prefetch_wait=ev_wait_s)
            devtime.set_learner_mfu("host_replay", device=dev, reg=reg)
            devtime.sweep_device_memory(reg)
            if did and not prog_train.cost_attached:
                with devtime.device_work():
                    prog_train.attach_cost(
                        lambda: flops.census(train_step, state, batch, w))

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
                "ring_gb": round(ring.nbytes * dp / 1e9, 3),
                "sample_s": round(ev_sample_s, 4),
                "chip_busy_s": round(chip["busy"], 4),
                "idle_other_s": round(chip["other"], 4),
                "prefetch_wait_s": round(ev_wait_s, 4),
                "prefetch_depth": round(ev_depth_sum / (did * dp), 2)
                if did else 0.0,
                "stale_batches": ev_stale,
            }
            if t_evac_parts is not None:
                row["chunk_collect_fetch_s"] = round(t_evac_parts[0], 4)
                row["chunk_ring_s"] = round(t_evac_parts[1], 4)
            if prefetcher is not None or stager is not None:
                row["h2d_staged_bytes"] = h2d
            if did:
                with devtime.device_work():
                    loss_val = float(metrics["loss"])
                row["loss"] = round(loss_val, 4)
                # A NaN/Inf loss dumps a forensics bundle instead of
                # training on silently.
                tm_watchdog.observe_divergence(loss=loss_val,
                                               step=grad_steps)
            history.append(row)
            log_fn(json.dumps(row))
            if g == profile_chunk and tracer.stop():
                from dist_dqn_tpu_torch.train import _write_profile
                log_fn(json.dumps(_write_profile(
                    tracer.profile, profile_dir, wall, dev.type == "cuda")))
            if checkpoint_dir and env_steps >= next_save:
                next_save = env_steps + save_period
                with devtime.device_work():
                    _save_checkpoint(g)
            # Chaos seam: the deliberate mid-run kill the
            # resume-bit-identical pin uses — fired AFTER the save so
            # "killed at chunk k" means "with a checkpoint at k".
            cev = chaos.fire("host_replay.chunk")
            if cev is not None and cev.fault == "crash":
                raise chaos.ChaosInjectedError("host_replay.chunk",
                                               cev.fault)
        if checkpoint_dir and num_chunks:
            # The final whole-state save: resuming a completed run is a
            # pass straight to the summary.
            with devtime.device_work():
                _save_checkpoint(num_chunks - 1)
    finally:
        tracer.stop()
        if worker is not None:
            worker.close()
        if prefetcher is not None:
            prefetcher.close()
        if ckpt is not None:
            ckpt.close()
        if server is not None:
            server.close()
        tm_watchdog.unregister_emergency_hook("host_replay.checkpoint")
        hb_collect.close()
        hb_train.close()

    # Land any accumulated write-backs before the summary counts them.
    _wb_flush()
    wall = time.perf_counter() - t_start
    # The pipelined-vs-serial pin's anchor: a float64 fold of the params.
    param_checksum = float(sum(
        np.float64(np.sum(p.detach().cpu().numpy().astype(np.float64)))
        for p in state.net.parameters()))
    # The checksum doubles as the sentinel's divergence signal: NaN/Inf
    # parameters at run end produce a bundle even when no train event
    # logged a loss. Finiteness only: the sentinel's explosion tracking
    # compares consecutive observations of one run's stream, and this is
    # a once-per-run value.
    if not math.isfinite(param_checksum):
        tm_watchdog.observe_divergence(param_checksum=param_checksum,
                                       step=grad_steps)
    n = max(len(overlap_fracs), 1)
    g_grad_rate.set(grad_steps / wall)
    per = per_sampler
    totals = [per.writeback_flushes if per else 0,
              per.writeback_rows if per else 0,
              per.writeback_dropped if per else 0,
              is_w_sum, is_w_count, is_w_min, collect_dispatch_s,
              prefetcher.stale_total if prefetcher is not None else 0,
              prefetcher.bytes_staged if prefetcher is not None
              else stager.bytes_staged if stager is not None else 0,
              ring_bytes]
    ring_bytes_by_shard = None
    if mesh_mode:
        # The run's per-shard counters over every rank (JAX sums its
        # shards' samplers and prefetchers).
        table = mesh.gather(totals)
        totals = list(table.sum(axis=0))
        totals[5] = float(table[:, 5].min())
        ring_bytes_by_shard = [int(b) for b in table[:, 9]]
    (wb_flushes, wb_rows, wb_dropped, is_w_sum, is_w_count, is_w_min,
     collect_dispatch_s, stale_total, h2d_total, _) = totals
    return {
        "env_steps": env_steps, "grad_steps": grad_steps,
        "wall_s": round(wall, 1),
        "env_steps_per_sec": round(env_steps / wall, 1),
        "grad_steps_per_sec": round(grad_steps / wall, 1),
        "dp_size": dp,
        "replay_ratio": replay_ratio,
        "train_batch": train_batch,
        "actor_dtype": cfg.network.actor_dtype or "float32",
        "sharded_collect": mesh_mode,
        "collect_lane_block": lanes,
        "collect_dispatch_s_total": round(collect_dispatch_s, 4),
        "d2h_bytes_by_shard": d2h_bytes_by_shard,
        "ring_bytes_by_shard": ring_bytes_by_shard,
        "ring_transitions": ring.size * B,
        "ring_gb": round(ring.nbytes * dp / 1e9, 3),
        "window_transitions_max": num_slots * B,
        "pipeline": pipeline,
        "evac_slices": evac_slices if evacuator is not None else 0,
        "d2h_bytes_total": d2h_bytes_total,
        "evac_fence_wait_s_total": round(fence_wait_total, 4),
        "evac_overlap_frac_mean": round(sum(overlap_fracs) / n, 4),
        "param_checksum": param_checksum,
        "double_buffer": stager is not None or prefetcher is not None,
        "h2d_staged_bytes": int(h2d_total),
        "prefetch": prefetcher is not None,
        "prefetch_depth": prefetch_depth if prefetcher is not None else 0,
        "prioritized": per_sampler is not None,
        "sampler": ("device" if (per_sampler is not None and device_sampling)
                    else "tree" if per_sampler is not None else "uniform"),
        "sample_s_total": round(sample_s_total, 4),
        "prefetch_wait_s_total": round(prefetch_wait_s_total, 4),
        "stale_batches": int(stale_total),
        "prio_writeback_flushes": int(wb_flushes),
        "prio_writeback_rows": int(wb_rows),
        "prio_writeback_dropped": int(wb_dropped),
        "is_weight_mean": round(is_w_sum / is_w_count, 6)
        if is_w_count else 1.0,
        "is_weight_min": round(is_w_min, 6) if is_w_count else 1.0,
        "chip_time": ledger.snapshot(),
        "programs": devtime.programs_snapshot("host_replay"),
        "history": history,
        "learner": state,
    }

