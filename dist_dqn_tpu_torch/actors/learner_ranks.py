"""The Ape-X service's learner ranks: ``learner_devices`` > 1 (JAX
``dist_dqn_tpu/actors/service.py:392-410``, ``:544-573``, ``:711-719``).

JAX runs one process, one store and one actor fleet, and shards each train
batch over N local devices with the gradients averaged by ``pmean`` and the
learner state replicated. The port's idiom is one process per device
(``parallel/distributed.py``), so the service process is rank 0 of an
N-rank group and starts N - 1 *learner ranks*: processes that hold only a
learner replica, with no actors and no store. Each serves this part of
the design:

* every rank builds the learner from the same seed and takes rank 0's
  (:func:`~dist_dqn_tpu_torch.parallel.learner.sync_learner_from_rank0`,
  after rank 0's checkpoint restore), so the replicas start bit-equal;
* per train event rank 0 broadcasts a small command header (step, scan,
  check or stop) and then the global batch, one flat broadcast per dtype
  (``Mesh.broadcast_``); every rank runs ``make_sharded_train_step`` on its
  row block, whose learner all-reduces the gradients once per grad step
  before the optimizer, so every replica applies the same update to the
  same weights and they stay bit-equal; the priorities come back in
  global row order (the service's last-wins write-back needs it);
  ``replay_ratio`` > 1 runs the sub-steps over the stacked batches with
  ``scan_train_step_specs``, one gradient all-reduce per sub-step;
* no rank is left running or waiting when another raises: rank 0 checks
  its ranks' liveness before every event and raises naming a dead one; a
  learner rank that raises leaves the group, so rank 0's next collective
  fails; a rank 0 that ends badly terminates its ranks instead of
  commanding them, and every collective raises after the group's timeout
  without its peers.

Only ``all_reduce`` and ``broadcast`` cross ranks, so the ranks run over
NCCL on cards, over ``gloo`` on the CPU, and over ``gloo`` sharing one card
(``backend="gloo"`` on a card: the mechanism check of a machine with one
card; NCCL refuses two ranks on one card).
"""
from __future__ import annotations

import datetime
import os
import sys
import traceback
from typing import Optional

import torch
import torch.distributed as dist

from dist_dqn_tpu_torch.parallel import distributed
from dist_dqn_tpu_torch.parallel.learner import (learner_replicas_equal,
                                                 make_sharded_train_step,
                                                 scan_train_step_specs,
                                                 sync_learner_from_rank0,
                                                 train_step_specs)
from dist_dqn_tpu_torch.parallel.mesh import make_mesh
from dist_dqn_tpu_torch.replay.staging import tree_flatten
from dist_dqn_tpu_torch.types import SequenceSample, Transition

# The command header: [command, leaf count, then per leaf its dtype code,
# rank and up to _MAX_DIMS sizes].
STOP, STEP, SCAN, CHECK = 0, 1, 2, 3
_MAX_DIMS = 6
_HEADER = 2 + 12 * (2 + _MAX_DIMS)
_DTYPES = (torch.uint8, torch.int8, torch.int32, torch.int64, torch.float16,
           torch.bfloat16, torch.float32, torch.float64, torch.bool)
# Seconds a learner rank gets to leave after the stop command.
_JOIN_S = 60.0


def _template(recurrent: bool):
    """The tree of one train event's arguments, leaves standing in."""
    if recurrent:
        return (SequenceSample(obs=0, action=0, reward=0, done=0, reset=0,
                               start_state=(0, 0), weights=0, t_idx=0,
                               b_idx=0),)
    return (Transition(obs=0, action=0, reward=0, discount=0, next_obs=0),
            0)


def make_scan_step(train_step):
    """The replay-ratio step over N stacked batches (``[N, B, ...]`` leaves,
    weights ``[N, B]``): N grad steps in order, priorities stacked ``[N,
    B]``, the loss their mean (the JAX service's ``make_scan_train(...,
    flatten=False)``)."""

    def scan_step(state, batch, weights):
        prios, losses = [], []
        for j in range(weights.shape[0]):
            state, m = train_step(
                state, Transition(*(x[j] for x in batch)), weights[j])
            prios.append(m["priorities"])
            losses.append(m["loss"])
        return state, {"priorities": torch.stack(prios),
                       "loss": torch.stack(losses).mean()}

    return scan_step


def _steps(train_step, mesh, recurrent: bool):
    """{command: the row-sharded step} of every rank: the sequence step, or
    the scan over stacked transition batches (the service's layout at
    every replay ratio).

    devtime: rank 0 is the service, whose train events the service
    registers as apex.train_step (its census left unknown: the step
    all-reduces, which cannot run on one process alone); the other ranks
    keep no program table of their own."""
    if recurrent:
        # devtime: apex.train_step on rank 0 (docstring).
        return {STEP: make_sharded_train_step(
            train_step, mesh, *train_step_specs(recurrent=True))}
    # devtime: apex.train_step on rank 0 (docstring).
    return {SCAN: make_sharded_train_step(make_scan_step(train_step), mesh,
                                          *scan_train_step_specs())}


def _header(command: int, leaves=(), device=None) -> torch.Tensor:
    head = torch.zeros(_HEADER, dtype=torch.int64)
    head[0], head[1] = command, len(leaves)
    for i, x in enumerate(leaves):
        if x.dim() > _MAX_DIMS:
            raise ValueError(f"a batch leaf of rank {x.dim()} > {_MAX_DIMS}")
        base = 2 + i * (2 + _MAX_DIMS)
        head[base] = _DTYPES.index(x.dtype)
        head[base + 1] = x.dim()
        head[base + 2:base + 2 + x.dim()] = torch.tensor(x.shape)
    return head.to(device)


def _leaves_of(head: torch.Tensor, device) -> list:
    head = head.tolist()
    out = []
    for i in range(head[1]):
        base = 2 + i * (2 + _MAX_DIMS)
        shape = head[base + 2:base + 2 + head[base + 1]]
        out.append(torch.empty(shape, dtype=_DTYPES[head[base]],
                               device=device))
    return out


def _rank_device(device: torch.device, backend: str, rank: int
                 ) -> torch.device:
    """Rank ``rank``'s device: the service's own for a CPU group or ranks
    sharing a card over ``gloo``, else the rank-th card from the
    service's."""
    if device.type != "cuda" or backend == "gloo":
        return device
    index = device.index if device.index is not None else 0
    return torch.device("cuda", (index + rank) % torch.cuda.device_count())


def _join(address: str, world: int, rank: int, backend: str,
          device: torch.device):
    """Join the learner group; every collective raises after the group
    timeout without its peers."""
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(
        backend, init_method=f"tcp://{address}", world_size=world,
        rank=rank, timeout=datetime.timedelta(
            seconds=distributed.DEFAULT_TIMEOUT_S))
    return make_mesh(device=device)


def _build_learner(cfg, num_actions: int, obs_shape, device, mesh):
    """(state, train_step) of one replica, built from the config's seed as
    the service builds its own."""
    from dist_dqn_tpu_torch.models import build_network

    net = build_network(cfg.network, num_actions, obs_shape, device=device,
                        seed=cfg.seed)
    if cfg.network.lstm_size > 0:
        from dist_dqn_tpu_torch.agents.r2d2 import make_r2d2_learner

        init, step = make_r2d2_learner(cfg.learner, cfg.replay, axis=mesh)
        return init(net), step
    from dist_dqn_tpu_torch.agents.dqn import make_learner

    init, step = make_learner(cfg.learner, net, axis=mesh)
    return init(net, torch.Generator(device=device).manual_seed(
        cfg.seed + 1)), step


def run_learner_rank(rank: int, world: int, address: str, backend: str,
                     device: str, threads: int, cfg, num_actions: int,
                     obs_shape) -> None:
    """A learner rank's process: join the group, build the replica, take
    rank 0's, then serve rank 0's commands until it says stop. Leaves the
    group on every exit path; exits nonzero after printing a traceback if
    anything raised."""
    code = 0
    try:
        if threads:
            torch.set_num_threads(threads)
        dev = _rank_device(torch.device(device), backend, rank)
        mesh = _join(address, world, rank, backend, dev)
        recurrent = cfg.network.lstm_size > 0
        state, step = _build_learner(cfg, num_actions, obs_shape, dev, mesh)
        sync_learner_from_rank0(mesh, state)
        steps = _steps(step, mesh, recurrent)
        rebuild = tree_flatten(_template(recurrent))[1]
        head = torch.zeros(_HEADER, dtype=torch.int64, device=dev)
        while True:
            mesh.broadcast_([head])
            command = int(head[0])
            if command == STOP:
                break
            if command == CHECK:
                learner_replicas_equal(mesh, state)
                continue
            leaves = _leaves_of(head, dev)
            mesh.broadcast_(leaves)
            state, _ = steps[command](state, *rebuild(leaves))
    except BaseException:  # noqa: BLE001 — reported, then a nonzero exit
        traceback.print_exc()
        sys.stderr.flush()
        code = 1
    finally:
        distributed.shutdown()
    if code:
        os._exit(code)


class LearnerRanks:
    """Rank 0's side of the learner group, held by the service.

    ``start`` spawns the N - 1 learner ranks and joins the group;
    :meth:`train` runs one train event on every rank; :meth:`check`
    compares every replica with rank 0's, bit for bit; :meth:`close` stops
    the ranks (or terminates them after a failure) and leaves the group.
    """

    def __init__(self, size: int, device: torch.device,
                 backend: Optional[str] = None):
        self.size = int(size)
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.backend = backend or distributed.backend_for(self.device)
        self.mesh = None
        self.procs: list = []
        self._steps: dict = {}

    def start(self, cfg, num_actions: int, obs_shape, spawn) -> object:
        """Spawn the learner ranks with ``spawn(target, args, kwargs)`` and
        join the group as rank 0; returns the mesh."""
        address = f"127.0.0.1:{distributed.free_port()}"
        threads = (max(torch.get_num_threads() // self.size, 1)
                   if self.device.type == "cpu" else 0)
        for rank in range(1, self.size):
            self.procs.append(spawn(run_learner_rank, (
                rank, self.size, address, self.backend, str(self.device),
                threads, cfg, num_actions, tuple(obs_shape)), {}))
        self.mesh = _join(address, self.size, 0, self.backend, self.device)
        return self.mesh

    def bind(self, state, train_step, recurrent: bool) -> None:
        """Take rank 0's learner (built with ``axis=self.mesh`` and
        restored where it resumes) into every replica and build the
        row-sharded steps."""
        sync_learner_from_rank0(self.mesh, state)
        self._steps = _steps(train_step, self.mesh, recurrent)

    def check_alive(self) -> None:
        for rank, p in enumerate(self.procs, start=1):
            if not p.is_alive():
                raise RuntimeError(f"learner rank {rank} exited with code "
                                   f"{p.exitcode}")

    def train(self, state, args, scan: bool = False):
        """One train event over the group: the header and the global batch
        broadcast, then the row-sharded step on every rank. Returns rank
        0's (state, metrics), the priorities in global row order."""
        self.check_alive()
        command = SCAN if scan else STEP
        leaves = tree_flatten(args)[0]
        self.mesh.broadcast_([_header(command, leaves, self.device)])
        self.mesh.broadcast_(leaves)
        return self._steps[command](state, *args)

    def check(self, state) -> bool:
        """Whether every replica equals rank 0's learner, bit for bit."""
        self.check_alive()
        self.mesh.broadcast_([_header(CHECK, device=self.device)])
        return learner_replicas_equal(self.mesh, state)

    def close(self, clean: bool) -> None:
        """Stop the learner ranks and leave the group (idempotent). After a
        clean run the ranks are told to stop and joined; otherwise, or
        when one does not leave in time, they are terminated."""
        if self.mesh is not None and clean:
            try:
                self.check_alive()
                self.mesh.broadcast_([_header(STOP, device=self.device)])
            except Exception:  # noqa: BLE001 — the ranks are ended below
                clean = False
        for p in self.procs:
            p.join(timeout=_JOIN_S if clean else 0.1)
            if p.is_alive():
                p.terminate()
                p.join(timeout=5)
        self.procs = []
        self.mesh = None
        distributed.shutdown()


def pick_learner_devices(learner_devices: int, device: torch.device,
                         share_card: bool = False) -> int:
    """The learner ranks ``learner_devices`` asks for: ``0`` means every
    local card, or on the CPU the ranks ``--mesh-devices`` takes (one);
    more than the machine holds raises the JAX service's text. Ranks that
    share one card (``share_card``) are not counted against the cards."""
    if device.type == "cuda":
        available = torch.cuda.device_count()
    else:
        available = max(learner_devices, 1)
    n = available if learner_devices == 0 else learner_devices
    if n > available and not share_card:
        raise ValueError(
            f"learner_devices={n} but only "
            f"{available} devices are available")
    return n

