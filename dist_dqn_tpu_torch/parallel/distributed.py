"""The port's process-group runtime (twin of
dist_dqn_tpu/parallel/distributed.py).

JAX drives every device of a host from one process and joins hosts with
``jax.distributed``. The torch idiom is one process per device, a *rank*,
in a ``torch.distributed`` process group: NCCL when the device is a card,
``gloo`` when it is the CPU. What this module adds around it:

  * :func:`initialize`: join this rank into the group over TCP (the
    coordinator's ``host:port``), with the backend the device asks for
    and a timeout, so a peer that dies ends its group's collectives
    instead of leaving them waiting for ever;
  * main-process gating for logging and checkpoints (every rank computes,
    rank 0 reports);
  * :func:`host_replica`: a tensor tree as host numpy, for per-rank code
    (greedy eval, checkpoint writes) that must not enter a collective;
  * :func:`spawn`: start a function on N local ranks and join them with a
    deadline; a rank that raises ends its peers and the error re-raises
    in the caller.

Only ``all_reduce`` and ``broadcast`` cross ranks anywhere in the port:
``gloo`` on a CUDA tensor carries nothing else, so the same code runs under
NCCL on cards and under ``gloo`` with several ranks sharing one card.
"""
from __future__ import annotations

import datetime
import pickle
import socket
import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

# How long a collective may wait for its peers before the group raises.
DEFAULT_TIMEOUT_S = 1800.0
# Seconds the other ranks of a spawn get to end on their own after one
# raised, before they are terminated.
SPAWN_GRACE_S = 5.0
# Seconds the other ranks of a spawn get to end once one has ended cleanly
# (in training, rank 0's final checkpoint save is the longest lag).
SPAWN_FINISH_S = 300.0


def backend_for(device) -> str:
    """``nccl`` for a card, ``gloo`` for the CPU."""
    kind = torch.device(device).type
    if kind == "cuda":
        return "nccl"
    if kind == "cpu":
        return "gloo"
    raise ValueError(f"unsupported device {device}; expected cuda or cpu")


def initialize(coordinator_address: str, num_processes: int,
               process_id: int,
               local_device_ids: Optional[Sequence[int]] = None,
               device: str = "cuda",
               timeout_s: float = DEFAULT_TIMEOUT_S) -> torch.device:
    """Join this rank into the process group; returns its device.

    ``coordinator_address`` is ``host:port`` of rank 0, which serves the
    group's rendezvous there; ``num_processes`` is the world's rank count
    and ``process_id`` this rank. On ``cuda`` the rank drives card
    ``local_device_ids[0]`` (default: ``process_id`` modulo the cards
    this machine has) over NCCL; on the CPU it joins over ``gloo``. Every
    collective of the group raises after ``timeout_s`` without its
    peers.
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        index = (local_device_ids[0] if local_device_ids
                 else process_id % max(torch.cuda.device_count(), 1))
        dev = torch.device("cuda", index)
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend_for(dev),
        init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=timeout_s))
    return dev


def is_main_process() -> bool:
    """True on the rank that logs and checkpoints (rank 0, or the only
    process when no group is initialized)."""
    return not dist.is_initialized() or dist.get_rank() == 0


def main_process_log(log_fn):
    """Wrap ``log_fn`` so only rank 0 emits (the others compute
    silently)."""
    if is_main_process():
        return log_fn
    return lambda *a, **k: None


def host_replica(tree):
    """A tensor tree (tensors inside dicts, lists, tuples and named tuples)
    as host numpy; bf16 becomes float32, which numpy lacks."""
    if isinstance(tree, torch.Tensor):
        t = tree.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy()
    if isinstance(tree, dict):
        return {k: host_replica(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(host_replica(v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(host_replica(v) for v in tree)
    return np.asarray(tree)


def shutdown() -> None:
    """Leave the process group (idempotent)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def free_port(host: str = "127.0.0.1") -> int:
    """A TCP port on ``host`` that nothing listens on now (the rendezvous
    of a local group)."""
    # socket: bind-only probe: it never connects, listens or accepts, so
    # nothing here can block.
    with socket.socket() as s:
        s.bind((host, 0))
        return s.getsockname()[1]


def spawn(fn: Callable, args: tuple, nprocs: int,
          deadline_s: Optional[float] = None) -> None:
    """Run ``fn(local_rank, *args)`` in ``nprocs`` spawned processes and
    join them. A rank that raises ends the others (after SPAWN_GRACE_S
    seconds in which they may end on their own, as a peer of a dead rank
    does at its next collective) and ``ProcessRaisedException`` raises
    here with the traceback of every rank that raised, in rank order, so
    the first cause is never hidden behind a peer's lost connection. Past
    ``deadline_s`` seconds, or SPAWN_FINISH_S seconds after the first rank
    ended cleanly (the deadline of a run whose length is not known ahead,
    such as training), every rank is terminated and ``TimeoutError``
    raises. ``fn`` must be importable by name (a module's top level)."""
    import torch.multiprocessing as mp

    ctx = mp.start_processes(fn, args=args, nprocs=nprocs, join=False,
                             start_method="spawn")
    end = None if deadline_s is None else time.monotonic() + deadline_s
    finish_end = None
    try:
        while not ctx.join(timeout=1.0, grace_period=SPAWN_GRACE_S):
            now = time.monotonic()
            if end is not None and now > end:
                raise TimeoutError(f"{nprocs} ranks did not finish within "
                                   f"{deadline_s} s")
            if finish_end is None and any(p.exitcode == 0
                                          for p in ctx.processes):
                finish_end = now + SPAWN_FINISH_S
            if finish_end is not None and now > finish_end:
                raise TimeoutError(f"a rank ended, but the others did not "
                                   f"within {SPAWN_FINISH_S} s")
    except mp.ProcessRaisedException as e:
        raise mp.ProcessRaisedException(_rank_errors(ctx), e.error_index,
                                        e.error_pid) from None
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
        for p in ctx.processes:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()


def _rank_errors(ctx) -> str:
    """The tracebacks the spawned ranks left, rank by rank."""
    out = []
    for rank, path in enumerate(ctx.error_files):
        try:
            with open(path, "rb") as fh:
                trace = pickle.load(fh)
        except (OSError, EOFError, pickle.UnpicklingError):
            continue
        out.append(f"-- rank {rank} raised:\n{trace}")
    return "\n".join(out)
