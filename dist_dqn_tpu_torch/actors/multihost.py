"""Multi-host Ape-X: one learner service per host, gradients over the
group (twin of dist_dqn_tpu/actors/multihost.py).

Every host runs its own ``ApexLearnerService``: its own actor fleet, its
own trajectory assembly and its own replay store in host memory. The train
step is collective: each host feeds its store's rows of the global batch,
the learner averages the gradients across hosts in one all-reduce per grad
step, and the learner stays replicated bit for bit everywhere. Ingestion
stays asynchronous per host; only training is in lockstep.

Cadence without a scheduler: hosts agree on global counters (transitions
inserted, readiness, env steps) through a tiny all-reduce, the agreement.
Each host starts one when its own clock says one is due and then waits
until every peer joins, so agreements pair one to one across hosts (a host
cannot finish agreement k + 1 before its peers finished k), and every host
derives the same train-step target from the same agreed numbers, so the
collective train steps pair too.

The layout differs from JAX's in one way: JAX drives every local device of
a host from one process, so its host is a process with one or more
devices. The port's host is a process that drives one card (the torch
idiom of ``parallel/distributed.py``): ``--coordinator`` joins one
process per card, and a machine with several cards runs one such process
for each. Used by ``ApexLearnerService`` when the process group it finds
has more than one rank; single-process runs never build one.
"""
from __future__ import annotations

import os
import threading
from typing import Tuple

import numpy as np
import torch


class MultihostLearner:
    """Collective-learner machinery for one service process in the group,
    over the port's :class:`~dist_dqn_tpu_torch.parallel.mesh.Mesh` (one
    ``dp`` axis, one rank per process)."""

    def __init__(self, device=None):
        from dist_dqn_tpu_torch.parallel import make_mesh

        device = torch.device(device or "cuda")
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        self.mesh = make_mesh(device=device)
        self.nprocs = self.mesh.size
        # One card per process (see the module docstring).
        self.local_devices = 1
        self.total_devices = self.mesh.size
        # Set when an agreement times out: the worker thread is then parked
        # inside the all-reduce for good, so a second collective from this
        # process could interleave with the first and corrupt the group's
        # order. Poisoning makes that impossible instead of relying on the
        # caller to exit after the raise.
        self._agree_poisoned = False
        # The collective step's program record (wrap_train_step).
        self.program = None

    # -- init -----------------------------------------------------------------
    def wrap_init(self, init):
        """Learner init -> the replicated learner: every process inits from
        the same seed, then takes rank 0's (the group's first collective
        program)."""
        from dist_dqn_tpu_torch.parallel.learner import \
            sync_learner_from_rank0

        def replicated_init(*args, **kwargs):
            state = init(*args, **kwargs)
            sync_learner_from_rank0(self.mesh, state)
            return state

        return replicated_init

    # -- train ----------------------------------------------------------------
    def wrap_train_step(self, train_step, data_specs, metric_specs):
        """The learner's step built with ``axis=mesh`` -> the collective step
        fed THIS process's rows of the global batch.

        The returned ``step(state, *data)`` takes this process's batch (host
        numpy or tensors; numpy moves to the process's device), runs the
        step, whose gradient all-reduce averages over every process, and
        returns (state, metrics) with ``metrics["priorities"]`` this
        process's local rows (a tensor on its device, read back at the
        service's retirement), not the global rows. ``data_specs`` name
        each leaf's row axis (``parallel/learner.py train_step_specs``);
        the scalars of ``metric_specs`` arrive averaged, the row metrics
        stay local."""
        from dist_dqn_tpu_torch.parallel.learner import _map_spec
        from dist_dqn_tpu_torch.telemetry import devtime

        dev = self.mesh.device
        # The chip-time plane (dist_dqn_tpu/actors/multihost.py:104-125):
        # the collective step is this process's train program. Its census
        # is unknown (the all-reduce cannot run on one process alone), and
        # its device seconds are the retirement intervals the service
        # reads its priorities back at (``self.program``; the step holds
        # no fence of its own).
        prog = devtime.register_program(
            "multihost.train_step", loop="multihost", role="train")
        prog.attach_cost({})
        self.program = prog

        def to_device(x, axis):
            if isinstance(x, np.ndarray):
                return torch.from_numpy(np.ascontiguousarray(x)).to(dev)
            return x

        def step(state, *host_data):
            data = [_map_spec(to_device, d, s)
                    for d, s in zip(host_data, data_specs)]
            prog.count_dispatch()
            return train_step(state, *data)

        return step

    # -- agreement ------------------------------------------------------------
    # JAX sums the counters in float32 on device, split into base-2**14
    # limbs, which is exact below 2**38 in all and for up to 1024 hosts. The
    # port's all-reduce is int64, exact by construction; the per-host range
    # and the host ceiling are kept as JAX's public contract, so a counter
    # one package refuses the other refuses too.

    def agree(self, values: np.ndarray) -> np.ndarray:
        """Exact sum of small non-negative integer counters across
        processes. Blocks until every process joins (see the module
        docstring for why agreements pair one to one), but only up to
        ``DQN_AGREE_TIMEOUT_S`` seconds (default 600): a peer that died
        with an uncaught error would otherwise wedge every surviving host
        inside the collective. On timeout the process raises, which in
        turn times out its peers' agreements: the fleet fails loudly
        instead of hanging."""
        if self._agree_poisoned:
            raise RuntimeError(
                "agree() called after a previous agreement collective timed "
                "out; the worker thread may still be blocked inside that "
                "psum, so this learner is poisoned — restart the process")
        ints = np.asarray(values, np.int64)
        if self.nprocs > 1024:
            raise ValueError(
                f"agree() limb split is exact only up to 1024 hosts "
                f"(group has {self.nprocs}); widen the limb split first")
        limit = (1 << 38) // max(self.nprocs, 1)
        if (ints < 0).any() or (ints >= limit).any():
            raise ValueError(
                f"agree() counters out of per-host range [0, {limit}): "
                f"{ints}")
        mesh = self.mesh
        # gloo carries the counters on the host; NCCL only on the card.
        on_card = mesh.backend != "gloo"
        counters = torch.from_numpy(ints.reshape(-1).copy())
        if on_card:
            counters = counters.to(mesh.device)
        result: dict = {}

        def collective():
            try:
                if on_card:
                    torch.cuda.set_device(mesh.device)
                result["out"] = mesh.psum([counters])[0].cpu().numpy()
            except Exception as e:  # noqa: BLE001 — re-raised on the caller
                result["err"] = e

        timeout_s = float(os.environ.get("DQN_AGREE_TIMEOUT_S", "600"))
        worker = threading.Thread(target=collective, name="mh-agree",
                                  daemon=True)
        worker.start()
        # <= 0 means no timeout (block for ever).
        worker.join(timeout_s if timeout_s > 0 else None)
        if worker.is_alive():
            self._agree_poisoned = True
            raise RuntimeError(
                f"agreement collective incomplete after {timeout_s:.0f}s — "
                "a peer host likely died; failing fast instead of wedging "
                "the fleet (DQN_AGREE_TIMEOUT_S to tune)")
        if "err" in result:
            raise result["err"]
        return result["out"].reshape(ints.shape)

    # -- host mirrors ---------------------------------------------------------
    def host_copy(self, tree):
        """A replicated tensor tree -> process-local numpy."""
        from dist_dqn_tpu_torch.parallel.distributed import host_replica
        return host_replica(tree)

    def shard_batch_size(self, global_batch: int) -> Tuple[int, int]:
        """(this process's slice, per-device slice) of a global batch."""
        if global_batch % self.total_devices:
            raise ValueError(
                f"global batch {global_batch} must divide over "
                f"{self.total_devices} devices")
        per_dev = global_batch // self.total_devices
        return per_dev * self.local_devices, per_dev
