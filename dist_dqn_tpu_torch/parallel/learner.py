"""Data-parallel fused training over the mesh (twin of
dist_dqn_tpu/parallel/learner.py).

The JAX package lifts its per-device fused loops into one ``shard_map``
program over the ``dp`` axis. Here every rank is a process that runs the
same per-device loop (train_loop.py, r2d2_loop.py) built with the mesh:

  * env lanes and the replay shard are the rank's own: each rank rolls out
    its ``num_envs / size`` lanes into its ring on its device and draws
    its own batch rows from it, PER through the sampler kernel;
  * learner state is replicated: rank 0's parameters are broadcast once at
    init, and the gradients of each step are averaged in one flat
    all-reduce inside the learner (agents/dqn.py, agents/r2d2.py), so
    every rank applies the same update to the same weights;
  * chunk metrics are reduced so every rank reports global numbers.

The rule of which rows of a global batch a rank holds (``P(axis)`` in
JAX) is :meth:`Mesh.rows`: rank r takes the r-th block.
"""
from __future__ import annotations

import time
from typing import Dict, Optional

import torch

from dist_dqn_tpu_torch.config import ExperimentConfig
from dist_dqn_tpu_torch.envs.base import TorchEnv
from dist_dqn_tpu_torch.parallel.mesh import Mesh
from dist_dqn_tpu_torch.telemetry import get_registry
from dist_dqn_tpu_torch.train_loop import make_fused_train
from dist_dqn_tpu_torch.types import SequenceSample, Transition


def _mesh_wrap(init_local, run_local):
    """The rank's (init, run) with the mesh-chunk telemetry of
    ``learner.py:117-128``: chunks run and the host seconds each took to
    dispatch. Each chunk's kernels are queued from this rank's Python
    loop without a fence, so the time is the host's enqueue, which grows
    when the device holds the host back."""
    reg = get_registry()
    c_chunks = reg.counter("dqn_mesh_chunks_total",
                           "fused mesh chunks dispatched")
    h_dispatch = reg.histogram("dqn_mesh_chunk_dispatch_seconds",
                               "host-side mesh chunk enqueue latency")

    def run(carry, num_iters: int):
        t0 = time.perf_counter()
        out = run_local(carry, num_iters)
        h_dispatch.observe(time.perf_counter() - t0)
        c_chunks.inc()
        return out

    return init_local, run


def make_mesh_fused_train(cfg: ExperimentConfig, env: TorchEnv, net,
                          mesh: Mesh, axis: str = "dp"):
    """(init, run) of the calling rank: ``init(seed)`` builds its carry
    (its lanes and replay shard, the replicated learner) on
    ``mesh.device``, and ``run(carry, num_iters)`` runs a fused chunk on
    it and returns the carry with global metrics. Sizes resolve per shard
    (``loop_common.shard_sizes``), so ``num_envs`` and the train batch
    must divide by the mesh size. The replay-ratio engine and the deferred
    PER flush ride the per-rank body unchanged: every rank draws its own
    sub-step batches from its shard and averages gradients once per
    sub-step."""
    # devtime: the caller registers the mesh program (train.py
    # _FusedTelemetry, fused.chunk).
    init_local, run_local = make_fused_train(
        cfg, env, net, device=mesh.device, axis=mesh,
        num_shards=mesh.shape[axis])
    return _mesh_wrap(init_local, run_local)


def make_mesh_r2d2_train(cfg: ExperimentConfig, env: TorchEnv, net,
                         mesh: Mesh, axis: str = "dp"):
    """R2D2 across the mesh: env lanes and a sequence-replay shard per
    rank, the sequence learner's gradients averaged across ranks; the
    contract of :func:`make_mesh_fused_train`."""
    from dist_dqn_tpu_torch.r2d2_loop import make_r2d2_train

    # devtime: the caller registers the mesh program (train.py
    # _FusedTelemetry, fused.chunk).
    init_local, run_local = make_r2d2_train(
        cfg, env, net, device=mesh.device, axis=mesh,
        num_shards=mesh.shape[axis])
    return _mesh_wrap(init_local, run_local)


# A row spec names the axis of a tensor that holds batch rows (sharded
# over the ranks in blocks, ``P(axis)`` / ``P(None, axis)`` in JAX), or is
# None for a replicated value (``P()``).

def train_step_specs(recurrent: bool = False):
    """(data_specs, metric_specs) of one data-parallel train step: batch
    fields hold rows on axis 0 (time-major sequences on axis 1; their
    start states, weights and indices on 0), the IS weights shard with
    them, the averaged scalars are replicated and the per-example
    priorities keep their rows. The one spec set every host-side
    data-parallel learner lifts its step with."""
    if recurrent:
        data_specs = (SequenceSample(
            obs=1, action=1, reward=1, done=1, reset=1, start_state=(0, 0),
            weights=0, t_idx=0, b_idx=0),)
        metric_specs = {"loss": None, "raw_loss": None, "priorities": 0,
                        "grad_norm": None}
    else:
        data_specs = (Transition(obs=0, action=0, reward=0, discount=0,
                                 next_obs=0), 0)   # batch, weights
        metric_specs = {"loss": None, "raw_loss": None, "priorities": 0,
                        "grad_norm": None, "mean_q_target_gap": None}
    return data_specs, metric_specs


def scan_train_step_specs():
    """Specs of a replay-ratio step over N stacked sub-step batches
    ([N, B, ...]): rows are axis 1, and the priorities come back [N, B],
    each sub-step's rows in global order, so ``reshape(-1)`` is the
    chronological [N x B] the batched write-back expects (a flat concat
    of the ranks' [N x B_local] would interleave by rank block, not by
    sub-step)."""
    data_specs = (Transition(obs=1, action=1, reward=1, discount=1,
                             next_obs=1), 1)
    metric_specs = {"loss": None, "raw_loss": None, "priorities": 1,
                    "grad_norm": None, "mean_q_target_gap": None}
    return data_specs, metric_specs


def _map_spec(fn, tree, spec):
    """Apply ``fn(leaf, axis)`` over ``tree`` and its matching spec tree
    (tuples and named tuples); None leaves pass through."""
    if tree is None:
        return None
    if isinstance(tree, tuple):
        specs = spec if isinstance(spec, tuple) else (spec,) * len(tree)
        out = [_map_spec(fn, t, s) for t, s in zip(tree, specs)]
        return type(tree)(*out) if hasattr(tree, "_fields") else tuple(out)
    return fn(tree, spec)


def _local_rows(x: torch.Tensor, axis: Optional[int], mesh: Mesh):
    if axis is None:
        return x
    rows = x.shape[axis] // mesh.size
    return x.narrow(axis, mesh.rank * rows, rows)


def _global_rows(x: torch.Tensor, axis: Optional[int], mesh: Mesh):
    """This rank's rows put back into the global layout on every rank: one
    all-reduce of a zero buffer holding them in the rank's block (adding
    zeros is exact, so each row is bit for bit its rank's)."""
    if axis is None:
        return x
    shape = list(x.shape)
    rows = shape[axis]
    shape[axis] = rows * mesh.size
    buf = x.new_zeros(shape)
    buf.narrow(axis, mesh.rank * rows, rows).copy_(x)
    return mesh.psum([buf])[0]


def make_sharded_train_step(train_step, mesh: Mesh, data_specs,
                            metric_specs):
    """Lift a learner step built with ``axis=mesh`` (its gradient
    all-reduce inside) onto the rank's row block: ``sharded(state, *data,
    **kw)`` takes the GLOBAL batch on every rank, hands the step this
    rank's rows per ``data_specs`` (keywords such as ``draws`` pass
    through: IQN's draws are global blocks the learner cuts itself), and
    returns the replicated state with the metrics in their global
    layout: the sharded ones (``metric_specs``) rebuilt from every rank's
    rows by one all-reduce each. The host-replay and Ape-X data-parallel
    learners reuse it."""

    def sharded(state, *data, **kw):
        local = [_map_spec(lambda x, a: _local_rows(x, a, mesh), d, s)
                 for d, s in zip(data, data_specs)]
        state, metrics = train_step(state, *local, **kw)
        return state, {k: _global_rows(v, metric_specs.get(k), mesh)
                       for k, v in metrics.items()}

    return sharded


def sync_learner_from_rank0(mesh: Mesh, learner) -> None:
    """Make every rank's learner rank 0's: weights, target, optimizer
    moments (agents/dqn.py ``broadcast_learner``), the step's generator
    state, the step counter and the optimizer's count. A resume that
    restored the learner on rank 0 alone ends with this."""
    from dist_dqn_tpu_torch.agents.dqn import broadcast_learner

    head = torch.tensor([learner.steps, learner.opt_state.count],
                        dtype=torch.int64, device=mesh.device)
    mesh.broadcast_([head])
    broadcast_learner(learner, mesh)
    gen = learner.generator.get_state().to(mesh.device)
    mesh.broadcast_([gen])
    learner.generator.set_state(gen.cpu())
    learner.steps, learner.opt_state.count = head.tolist()


def learner_replicas_equal(mesh: Mesh, learner) -> bool:
    """Whether every rank's learner equals rank 0's, bit for bit: weights,
    target, optimizer moments, step and optimizer counts and the step's
    generator state. Rank 0's copies are broadcast, each rank counts the
    tensors of its own that differ, and one all-reduce sums the counts, so
    every rank returns the same answer (a collective: every rank calls
    it)."""
    opt = learner.opt_state
    dev = mesh.device
    mine = [t.detach() for t in (*learner.net.parameters(),
                                 *learner.target_net.parameters(),
                                 *opt.mu, *opt.nu)]
    mine.append(torch.tensor([learner.steps, opt.count], dtype=torch.int64,
                             device=dev))
    mine.append(learner.generator.get_state().to(dev))
    rank0 = [t.clone() for t in mine]
    mesh.broadcast_(rank0)
    differ = sum(not torch.equal(a, b) for a, b in zip(mine, rank0))
    total = mesh.psum([torch.tensor([float(differ)], device=dev)])[0]
    return float(total) == 0.0


def global_metrics(metrics: Dict) -> Dict:
    """A chunk's metrics as host floats for logging; mirrors each into a
    ``dqn_mesh_<name>`` registry gauge on the way."""
    out = {k: float(v) for k, v in metrics.items()}
    reg = get_registry()
    for k, v in out.items():
        reg.gauge(f"dqn_mesh_{k}", f"mesh chunk metric {k!r}").set(v)
    return out
