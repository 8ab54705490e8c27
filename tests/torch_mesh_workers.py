"""Rank bodies of the port's mesh tests (tests/test_torch_mesh.py,
tests/test_torch_distributed.py).

:func:`run_ranks` spawns N ``gloo`` ranks through the port's own
``parallel.distributed.spawn`` (a deadline, a failing rank ends the others)
and returns each rank's result. This module imports torch and the port
only, so the spawned ranks start without JAX.
"""
from __future__ import annotations

import os
import tempfile
import time

import numpy as np
import torch

from dist_dqn_tpu_torch import config as tconfig
from dist_dqn_tpu_torch.agents.dqn import make_learner
from dist_dqn_tpu_torch.agents.r2d2 import make_r2d2_learner
from dist_dqn_tpu_torch.envs import make_env
from dist_dqn_tpu_torch.models import build_network
from dist_dqn_tpu_torch.parallel import distributed, learner as plearner
from dist_dqn_tpu_torch.parallel import make_mesh
from dist_dqn_tpu_torch.types import SequenceSample, Transition

# Seconds a spawned group may take, start-up included, and a collective
# may wait for its peers: well inside the suite's clock, with room for a
# loaded host (alone, the longest group takes about 25 s).
DEADLINE_S = 300.0
PEER_TIMEOUT_S = 180.0


def run_ranks(jobs, nprocs: int = 2):
    """Each ``(body, payload)`` of ``jobs`` in turn, as
    ``BODIES[body](mesh, payload)`` on ``nprocs`` CPU ranks of one spawned
    group; per rank, the list of its jobs' results."""
    with tempfile.TemporaryDirectory() as out:
        distributed.spawn(_rank, (f"127.0.0.1:{distributed.free_port()}",
                                  nprocs, jobs, out), nprocs,
                          deadline_s=DEADLINE_S)
        return [torch.load(os.path.join(out, f"{r}.pt"), weights_only=False)
                for r in range(nprocs)]


def _rank(rank, address, nprocs, jobs, out):
    torch.set_num_threads(1)
    distributed.initialize(address, nprocs, rank, device="cpu",
                           timeout_s=PEER_TIMEOUT_S)
    try:
        mesh = make_mesh()
        results = [BODIES[body](mesh, payload) for body, payload in jobs]
        torch.save(results, os.path.join(out, f"{rank}.pt"))
    finally:
        distributed.shutdown()


def _np(x):
    return x.detach().cpu().numpy()


def _params(net) -> dict:
    return {k: _np(v) for k, v in net.state_dict().items()}


def build_learner(case: dict, axis=None):
    """(net, init, step) of one sharded-step case: a feed-forward head or
    the R2D2 learner, on the CPU, with the case's weights."""
    network = tconfig.NetworkConfig(**case["network"])
    lcfg = tconfig.LearnerConfig(**case["learner"])
    net = build_network(network, case["num_actions"],
                        tuple(case["obs_shape"]), device="cpu")
    net.load_state_dict({k: torch.from_numpy(v)
                         for k, v in case["state_dict"].items()})
    if network.lstm_size:
        init, step = make_r2d2_learner(
            lcfg, tconfig.ReplayConfig(**case["replay"]), axis=axis)
    else:
        init, step = make_learner(lcfg, net, axis=axis)
    return net, init, step


def batch_of(case: dict):
    """(data, keywords) of a case's step: the global batch as tensors."""
    def t(x):
        x = torch.from_numpy(np.asarray(x))
        return x.long() if x.dtype == torch.int32 else x
    if case["network"].get("lstm_size"):
        d = case["batch"]
        return (SequenceSample(**{
            k: tuple(t(x) for x in v) if k == "start_state" else t(v)
            for k, v in d.items()}),), {}
    kw = {}
    if case.get("draws") is not None:
        kw["draws"] = {k: torch.from_numpy(v)
                       for k, v in case["draws"].items()}
    return (Transition(*(t(x) for x in case["batch"])),
            torch.from_numpy(case["weights"])), kw


def step_result(learner, metrics) -> dict:
    out = {k: _np(v) for k, v in metrics.items()}
    out["params"] = _params(learner.net)
    out["target_params"] = _params(learner.target_net)
    return out


def sharded_steps(mesh, cases):
    """One sharded train step per case: this rank's rows of the global
    batch through ``make_sharded_train_step``, metrics in global layout."""
    results = []
    for case in cases:
        net, init, step = build_learner(case, axis=mesh)
        recurrent = bool(case["network"].get("lstm_size"))
        sharded = plearner.make_sharded_train_step(
            step, mesh, *plearner.train_step_specs(recurrent))
        data, kw = batch_of(case)
        learner = init(net)
        learner, metrics = sharded(learner, *data, **kw)
        results.append(step_result(learner, metrics))
    return results


def _flat(net) -> np.ndarray:
    return np.concatenate([_np(p).reshape(-1) for p in net.parameters()])


def chunks(mesh, cases):
    """Each case's config through the mesh trainer for ``iters`` iterations
    per chunk, ``chunks`` times: every chunk's global metrics, the rank's
    own episode counts, its final flat parameters and priority seed."""
    results = []
    for case in cases:
        cfg = tconfig.apply_overrides(tconfig.CONFIGS[case["preset"]],
                                      case["overrides"])
        env = make_env(cfg.env_name, device="cpu")
        net = build_network(cfg.network, env.num_actions,
                            env.observation_shape, device="cpu",
                            seed=cfg.seed)
        make = (plearner.make_mesh_r2d2_train if cfg.network.lstm_size
                else plearner.make_mesh_fused_train)
        init, run = make(cfg, env, net, mesh)
        carry = init(cfg.seed)
        rows, local = [], []
        for _ in range(case["chunks"]):
            carry, metrics = run(carry, case["iters"])
            rows.append({k: float(v) for k, v in metrics.items()})
            local.append(float(carry.completed_count))
        replay = carry.replay
        results.append({
            "rows": rows, "local_episodes": local,
            "params": _flat(carry.learner.net),
            "target_params": _flat(carry.learner.target_net),
            "max_priority": float(getattr(replay, "max_priority",
                                          torch.tensor(float("nan")))),
            "steps": carry.learner.steps})
    return results


def mesh_carry(mesh, case):
    """The carry of a chunk case run on the mesh trainer."""
    cfg = tconfig.apply_overrides(tconfig.CONFIGS[case["preset"]],
                                  case["overrides"])
    env = make_env(cfg.env_name, device="cpu")
    net = build_network(cfg.network, env.num_actions, env.observation_shape,
                        device="cpu", seed=cfg.seed)
    init, run = plearner.make_mesh_fused_train(cfg, env, net, mesh)
    carry = init(cfg.seed)
    for _ in range(case["chunks"]):
        carry, _ = run(carry, case["iters"])
    return carry


def checkpoint_resume(mesh, case):
    """train() as a mesh rank with learner checkpoints, twice: to
    ``totals[0]`` frames, then resumed to ``totals[1]``. Returns the
    learner steps and flat params after each leg, the rows this rank
    logged and the directory's entries after each leg."""
    from dist_dqn_tpu_torch.train import train

    cfg = tconfig.apply_overrides(tconfig.CONFIGS[case["preset"]],
                                  case["overrides"])
    # Ranks other than 0 may see storage of their own.
    directory = case["directory"] if mesh.rank == 0 else case.get(
        "other_directory", case["directory"])
    out = {"legs": []}
    for total in case["totals"]:
        logged = []
        carry, history = train(cfg, total_env_steps=total,
                               chunk_iters=case["iters"], log_fn=logged.append,
                               mesh=mesh, checkpoint_dir=directory,
                               save_every_frames=case["save_every"])
        # A barrier: rank 0's final save lands before any rank lists the
        # directory or restores from it.
        mesh.psum([torch.zeros(1)])
        out["legs"].append({
            "steps": carry.learner.steps, "params": _flat(carry.learner.net),
            "logged": logged, "frames": [r["env_frames"] for r in history],
            "entries": sorted(os.listdir(case["directory"]))})
    return out


def failing(mesh, _):
    """Rank 1 raises; rank 0 waits in a collective it never completes."""
    if mesh.rank == 1:
        raise RuntimeError("rank 1 failed on purpose")
    mesh.psum([torch.zeros(1)])
    return None


# Seconds a lingering rank sleeps (far past the SPAWN_FINISH_S a test sets).
LINGER_S = 60.0


def linger(local_rank):
    """Rank 0 ends at once; rank 1 outlives it."""
    if local_rank == 1:
        time.sleep(LINGER_S)


BODIES = {"sharded_steps": sharded_steps, "chunks": chunks,
          "checkpoint_resume": checkpoint_resume, "failing": failing}
