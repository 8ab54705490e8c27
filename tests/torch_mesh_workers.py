"""Rank bodies of the port's mesh tests (tests/test_torch_mesh.py,
tests/test_torch_distributed.py, tests/test_torch_host_replay_mesh.py).

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


class Killed(Exception):
    """The stand-in for a process killed right after a checkpoint save."""


class KillAfterSaves:
    """A mesh whose ranks all die together right after the ``saves``-th
    checkpoint save: every save of the port's mesh loops ends in one
    ``barrier``, and after the last one every rank raises :class:`Killed`
    at its next collective, before entering it, so no rank waits on a dead
    peer and rank 0 has committed the step."""

    def __init__(self, mesh, saves: int):
        self._mesh = mesh
        self._left = saves

    def __getattr__(self, name):
        return getattr(self._mesh, name)

    def _check(self):
        if self._left <= 0:
            raise Killed

    def barrier(self):
        self._check()
        self._mesh.barrier()
        self._left -= 1

    def psum(self, tensors):
        self._check()
        return self._mesh.psum(tensors)

    def pmean(self, tensors):
        self._check()
        return self._mesh.pmean(tensors)

    def gather(self, values):
        self._check()
        return self._mesh.gather(values)

    def broadcast_(self, tensors, src: int = 0):
        self._check()
        return self._mesh.broadcast_(tensors, src)


class KillInSave(KillAfterSaves):
    """A mesh whose ranks all die together inside the ``saves + 1``-th
    checkpoint save, at its barrier: every rank has written its part file
    and rank 0 has not yet composed the sidecar or committed the step.
    The ranks pass that barrier before they die, so no rank lists the
    directory before every part is there."""

    def _check(self):
        pass

    def barrier(self):
        self._mesh.barrier()
        if self._left <= 0:
            raise Killed
        self._left -= 1


def quiet(*_args, **_kwargs):
    """A log function that drops its rows (picklable, for spawned ranks)."""


def _cfg_of(case):
    return tconfig.apply_overrides(tconfig.CONFIGS[case["preset"]],
                                   case["overrides"])


def host_replay(mesh, case):
    """``run_host_replay`` as a mesh rank, once per entry of
    ``case["runs"]`` (keywords; ``kill_after_saves`` kills the run after
    that many saves, ``kill_in_save`` inside the save after that many,
    ``catch`` records the error the run raises). Per run: the summary
    without ``learner``, the flat final params, the rows this rank logged
    and the checkpoint directory's files, or ``{"killed": True, ...}``, or
    ``{"error": text}``. With ``case["chaos_plan"]`` (a plan's JSON) every
    run of the case runs under one injector this rank arms, as a JAX test
    holds one ``chaos.installed`` across its runs: a run the plan kills
    records ``{"chaos_killed": text, ...}`` with the newest sidecar's keys,
    and every run its injector's evidence so far (``chaos_injected``,
    ``chaos_open_trips``)."""
    from dist_dqn_tpu_torch import chaos

    plan = case.get("chaos_plan")
    if plan is None:
        return _host_replay_runs(mesh, case)
    with chaos.installed(chaos.FaultPlan.from_json(plan)) as inj:
        return _host_replay_runs(mesh, case, inj)


def _newest_sidecar_keys(directory: str) -> list:
    """The member names of the newest composed sidecar in ``directory``."""
    import re

    steps = [int(m.group(1)) for m in (
        re.match(r"^host_loop_(\d+)\.npz$", n) for n in os.listdir(directory))
        if m is not None]
    path = os.path.join(directory, f"host_loop_{max(steps)}.npz")
    with np.load(path) as f:
        return sorted(f.files)


def _host_replay_runs(mesh, case, inj=None):
    from dist_dqn_tpu_torch import chaos
    from dist_dqn_tpu_torch.host_replay_loop import run_host_replay

    cfg = _cfg_of(case)
    out = []
    for kw in case["runs"]:
        kw = dict(kw)
        run_mesh = mesh
        if "kill_after_saves" in kw:
            run_mesh = KillAfterSaves(mesh, kw.pop("kill_after_saves"))
        elif "kill_in_save" in kw:
            run_mesh = KillInSave(mesh, kw.pop("kill_in_save"))
        catch = kw.pop("catch", False)
        directory = kw.get("checkpoint_dir")
        logged = []
        try:
            summary = run_host_replay(
                cfg, mesh=run_mesh, mesh_devices=mesh.size,
                log_fn=logged.append, **kw)
        except Killed:
            out.append({"killed": True, "logged": logged,
                        "files": sorted(os.listdir(directory))})
            continue
        except chaos.ChaosInjectedError as e:
            out.append({"chaos_killed": str(e), "logged": logged,
                        "chaos_injected": list(inj.injected),
                        "chaos_open_trips": inj.open_trips(),
                        "sidecar_keys": (_newest_sidecar_keys(directory)
                                         if directory else [])})
            continue
        except Exception as e:  # noqa: BLE001 — the case asked for it
            if not catch:
                raise
            out.append({"error": f"{type(e).__name__}: {e}"})
            continue
        learner = summary.pop("learner")
        summary["params"] = _flat(learner.net)
        summary["logged"] = logged
        if directory:
            summary["files"] = sorted(os.listdir(directory))
        if inj is not None:
            summary["chaos_injected"] = list(inj.injected)
            summary["chaos_open_trips"] = inj.open_trips()
        out.append(summary)
    return out


def _carry_arrays(carry) -> list:
    """Every tensor of a fused carry (ring, env states, generators,
    learner) as host arrays, in walk order."""
    from dist_dqn_tpu_torch.utils.checkpoint import state_tree, tree_leaves

    return [_np(t.float() if t.dtype == torch.bfloat16 else t)
            if isinstance(t, torch.Tensor) else np.asarray(t)
            for t in tree_leaves(state_tree(carry))]


def fused_carry_resume(mesh, case):
    """``train(checkpoint_replay=True)`` as a mesh rank: the uninterrupted
    run to ``total``; a run killed right after its ``kill_after``-th save;
    the relaunch that resumes it to ``total``. Returns each rank's final
    carry arrays of the reference and the resumed run, and rank 0's
    resume row."""
    from dist_dqn_tpu_torch.train import train

    cfg = _cfg_of(case)
    kw = dict(total_env_steps=case["total"], chunk_iters=case["iters"],
              checkpoint_replay=True, save_every_frames=case["save_every"])
    ref, _ = train(cfg, mesh=mesh, log_fn=quiet,
                   **{k: v for k, v in kw.items() if k != "checkpoint_replay"})
    try:
        train(cfg, mesh=KillAfterSaves(mesh, case["kill_after"]),
              log_fn=quiet, checkpoint_dir=case["directory"], **kw)
        raise AssertionError("the run was not killed")
    except Killed:
        pass
    logged = []
    resumed, _ = train(cfg, mesh=mesh, log_fn=logged.append,
                       checkpoint_dir=case["directory"], **kw)
    return {"ref": _carry_arrays(ref), "resumed": _carry_arrays(resumed),
            "logged": logged,
            "shards": sorted(os.listdir(case["directory"]))}


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
          "checkpoint_resume": checkpoint_resume, "failing": failing,
          "host_replay": host_replay,
          "fused_carry_resume": fused_carry_resume}
