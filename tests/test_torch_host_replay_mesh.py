"""The host-replay runtime at dp > 1 (dist_dqn_tpu_torch/host_replay_loop.py
with a mesh) on CPU ``gloo`` ranks, against its own dp-1 program and
against the JAX package's ``run_host_replay(mesh_devices=2)`` on 2 of the 8
virtual CPU devices.

One spawned group of 2 ranks (``torch_mesh_workers.host_replay``) runs
every rank case of the module, the twins of JAX's
``tests/test_sharded_collect.py``, ``test_sharded_checkpoint.py`` and
``test_device_sharded_sampling.py``:

* rank r's ring window equals a standalone ``make_collect_chunk(lanes=B/2,
  num_shards=2)`` over rank r's generators at the initial params;
* pipelined (and, uniform, prefetched) runs end with the params of the
  serial ``pipeline=False, prefetch=False`` run, and every shard's
  evacuated bytes equal the bytes its ring appended;
* a run killed right after its 4th save and relaunched equals the
  uninterrupted run bit for bit, for uniform, the PER sum-tree and the PER
  device plane; so does one killed inside its 5th save, between the
  ranks' part files and rank 0's compose, whose stray parts a later save
  removes;
* the sampler-kind refusal on resume;
* under an armed chaos plan, JAX's chaos cases of those files: a run killed
  by ``host_replay.chunk`` at hit 4 (uniform, and the PER device plane)
  resumes bit-identically with every trip closed, its newest sidecar
  holding every rank's collect carry; a ``host_replay.collect`` stall at
  hit 3 recovers, a crash at hit 5 ends the run on both ranks.

In this process: ``sharded_collect=True`` at dp 1 (a world-size-1 mesh)
is bit-equal to the plain program, the dp and collect-mode refusals, and
the JAX comparison (the same env and grad steps, chunk count, per-shard
bytes, row, summary and sidecar key sets, refusal texts).
"""
import dataclasses
import glob
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from dist_dqn_tpu_torch import chaos

from dist_dqn_tpu import host_replay_loop as jhrl
from dist_dqn_tpu.config import CONFIGS as JCONFIGS
from dist_dqn_tpu_torch import host_replay_loop as thrl
from dist_dqn_tpu_torch.config import CONFIGS, apply_overrides
from dist_dqn_tpu_torch.envs import make_env
from dist_dqn_tpu_torch.models import build_network
from torch_mesh_workers import run_ranks

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# JAX's tests/test_sharded_collect.py _cfg: 8 CartPole lanes, an MLP of 32,
# a 4,096-slot ring filled at 64, batches of 16.
TINY = ["actor.num_envs=8", "network.torso=mlp", "network.mlp_features=(32,)",
        "network.hidden=0", "network.compute_dtype=float32",
        "replay.capacity=4096", "replay.min_fill=64", "learner.batch_size=16"]
CHUNK = 50
SERIAL_PER = dict(prioritized=True, prefetch=False, prio_writeback_batch=4)
RESUME = dict(total_env_steps=2400, save_every_frames=400)


def _cfg(*extra):
    return apply_overrides(CONFIGS["cartpole"], [*TINY, *extra])


def _jcfg(prioritized=False, min_fill=64):
    cfg = JCONFIGS["cartpole"]
    return dataclasses.replace(
        cfg, actor=dataclasses.replace(cfg.actor, num_envs=8),
        network=dataclasses.replace(cfg.network, torso="mlp",
                                    mlp_features=(32,), hidden=0,
                                    compute_dtype="float32"),
        replay=dataclasses.replace(cfg.replay, capacity=4096,
                                   min_fill=min_fill,
                                   prioritized=prioritized),
        learner=dataclasses.replace(cfg.learner, batch_size=16))


def _crash_plan(seam: str, fault: str = "crash", hit: int = 4, **args):
    return chaos.FaultPlan(seed=9, events=(chaos.FaultEvent(
        seam, fault, at_hit=hit, args=args),)).to_json()


def _chaos_kill_resume(directory, **kw):
    """The killed (by the armed plan) and resumed runs of a chaos case."""
    return [dict(**RESUME, chunk_iters=CHUNK, checkpoint_dir=directory,
                 **kw),
            dict(**RESUME, chunk_iters=CHUNK, checkpoint_dir=directory,
                 **kw)]


def _kill_resume(directory, **kw):
    """The reference, killed and resumed runs of one resume case."""
    return [dict(**RESUME, chunk_iters=CHUNK, **kw),
            dict(**RESUME, chunk_iters=CHUNK, checkpoint_dir=directory,
                 kill_after_saves=4, **kw),
            dict(**RESUME, chunk_iters=CHUNK, checkpoint_dir=directory, **kw)]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every rank case, in one spawned group of 2 ranks: per rank, the
    list of each job's list of runs."""
    d = tmp_path_factory.mktemp("mesh_host_replay")
    common = dict(total_env_steps=1600, chunk_iters=CHUNK)
    jobs = [
        # 0: the lane-block window (never trains), with a final save.
        ("host_replay", dict(preset="cartpole", overrides=TINY + [
            "replay.min_fill=1000000000"], runs=[dict(
                **common, checkpoint_dir=str(d / "lanes"))])),
        # 1: uniform pipelined + prefetched vs serial; then kill/resume.
        ("host_replay", dict(preset="cartpole", overrides=TINY, runs=[
            dict(**common),
            dict(**common, pipeline=False, prefetch=False),
            *_kill_resume(str(d / "uniform"))])),
        # 2: PER sum-tree, pipelined vs serial; then kill/resume.
        ("host_replay", dict(preset="cartpole", overrides=TINY, runs=[
            dict(**common, **SERIAL_PER),
            dict(**common, **SERIAL_PER, pipeline=False),
            *_kill_resume(str(d / "tree"), **SERIAL_PER)])),
        # 3: PER device plane kill/resume, then a resume that swaps the
        # sampler kind.
        ("host_replay", dict(preset="cartpole", overrides=TINY, runs=[
            *_kill_resume(str(d / "plane"), device_sampling=True,
                          **SERIAL_PER),
            dict(**RESUME, chunk_iters=CHUNK, checkpoint_dir=str(
                d / "plane"), catch=True, **SERIAL_PER)])),
        # 4: the JAX comparison's run: PER device plane, serial, a save
        # every chunk.
        ("host_replay", dict(preset="cartpole", overrides=TINY, runs=[
            dict(**common, **SERIAL_PER, device_sampling=True,
                 pipeline=False, checkpoint_dir=str(d / "keys"),
                 save_every_frames=400)])),
        # 5: uniform, killed inside the save at 2,000 frames (parts written,
        # no sidecar, no step), then resumed with saves every 800 frames.
        ("host_replay", dict(preset="cartpole", overrides=TINY, runs=[
            dict(**RESUME, chunk_iters=CHUNK, checkpoint_dir=str(d / "torn"),
                 kill_in_save=4),
            dict(**{**RESUME, "save_every_frames": 800}, chunk_iters=CHUNK,
                 checkpoint_dir=str(d / "torn"))])),
        # 6: uniform, killed by the armed host_replay.chunk crash at hit 4
        # (right after the save at 1,600 frames), then resumed.
        ("host_replay", dict(
            preset="cartpole", overrides=TINY,
            chaos_plan=_crash_plan("host_replay.chunk"),
            runs=_chaos_kill_resume(str(d / "chaos_uniform")))),
        # 7: the PER device plane, serial, the same crash and resume.
        ("host_replay", dict(
            preset="cartpole", overrides=TINY,
            chaos_plan=_crash_plan("host_replay.chunk"),
            runs=_chaos_kill_resume(str(d / "chaos_plane"),
                                    device_sampling=True, **SERIAL_PER))),
        # 8, 9: a host_replay.collect stall at hit 3, a crash at hit 5.
        ("host_replay", dict(
            preset="cartpole", overrides=TINY,
            chaos_plan=_crash_plan("host_replay.collect", "stall", hit=3,
                                   delay_s=0.05),
            runs=[dict(**common)])),
        ("host_replay", dict(
            preset="cartpole", overrides=TINY,
            chaos_plan=_crash_plan("host_replay.collect", hit=5),
            runs=[dict(**common)])),
    ]
    return {"dir": d, "ranks": run_ranks(jobs)}


def _job(ranks, i):
    """Job i's runs on rank 0 and rank 1."""
    return ranks["ranks"][0][i], ranks["ranks"][1][i]


def _equal_runs(a, b):
    assert a["grad_steps"] == b["grad_steps"] > 0
    assert a["param_checksum"] == b["param_checksum"]
    np.testing.assert_array_equal(a["params"], b["params"])


def test_ranks_end_with_equal_learners_and_rank0_logs(ranks):
    """Every run's replicas end bit-equal; rank 0 alone logs rows."""
    for i in range(len(ranks["ranks"][0])):
        for r0, r1 in zip(*_job(ranks, i)):
            if "params" in r0:
                np.testing.assert_array_equal(r0["params"], r1["params"])
                assert r1["logged"] == [] and r0["logged"]
    r0 = _job(ranks, 1)[0][0]
    rows = [json.loads(x) for x in r0["logged"] if x.startswith("{")]
    assert [r["env_frames"] for r in rows] == [400, 800, 1200, 1600]
    assert r0["logged"][0] == "# host-replay sampler: uniform x 2 shards"


def test_rank_ring_window_equals_the_standalone_lane_block_collect(ranks):
    """Twin of test_sharded_collect.py:86: rank r's ring holds exactly
    what ``make_collect_chunk(lanes=4, num_shards=2)`` collects over rank
    r's generators at the initial params (training never starts)."""
    out = _job(ranks, 0)[0][0]
    assert out["grad_steps"] == 0 and out["sharded_collect"]
    path = sorted(glob.glob(str(ranks["dir"] / "lanes" / "host_loop_*.npz")))
    with np.load(path[-1]) as f:
        side = {k: f[k] for k in f.files}
    cfg = _cfg("replay.min_fill=1000000000")
    env = make_env(cfg.env_name, device="cpu")
    net = build_network(cfg.network, env.num_actions,
                        env.observation_shape, device="cpu", seed=cfg.seed)
    init, collect = thrl.make_collect_chunk(cfg, env, 0, lanes=4,
                                            num_shards=2)
    T = 4 * CHUNK
    for r in range(2):
        gen_env, gen_act, _ = thrl.host_replay_generators(cfg.seed, "cpu",
                                                          r)
        carry = init(gen_env, gen_act)
        parts = {k: [] for k in ("obs", "action", "reward")}
        for _ in range(4):
            carry, rec, _ = collect(carry, net, CHUNK)
            for k in parts:
                parts[k].append(rec[k].numpy())
        for k in parts:
            np.testing.assert_array_equal(
                np.concatenate(parts[k])[:T], side[f"ring_shard{r}_{k}"][:T],
                err_msg=f"rank {r} {k}")


def test_pipelined_runs_match_serial_and_bytes_are_conserved(ranks):
    """Uniform pipelined + prefetched and PER pipelined end with the
    serial run's params; every shard evacuated the bytes its ring
    appended, both shards alike (twin of test_sharded_collect.py:147)."""
    for job in (1, 2):
        runs = _job(ranks, job)[0]
        piped, serial = runs[0], runs[1]
        _equal_runs(piped, serial)
        for out in (piped, serial):
            by_shard = out["d2h_bytes_by_shard"]
            assert len(by_shard) == 2 and len(set(by_shard)) == 1
            assert sum(by_shard) == out["d2h_bytes_total"]
            assert by_shard == out["ring_bytes_by_shard"]
            assert out["collect_lane_block"] == 4 and out["dp_size"] == 2


@pytest.mark.parametrize("job", [1, 2, 3],
                         ids=["uniform", "per_sum_tree", "per_device_plane"])
def test_kill_and_resume_is_bit_identical(ranks, job):
    """Twins of test_sharded_checkpoint.py:82,101 and
    test_device_sharded_sampling.py:296: killed right after the save at
    1,600 frames, the relaunch resumes there and ends bit-equal to the
    uninterrupted run on both ranks."""
    for runs in _job(ranks, job):
        ref, killed, resumed = runs[-4:-1] if job == 3 else runs[-3:]
        assert killed["killed"]
        _equal_runs(resumed, ref)
        assert resumed["prio_writeback_rows"] == ref["prio_writeback_rows"]
    logged = _job(ranks, job)[0][-2 if job == 3 else -1]["logged"]
    rows = [json.loads(x) for x in logged if x.startswith("{")]
    assert rows[0] == {"resumed_at_frames": 1600, "resumed_at_chunk": 4,
                       "resumed_dp": 2, "resumed_per": job != 1}
    losses = [r["loss"] for r in rows if "loss" in r]
    ref_rows = [json.loads(x) for x in _job(ranks, job)[0][-4 if job == 3
                                                            else -3]["logged"]
                if x.startswith("{")]
    ref_losses = [r["loss"] for r in ref_rows if "loss" in r]
    assert losses == ref_losses[len(ref_losses) - len(losses):]


def test_kill_between_part_writes_and_compose(ranks):
    """A run killed after every rank wrote its part file of the save at
    2,000 frames and before rank 0 composed it resumes at 1,600, ends
    bit-equal to the uninterrupted run, and its first save past 2,000
    (at 2,400: it never saves 2,000 again) removes the stray parts."""
    killed, resumed = _job(ranks, 5)[0]
    assert killed["killed"]
    assert {"host_loop_2000.part0.npz", "host_loop_2000.part1.npz"} <= \
        set(killed["files"])
    assert "host_loop_2000.npz" not in killed["files"]
    ref = _job(ranks, 1)[0][2]
    _equal_runs(resumed, ref)
    rows = [json.loads(x) for x in resumed["logged"] if x.startswith("{")]
    assert rows[0]["resumed_at_frames"] == 1600
    assert "host_loop_2400.npz" in resumed["files"]
    assert not [f for f in resumed["files"] if ".part" in f]


def test_prune_sidecars_keeps_retained_and_later_steps(tmp_path):
    """``prune_sidecars`` removes the sidecars and part files of steps up
    to the current one that are not retained, and nothing else."""
    names = ["host_loop_400.npz", "host_loop_800.npz",
             "host_loop_800.part1.npz", "host_loop_1200.part0.npz",
             "host_loop_1600.npz", "host_loop_2000.part0.npz",
             "host_loop_1600.npz.tmp", "other.npz"]
    for n in names:
        (tmp_path / n).write_bytes(b"")
    thrl.prune_sidecars(str(tmp_path), {800, 1600}, 1600)
    assert sorted(os.listdir(tmp_path)) == sorted(
        ["host_loop_800.npz", "host_loop_800.part1.npz",
         "host_loop_1600.npz", "host_loop_2000.part0.npz",
         "host_loop_1600.npz.tmp", "other.npz"])


def test_sampler_kind_mismatch_resume_refused(ranks):
    """Twin of test_device_sharded_sampling.py:335: a device-plane
    checkpoint refuses a sum-tree resume on rank 0, and rank 1 raises with
    it instead of waiting."""
    r0, r1 = (runs[-1] for runs in _job(ranks, 3))
    assert "device-sampling" in r0["error"] and "ValueError" in r0["error"]
    assert "rank 0 refused" in r1["error"]


def test_dp1_sharded_collect_is_the_plain_program():
    """Twin of test_sharded_collect.py:67: ``sharded_collect=True`` at one
    device (a world-size-1 mesh built in this process) reproduces the
    plain dp-1 program bit for bit; one shard owns every byte."""
    kw = dict(total_env_steps=2000, chunk_iters=CHUNK, device="cpu",
              log_fn=lambda s: None)
    ref = thrl.run_host_replay(_cfg(), **kw)
    out = thrl.run_host_replay(_cfg(), **kw, sharded_collect=True)
    assert not ref["sharded_collect"] and out["sharded_collect"]
    assert out["param_checksum"] == ref["param_checksum"]
    assert out["grad_steps"] == ref["grad_steps"] > 0
    assert [r.get("loss") for r in out["history"]] == \
        [r.get("loss") for r in ref["history"]]
    for a, b in zip(ref["learner"].net.parameters(),
                    out["learner"].net.parameters()):
        assert torch.equal(a, b)
    assert out["d2h_bytes_by_shard"] == [out["d2h_bytes_total"]]
    assert out["ring_bytes_by_shard"] == [out["d2h_bytes_total"]]


def test_resume_refuses_another_width_or_collect_mode(ranks, tmp_path):
    """Twins of test_sharded_checkpoint.py:119 and
    test_sharded_collect.py:283: the dp-2 checkpoint refuses a dp-1
    resume naming the width; a sharded-collect checkpoint refuses a plain
    resume naming the mode."""
    kw = dict(total_env_steps=2400, chunk_iters=CHUNK, device="cpu",
              log_fn=lambda s: None, save_every_frames=400)
    with pytest.raises(ValueError, match="--mesh-devices 2, this run uses 1"):
        thrl.run_host_replay(_cfg(), **kw,
                             checkpoint_dir=str(ranks["dir"] / "uniform"))
    d = str(tmp_path / "mode")
    thrl.run_host_replay(_cfg(), **{**kw, "total_env_steps": 800},
                         checkpoint_dir=d, sharded_collect=True)
    with pytest.raises(ValueError, match="sharded_collect"):
        thrl.run_host_replay(_cfg(), **kw, checkpoint_dir=d)


# --------------------------------------------------------------------------
# Against the JAX package's dp-2 runtime.
# --------------------------------------------------------------------------

def _jax_error(cfg, **kw):
    with pytest.raises(ValueError) as e:
        jhrl.run_host_replay(cfg, total_env_steps=400, chunk_iters=CHUNK,
                             log_fn=lambda s: None, **kw)
    return str(e.value)


def _port_error(cfg, **kw):
    with pytest.raises(ValueError) as e:
        thrl.run_host_replay(cfg, total_env_steps=400, chunk_iters=CHUNK,
                             device="cpu", log_fn=lambda s: None, **kw)
    return str(e.value)


def test_refusals_match_jax(monkeypatch):
    """B % dp, train_batch % dp, sharded_collect=False at dp 2 and more
    cards than the machine has, in JAX's words (the third without JAX's
    parenthesis on its own history)."""
    jax_b = dataclasses.replace(
        _jcfg(), actor=dataclasses.replace(_jcfg().actor, num_envs=6))
    assert _port_error(_cfg("actor.num_envs=6"), mesh_devices=4) == \
        _jax_error(jax_b, mesh_devices=4)
    jax_tb = dataclasses.replace(
        _jcfg(), learner=dataclasses.replace(_jcfg().learner,
                                             batch_size=18))
    assert _port_error(_cfg("learner.batch_size=18"), mesh_devices=4) == \
        _jax_error(jax_tb, mesh_devices=4)
    # JAX's text less its parenthesis on the package's history.
    assert _port_error(_cfg(), mesh_devices=2, sharded_collect=False) == \
        re.sub(r" \([^)]*\);", ";", _jax_error(
            _jcfg(), mesh_devices=2, sharded_collect=False))
    want = _jax_error(_jcfg(), mesh_devices=9)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    with pytest.raises(ValueError) as e:
        thrl.run_host_replay(_cfg(), total_env_steps=400, chunk_iters=CHUNK,
                             log_fn=lambda s: None, mesh_devices=9)
    assert str(e.value) == want


_CARRY_LEAF = re.compile(r"^carry\d+_leaf\d+$")


def test_against_jax_dp2(ranks, tmp_path):
    """The same PER device-plane serial run at dp 2 in both packages: equal
    env and grad steps, chunk count and per-shard bytes; the same row and
    summary keys (less the port's learner) and program names; the
    same sidecar keys apart from the number of carry leaves."""
    d = str(tmp_path / "jax")
    rows = []
    want = jhrl.run_host_replay(
        _jcfg(prioritized=True), total_env_steps=1600, chunk_iters=CHUNK,
        mesh_devices=2, prefetch=False, pipeline=False,
        device_sampling=True, prio_writeback_batch=4, checkpoint_dir=d,
        save_every_frames=400, log_fn=rows.append)
    got = _job(ranks, 4)[0][0]
    for k in ("env_steps", "grad_steps", "d2h_bytes_by_shard",
              "ring_bytes_by_shard", "d2h_bytes_total", "dp_size",
              "collect_lane_block", "sharded_collect", "sampler",
              "train_batch"):
        assert got[k] == want[k], k
    assert len(got["history"]) == len(want["history"]) == 4
    assert set(got["history"][-1]) == set(want["history"][-1])
    assert set(got) - {"params", "logged", "files"} == \
        set(want) | {"history"}
    assert set(got["programs"]) == set(want["programs"])
    port_rows = [json.loads(x) for x in got["logged"] if x.startswith("{")
                 and "env_frames" in x]
    assert [set(r) for r in port_rows] == [set(r) for r in want["history"]]

    def keys(directory, step):
        with np.load(os.path.join(directory, f"host_loop_{step}.npz")) as f:
            return set(f.files)
    theirs = keys(d, 1200)
    ours = keys(str(ranks["dir"] / "keys"), 1200)
    assert {k for k in theirs if not _CARRY_LEAF.match(k)} == \
        {k for k in ours if not _CARRY_LEAF.match(k)}
    for s in (0, 1):
        assert f"carry{s}_leaf0" in ours and f"carry{s}_leaf0" in theirs
    assert any(k.startswith("pending1_") for k in ours)


def test_cli_mesh_host_replay_runs_on_cpu_ranks(tmp_path):
    """``--runtime host-replay --mesh-devices 2 --device cpu --per
    --device-sampling``: two gloo ranks, rank 0 alone prints the rows
    (JAX's keys), then the summary; relaunched on its checkpoint
    directory toward a larger total it resumes at the saved step."""
    base = [sys.executable, "-m", "dist_dqn_tpu_torch.train", "--config",
            "cartpole", "--runtime", "host-replay", "--mesh-devices", "2",
            "--device", "cpu", "--per", "--device-sampling",
            "--chunk-iters", str(CHUNK), "--checkpoint-dir",
            str(tmp_path / "ckpt"), "--save-every-frames", "400"]
    for o in TINY:
        base += ["--set", o]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    outs = []
    for total in (800, 1200):
        proc = subprocess.run([*base, "--total-env-steps", str(total)],
                              cwd=REPO, env=env, capture_output=True,
                              text=True, timeout=180)
        assert proc.returncode == 0, proc.stdout + proc.stderr
        outs.append([json.loads(x) for x in proc.stdout.splitlines()
                     if x.startswith("{")])
    first, second = outs
    assert [r["env_frames"] for r in first if "env_frames" in r] == \
        [400, 800]
    assert first[-1]["dp_size"] == 2 and first[-1]["sampler"] == "device"
    assert {"resumed_at_frames": 800, "resumed_at_chunk": 2,
            "resumed_dp": 2, "resumed_per": True} in second
    assert second[-1]["env_steps"] == 1200


def test_cli_coordinator_with_host_replay_is_refused():
    """JAX's CLI would join the processes and then place every shard's
    carry from each process (host_replay_loop.py:540), which fails on the
    other processes' devices; the port refuses the pair up front."""
    from dist_dqn_tpu_torch import train as ttr
    with pytest.raises(SystemExit, match="local ranks of one process"):
        ttr.main(["--config", "cartpole", "--runtime", "host-replay",
                  "--device", "cpu", "--coordinator", "127.0.0.1:1",
                  "--num-processes", "2", "--process-id", "0"])
    with pytest.raises(ValueError, match="local ranks of one process"):
        ttr.run_mesh(_cfg(), 2, device="cpu", coordinator="127.0.0.1:1",
                     num_processes=2, runtime="host-replay")


@pytest.mark.chaos
@pytest.mark.parametrize("job,ref_job,ref_run", [(6, 1, 2), (7, 3, 0)],
                         ids=["uniform", "per_device_plane"])
def test_chaos_killed_resume_bit_identical(ranks, job, ref_job, ref_run):
    """Twins of tests/test_sharded_checkpoint.py:58,
    tests/test_sharded_collect.py:256 and
    tests/test_device_sharded_sampling.py:315: a dp=2 run killed at chunk 4
    by an injected crash raises ``ChaosInjectedError`` on both ranks (each
    rank arms the plan and counts its own hits, as a JAX process counts
    its own); the newest sidecar carries both ranks' collect carries
    under the schema; the resumed run closes every trip and ends
    bit-identical to the uninterrupted, never-checkpointed reference."""
    from dist_dqn_tpu_torch.utils import ckpt_schema

    for r, (runs, refs) in enumerate(zip(_job(ranks, job),
                                         _job(ranks, ref_job))):
        killed, resumed = runs
        assert "host_replay.chunk" in killed["chaos_killed"]
        assert [e["hit"] for e in killed["chaos_injected"]] == [4]
        assert resumed["chaos_open_trips"] == [], (r, resumed)
        _equal_runs(resumed, refs[ref_run])
        assert resumed["prio_writeback_rows"] == \
            refs[ref_run]["prio_writeback_rows"]
    keys = _job(ranks, job)[0][0]["sidecar_keys"]
    for s in (0, 1):
        assert f"carry{s}_leaf0" in keys, keys
    ckpt_schema.validate_sidecar(keys)
    rows = [json.loads(x) for x in _job(ranks, job)[0][1]["logged"]
            if x.startswith("{")]
    assert rows[0]["resumed_at_frames"] == 1600
    assert rows[0]["resumed_dp"] == 2
    ref_rows = [json.loads(x) for x in _job(ranks, ref_job)[0][ref_run][
        "logged"] if x.startswith("{")]
    la = [r["loss"] for r in ref_rows if "loss" in r]
    lb = [r["loss"] for r in rows if "loss" in r]
    assert lb == la[len(la) - len(lb):]


@pytest.mark.chaos
def test_chaos_collect_crash_and_stall(ranks):
    """Twin of tests/test_sharded_collect.py:299: the
    ``host_replay.collect`` seam counts every shard's dispatch on every
    rank (hit 3 is chunk 2's shard 0), so a stall delays one shard's
    dispatch and the completed pass marks the recovery; a crash at hit 5
    ends the dispatch pass loudly, on both ranks."""
    for r in range(2):
        stalled = _job(ranks, 8)[r][0]
        assert [e["fault"] for e in stalled["chaos_injected"]] == ["stall"]
        assert stalled["chaos_injected"][0]["hit"] == 3
        assert stalled["chaos_open_trips"] == []
        assert stalled["grad_steps"] > 0
        crashed = _job(ranks, 9)[r][0]
        assert "host_replay.collect" in crashed["chaos_killed"]
        assert [e["fault"] for e in crashed["chaos_injected"]] == ["crash"]
    np.testing.assert_array_equal(_job(ranks, 8)[0][0]["params"],
                                  _job(ranks, 8)[1][0]["params"])
