"""The port's process-group runtime and the mesh entry points
(dist_dqn_tpu_torch/parallel/distributed.py, train.py's ``--mesh-devices``
and ``--coordinator``) on CPU ``gloo`` ranks.

Two separately launched processes joined by ``--coordinator`` train as one
mesh, rows from process 0 only; a learner checkpoint written by rank 0
resumes on both ranks, whatever directory the others see; a failing rank
ends its peers and fails the run within the spawn's deadline, and a rank
that outlives its peers is ended; the refusals give the JAX CLI's texts (the
population x mesh parser error, too many cards) or name their ROADMAP.md
item; the "# ..." lines the CLI prints for ignored flags under a mesh
equal the JAX CLI's; ``--checkpoint-replay`` under a 2-rank mesh resumes
every rank's carry bit-equal, for PER CartPole and the tiny R2D2, and at
another width raises as JAX's restore does. Every spawned group and
subprocess has a deadline.
"""
import json
import os
import subprocess
import sys
import time
from collections import namedtuple
from unittest import mock

import jax
import numpy as np
import pytest
import torch
from torch.multiprocessing import ProcessRaisedException

from dist_dqn_tpu import train as jtr
from dist_dqn_tpu_torch import train as ttr
from dist_dqn_tpu_torch.parallel import distributed
import torch_mesh_workers as workers
from torch_mesh_workers import DEADLINE_S, run_ranks
from torch_parity import train_cli_in_fleet

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["--total-env-steps", "320", "--chunk-iters", "40",
        "--eval-every-steps", "0",
        "--set", "network.mlp_features=(16,)",
        "--set", "replay.min_fill=32", "--set", "learner.batch_size=16",
        "--set", "actor.num_envs=4"]
TINY_SETS = ["network.mlp_features=(16,)", "replay.min_fill=32",
             "learner.batch_size=16", "actor.num_envs=4",
             "eval_every_steps=0"]
SUBPROCESS_S = 180


def _rows(text):
    """The JSON rows of a CLI's output, less its run manifest line."""
    return [json.loads(line) for line in text.splitlines()
            if line.startswith("{") and not line.startswith('{"manifest"')]


def test_coordinator_processes_train_as_one_mesh():
    """``--coordinator 127.0.0.1:P --num-processes 2 --process-id i``,
    launched twice: one mesh of two CPU ranks (4 envs over both), rows
    from process 0 only."""
    address = f"127.0.0.1:{distributed.free_port()}"
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    procs = [subprocess.Popen(
        [sys.executable, "-m", "dist_dqn_tpu_torch.train", "--config",
         "cartpole", "--device", "cpu", *TINY, "--coordinator", address,
         "--num-processes", "2", "--process-id", str(i)],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for i in range(2)]
    try:
        outs = [p.communicate(timeout=SUBPROCESS_S) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, out + err
    rows = _rows(outs[0][0])
    assert [r["env_frames"] for r in rows] == [160, 320]
    assert rows[-1]["grad_steps_in_chunk"] == 40
    assert _rows(outs[1][0]) == []


def test_rank0_checkpoint_resumes_on_both_ranks(tmp_path):
    """Learner checkpoints under a mesh: rank 0 alone reads, writes and
    logs, and a relaunch restores the saved learner and frame cursor on
    both ranks though rank 1 sees another directory, which it never
    creates (their learners continue from the saved step count and stay
    bit-equal)."""
    directory = str(tmp_path / "ckpt")
    elsewhere = str(tmp_path / "rank1")
    case = dict(preset="cartpole", overrides=TINY_SETS, iters=40,
                totals=[320, 480], directory=directory, save_every=160,
                other_directory=elsewhere)
    ranks = run_ranks([("checkpoint_resume", case)])
    legs = [r[0]["legs"] for r in ranks]
    for i in range(2):
        assert legs[0][i]["steps"] == legs[1][i]["steps"]
        assert legs[0][i]["frames"] == legs[1][i]["frames"]
        np.testing.assert_array_equal(legs[0][i]["params"],
                                      legs[1][i]["params"])
    assert not os.path.exists(elsewhere)
    # Leg 1 trains 73 grad steps to 320 frames; leg 2 resumes there with a
    # fresh ring (8 iterations to refill), 33 more by 480.
    assert legs[0][0]["frames"] == [160, 320]
    assert legs[0][1]["frames"] == [480]
    assert legs[0][1]["steps"] == legs[0][0]["steps"] + 33
    resumed = [r for r in legs[0][1]["logged"] if "resumed_at_frames" in r]
    assert [json.loads(r) for r in resumed] == [
        {"resumed_at_frames": 320, "with_replay": False}]
    assert legs[1][0]["logged"] == legs[1][1]["logged"] == []
    assert legs[0][0]["entries"] == ["160", "320", "CHECKPOINT_KIND",
                                     "LATEST"]
    assert legs[0][1]["entries"] == ["160", "320", "480", "CHECKPOINT_KIND",
                                     "LATEST"]


def test_a_failing_rank_fails_the_run():
    """Rank 1 raises while rank 0 waits in an all-reduce: the spawn ends
    rank 0 and re-raises rank 1's error, within the deadline."""
    with pytest.raises(ProcessRaisedException, match="failed on purpose"):
        run_ranks([("failing", None)])


def test_a_rank_that_outlives_its_peers_is_ended(monkeypatch):
    """Once one rank of a spawn has ended cleanly, the others get
    SPAWN_FINISH_S seconds: a rank that lingers past them is terminated
    and the run raises."""
    monkeypatch.setattr(distributed, "SPAWN_FINISH_S", 2.0)
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="did not within 2"):
        distributed.spawn(workers.linger, (), 2, deadline_s=DEADLINE_S)
    assert time.monotonic() - t0 < workers.LINGER_S


def test_distributed_helpers():
    """Rank-0 gating without a group, the host copy of a tensor tree,
    backends by device and an idempotent shutdown."""
    assert distributed.is_main_process()
    calls = []
    distributed.main_process_log(calls.append)("row")
    assert calls == ["row"]
    Pair = namedtuple("Pair", "a b")
    tree = {"x": torch.arange(3),
            "p": Pair(torch.ones(2, dtype=torch.bfloat16), [torch.zeros(1)])}
    host = distributed.host_replica(tree)
    assert isinstance(host["p"], Pair) and host["p"].a.dtype == np.float32
    np.testing.assert_array_equal(host["x"], np.arange(3))
    assert isinstance(host["p"].b, list)
    assert distributed.backend_for("cpu") == "gloo"
    assert distributed.backend_for("cuda") == "nccl"
    distributed.shutdown()
    distributed.shutdown()


def _jax_pick(num, multiprocess, count):
    with mock.patch.object(jax, "devices",
                           lambda: [object()] * count):
        with pytest.raises(ValueError) as e:
            jtr._pick_mesh_devices(num, multiprocess)
    return str(e.value)


def test_too_many_cards_gives_jax_text(monkeypatch):
    """``--mesh-devices 2`` on a machine with one card (a mocked count),
    and a multi-process request that is not the global device list."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError) as e:
        ttr.main(["--config", "cartpole", "--mesh-devices", "2"])
    assert str(e.value) == _jax_pick(2, False, 1)
    with pytest.raises(ValueError) as e:
        ttr._pick_mesh_devices(3, True, "cuda", num_processes=2)
    assert str(e.value) == _jax_pick(3, True, 2)
    assert ttr._pick_mesh_devices(0, False, "cuda") == 1
    assert ttr._pick_mesh_devices(3, False, "cpu") == 3


def test_mesh_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ttr.main(["--config", "cartpole", "--mesh-devices", "0"])


def test_population_with_mesh_gives_jax_parser_error(capsys):
    argv = ["--config", "cartpole", "--population", "2", "--mesh-devices",
            "2"]
    with mock.patch.object(sys, "argv", ["train", *argv, "--platform",
                                         "cpu"]), \
            pytest.raises(SystemExit):
        jtr.main()
    want = capsys.readouterr().err.strip().splitlines()[-1]
    with pytest.raises(SystemExit):
        ttr.main([*argv, "--device", "cpu"])
    got = capsys.readouterr().err.strip().splitlines()[-1]
    # The same text after each parser's program name.
    assert "mutually exclusive" in want
    assert got.split(" error: ", 1)[1] == want.split(" error: ", 1)[1]
    cfg = ttr.apply_overrides(ttr.CONFIGS["cartpole"],
                              ["population.size=2"])
    with pytest.raises(ValueError, match="--population composes"):
        ttr.run_mesh(cfg, 2, device="cpu")


HOST_REPLAY_TINY = ["--set", "replay.capacity=4096",
                    "--set", "replay.min_fill=64", "--chunk-iters", "50"]


@pytest.mark.parametrize("argv, item", [
    (["--mesh-devices", "2", "--checkpoint-replay", *TINY], None),
    (["--runtime", "host-replay", "--mesh-devices", "2", "--total-env-steps",
      "800", "--set", "learner.batch_size=16", "--set", "actor.num_envs=8",
      *HOST_REPLAY_TINY], None),
    (["--runtime", "apex", "--coordinator", "127.0.0.1:1",
      "--fleet-dir", "f"], "A10c"),
], ids=["checkpoint_replay", "host_replay", "apex_coordinator"])
def test_unported_mesh_paths_name_their_item(argv, item, tmp_path, capsys):
    """The CLI's mesh paths: ``--checkpoint-replay`` under a mesh and
    ``--runtime host-replay --mesh-devices 2`` run (every rank writes its
    carry shard beside rank 0's steps; the host-replay summary prints
    once); ``--coordinator`` under the apex runtime runs since A6c
    (tests/test_torch_apex_distributed.py), and the fleet flag beside it
    since A10c: a one-process group's service (on a free rendezvous
    port) is a live learner-role member of the fleet while it runs, and
    its descriptor goes with it."""
    argv = ["--config", "cartpole", "--device", "cpu", *argv,
            "--checkpoint-dir", str(tmp_path / "ckpt")]
    if item is not None:
        argv = argv[:argv.index("--coordinator")] + [
            "--coordinator", f"127.0.0.1:{distributed.free_port()}",
            "--num-processes", "1", "--host-env", "CartPole-v1",
            "--num-actors", "1", "--envs-per-actor", "4",
            "--total-env-steps", "600", "--set",
            "network.mlp_features=(32,)", "--set", "replay.min_fill=128",
            "--set", "learner.batch_size=32"]
        rows, status, left = train_cli_in_fleet(argv,
                                                str(tmp_path / "fleet"))
        (name, member), = status["members"].items()
        assert name.startswith("learner-") and member["state"] == "live"
        assert member["labels"] == {"loop": "apex"}
        assert rows[-1]["env_steps"] >= 600 and left == []
        return
    ttr.main(argv)
    entries = sorted(os.listdir(tmp_path / "ckpt"))
    if "--checkpoint-replay" in argv:
        assert entries == ["160", "320", "CHECKPOINT_KIND", "LATEST",
                           "MESH_WIDTH", "rank1"]
        assert sorted(os.listdir(tmp_path / "ckpt" / "rank1")) == [
            "160.pt", "320.pt"]
    else:
        summary = _rows(capsys.readouterr().out)[-1]
        assert summary["dp_size"] == 2 and summary["env_steps"] == 800
        assert "host_loop_800.npz" in entries


# The carry-kind resume cases: JAX test_distributed.py's tiny CartPole with
# PER (16 envs over 2 ranks, 4 chunks of 640 frames, a save every chunk,
# killed after the 2nd) and its tiny R2D2.
CARRY_CASES = {
    "per_cartpole": dict(preset="cartpole", overrides=[
        "network.mlp_features=(32,)", "actor.num_envs=16",
        "replay.capacity=2048", "replay.min_fill=64",
        "learner.batch_size=32", "replay.prioritized=true",
        "eval_every_steps=0"]),
    "r2d2": dict(preset="r2d2", overrides=[
        "env_name=cartpole", "network.torso=mlp",
        "network.mlp_features=(16,)", "network.hidden=0",
        "network.lstm_size=8", "network.compute_dtype=float32",
        "network.lstm_dtype=float32", "replay.capacity=2048",
        "replay.min_fill=64", "replay.burn_in=2", "replay.unroll_length=4",
        "replay.sequence_stride=2", "learner.n_step=2",
        "learner.batch_size=32", "actor.num_envs=16",
        "eval_every_steps=0"]),
}


@pytest.fixture(scope="module")
def carry_resumes(tmp_path_factory):
    d = tmp_path_factory.mktemp("carry_resume")
    jobs = [("fused_carry_resume", dict(
        case, directory=str(d / name), total=2560, iters=40,
        save_every=640, kill_after=2))
        for name, case in CARRY_CASES.items()]
    ranks = run_ranks(jobs)
    return {"dir": d, "ranks": {name: [r[i] for r in ranks]
                                for i, name in enumerate(CARRY_CASES)}}


@pytest.mark.parametrize("name", list(CARRY_CASES))
def test_mesh_carry_checkpoint_resumes_bit_equal(carry_resumes, name):
    """``--checkpoint-replay`` under a 2-rank mesh: a run killed right
    after its save at 1,280 frames and relaunched ends with every rank's
    whole carry (ring, env states, generators, learner) bit-equal to the
    uninterrupted run's, and the replicas equal each other."""
    r0, r1 = carry_resumes["ranks"][name]
    for rank in (r0, r1):
        assert len(rank["ref"]) == len(rank["resumed"])
        for a, b in zip(rank["ref"], rank["resumed"]):
            np.testing.assert_array_equal(a, b)
    assert [json.loads(x) for x in r0["logged"]
            if "resumed_at_frames" in x] == [
        {"resumed_at_frames": 1280, "with_replay": True}]
    assert r1["logged"] == []
    assert r0["shards"] == ["1280", "1920", "2560", "CHECKPOINT_KIND",
                            "LATEST", "MESH_WIDTH", "rank1"]


def test_mesh_carry_checkpoint_at_another_width_raises_as_jax(
        carry_resumes):
    """JAX's checkpoint of a dp-2 fused carry does not restore into a dp-1
    run (its restore refuses the sharded shapes); the port's 2-rank carry
    checkpoint raises at one device too, naming both widths."""
    from dist_dqn_tpu.config import apply_overrides as japply
    from dist_dqn_tpu.config import CONFIGS as JCONFIGS
    from dist_dqn_tpu.envs import make_jax_env
    from dist_dqn_tpu.models import build_network as jbuild
    from dist_dqn_tpu.parallel import make_mesh as jmesh
    from dist_dqn_tpu.parallel import make_mesh_fused_train as jmesh_train
    from dist_dqn_tpu.train_loop import make_fused_train as jfused
    from dist_dqn_tpu.utils.checkpoint import TrainCheckpointer as JCkpt

    case = CARRY_CASES["per_cartpole"]
    jcfg = japply(JCONFIGS["cartpole"], case["overrides"])
    env = make_jax_env(jcfg.env_name)
    net = jbuild(jcfg.network, env.num_actions)
    init2, _ = jmesh_train(jcfg, env, net,
                           jmesh(devices=jax.devices()[:2]))
    jdir = str(carry_resumes["dir"] / "jax")
    ck = JCkpt(jdir, save_every_frames=1)
    ck.save(640, init2(jax.random.PRNGKey(0)))
    ck.wait()
    init1, _ = jfused(jcfg, env, net)
    with pytest.raises(ValueError):
        JCkpt(jdir, save_every_frames=1).restore_latest(
            jax.jit(init1)(jax.random.PRNGKey(0)))

    cfg = ttr.apply_overrides(ttr.CONFIGS["cartpole"], case["overrides"])
    with pytest.raises(ValueError, match=r"2-rank mesh, but this run has 1 "
                                         r"rank.*--mesh-devices 2"):
        ttr.train(cfg, total_env_steps=3200, chunk_iters=40, device="cpu",
                  checkpoint_dir=str(carry_resumes["dir"] / "per_cartpole"),
                  checkpoint_replay=True, log_fn=lambda s: None)


def _comment_lines(text):
    return [line for line in text.splitlines() if line.startswith("# ")]


@pytest.mark.parametrize("flags", [
    ["--config", "cartpole", "--no-pipeline", "--per"],
    ["--config", "cartpole", "--device-sampling", "--no-double-buffer"],
    ["--config", "r2d2", "--replay-ratio", "2", "--actor-dtype",
     "bfloat16", "--population", "2"],
], ids=["host_replay_flags", "device_sampling", "recurrent"])
def test_cli_lines_under_a_mesh_match_jax(flags, capsys, monkeypatch):
    """The "# ... ignored" lines of a ``--mesh-devices 2`` fused run."""
    argv = [*flags, "--mesh-devices", "2"]
    with mock.patch.object(sys, "argv", ["train", *argv, "--platform",
                                         "cpu"]), \
            mock.patch.object(jtr, "train", lambda *a, **k: None):
        jtr.main()
    want = _comment_lines(capsys.readouterr().out)
    launched = []
    monkeypatch.setattr(ttr, "run_mesh",
                        lambda *a, **k: launched.append(k))
    ttr.main([*argv, "--device", "cpu"])
    assert want and _comment_lines(capsys.readouterr().out) == want
    assert launched[0]["num_devices"] == 2
