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
equal the JAX CLI's. Every spawned group and subprocess has a deadline.
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
    return [json.loads(line) for line in text.splitlines()
            if line.startswith("{")]


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


@pytest.mark.parametrize("argv, item", [
    (["--mesh-devices", "2", "--checkpoint-replay",
      "--checkpoint-dir", "unused"], "A6b"),
    (["--runtime", "host-replay", "--mesh-devices", "2"], "A6b"),
    (["--runtime", "apex", "--coordinator", "127.0.0.1:1"], "A6c"),
], ids=["checkpoint_replay", "host_replay", "apex_coordinator"])
def test_unported_mesh_paths_name_their_item(argv, item):
    with pytest.raises(SystemExit, match=rf"not ported yet.*{item}"):
        ttr.main(["--config", "cartpole", "--device", "cpu", *argv])


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
