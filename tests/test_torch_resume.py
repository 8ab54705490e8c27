"""Save and resume through the port's ``train()`` on the CPU.

A carry-kind (``checkpoint_replay``) run stopped after a chunk and resumed
is bit-equal to one that never stopped: learner, optimizer, ring,
priorities, env states, the actor carry and every generator, for the
feed-forward loop (uniform, PER through the sampler's routing, a
frame-dedup ring) and for R2D2. A learner-kind resume continues the frame
cursor and the grad steps; a finished run trains nothing more. For one
command sequence, the saved steps and the ``resumed_at_frames`` rows equal
the JAX package's."""
import dataclasses
import json

import pytest

from dist_dqn_tpu_torch import config as tconfig
from dist_dqn_tpu_torch.train import train
from dist_dqn_tpu_torch.utils.checkpoint import (list_checkpoint_steps,
                                                 state_tree)
from torch_parity import assert_trees_equal, cli_rows

QUIET = lambda line: None  # noqa: E731

R2D2_TINY = ["env_name=cartpole", "network.torso=mlp",
             "network.mlp_features=(16,)", "network.hidden=0",
             "network.lstm_size=8", "network.compute_dtype=float32",
             "network.lstm_dtype=float32", "replay.capacity=512",
             "replay.min_fill=64", "replay.burn_in=2", "replay.unroll_length=4",
             "replay.sequence_stride=2", "learner.n_step=2",
             "learner.batch_size=16", "actor.num_envs=4",
             "replay.pallas_sampler=true"]


def _cartpole(*overrides):
    return tconfig.apply_overrides(tconfig.CONFIGS["cartpole"], [
        "network.mlp_features=(16,)", "replay.capacity=512",
        "replay.min_fill=64", "learner.batch_size=16", "actor.num_envs=4",
        "eval_every_steps=0", *overrides])


def _config(mode):
    if mode == "vector":
        return _cartpole()
    if mode == "per_sampler":
        return _cartpole("replay.prioritized=true",
                         "replay.pallas_sampler=true")
    if mode == "pixel_dedup":
        return tconfig.apply_overrides(tconfig.CONFIGS["atari"], [
            "env_name=pixel_catch", "network.torso=small",
            "network.hidden=16", "network.compute_dtype=float32",
            "replay.capacity=512", "replay.min_fill=64",
            "replay.frame_dedup=true", "learner.batch_size=8",
            "actor.num_envs=4", "train_every=2", "eval_every_steps=0"])
    return tconfig.apply_overrides(tconfig.CONFIGS["r2d2"],
                                   R2D2_TINY + ["eval_every_steps=0"])


@pytest.mark.parametrize("mode", ["vector", "pixel_dedup", "per_sampler",
                                  "r2d2"])
def test_carry_resume_is_bit_equal(tmp_path, mode):
    cfg = _config(mode)
    ref, ref_hist = train(cfg, total_env_steps=600, chunk_iters=75,
                          log_fn=QUIET, device="cpu")
    d = str(tmp_path / "run")
    train(cfg, total_env_steps=300, chunk_iters=75, log_fn=QUIET,
          device="cpu", checkpoint_dir=d, checkpoint_replay=True)
    logs = []
    carry, hist = train(cfg, total_env_steps=600, chunk_iters=75,
                        log_fn=logs.append, device="cpu", checkpoint_dir=d,
                        checkpoint_replay=True)
    assert json.loads(logs[0]) == {"resumed_at_frames": 300,
                                   "with_replay": True}
    assert [r["env_frames"] for r in hist] == [600]
    assert hist[0]["grad_steps_in_chunk"] == ref_hist[-1][
        "grad_steps_in_chunk"] > 0
    assert hist[0]["loss"] == ref_hist[-1]["loss"]
    # Everything: both nets, Adam, steps, the ring with its cursors and
    # priorities, env states, obs, the actor carry, every generator.
    assert_trees_equal(state_tree(ref), state_tree(carry))
    assert carry.learner.steps == ref.learner.steps > 0


@pytest.mark.parametrize("replay", [False, True], ids=["learner", "carry"])
def test_completed_run_does_not_rerun(tmp_path, replay):
    d = str(tmp_path / "run")
    cfg = _cartpole()
    train(cfg, total_env_steps=300, chunk_iters=75, log_fn=QUIET,
          device="cpu", checkpoint_dir=d, checkpoint_replay=replay)
    logs = []
    _, hist = train(cfg, total_env_steps=300, chunk_iters=75,
                    log_fn=logs.append, device="cpu", checkpoint_dir=d,
                    checkpoint_replay=replay)
    assert hist == []
    assert json.loads(logs[0])["resumed_at_frames"] == 300
    assert list_checkpoint_steps(d) == (300,)


def test_learner_resume_continues_cursor_and_steps(tmp_path):
    """The JAX ``test_train_resumes_from_checkpoint`` at a small size: the
    relaunch continues toward the new total from the saved cursor, with a
    fresh ring, the restored learner's steps and a baseline eval on its
    first chunk; relaunched at its total, it trains nothing."""
    cfg = dataclasses.replace(_cartpole(), eval_every_steps=10**9,
                              eval_episodes=2)
    d = str(tmp_path / "run")
    carry1, _ = train(cfg, total_env_steps=600, chunk_iters=75,
                      log_fn=QUIET, device="cpu", checkpoint_dir=d)
    steps1 = carry1.learner.steps
    assert steps1 > 0
    logs = []
    carry2, hist2 = train(cfg, total_env_steps=900, chunk_iters=75,
                          log_fn=logs.append, device="cpu",
                          checkpoint_dir=d)
    resumed = [json.loads(s) for s in logs if "resumed_at_frames" in s]
    assert resumed == [{"resumed_at_frames": 600, "with_replay": False}]
    assert [r["env_frames"] for r in hist2] == [900]
    assert "eval_return" in hist2[0]
    # The fresh ring refills: the resumed chunk trains from min_fill on.
    assert 0 < hist2[0]["grad_steps_in_chunk"] < 75
    assert carry2.learner.steps == steps1 + hist2[0]["grad_steps_in_chunk"]
    assert carry2.iteration == 75          # a fresh carry's own cursor
    logs3 = []
    _, hist3 = train(cfg, total_env_steps=900, chunk_iters=75,
                     log_fn=logs3.append, device="cpu", checkpoint_dir=d)
    assert hist3 == []
    assert json.loads(logs3[0])["resumed_at_frames"] == 900


def test_steps_and_resume_rows_match_the_jax_package(tmp_path):
    """Train to 300 frames, resume to 600, a save every 150: both packages
    keep the same steps and log the same resume row."""
    from dist_dqn_tpu import config as jconfig
    from dist_dqn_tpu.train import train as jax_train
    from dist_dqn_tpu.utils.checkpoint import \
        list_checkpoint_steps as jax_steps

    cfg = _cartpole()
    jcfg = jconfig.apply_overrides(jconfig.CONFIGS["cartpole"], [
        "network.mlp_features=(16,)", "replay.capacity=512",
        "replay.min_fill=64", "learner.batch_size=16", "actor.num_envs=4",
        "eval_every_steps=0"])
    rows = {}
    for name, run, kwargs in (("port", train, {"device": "cpu"}),
                              ("jax", jax_train, {})):
        d = str(tmp_path / name)
        logs = []
        for total in (300, 600):
            run(jcfg if name == "jax" else cfg, total_env_steps=total,
                chunk_iters=75, log_fn=logs.append, checkpoint_dir=d,
                save_every_frames=150, **kwargs)
        rows[name] = ([json.loads(s) for s in logs
                       if "resumed_at_frames" in s],
                      tuple(jax_steps(d) if name == "jax"
                            else list_checkpoint_steps(d)))
    assert rows["port"] == rows["jax"]
    assert rows["port"] == ([{"resumed_at_frames": 300,
                              "with_replay": False}], (300, 600))


def test_cli_saves_resumes_and_stops_at_return(tmp_path, capsys):
    """The CLI's checkpoint flags reach train(): ``--stop-at-return``
    ends the run after the first chunk whose eval reaches it, the end save
    lands there, and a relaunch resumes from it."""
    from dist_dqn_tpu_torch.train import main

    d = str(tmp_path / "run")
    argv = ["--config", "cartpole", "--device", "cpu", "--total-env-steps",
            "900", "--chunk-iters", "75", "--eval-every-steps", "300",
            "--checkpoint-dir", d, "--save-every-frames", "600",
            "--stop-at-return", "0", "--set", "eval_episodes=2",
            "--set", "network.mlp_features=(16,)",
            "--set", "replay.min_fill=64", "--set", "learner.batch_size=16",
            "--set", "actor.num_envs=4"]
    main(argv)
    rows = cli_rows(capsys.readouterr().out)
    assert [r["env_frames"] for r in rows if "env_frames" in r] == [300]
    assert [r["checkpoint_save_at_frames"] for r in rows
            if "checkpoint_save_s" in r] == [300]
    assert list_checkpoint_steps(d) == (300,)
    main(argv)
    rows = cli_rows(capsys.readouterr().out)
    assert rows[0] == {"resumed_at_frames": 300, "with_replay": False}
    assert rows[1]["checkpoint_bytes"] > 0
    assert [r["env_frames"] for r in rows if "env_frames" in r] == [600]
