"""The port's R2D2 fused loop (r2d2_loop.py) and its CLI branch on the CPU,
at tiny widths: grad steps through both draw routes, the host-int
``can_train`` against the priority plane, the JAX CLI's row keys, the
options the port refuses for recurrent configs, and the two it warns about
and ignores, as the JAX CLI does."""
import dataclasses
import json

import numpy as np
import pytest
import torch

from dist_dqn_tpu_torch import config as tconfig
from dist_dqn_tpu_torch.envs import make_env
from dist_dqn_tpu_torch.models import build_network
from dist_dqn_tpu_torch.ops import sampler as tps
from dist_dqn_tpu_torch.r2d2_loop import make_r2d2_train
from dist_dqn_tpu_torch.replay import sequence_device as tsring

TINY = ["env_name=cartpole", "network.torso=mlp",
        "network.mlp_features=(16,)", "network.hidden=0",
        "network.lstm_size=8", "network.compute_dtype=float32",
        "network.lstm_dtype=float32", "replay.capacity=512",
        "replay.min_fill=64", "replay.burn_in=2", "replay.unroll_length=4",
        "replay.sequence_stride=2", "learner.n_step=2",
        "learner.batch_size=16", "actor.num_envs=4", "eval_episodes=2"]


def _tiny(*extra):
    return tconfig.apply_overrides(tconfig.CONFIGS["r2d2"],
                                   TINY + list(extra))


@pytest.mark.parametrize("overrides", [
    ["replay.pallas_sampler=true"],                 # through the wrapper
    ["replay.pallas_sampler=false"],                # the cumsum twin
    ["env_name=pixel_pong", "network.torso=small",  # merged pixel rows
     "network.compute_dtype=bfloat16", "network.lstm_dtype=bfloat16",
     "replay.flat_storage=true", "replay.pallas_sampler=true",
     "learner.batch_size=4"],
])
def test_r2d2_loop_takes_grad_steps_on_cpu(monkeypatch, overrides):
    calls = []
    plain = tps.plain_stratified_sample

    def spy(w, u):
        calls.append(tuple(w.shape))
        return plain(w, u)

    monkeypatch.setattr(tps, "plain_stratified_sample", spy)
    cfg = _tiny(*overrides)
    env = make_env(cfg.env_name, device="cpu")
    net = build_network(cfg.network, env.num_actions, env.observation_shape,
                        device="cpu")
    init, run_chunk = make_r2d2_train(cfg, env, net, device="cpu")
    launches = tps.kernel_stratified_sample.launches
    carry, metrics = run_chunk(init(0), 30)
    grad_steps = metrics["grad_steps_in_chunk"]
    # Trains from the iteration whose add brings the ring to min_fill.
    assert grad_steps == 30 - (64 // 4 - 1)
    assert np.isfinite(float(metrics["loss"]))
    assert metrics["env_frames"] == 30 * 4
    use_kernel = cfg.replay.pallas_sampler
    assert len(calls) == (grad_steps if use_kernel else 0)
    if use_kernel:
        assert calls[0] == (128, 4)
    assert tps.kernel_stratified_sample.launches == launches
    replay = carry.replay
    if cfg.replay.flat_storage:
        assert tuple(replay.ring.obs.shape) == (128 * 4, 84 * 84 * 4)
    else:
        assert tuple(replay.ring.obs.shape) == (128, 4, 4)
    assert bool(torch.isfinite(replay.priorities).all())
    live = tsring.live_start_writes(replay.writes, 128, 8, 2)
    rows = (replay.priorities > 0).any(dim=1).nonzero()[:, 0].tolist()
    assert sorted(s % 128 for s in live) == rows
    # Write-backs moved some live priorities off the seed value.
    assert bool((replay.priorities[rows] != 1.0).any())
    assert tuple(carry.actor_carry[0].shape) == (4, 8)


def test_r2d2_loop_refuses_ratio_and_bf16_actor_when_called_directly(
        monkeypatch):
    """The loop itself, for callers that build it directly: a replay ratio
    above 1 raises, as the JAX loop's does; ``network.actor_dtype`` is not
    read (the JAX recurrent loop has no bf16 actor split), so a bfloat16
    setting builds and acts on the learner's float32 net."""
    env = make_env("cartpole", device="cpu")
    cfg = _tiny("replay.updates_per_chunk=2")
    net = build_network(cfg.network, env.num_actions, env.observation_shape,
                        device="cpu")
    with pytest.raises(ValueError, match="recurrent R2D2 loop"):
        make_r2d2_train(cfg, env, net, device="cpu")
    acted = _spy_actor_dtypes(monkeypatch)
    cfg = _tiny("network.actor_dtype=bfloat16")
    net = build_network(cfg.network, env.num_actions, env.observation_shape,
                        device="cpu")
    init, run_chunk = make_r2d2_train(cfg, env, net, device="cpu")
    _, metrics = run_chunk(init(0), 20)
    assert metrics["grad_steps_in_chunk"] == 20 - (64 // 4 - 1)
    assert acted and set(acted) == {torch.float32}


def _spy_actor_dtypes(monkeypatch):
    """Record the parameter dtype of the net every recurrent act reads."""
    from dist_dqn_tpu_torch import r2d2_loop

    dtypes = []
    real = r2d2_loop.make_recurrent_actor_step

    def make(num_actions):
        act = real(num_actions)

        def spy(net, *args):
            dtypes.append(next(net.parameters()).dtype)
            return act(net, *args)
        return spy

    monkeypatch.setattr(r2d2_loop, "make_recurrent_actor_step", make)
    return dtypes


@pytest.mark.parametrize("pallas_sampler", [True, False])
def test_r2d2_dedup_loop_trains_on_cpu(pallas_sampler):
    """The dedup R2D2 loop on PixelCatch at tiny widths: the ring stores
    one frame per step, windows are rebuilt stacks, and the host predicate
    counts exactly the drawable starts."""
    cfg = _tiny("env_name=pixel_catch", "network.torso=small",
                "network.hidden=16", "replay.frame_dedup=true",
                "learner.batch_size=4", "train_every=2",
                f"replay.pallas_sampler={str(pallas_sampler).lower()}")
    env = make_env(cfg.env_name, device="cpu")
    net = build_network(cfg.network, env.num_actions, env.observation_shape,
                        device="cpu")
    init, run_chunk = make_r2d2_train(cfg, env, net, device="cpu")
    carry, metrics = run_chunk(init(0), 40)
    assert metrics["grad_steps_in_chunk"] > 0
    assert np.isfinite(float(metrics["loss"]))
    replay = carry.replay
    assert tuple(replay.ring.obs.shape) == (128 * 4, 84 * 84)
    live = tsring.live_start_writes(replay.writes, 128, 8, 2, frame_stack=4)
    from dist_dqn_tpu_torch.replay.device import contextful_start_mask
    drawable = (replay.priorities > 0) & contextful_start_mask(
        replay.ring, 4)[:, None]
    assert sorted(s % 128 for s in live) == \
        drawable.any(dim=1).nonzero()[:, 0].tolist()


def test_r2d2_cli_rows_on_cpu(capsys):
    """``python -m dist_dqn_tpu_torch.train --config r2d2`` on the CPU
    prints the JAX CLI's row keys, with eval_return on the eval cadence."""
    from dist_dqn_tpu_torch.train import main

    argv = ["--config", "r2d2", "--device", "cpu", "--total-env-steps",
            "240", "--chunk-iters", "30", "--eval-every-steps", "120",
            "--set", "replay.pallas_sampler=true"]
    for assignment in TINY:
        argv += ["--set", assignment]
    main(argv)
    rows = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [r["env_frames"] for r in rows] == [120, 240]
    for r in rows:
        assert {"env_frames", "loss", "episode_return", "episodes",
                "env_steps_per_sec", "grad_steps_in_chunk",
                "grad_steps_per_sec", "eval_return"} <= set(r)
    assert rows[-1]["grad_steps_in_chunk"] == 30


def test_r2d2_cli_profiles_a_chosen_training_chunk(capsys, tmp_path):
    """``--profile-chunk 3`` traces the fourth chunk, one past min_fill
    (the default, the second chunk, would still be filling)."""
    from dist_dqn_tpu_torch.train import main

    argv = ["--config", "r2d2", "--device", "cpu", "--total-env-steps",
            "160", "--chunk-iters", "8", "--eval-every-steps", "0",
            "--profile-dir", str(tmp_path), "--profile-chunk", "3"]
    for assignment in TINY:
        argv += ["--set", assignment]
    main(argv)
    rows = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    traced = [i for i, r in enumerate(rows) if "profile_trace" in r]
    assert traced == [3]                  # after chunks 0-2, before row 3
    assert rows[4]["env_frames"] == 4 * 8 * 4
    assert rows[4]["grad_steps_in_chunk"] == 8
    assert "Self CPU" in (tmp_path / "ops.txt").read_text()


@pytest.mark.parametrize("assignments,error", [
    # The JAX package's ValueError: no noisy heads on the recurrent net.
    (["network.noisy=true"], ValueError),
    # The JAX package's ValueError: the sequence learner has no member
    # axis.
    (["population.size=2"], ValueError),
    # Not read by the recurrent loop, as in the JAX package: trains in f32.
    (["network.actor_dtype=bfloat16"], None),
    (["replay.updates_per_chunk=2"], ValueError),
    # 10 slots < seq_len 8 + stride 4: the ring could hold no live start.
    (["replay.capacity=40", "replay.sequence_stride=4"], ValueError),
    # CartPole has no rolling frame stack to deduplicate.
    (["replay.frame_dedup=true"], ValueError),
])
def test_r2d2_train_refuses(monkeypatch, assignments, error):
    from dist_dqn_tpu_torch.train import train

    if error is None:
        acted = _spy_actor_dtypes(monkeypatch)
        _, history = train(_tiny(*assignments), total_env_steps=80,
                           chunk_iters=20, device="cpu",
                           log_fn=lambda line: None)
        assert history[-1]["grad_steps_in_chunk"] == 20 - (64 // 4 - 1)
        assert acted and set(acted) == {torch.float32}
        return
    with pytest.raises(error):
        train(_tiny(*assignments), total_env_steps=40, device="cpu",
              log_fn=lambda line: None)


# The JAX CLI's lines for the two learner-utilization flags on a recurrent
# config (dist_dqn_tpu/train.py:1093-1095, :1105-1106).
_IGNORED = {
    "--replay-ratio": "# --replay-ratio is not supported by the recurrent "
                      "(R2D2) fused loop yet (its sequence learner has no "
                      "scan-ratio path); ignored",
    "--actor-dtype": "# --actor-dtype is not supported by the recurrent "
                     "(R2D2) fused loop yet; ignored",
    # dist_dqn_tpu/train.py:1128-1130.
    "--population": "# --population is not supported by the recurrent "
                    "(R2D2) fused loop yet (its sequence learner has no "
                    "member axis); ignored",
}


@pytest.mark.parametrize("flag", [["--replay-ratio", "2"],
                                  ["--actor-dtype", "bfloat16"],
                                  ["--population", "2"]])
def test_r2d2_cli_refuses(monkeypatch, capsys, flag):
    """``--replay-ratio``, ``--actor-dtype`` and ``--population`` print
    the JAX CLI's warning, are ignored, and the run trains one recurrent
    policy with one grad step per train event and a float32 actor."""
    from dist_dqn_tpu_torch.train import main

    if flag[0] not in _IGNORED:
        with pytest.raises(SystemExit, match="not ported yet"):
            main(["--config", "r2d2", "--device", "cpu", *flag])
        return
    acted = _spy_actor_dtypes(monkeypatch)
    argv = ["--config", "r2d2", "--device", "cpu", "--total-env-steps", "80",
            "--chunk-iters", "20", "--eval-every-steps", "0", *flag]
    for assignment in TINY:
        argv += ["--set", assignment]
    main(argv)
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == _IGNORED[flag[0]]
    rows = [json.loads(line) for line in lines[1:]]
    assert [r["env_frames"] for r in rows] == [80]
    assert rows[0]["grad_steps_in_chunk"] == 20 - (64 // 4 - 1)
    assert acted and set(acted) == {torch.float32}


def test_r2d2_entry_points_need_cuda_unless_asked_for_cpu(monkeypatch):
    from dist_dqn_tpu_torch.train import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = _tiny()
    env = make_env(cfg.env_name, device="cpu")
    net = build_network(cfg.network, env.num_actions, env.observation_shape,
                        device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_r2d2_train(cfg, env, net)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["--config", "r2d2"])


@pytest.mark.slow
def test_r2d2_fused_loop_learns_cartpole():
    """The JAX package's R2D2 learning bar (``tests/test_r2d2.py``): eval
    >= 475 on CartPole within 480k frames, early-stopping at the bar."""
    from dist_dqn_tpu_torch.train import train

    cfg = tconfig.CONFIGS["r2d2"]
    cfg = dataclasses.replace(
        cfg, env_name="cartpole",
        network=dataclasses.replace(cfg.network, torso="mlp",
                                    mlp_features=(64,), hidden=0,
                                    lstm_size=32, compute_dtype="float32",
                                    lstm_dtype="float32"),
        replay=dataclasses.replace(cfg.replay, capacity=20_000, min_fill=500,
                                   burn_in=4, unroll_length=8,
                                   sequence_stride=4),
        learner=dataclasses.replace(cfg.learner, learning_rate=1e-3,
                                    n_step=2, batch_size=32, gamma=0.99,
                                    target_update_period=250,
                                    value_rescale=True),
        actor=dataclasses.replace(cfg.actor, num_envs=16,
                                  epsilon_decay_steps=15_000),
        total_env_steps=480_000, eval_every_steps=20_000)
    _, history = train(cfg, chunk_iters=500, device="cpu",
                       log_fn=lambda line: None,
                       stop_fn=lambda row: row.get("eval_return", 0.0)
                       >= 475.0)
    evals = [row["eval_return"] for row in history if "eval_return" in row]
    assert evals and max(evals) >= 475.0, evals
    assert all(abs(r["loss"]) < 1e3 for r in history)
