"""Port parity of the slice as a whole, and the port's fused loop and
entry points on the CPU.

One PER training step, end to end: both packages' envs run the same
trajectory under a fixed action sequence into their prioritized rings,
draw one batch at the same stratified uniforms (made with ``jax.random``),
take one train step from shared weights and write the priorities back.
Loss, |TD| priorities, updated params, target params and the written-back
priority plane agree to f32 rtol 1e-5: forward/backward sums run in other
orders in XLA and torch, and Adam divides by ``sqrt(v) + eps``, which
turns an ulp of gradient into an ulp of update, no more.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dist_dqn_tpu import config as jconfig
from dist_dqn_tpu.agents.dqn import make_learner as jax_make_learner
from dist_dqn_tpu.envs import make_jax_env
from dist_dqn_tpu.models import build_network as jax_build
from dist_dqn_tpu.replay import prioritized_device as jpring
from dist_dqn_tpu_torch import config as tconfig
from dist_dqn_tpu_torch.agents.dqn import make_learner as torch_make_learner
from dist_dqn_tpu_torch.envs import make_env
from dist_dqn_tpu_torch.models import build_network as torch_build
from dist_dqn_tpu_torch.ops import sampler as tps
from dist_dqn_tpu_torch.replay import prioritized_device as tpring
from dist_dqn_tpu_torch.utils.params import from_flax
from torch_parity import RESET_DRAWS, STEP_DRAWS, to_numpy_tree

NUM_SLOTS, B, STEPS, S = 16, 4, 22, 8


def _cfg(env_name, max_grad_norm, target_tau):
    if env_name == "cartpole":
        network = jconfig.NetworkConfig(torso="mlp", mlp_features=(32, 32),
                                        hidden=16, dueling=True)
    else:
        network = jconfig.NetworkConfig(torso="nature", hidden=32,
                                        dueling=True)
    learner = dataclasses.replace(jconfig.CONFIGS["apex"].learner,
                                  batch_size=S, learning_rate=1e-3,
                                  max_grad_norm=max_grad_norm,
                                  target_update_period=1,
                                  target_tau=target_tau)
    return network, learner


def _fill_rings(env_name):
    """Both rings through the same trajectory: the port's env takes the JAX
    env's draws (and, for CartPole, its state each step — see
    test_torch_envs.py for the ulp-level physics difference)."""
    jenv = make_jax_env(env_name)
    tenv = make_env(env_name, device="cpu")
    store_final = env_name == "cartpole"
    key = jax.random.PRNGKey(11)
    jstate, jobs = jenv.v_reset(key, B)
    tstate, tobs = tenv.v_reset(B, draws=RESET_DRAWS[env_name](key, B))
    jr = jpring.prioritized_ring_init(NUM_SLOTS, B, jobs[0],
                                      store_final_obs=store_final)
    tr = tpring.prioritized_ring_init(NUM_SLOTS, B, tobs[0],
                                      store_final_obs=store_final)
    rng = np.random.default_rng(0)
    v_step = jax.jit(jenv.v_step)
    for _ in range(STEPS):
        actions = rng.integers(0, jenv.num_actions, B).astype(np.int32)
        if env_name == "cartpole":
            tstate = type(tstate)(phys=torch.from_numpy(
                np.array(jstate.phys)), t=torch.from_numpy(np.array(jstate.t)))
        draws = STEP_DRAWS[env_name](jstate)
        prev_jobs, prev_tobs = jobs, tobs
        jstate, jout = v_step(jstate, jnp.asarray(actions))
        tstate, tout = tenv.v_step(tstate, torch.from_numpy(actions),
                                   draws=draws)
        jr = jpring.prioritized_ring_add(
            jr, prev_jobs, jnp.asarray(actions), jout.reward,
            jout.terminated, jout.truncated,
            final_obs=jout.next_obs if store_final else None)
        tpring.prioritized_ring_add(
            tr, prev_tobs, torch.from_numpy(actions), tout.reward,
            tout.terminated, tout.truncated,
            final_obs=tout.next_obs if store_final else None)
        jobs, tobs = jout.obs, tout.obs
    # Uneven priorities, so the draw is not uniform.
    t_idx = rng.integers(0, NUM_SLOTS, 24).astype(np.int32)
    b_idx = rng.integers(0, B, 24).astype(np.int32)
    prio = rng.uniform(0.1, 4.0, 24).astype(np.float32)
    jr = jpring.prioritized_ring_update(jr, jnp.asarray(t_idx),
                                        jnp.asarray(b_idx),
                                        jnp.asarray(prio))
    tpring.prioritized_ring_update(tr, torch.from_numpy(t_idx),
                                   torch.from_numpy(b_idx),
                                   torch.from_numpy(prio))
    return jenv, jr, tr


def _close(got, want, **kw):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **kw)


@pytest.mark.parametrize("env_name,max_grad_norm,use_kernel,target_tau", [
    ("cartpole", 10.0, True, 0.0),     # hard target copy (period 1)
    ("cartpole", 1e-3, True, 0.0),     # the global-norm clip fires
    ("cartpole", 10.0, False, 0.0),    # the cumsum+searchsorted draw
    ("cartpole", 10.0, True, 0.05),    # Polyak target sync
    ("pixel_pong", 10.0, True, 0.0),
])
def test_one_per_train_step_matches(env_name, max_grad_norm, use_kernel,
                                    target_tau):
    network, learner = _cfg(env_name, max_grad_norm, target_tau)
    jenv, jr, tr = _fill_rings(env_name)
    n_step, gamma, alpha, beta = learner.n_step, learner.gamma, 0.6, 0.4

    # One PER draw at the same stratified uniforms.
    key = jax.random.PRNGKey(5)
    u01 = np.array((jnp.arange(S, dtype=jnp.float32)
                    + jax.random.uniform(key, (S,))) / S)
    js = jpring.prioritized_ring_sample(
        jr, key, S, n_step, gamma, alpha, jnp.float32(beta),
        use_pallas=use_kernel, pallas_interpret=use_kernel)
    ts = tpring.prioritized_ring_sample(
        tr, None, S, n_step, gamma, alpha, beta, use_kernel=use_kernel,
        u=torch.from_numpy(u01))
    np.testing.assert_array_equal(ts.t_idx.numpy(), np.asarray(js.t_idx))
    np.testing.assert_array_equal(ts.b_idx.numpy(), np.asarray(js.b_idx))
    _close(ts.weights.numpy(), js.weights, rtol=1e-6)
    for field in ("obs", "action", "reward", "discount", "next_obs"):
        _close(getattr(ts.batch, field).numpy(),
               getattr(js.batch, field), rtol=1e-6, atol=1e-7,
               err_msg=field)

    # One train step from shared weights.
    jnet = jax_build(network, jenv.num_actions)
    j_init, j_step = jax_make_learner(jnet, learner)
    jl = j_init(jax.random.PRNGKey(3), js.batch.obs[0])
    tnet = torch_build(tconfig.NetworkConfig(**dataclasses.asdict(network)),
                       jenv.num_actions, jenv.observation_shape,
                       device="cpu")
    tnet.load_state_dict(from_flax(to_numpy_tree(jl.params), tnet))
    t_init, t_step = torch_make_learner(
        tconfig.LearnerConfig(**dataclasses.asdict(learner)), tnet)
    tl = t_init(tnet)
    jl2, jm = jax.jit(j_step)(jl, js.batch, js.weights)
    tl, tm = t_step(tl, ts.batch, ts.weights)

    _close(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
    _close(tm["priorities"].numpy(), jm["priorities"], rtol=1e-5, atol=1e-6)
    _close(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-5)
    if max_grad_norm < 1.0:
        assert float(tm["grad_norm"]) > max_grad_norm
    want = from_flax(to_numpy_tree(jl2.params), tnet)
    want_target = from_flax(to_numpy_tree(jl2.target_params), tnet)
    for name, value in tl.net.state_dict().items():
        _close(value.numpy(), want[name].numpy(), rtol=1e-5, atol=1e-7,
               err_msg=name)
    for name, value in tl.target_net.state_dict().items():
        _close(value.numpy(), want_target[name].numpy(), rtol=1e-5,
               atol=1e-7, err_msg=name)
    assert tl.steps == int(jl2.steps) == 1

    # Priority write-back.
    eps = 1e-6
    jr = jpring.prioritized_ring_update(jr, js.t_idx, js.b_idx,
                                        jm["priorities"], eps=eps)
    tpring.prioritized_ring_update(tr, ts.t_idx, ts.b_idx,
                                   tm["priorities"], eps=eps)
    _close(tr.priorities.numpy(), jr.priorities, rtol=1e-5, atol=1e-6)
    _close(float(tr.max_priority), float(jr.max_priority), rtol=1e-5)


def _tiny_cartpole():
    cfg = tconfig.CONFIGS["cartpole"]
    return dataclasses.replace(
        cfg,
        network=dataclasses.replace(cfg.network, mlp_features=(16,)),
        replay=dataclasses.replace(cfg.replay, capacity=256, min_fill=32,
                                   prioritized=True, pallas_sampler=True),
        learner=dataclasses.replace(cfg.learner, batch_size=16),
        actor=dataclasses.replace(cfg.actor, num_envs=4),
        total_env_steps=400, eval_every_steps=80, eval_episodes=3)


def test_fused_loop_with_sampler_runs_on_cpu(monkeypatch):
    """The port's fused loop with PER and the sampler kernel's routing, 40
    iterations on the CPU: the draw goes through the kernel wrapper to the
    plain version, never to the kernel."""
    from dist_dqn_tpu_torch.train_loop import make_fused_train

    calls = []
    plain = tps.plain_stratified_sample

    def spy(w, u):
        calls.append(tuple(w.shape))
        return plain(w, u)

    monkeypatch.setattr(tps, "plain_stratified_sample", spy)
    cfg = _tiny_cartpole()
    env = make_env(cfg.env_name, device="cpu")
    net = torch_build(cfg.network, env.num_actions, env.observation_shape,
                      device="cpu")
    init, run_chunk = make_fused_train(cfg, env, net, device="cpu")
    launches = tps.kernel_stratified_sample.launches
    carry, metrics = run_chunk(init(0), 40)
    grad_steps = metrics["grad_steps_in_chunk"]
    assert grad_steps > 0
    assert np.isfinite(float(metrics["loss"]))
    assert len(calls) == grad_steps
    assert calls[0] == (256 // 4, 4)
    assert tps.kernel_stratified_sample.launches == launches
    assert metrics["env_frames"] == 40 * 4
    assert bool(torch.isfinite(carry.replay.priorities).all())


def test_train_cli_rows_on_cpu(capsys):
    """``python -m dist_dqn_tpu_torch.train`` on the CPU prints the JAX
    CLI's row keys, with eval_return on the eval cadence."""
    from dist_dqn_tpu_torch.train import main

    main(["--config", "cartpole", "--device", "cpu",
          "--total-env-steps", "320", "--chunk-iters", "40",
          "--eval-every-steps", "160",
          "--set", "network.mlp_features=(16,)",
          "--set", "replay.min_fill=32", "--set", "replay.prioritized=true",
          "--set", "replay.pallas_sampler=true",
          "--set", "learner.batch_size=16", "--set", "actor.num_envs=4",
          "--set", "eval_episodes=2"])
    rows = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [r["env_frames"] for r in rows] == [160, 320]
    for r in rows:
        assert {"env_frames", "loss", "episode_return", "episodes",
                "env_steps_per_sec", "grad_steps_in_chunk",
                "grad_steps_per_sec", "eval_return"} <= set(r)
    assert rows[-1]["grad_steps_in_chunk"] > 0


def test_train_cli_profiles_second_chunk_on_cpu(capsys, tmp_path):
    """``--profile-dir`` writes the trace and per-op table of chunk 2."""
    from dist_dqn_tpu_torch.train import main

    main(["--config", "cartpole", "--device", "cpu",
          "--total-env-steps", "240", "--chunk-iters", "20",
          "--eval-every-steps", "0", "--profile-dir", str(tmp_path),
          "--set", "network.mlp_features=(16,)",
          "--set", "replay.min_fill=32", "--set", "replay.prioritized=true",
          "--set", "replay.pallas_sampler=true",
          "--set", "learner.batch_size=16", "--set", "actor.num_envs=4"])
    rows = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [r.get("env_frames") for r in rows] == [80, None, 160, 240]
    assert rows[1]["profile_trace"] == str(tmp_path / "trace.json")
    assert rows[1]["profile_wall_s"] > 0
    assert json.loads((tmp_path / "trace.json").read_text())
    assert "Self CPU" in (tmp_path / "ops.txt").read_text()


def test_device_busy_is_the_union_of_kernel_intervals():
    from types import SimpleNamespace

    from torch.autograd import DeviceType

    from dist_dqn_tpu_torch.train import _busy_seconds

    def ev(kind, start, end):
        return SimpleNamespace(device_type=kind, time_range=SimpleNamespace(
            start=start, end=end))

    events = [ev(DeviceType.CUDA, 10, 20), ev(DeviceType.CUDA, 15, 30),
              ev(DeviceType.CPU, 0, 100), ev(DeviceType.CUDA, 40, 45),
              ev(DeviceType.CUDA, 41, 42)]
    prof = SimpleNamespace(events=lambda: events)
    assert _busy_seconds(prof) == pytest.approx(25e-6)
    assert _busy_seconds(SimpleNamespace(events=lambda: [])) == 0.0


@pytest.mark.parametrize("flag", [
    # Flags still refused (the checkpoint flags are ported and tested in
    # tests/test_torch_resume.py); the population flags are ported
    # (tests/test_torch_population.py): --population runs a stacked
    # population, and --population-spec is validated at the parser;
    # --runtime host-replay is ported (tests/test_torch_host_replay.py)
    # and runs the host-replay loop; --runtime apex is ported with its
    # remote actors (tests/test_torch_apex_service.py,
    # tests/test_torch_remote_actors.py), and several learner devices
    # are not.
    ["--runtime", "host-replay"], ["--mesh-devices", "2"],
    ["--population", "2"], ["--runtime", "apex", "--learner-devices", "2"],
    ["--telemetry-port", "9100"],
    ["--population-spec", '{"lr": [0.001, 0.002]}']])
def test_train_cli_refuses_unported_flags(flag, capsys):
    from dist_dqn_tpu_torch.train import main

    if flag[0] == "--population":
        main(["--config", "cartpole", *_TINY_CLI, *flag])
        rows = [json.loads(line)
                for line in capsys.readouterr().out.splitlines()]
        assert [r["env_frames"] for r in rows] == [160, 320]
        assert rows[-1]["population"] == 2
        assert len(rows[-1]["loss_members"]) == 2
        return
    if flag == ["--runtime", "host-replay"]:
        main(["--config", "cartpole", *_TINY_CLI, *flag])
        lines = capsys.readouterr().out.splitlines()
        assert lines[0] == "# host-replay sampler: uniform"
        rows = [json.loads(line) for line in lines[1:]]
        assert [r["env_frames"] for r in rows[:-1]] == [160, 320]
        assert rows[-1]["env_steps"] == 320 and rows[-1]["pipeline"]
        return
    if flag[0] == "--population-spec":
        # Two lr entries for the default --population 1.
        with pytest.raises(SystemExit):
            main(["--config", "apex", "--device", "cpu", *flag])
        assert "each vector must be length M" in capsys.readouterr().err
        return
    with pytest.raises(SystemExit, match="not ported yet"):
        main(["--config", "apex", "--device", "cpu", *flag])


_CONFIG_CASES = {
    # The heads of the distributional slice train, with eval (the noisy
    # evaluator acts with noise).
    "network.noisy=true": None,
    # Ported: a stacked population of two (its rows checked below).
    "population.size=2": None,
    "network.num_atoms=51": None,
    "network.iqn=true": None,
    # The JAX learner's ValueError: Munchausen needs n_step 1 (cartpole
    # has 3).
    "learner.munchausen=true": ValueError,
}


@pytest.mark.parametrize("assignment", list(_CONFIG_CASES))
def test_train_refuses_unported_config(assignment):
    from dist_dqn_tpu_torch.train import train

    cfg = tconfig.apply_overrides(_tiny_cartpole(), [assignment])
    error = _CONFIG_CASES[assignment]
    if error is not None:
        with pytest.raises(error):
            train(cfg, device="cpu", log_fn=lambda line: None)
        return
    _, history = train(cfg, chunk_iters=50, device="cpu",
                       log_fn=lambda line: None)
    assert [r["env_frames"] for r in history] == [200, 400]
    assert history[-1]["grad_steps_in_chunk"] == 50
    assert all(np.isfinite(r["loss"]) and np.isfinite(r["eval_return"])
               for r in history)
    if assignment.startswith("population"):
        assert all(r["population"] == 2 and len(r["loss_members"]) == 2
                   and len(r["eval_return_members"]) == 2 for r in history)


_TINY_CLI = ["--device", "cpu", "--total-env-steps", "320",
             "--chunk-iters", "40", "--eval-every-steps", "0",
             "--set", "network.mlp_features=(16,)",
             "--set", "replay.min_fill=32", "--set", "learner.batch_size=16",
             "--set", "actor.num_envs=4"]


@pytest.mark.parametrize("per", [False, True], ids=["uniform", "per"])
def test_train_cli_replay_ratio_doubles_grad_steps(capsys, per):
    """``--replay-ratio 2`` runs on the CPU: every chunk reports twice the
    grad steps of ratio 1, which trains once per iteration past min_fill."""
    from dist_dqn_tpu_torch.train import main

    argv = ["--config", "cartpole", *_TINY_CLI,
            "--set", f"replay.prioritized={str(per).lower()}"]
    main(argv)
    base = [json.loads(line)["grad_steps_in_chunk"]
            for line in capsys.readouterr().out.splitlines()]
    main(argv + ["--replay-ratio", "2"])
    rows = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [r["grad_steps_in_chunk"] for r in rows] == [2 * g for g in base]
    assert base[-1] == 40 and all(np.isfinite(r["loss"]) for r in rows)


def test_train_cli_actor_dtype_bfloat16_runs(capsys):
    from dist_dqn_tpu_torch.train import main

    main(["--config", "cartpole", *_TINY_CLI, "--actor-dtype", "bfloat16"])
    rows = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [r["env_frames"] for r in rows] == [160, 320]
    assert rows[-1]["grad_steps_in_chunk"] == 40


def test_frame_dedup_needs_a_rolling_frame_stack():
    """CartPole declares no frame stack: dedup raises as in the JAX loop;
    so does dedup with a final-obs buffer."""
    from dist_dqn_tpu_torch.train import train

    cfg = tconfig.apply_overrides(_tiny_cartpole(),
                                  ["replay.frame_dedup=true"])
    with pytest.raises(ValueError, match="rolling frame stack"):
        train(cfg, device="cpu", log_fn=lambda line: None)
    cfg = tconfig.apply_overrides(
        _tiny_cartpole(), ["replay.frame_dedup=true", "env_name=pixel_catch",
                           "network.torso=small",
                           "replay.store_final_obs=true"])
    with pytest.raises(ValueError, match="store_final_obs"):
        train(cfg, device="cpu", log_fn=lambda line: None)


_TINY_PIXEL = ["network.torso=small", "network.hidden=32",
               "network.compute_dtype=float32", "replay.capacity=512",
               "replay.min_fill=64", "learner.batch_size=8",
               "actor.num_envs=8", "train_every=2"]


@pytest.mark.parametrize("preset", ["atari", "apex"])
def test_train_cli_breakout_dedup_ratio_bf16_actor_on_cpu(capsys, preset):
    """The CLI with PixelBreakout, a dedup ring, ``--replay-ratio 2`` and
    ``--actor-dtype bfloat16`` at tiny widths: no refusal, two grad steps
    per train event. (No eval: a greedy Breakout episode runs its full
    2,000 steps; the CartPole CLI tests cover the eval cadence.)"""
    from dist_dqn_tpu_torch.train import main

    argv = ["--config", preset, "--device", "cpu", "--total-env-steps",
            "480", "--chunk-iters", "30", "--eval-every-steps", "0",
            "--set", "env_name=pixel_breakout",
            "--set", "replay.frame_dedup=true", "--replay-ratio", "2",
            "--actor-dtype", "bfloat16"]
    for assignment in _TINY_PIXEL:
        argv += ["--set", assignment]
    main(argv)
    rows = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [r["env_frames"] for r in rows] == [240, 480]
    # Iterations 8..28 even train in the first chunk, all 15 in the second.
    assert [r["grad_steps_in_chunk"] for r in rows] == [22, 30]
    assert all(np.isfinite(r["loss"]) for r in rows)


@pytest.mark.parametrize("preset,extra", [
    ("atari", ["env_name=pixel_breakout"]),
    ("apex", ["env_name=pixel_breakout"]),
    ("atari", ["env_name=pixel_catch", "replay.prioritized=true",
               "replay.pallas_sampler=true"]),
], ids=["atari-breakout", "apex-breakout", "catch-per"])
def test_dedup_fused_loop_runs_on_cpu(monkeypatch, preset, extra):
    """The dedup fused loop at tiny widths, ratio 2 and the bf16 actor:
    the ring stores one frame per step (merged rows), the learner trains on
    rebuilt stacks, and PER draws once per grad step."""
    calls = []
    plain = tps.plain_stratified_sample

    def spy(w, u):
        calls.append(tuple(w.shape))
        return plain(w, u)

    from dist_dqn_tpu_torch.train_loop import make_fused_train

    monkeypatch.setattr(tps, "plain_stratified_sample", spy)
    cfg = tconfig.apply_overrides(
        tconfig.CONFIGS[preset],
        _TINY_PIXEL + extra + ["replay.frame_dedup=true",
                               "replay.updates_per_chunk=2",
                               "network.actor_dtype=bfloat16"])
    env = make_env(cfg.env_name, device="cpu")
    net = torch_build(cfg.network, env.num_actions, env.observation_shape,
                      device="cpu")
    init, run_chunk = make_fused_train(cfg, env, net, device="cpu")
    carry, metrics = run_chunk(init(0), 30)
    grad_steps = metrics["grad_steps_in_chunk"]
    # Trains every other iteration once 64 transitions and the n-step and
    # stack context (3 + 3 slots) are stored: iterations 8..29 even.
    assert grad_steps == 2 * len(range(8, 30, 2))
    assert np.isfinite(float(metrics["loss"]))
    replay = carry.replay.ring if cfg.replay.prioritized else carry.replay
    assert tuple(replay.obs.shape) == (64 * 8, 84 * 84)
    assert len(calls) == (grad_steps if cfg.replay.pallas_sampler else 0)
    if cfg.replay.prioritized:
        assert bool(torch.isfinite(carry.replay.priorities).all())


def test_entry_points_need_cuda_unless_asked_for_cpu(monkeypatch):
    from dist_dqn_tpu_torch.train import train
    from dist_dqn_tpu_torch.train_loop import make_fused_train

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = _tiny_cartpole()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train(cfg, log_fn=lambda line: None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_env("cartpole")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        torch_build(cfg.network, 2, (4,))
    env = make_env("cartpole", device="cpu")
    net = torch_build(cfg.network, 2, (4,), device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_fused_train(cfg, env, net)
