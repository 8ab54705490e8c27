"""Port parity and pins of the host-replay runtime
(dist_dqn_tpu_torch/host_replay_loop.py and its CLI branch).

* One collect chunk against the JAX package's ``make_collect_chunk``, both
  under the same fixed actions, the port's env handed the JAX env's draws:
  the records and episode stats equal bit for bit (PixelPong, whose steps
  match exactly; tests/test_torch_envs.py).
* The JAX package's own pins, on the port: pipelined vs serial and
  prefetched vs serial runs end with equal params (uniform; PER only
  without prefetch, whose draws race the write-backs), at replay ratio 2
  too, and with a pixel dedup ring.
* A run killed at chunk k (an exception from ``log_fn`` right after that
  chunk's save) and resumed equals the uninterrupted run bit for bit:
  uniform, serial PER on the host sum-tree, serial PER on the device
  plane.
* The CLI's refusals and "ignored" lines, word for word against the JAX
  package's train.py.
* The data-parallel runtime from the plain call (two spawned CPU ranks,
  and one rank in this process).
"""
import dataclasses
import json
import sys
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dist_dqn_tpu import host_replay_loop as jhrl
from dist_dqn_tpu import loop_common as jlc
from dist_dqn_tpu.config import CONFIGS as JCONFIGS
from dist_dqn_tpu.envs import make_jax_env
from dist_dqn_tpu_torch import host_replay_loop as thrl
from dist_dqn_tpu_torch import loop_common as tlc
from dist_dqn_tpu_torch.config import CONFIGS, apply_overrides
from dist_dqn_tpu_torch.envs import make_env
from torch_parity import RESET_DRAWS, STEP_DRAWS, train_cli_in_fleet
import torch_mesh_workers as workers

_CARTPOLE = ["network.mlp_features=(32,)", "replay.capacity=4096",
             "replay.min_fill=64", "learner.batch_size=16",
             "actor.num_envs=8", "eval_every_steps=0"]
_PIXEL = ["env_name=pixel_catch", "network.torso=small", "network.hidden=32",
          "network.compute_dtype=float32", "actor.num_envs=4",
          "replay.capacity=1024", "replay.min_fill=64",
          "replay.frame_dedup=true", "learner.batch_size=8", "train_every=4",
          "eval_every_steps=0"]


def _cfg(preset, overrides, *extra):
    return apply_overrides(CONFIGS[preset], [*overrides, *extra])


def _run(cfg, total=1600, chunk=50, **kw):
    return thrl.run_host_replay(cfg, total_env_steps=total, chunk_iters=chunk,
                                device="cpu", log_fn=lambda line: None, **kw)


def _params(out):
    return [p.detach().clone() for p in out["learner"].net.parameters()]


def _assert_same_params(a, b):
    assert a["grad_steps"] == b["grad_steps"] > 0
    assert a["param_checksum"] == b["param_checksum"]
    for x, y in zip(_params(a), _params(b)):
        assert torch.equal(x, y)


# --------------------------------------------------------------------------
# One collect chunk against the JAX package's.
# --------------------------------------------------------------------------

def _pong_collect_against_jax(monkeypatch, B, C, lanes=None, num_shards=1,
                              real_schedule=False):
    """One PixelPong dedup chunk of ``lanes`` (default B) lanes in both
    packages under a fixed action table, the port's env handed the JAX
    env's draws. With ``real_schedule`` both actors take the real epsilon
    schedule, record it and return the table's row by call count;
    otherwise the schedule is replaced by the iteration counter, which
    indexes the table."""
    L = B if lanes is None else lanes
    table = np.random.default_rng(0).integers(0, 3, (C, L)).astype(np.int32)
    jcfg = dataclasses.replace(
        JCONFIGS["apex"], actor=dataclasses.replace(JCONFIGS["apex"].actor,
                                                    num_envs=B))
    j_eps, t_eps = [], []
    if real_schedule:
        from jax.experimental import io_callback

        def j_row(eps):
            j_eps.append(np.float32(eps))
            return table[(len(j_eps) - 1) % C]

        monkeypatch.setattr(
            jhrl, "make_actor_step",
            lambda net: lambda params, obs, key, eps: io_callback(
                j_row, jax.ShapeDtypeStruct((L,), jnp.int32), eps,
                ordered=True))

        def t_act(n):
            def act(net, obs, gen, eps):
                t_eps.append(np.float32(eps))
                return torch.from_numpy(table[len(t_eps) - 1]).long()
            return act
    else:
        monkeypatch.setattr(jlc, "make_schedules",
                            lambda cfg, B, num_shards=1: (lambda it: it,
                                                          None))
        monkeypatch.setattr(
            jhrl, "make_actor_step",
            lambda net: lambda params, obs, key, eps: jnp.asarray(table)[
                eps.astype(jnp.int32)])
        monkeypatch.setattr(tlc, "make_schedules",
                            lambda cfg, B, num_shards=1: (lambda it: it,
                                                          None))

        def t_act(n):
            return lambda net, obs, gen, eps: torch.from_numpy(
                table[int(eps)]).long()
    jenv = make_jax_env("pixel_pong")
    jinit, jcollect = jhrl.make_collect_chunk(jcfg, jenv, None, 4,
                                              lanes=lanes,
                                              num_shards=num_shards)
    rng = jax.random.PRNGKey(3)
    jcarry = jinit(rng)
    _, jrec, jstats = jcollect(jcarry, None, C)
    # The env draws each step of that chunk consumes, step by step.
    draws, c = [], jcarry
    for _ in range(C):
        draws.append(STEP_DRAWS["pixel_pong"](c.env_state))
        c, _, _ = jcollect(c, None, 1)

    tcfg = _cfg("apex", [f"actor.num_envs={B}"])
    monkeypatch.setattr(thrl, "make_actor_step", t_act)
    tenv = make_env("pixel_pong", device="cpu")
    feed = iter(draws)
    monkeypatch.setattr(tenv, "draw", lambda n, g: next(feed))
    _, tcollect = thrl.make_collect_chunk(tcfg, tenv, 4, lanes=lanes,
                                          num_shards=num_shards)
    k_env, _ = jax.random.split(rng)
    env_state, obs = tenv.v_reset(L, draws=RESET_DRAWS["pixel_pong"](k_env,
                                                                     L))
    carry = thrl.CollectCarry(env_state=env_state, obs=obs.clone(),
                              gen_env=None, gen_act=None, iteration=0,
                              ep_return=torch.zeros(L))
    carry, rec, stats = tcollect(carry, None, C)
    assert rec["obs"].shape == (C, L, 84, 84, 1)
    for key in ("obs", "action", "reward", "terminated", "truncated"):
        np.testing.assert_array_equal(rec[key].numpy(), np.asarray(jrec[key]),
                                      err_msg=key)
    np.testing.assert_array_equal(carry.obs.numpy(), np.asarray(c.obs))
    assert carry.iteration == C
    for got, want in zip(stats, jstats):
        assert float(got) == float(want)
    if real_schedule:
        assert len(t_eps) == C and len(set(t_eps)) > 1
        # Within one float32 ulp: JAX's compiled scan contracts the
        # schedule's ``delta * frac + end`` into one fused multiply-add,
        # where its eager schedule (held exactly in test_torch_schedules)
        # and the port round twice.
        np.testing.assert_array_max_ulp(np.array(t_eps),
                                        np.array(j_eps[:C]), maxulp=1)
    return t_eps


def test_collect_chunk_matches_jax(monkeypatch):
    """PixelPong with a dedup stack, 4 lanes, 40 iterations under a fixed
    action table (both actors read it by iteration; the epsilon schedule
    is replaced by the iteration counter to index it): obs (the newest
    frame), actions, rewards, episode flags, the carry's obs and the
    chunk's episode stats equal bit for bit."""
    _pong_collect_against_jax(monkeypatch, 4, 40)


def test_lane_block_collect_matches_jax(monkeypatch):
    """One shard's program of a 2-shard run (``lanes=2, num_shards=2`` of
    B = 4, 16 iterations) against JAX's, both actors on the real epsilon schedule in
    per-shard units: the records, the carry's obs and the stats equal bit
    for bit, the epsilon each iteration acts on to one float32 ulp; the
    schedule is the whole-B program's, not a lone 2-lane program's."""
    eps = _pong_collect_against_jax(monkeypatch, 4, 16, lanes=2,
                                    num_shards=2, real_schedule=True)
    cfg = _cfg("apex", ["actor.num_envs=4"])
    (whole, _), (lone, _) = (tlc.make_schedules(cfg, 4),
                             tlc.make_schedules(cfg, 2))
    assert eps == [np.float32(whole(i)) for i in range(len(eps))]
    assert eps != [np.float32(lone(i)) for i in range(len(eps))]


# --------------------------------------------------------------------------
# The loop's own pins.
# --------------------------------------------------------------------------

@pytest.mark.parametrize("variant", [
    dict(pipeline=False, prefetch=False),
    dict(prefetch=False),
    dict(prefetch=False, double_buffer=False),
    dict(pipeline=False),
], ids=["serial", "pipeline_no_prefetch", "no_double_buffer",
        "prefetch_no_pipeline"])
def test_uniform_variants_match_pipelined_prefetched(variant):
    """Uniform sampling: every serial reference ends with the pipelined,
    prefetched run's params bit for bit, and no batch was stale."""
    cfg = _cfg("cartpole", _CARTPOLE)
    ref = _run(cfg)
    got = _run(cfg, **variant)
    _assert_same_params(ref, got)
    assert ref["stale_batches"] == 0 and ref["prefetch"]
    assert [r["env_frames"] for r in ref["history"]] == \
        [r["env_frames"] for r in got["history"]]
    assert [r.get("loss") for r in ref["history"]] == \
        [r.get("loss") for r in got["history"]]


@pytest.mark.parametrize("device_sampling", [False, True],
                         ids=["sum_tree", "device_plane"])
def test_per_pipeline_matches_serial_without_prefetch(device_sampling):
    """PER without prefetch: the pipelined run equals the serial one bit
    for bit, on the host sum-tree and on the device plane (on the CPU its
    three-level draw)."""
    cfg = _cfg("cartpole", _CARTPOLE)
    kw = dict(prioritized=True, device_sampling=device_sampling,
              prefetch=False)
    a = _run(cfg, **kw)
    b = _run(cfg, pipeline=False, **kw)
    _assert_same_params(a, b)
    assert a["sampler"] == ("device" if device_sampling else "tree")
    assert a["prio_writeback_rows"] == b["prio_writeback_rows"] > 0
    assert 0 < a["is_weight_min"] <= a["is_weight_mean"] <= 1


def test_replay_ratio_two_doubles_grad_steps():
    cfg = _cfg("cartpole", _CARTPOLE)
    one = _run(cfg)
    two = _run(cfg, **{})
    cfg2 = _cfg("cartpole", _CARTPOLE, "replay.updates_per_chunk=2")
    a = _run(cfg2)
    b = _run(cfg2, pipeline=False, prefetch=False)
    _assert_same_params(a, b)
    assert a["grad_steps"] == 2 * one["grad_steps"] == 2 * two["grad_steps"]
    assert a["replay_ratio"] == 2


def test_pixel_dedup_streams_single_frames():
    """PixelCatch with a dedup ring: each chunk evacuates single frames
    (not stacks), the host ring rebuilds the stacks, the CNN learner
    trains, and the pipelined run equals the serial one."""
    cfg = _cfg("atari", _PIXEL)
    a = _run(cfg, total=1200)
    b = _run(cfg, total=1200, pipeline=False, prefetch=False)
    _assert_same_params(a, b)
    last = a["history"][-1]
    assert last["d2h_bytes"] < 50 * 4 * 84 * 84 * 2
    assert np.isfinite(last["loss"])
    assert a["ring_gb"] == round(256 * 4 * 84 * 84 / 1e9 + 256 * 4 * 10
                                 / 1e9, 3)


def test_rows_and_summary_carry_the_jax_keys():
    """Every key of the JAX loop's per-chunk rows and summary."""
    out = _run(_cfg("cartpole", _CARTPOLE), total=800)
    row_keys = {
        "env_frames", "grad_steps", "episode_return", "env_steps_per_sec",
        "env_steps_per_sec_loop", "chunk_train_s", "chunk_stats_fetch_s",
        "evac_s", "evac_fence_wait_s", "evac_overlap_frac",
        "device_idle_est_s", "d2h_bytes", "ring_transitions", "ring_gb",
        "sample_s", "chip_busy_s", "idle_other_s", "prefetch_wait_s",
        "prefetch_depth", "stale_batches", "h2d_staged_bytes", "loss"}
    assert set(out["history"][-1]) == row_keys
    summary_keys = {
        "env_steps", "grad_steps", "wall_s", "env_steps_per_sec",
        "grad_steps_per_sec", "dp_size", "replay_ratio", "train_batch",
        "actor_dtype", "sharded_collect", "collect_lane_block",
        "collect_dispatch_s_total", "d2h_bytes_by_shard",
        "ring_bytes_by_shard", "ring_transitions", "ring_gb",
        "window_transitions_max", "pipeline", "evac_slices",
        "d2h_bytes_total", "evac_fence_wait_s_total",
        "evac_overlap_frac_mean", "param_checksum", "double_buffer",
        "h2d_staged_bytes", "prefetch", "prefetch_depth", "prioritized",
        "sampler", "sample_s_total", "prefetch_wait_s_total",
        "stale_batches", "prio_writeback_flushes", "prio_writeback_rows",
        "prio_writeback_dropped", "is_weight_mean", "is_weight_min",
        "chip_time", "programs", "history"}
    assert set(out) - {"learner"} == summary_keys


# --------------------------------------------------------------------------
# Kill and resume.
# --------------------------------------------------------------------------

class _Killed(Exception):
    pass


def _kill_after_save(frames: int):
    def log(line):
        if line.startswith("{") and \
                json.loads(line).get("host_replay_checkpoint") == frames:
            raise _Killed
    return log


@pytest.mark.parametrize("kw", [
    dict(),
    dict(prioritized=True, prefetch=False, pipeline=False),
    dict(prioritized=True, prefetch=False, pipeline=False,
         device_sampling=True),
], ids=["uniform", "per_sum_tree_serial", "per_device_plane_serial"])
def test_kill_and_resume_is_bit_identical(tmp_path, kw):
    """Killed right after chunk 3's save (1,600 frames of 8 lanes, 50
    iterations a chunk) and relaunched: the resumed run ends with the
    uninterrupted run's params, grad steps and chunk losses."""
    cfg = _cfg("cartpole", _CARTPOLE, "replay.min_fill=200")
    total, chunk = 2800, 50
    ref = _run(cfg, total=total, chunk=chunk, **kw)
    directory = str(tmp_path / "ckpt")
    with pytest.raises(_Killed):
        thrl.run_host_replay(cfg, total_env_steps=total, chunk_iters=chunk,
                             device="cpu", log_fn=_kill_after_save(1600),
                             checkpoint_dir=directory,
                             save_every_frames=800, **kw)
    logged = []
    got = thrl.run_host_replay(cfg, total_env_steps=total, chunk_iters=chunk,
                               device="cpu", log_fn=logged.append,
                               checkpoint_dir=directory,
                               save_every_frames=800, **kw)
    resumed = [json.loads(x) for x in logged if "resumed_at_frames" in x]
    assert resumed == [{"resumed_at_frames": 1600, "resumed_at_chunk": 4,
                        "resumed_dp": 1,
                        "resumed_per": bool(kw.get("prioritized"))}]
    _assert_same_params(ref, got)
    tail = [r.get("loss") for r in ref["history"][4:]]
    assert [r.get("loss") for r in got["history"]] == tail
    if kw.get("prioritized"):
        assert got["prio_writeback_rows"] > 0
    # A finished run relaunched trains nothing more.
    again = _run(cfg, total=total, chunk=chunk, checkpoint_dir=directory,
                 save_every_frames=800, **kw)
    assert again["history"] == [] and again["env_steps"] == total


def test_resume_refuses_a_changed_loop_shape(tmp_path):
    cfg = _cfg("cartpole", _CARTPOLE)
    directory = str(tmp_path / "c")
    _run(cfg, total=800, checkpoint_dir=directory)
    with pytest.raises(ValueError, match="--chunk-iters 50, this run uses"):
        _run(cfg, total=1200, chunk=25, checkpoint_dir=directory)
    with pytest.raises(ValueError, match="prioritized=False, this run"):
        _run(cfg, total=1200, checkpoint_dir=directory, prioritized=True)


# --------------------------------------------------------------------------
# Refusals and the CLI, word for word against the JAX package.
# --------------------------------------------------------------------------

def _jax_error(cfg_name, overrides, **kw):
    from dist_dqn_tpu.config import apply_overrides as japply
    cfg = japply(JCONFIGS[cfg_name], overrides)
    with pytest.raises(ValueError) as e:
        jhrl.run_host_replay(cfg, total_env_steps=400, log_fn=lambda s: None,
                             **kw)
    return str(e.value)


@pytest.mark.parametrize("case", [
    ("r2d2", [], {}),
    ("cartpole", _CARTPOLE, dict(device_sampling=True)),
    ("cartpole", _CARTPOLE, dict(evac_slices=0)),
    ("cartpole", _CARTPOLE, dict(chunk_iters=600)),
    ("cartpole", _CARTPOLE, dict(prio_writeback_batch=0)),
], ids=["recurrent", "device_sampling_without_per", "evac_slices",
        "chunk_iters_over_slots", "writeback_batch"])
def test_refusals_match_jax(case):
    name, overrides, kw = case
    want = _jax_error(name, overrides, **kw)
    with pytest.raises(ValueError) as e:
        thrl.run_host_replay(_cfg(name, overrides), total_env_steps=400,
                             device="cpu", log_fn=lambda s: None, **kw)
    assert str(e.value) == want


def test_mesh_is_not_ported_yet():
    """The data-parallel runtime runs from the plain call: ``mesh_devices=2``
    starts two CPU ranks and returns rank 0's summary (no learner: it
    stayed in the rank), ``sharded_collect=True`` runs one rank in this
    process (tests/test_torch_host_replay_mesh.py holds both against JAX
    and the plain program)."""
    cfg = _cfg("cartpole", _CARTPOLE)
    for kw, dp in ((dict(mesh_devices=2), 2), (dict(sharded_collect=True), 1)):
        out = thrl.run_host_replay(cfg, total_env_steps=800, chunk_iters=50,
                                   device="cpu", log_fn=workers.quiet, **kw)
        assert out["sharded_collect"] and out["dp_size"] == dp
        assert out["env_steps"] == 800 and out["grad_steps"] > 0
        assert len(out["d2h_bytes_by_shard"]) == dp
        assert ("learner" in out) == (dp == 1)


def _comment_lines(text):
    return [line for line in text.splitlines() if line.startswith("# ")]


def _jax_cli_lines(argv, capsys):
    from dist_dqn_tpu import train as jtr
    with mock.patch.object(sys, "argv", ["train", *argv]), \
            mock.patch.object(jtr, "train", lambda *a, **k: None), \
            mock.patch.object(jhrl, "run_host_replay",
                              lambda *a, **k: {}):
        jtr.main()
    return _comment_lines(capsys.readouterr().out)


def _port_cli_lines(argv, capsys, monkeypatch):
    from dist_dqn_tpu_torch import train as ttr
    monkeypatch.setattr(ttr, "train", lambda *a, **k: None)
    monkeypatch.setattr(thrl, "run_host_replay", lambda *a, **k: {})
    ttr.main(argv)
    return _comment_lines(capsys.readouterr().out)


@pytest.mark.parametrize("flags", [
    ["--no-double-buffer"], ["--no-pipeline"], ["--evac-slices", "2"],
    ["--no-prefetch"], ["--prefetch-depth", "3"], ["--per"],
    ["--device-sampling"],
    ["--runtime", "host-replay", "--stop-at-return", "100",
     "--checkpoint-replay", "--save-every-frames", "1000",
     "--eval-every-steps", "500"],
    ["--runtime", "host-replay", "--population", "2"],
], ids=["no_double_buffer", "no_pipeline", "evac_slices", "no_prefetch",
        "prefetch_depth", "per", "device_sampling", "host_replay_ignored",
        "host_replay_population"])
def test_cli_ignored_lines_match_jax(flags, capsys, monkeypatch):
    """The "# ... ignored" lines the CLI prints for flags a runtime does
    not use, as the JAX CLI prints them."""
    want = _jax_cli_lines(["--config", "cartpole", "--platform", "cpu",
                           *flags], capsys)
    got = _port_cli_lines(["--config", "cartpole", "--device", "cpu",
                           *flags], capsys, monkeypatch)
    assert want and got == want


def test_cli_host_replay_runs_and_needs_a_device(capsys, monkeypatch,
                                                 tmp_path):
    """The CLI branch trains on the CPU when asked and prints the summary;
    without --device cpu and without a card it raises. The apex branch's
    fleet flag, refused until ROADMAP.md A10c, runs: the service is a live
    learner-role fleet member while it trains."""
    from dist_dqn_tpu_torch.train import main
    argv = ["--config", "cartpole", "--runtime", "host-replay",
            "--total-env-steps", "800", "--chunk-iters", "50", "--per",
            "--device-sampling", "--no-prefetch"]
    for o in _CARTPOLE:
        argv += ["--set", o]
    main([*argv, "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert json.loads(lines.pop(0))["manifest"]["config_name"] == "cartpole"
    assert lines[0].startswith("# host-replay sampler: prioritized device "
                               "plane (cpu, alpha=0.6")
    summary = json.loads(lines[-1])
    assert summary["env_steps"] == 800 and summary["sampler"] == "device"
    assert "history" not in summary and "learner" not in summary
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(argv)
    rows, status, left = train_cli_in_fleet(
        ["--config", "cartpole", "--runtime", "apex", "--device", "cpu",
         "--host-env", "CartPole-v1", "--num-actors", "1",
         "--envs-per-actor", "4", "--total-env-steps", "600", "--set",
         "network.mlp_features=(32,)", "--set", "replay.min_fill=128",
         "--set", "learner.batch_size=32"], str(tmp_path / "fleet"))
    assert [m["state"] for m in status["members"].values()] == ["live"]
    assert rows[-1]["env_steps"] >= 600 and left == []
