"""Port parity of the distributional slice as a whole, and the rainbow,
qrdqn, iqn and mdqn presets through the port's fused loop and CLI on the
CPU.

One PER training step of the rainbow preset, end to end, in the manner of
tests/test_torch_slice.py: both packages' PixelReacher envs run the same
trajectory under a fixed action sequence into their prioritized rings,
draw one batch at the same stratified uniforms through the
cumsum+searchsorted twin (the preset's ``pallas_sampler=False``), take
one noisy C51 double-Q train step from shared weights with the JAX step's
own noise (recorded while it runs) and write the priorities back. Loss,
priorities, grad norm and the written-back plane agree to f32 rtol 1e-5,
for the reasons test_torch_slice.py gives; params and target params to
rtol 1e-5 / atol 1e-6, a thousandth of the lr-sized Adam step: a conv
bias gradient sums thousands of cancelling terms, whose order-dependent
rounding reaches 1e-4 of a step when Adam's eps dominates its scale.
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
from dist_dqn_tpu.models import build_network as jax_build
from dist_dqn_tpu.replay import prioritized_device as jpring
from dist_dqn_tpu_torch import config as tconfig
from dist_dqn_tpu_torch.agents.dqn import make_learner as torch_make_learner
from dist_dqn_tpu_torch.envs import make_env
from dist_dqn_tpu_torch.models import build_network as torch_build
from dist_dqn_tpu_torch.ops import sampler as tps
from dist_dqn_tpu_torch.replay import prioritized_device as tpring
from dist_dqn_tpu_torch.utils.params import from_flax
from test_torch_slice import S, _close, _fill_rings
from torch_parity import NormalRecorder, cli_rows, to_numpy_tree


def test_one_rainbow_per_train_step_matches(monkeypatch):
    rainbow = jconfig.CONFIGS["rainbow"]
    network = dataclasses.replace(rainbow.network, hidden=32,
                                  compute_dtype="float32")
    learner = dataclasses.replace(rainbow.learner, batch_size=S,
                                  learning_rate=1e-3, target_update_period=1)
    jenv, jr, tr = _fill_rings("dmc_pixels")
    n_step, gamma = learner.n_step, learner.gamma
    alpha = rainbow.replay.priority_exponent
    beta = rainbow.replay.importance_exponent

    key = jax.random.PRNGKey(5)
    u01 = np.array((jnp.arange(S, dtype=jnp.float32)
                    + jax.random.uniform(key, (S,))) / S)
    js = jpring.prioritized_ring_sample(jr, key, S, n_step, gamma, alpha,
                                        jnp.float32(beta), use_pallas=False)
    ts = tpring.prioritized_ring_sample(tr, None, S, n_step, gamma, alpha,
                                        beta, use_kernel=False,
                                        u=torch.from_numpy(u01))
    np.testing.assert_array_equal(ts.t_idx.numpy(), np.asarray(js.t_idx))
    np.testing.assert_array_equal(ts.b_idx.numpy(), np.asarray(js.b_idx))
    _close(ts.weights.numpy(), js.weights, rtol=1e-6)
    for field in ("obs", "action", "reward", "discount", "next_obs"):
        _close(getattr(ts.batch, field).numpy(), getattr(js.batch, field),
               rtol=1e-6, atol=1e-7, err_msg=field)

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
    recorder = NormalRecorder()
    monkeypatch.setattr(jax.random, "normal", recorder)
    jl2, jm = j_step(jl, js.batch, js.weights)
    monkeypatch.undo()
    online, nxt, target = recorder.layer_noise(["advantage", "value"], 3)
    tl, tm = t_step(tl, ts.batch, ts.weights,
                    {"online": online, "next": nxt, "target": target})

    _close(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
    _close(tm["priorities"].numpy(), jm["priorities"], rtol=1e-5, atol=1e-6)
    _close(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-5)
    want = from_flax(to_numpy_tree(jl2.params), tnet)
    want_target = from_flax(to_numpy_tree(jl2.target_params), tnet)
    for name, value in tl.net.state_dict().items():
        _close(value.numpy(), want[name].numpy(), rtol=1e-5, atol=1e-6,
               err_msg=name)
    for name, value in tl.target_net.state_dict().items():
        _close(value.numpy(), want_target[name].numpy(), rtol=1e-5,
               atol=1e-6, err_msg=name)

    eps = rainbow.replay.priority_eps
    jr = jpring.prioritized_ring_update(jr, js.t_idx, js.b_idx,
                                        jm["priorities"], eps=eps)
    tpring.prioritized_ring_update(tr, ts.t_idx, ts.b_idx, tm["priorities"],
                                   eps=eps)
    _close(tr.priorities.numpy(), jr.priorities, rtol=1e-5, atol=1e-6)
    _close(float(tr.max_priority), float(jr.max_priority), rtol=1e-5)


# Tiny widths of the four presets' networks and rings.
_TINY = ["network.torso=small", "network.hidden=32",
         "network.compute_dtype=float32", "replay.capacity=512",
         "replay.min_fill=64", "learner.batch_size=8", "actor.num_envs=8",
         "train_every=2"]
_HEADS = {"rainbow": ["network.num_atoms=11"],
          "qrdqn": ["network.num_atoms=9"],
          "iqn": ["network.iqn_embed_dim=16", "network.iqn_tau_samples=8",
                  "network.iqn_tau_target_samples=8",
                  "network.iqn_tau_act=8"],
          "mdqn": []}


@pytest.mark.parametrize("preset", sorted(_HEADS))
def test_distributional_fused_loop_runs_on_cpu(monkeypatch, preset):
    """Each preset at tiny widths through the fused loop, 30 iterations:
    grad steps past min_fill with finite loss and priorities, and every
    PER draw through the cumsum twin, never the sampler kernel's routing."""
    from dist_dqn_tpu_torch.train_loop import make_fused_train

    calls = []
    monkeypatch.setattr(tps, "plain_stratified_sample",
                        lambda w, u: calls.append(w.shape))
    cfg = tconfig.apply_overrides(tconfig.CONFIGS[preset],
                                  _TINY + _HEADS[preset])
    assert cfg.replay.prioritized and not cfg.replay.pallas_sampler
    env = make_env(cfg.env_name, device="cpu")
    net = torch_build(cfg.network, env.num_actions, env.observation_shape,
                      device="cpu")
    init, run_chunk = make_fused_train(cfg, env, net, device="cpu")
    carry, metrics = run_chunk(init(0), 30)
    # 64 transitions stored after iteration 7; then every other iteration.
    assert metrics["grad_steps_in_chunk"] == len(range(8, 30, 2))
    assert np.isfinite(float(metrics["loss"]))
    assert not calls
    assert bool(torch.isfinite(carry.replay.priorities).all())
    assert bool((carry.replay.priorities >= 0).all())
    assert all(bool(torch.isfinite(p).all())
               for p in carry.learner.net.parameters())


@pytest.mark.parametrize("preset", sorted(_HEADS))
def test_distributional_cli_with_dedup_ratio_and_bf16_actor(capsys, preset):
    """``--config rainbow|qrdqn|iqn|mdqn --device cpu`` at tiny widths, with
    the options of the feed-forward loop: a frame-dedup ring, replay ratio 2
    and the bf16 actor. No eval: a greedy PixelReacher episode runs its
    full 1,000 steps (the CartPole runs of tests/test_torch_slice.py cover
    the eval cadence with these heads)."""
    from dist_dqn_tpu_torch.train import main

    argv = ["--config", preset, "--device", "cpu", "--total-env-steps",
            "480", "--chunk-iters", "30", "--eval-every-steps", "0",
            "--set", "replay.frame_dedup=true", "--replay-ratio", "2",
            "--actor-dtype", "bfloat16"]
    for assignment in _TINY + _HEADS[preset]:
        argv += ["--set", assignment]
    main(argv)
    rows = cli_rows(capsys.readouterr().out)
    assert [r["env_frames"] for r in rows] == [240, 480]
    # Iterations 8..28 even train in the first chunk (the dedup ring's stack
    # context is stored by then), all 15 in the second; two steps each.
    assert [r["grad_steps_in_chunk"] for r in rows] == [22, 30]
    assert all(np.isfinite(r["loss"]) for r in rows)
