"""The port's replay-ratio engine and bf16 actor split (the twins of
tests/test_replay_ratio.py).

* The last-wins scatter and the batched PER write-back equal the JAX
  package's on collision-heavy index streams, bit for bit.
* Uniform ``replay.updates_per_chunk=N`` is ``updates_per_train=N``, bit
  for bit, inside the port (same sub-steps, same generator stream).
* PER at ratio N draws through the sampler wrapper once per grad step and
  flushes its write-backs once per train event.
* The bf16 actor snapshot: its weights are the JAX package's bf16 cast of
  the same params exactly, its Q-values match JAX's cast-params forward
  (f32 nets to f32 rtol 1e-5: both compute in f32 on the same rounded
  weights; bf16 nets to the 5 %-of-scale bar), and acting never touches
  the learner's f32 masters.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dist_dqn_tpu import loop_common as jloop
from dist_dqn_tpu.config import NetworkConfig as JNetworkConfig
from dist_dqn_tpu.models import build_network as jax_build
from dist_dqn_tpu.replay import device as jring
from dist_dqn_tpu.replay import prioritized_device as jpring
from dist_dqn_tpu_torch import config as tconfig
from dist_dqn_tpu_torch import loop_common
from dist_dqn_tpu_torch.envs import make_env
from dist_dqn_tpu_torch.models import build_network as torch_build
from dist_dqn_tpu_torch.ops import sampler as tps
from dist_dqn_tpu_torch.replay import device as tring
from dist_dqn_tpu_torch.replay import prioritized_device as tpring
from dist_dqn_tpu_torch.train_loop import make_fused_train
from dist_dqn_tpu_torch.utils.params import from_flax
from torch_parity import to_numpy_tree


@pytest.mark.parametrize("seed", range(4))
def test_last_write_wins_scatter_matches_jax(seed):
    rng = np.random.default_rng(seed)
    n, m = 32, 96                       # three writes a slot on average
    plane = rng.normal(size=n).astype(np.float32)
    idx = rng.integers(0, n, size=m).astype(np.int32)
    vals = rng.normal(size=m).astype(np.float32)
    ref = plane.copy()
    for i, v in zip(idx, vals):         # chronological: later wins
        ref[i] = v
    want = np.asarray(jring.last_write_wins_scatter(
        jnp.asarray(plane), jnp.asarray(idx), jnp.asarray(vals)))
    got = tring.last_write_wins_scatter(
        torch.from_numpy(plane), torch.from_numpy(idx),
        torch.from_numpy(vals)).numpy()
    np.testing.assert_array_equal(want, ref)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("seed", range(3))
def test_batched_writeback_matches_jax(seed):
    """[N, S] sub-step draws with many duplicates (within and across
    sub-steps) land as JAX's flush lands them, max_priority included."""
    rng = np.random.default_rng(10 + seed)
    T, B, N, S = 8, 4, 3, 16
    ex = np.zeros((2,), np.float32)
    js = jpring.prioritized_ring_init(T, B, jnp.asarray(ex))
    ts = tpring.prioritized_ring_init(T, B, torch.from_numpy(ex))
    seed_plane = rng.uniform(0.1, 2.0, (T, B)).astype(np.float32)
    js = js._replace(priorities=jnp.asarray(seed_plane))
    ts.priorities.copy_(torch.from_numpy(seed_plane))
    t_idx = rng.integers(0, 3, (N, S)).astype(np.int32)   # 12 cells, 48 writes
    b_idx = rng.integers(0, B, (N, S)).astype(np.int32)
    prios = rng.normal(size=(N, S)).astype(np.float32) * 3
    js = jpring.prioritized_ring_update_batched(
        js, jnp.asarray(t_idx), jnp.asarray(b_idx), jnp.asarray(prios),
        eps=0.5)
    tpring.prioritized_ring_update_batched(
        ts, torch.from_numpy(t_idx), torch.from_numpy(b_idx),
        torch.from_numpy(prios), eps=0.5)
    np.testing.assert_array_equal(ts.priorities.numpy(),
                                  np.asarray(js.priorities))
    assert float(ts.max_priority) == float(js.max_priority)


def test_batched_writeback_last_wins_by_hand():
    state = tpring.prioritized_ring_init(8, 4, torch.zeros(2))
    # Three sub-steps of two rows: slot (1, 2) written by sub-steps 0 and
    # 2, slot (3, 1) by sub-steps 1 and 2.
    t_idx = torch.tensor([[1, 3], [3, 5], [1, 3]], dtype=torch.int32)
    b_idx = torch.tensor([[2, 1], [1, 0], [2, 1]], dtype=torch.int32)
    prios = torch.tensor([[10.0, 20.0], [30.0, 40.0], [1.0, 2.0]])
    tpring.prioritized_ring_update_batched(state, t_idx, b_idx, prios,
                                           eps=0.5)
    got = state.priorities
    assert float(got[1, 2]) == 1.5 and float(got[3, 1]) == 2.5
    assert float(got[5, 0]) == 40.5 and float(state.max_priority) == 40.5
    assert int((got > 0).sum()) == 3


def _tiny_cfg(ratio=1, upt=1, prioritized=False, actor_dtype="float32",
              pallas_sampler=False):
    cfg = tconfig.CONFIGS["cartpole"]
    return dataclasses.replace(
        cfg,
        actor=dataclasses.replace(cfg.actor, num_envs=8),
        network=dataclasses.replace(cfg.network, torso="mlp",
                                    mlp_features=(32,), hidden=0,
                                    compute_dtype="float32",
                                    actor_dtype=actor_dtype),
        replay=dataclasses.replace(cfg.replay, capacity=2048, min_fill=64,
                                   prioritized=prioritized,
                                   pallas_sampler=pallas_sampler,
                                   updates_per_chunk=ratio),
        learner=dataclasses.replace(cfg.learner, batch_size=16),
        updates_per_train=upt)


def _run(cfg, chunks=3, iters=40):
    env = make_env(cfg.env_name, device="cpu")
    net = torch_build(cfg.network, env.num_actions, env.observation_shape,
                      device="cpu")
    init, run_chunk = make_fused_train(cfg, env, net, device="cpu")
    carry = init(0)
    steps = 0
    for _ in range(chunks):
        carry, metrics = run_chunk(carry, iters)
        steps += metrics["grad_steps_in_chunk"]
    return carry, steps


def test_uniform_ratio_equals_serial_updates():
    """Ratio N == updates_per_train N, bit for bit, with N x the grad
    steps of ratio 1."""
    _, g1 = _run(_tiny_cfg(ratio=1))
    c4, g4 = _run(_tiny_cfg(ratio=4))
    cu, gu = _run(_tiny_cfg(ratio=1, upt=4))
    assert g4 == gu == 4 * g1 > 0
    for (name, a), b in zip(c4.learner.net.state_dict().items(),
                            cu.learner.net.state_dict().values()):
        assert torch.equal(a, b), name
        assert bool(torch.isfinite(a).all())


def test_per_ratio_draws_per_step_and_flushes_per_event(monkeypatch):
    calls = []
    plain = tps.plain_stratified_sample
    flushes = []
    batched = tpring.prioritized_ring_update_batched

    def spy(w, u):
        calls.append(tuple(w.shape))
        return plain(w, u)

    def spy_flush(state, t_idx, b_idx, prios, eps):
        flushes.append(tuple(t_idx.shape))
        return batched(state, t_idx, b_idx, prios, eps=eps)

    monkeypatch.setattr(tps, "plain_stratified_sample", spy)
    monkeypatch.setattr(tpring, "prioritized_ring_update_batched", spy_flush)
    _, g1 = _run(_tiny_cfg(ratio=1, prioritized=True, pallas_sampler=True))
    assert len(calls) == g1 > 0 and not flushes
    calls.clear()
    carry, g3 = _run(_tiny_cfg(ratio=3, prioritized=True,
                               pallas_sampler=True))
    assert g3 == 3 * g1 and len(calls) == g3
    assert flushes == [(3, 16)] * (g3 // 3)
    pr = carry.replay.priorities
    assert bool(torch.isfinite(pr).all()) and bool((pr >= 0).all())
    # The flushes landed: sampled slots moved off the max-priority seed.
    assert bool((pr[pr > 0] != carry.replay.max_priority).any())


def test_make_actor_param_cast_refuses_other_dtypes():
    with pytest.raises(ValueError):
        loop_common.make_actor_param_cast("float16")
    with pytest.raises(ValueError):
        loop_common.resolve_replay_ratio(_tiny_cfg(ratio=0))
    net = torch.nn.Linear(2, 2)
    assert loop_common.make_actor_param_cast("float32")(net) is net


@pytest.mark.parametrize("torso,compute_dtype,obs_shape", [
    ("mlp", "float32", (4,)),
    ("small", "float32", (84, 84, 4)),
    ("small", "bfloat16", (84, 84, 4)),
])
def test_bf16_snapshot_matches_jax_cast_forward(torso, compute_dtype,
                                                obs_shape):
    network = JNetworkConfig(torso=torso, mlp_features=(32, 32), hidden=16,
                             dueling=True, compute_dtype=compute_dtype)
    jnet = jax_build(network, 3)
    rng = np.random.default_rng(0)
    if len(obs_shape) == 3:
        obs = rng.integers(0, 255, (8,) + obs_shape).astype(np.uint8)
    else:
        obs = rng.normal(size=(8,) + obs_shape).astype(np.float32)
    params = jnet.init(jax.random.PRNGKey(1), jnp.asarray(obs[:1]))
    cast, active = jloop.make_actor_param_cast("bfloat16")
    q_jax = np.asarray(jnet.apply(cast(params), jnp.asarray(obs),
                                  method=jnet.q_values))

    tnet = torch_build(tconfig.NetworkConfig(**dataclasses.asdict(network)),
                       3, obs_shape, device="cpu")
    tnet.load_state_dict(from_flax(to_numpy_tree(params["params"]), tnet))
    masters = {k: v.clone() for k, v in tnet.state_dict().items()}
    snapshot = loop_common.make_actor_param_cast("bfloat16")
    assert active
    actor = snapshot(tnet)
    # The snapshot's weights are JAX's bf16 cast of the same params.
    want = from_flax(to_numpy_tree(jax.tree.map(
        lambda x: x.astype(jnp.float32), cast(params)["params"])), tnet)
    for name, value in actor.state_dict().items():
        assert value.dtype == torch.bfloat16, name
        assert torch.equal(value.float(), want[name]), name
    with torch.no_grad():
        q = actor.q_values(torch.from_numpy(obs)).numpy()
    assert q.dtype == np.float32 and q.shape == (8, 3)
    if compute_dtype == "float32":
        np.testing.assert_allclose(q, q_jax, rtol=1e-5, atol=1e-6)
    else:
        scale = max(float(np.abs(q_jax).max()), 1e-3)
        assert float(np.abs(q - q_jax).max()) <= 0.05 * scale
    # Acting left the f32 masters as they were.
    for name, value in tnet.state_dict().items():
        assert value.dtype == torch.float32
        assert torch.equal(value, masters[name]), name
    # A later snapshot refreshes the same copy from the updated masters.
    with torch.no_grad():
        for p in tnet.parameters():
            p.add_(0.25)
    again = snapshot(tnet)
    assert again is actor
    for (name, a), b in zip(again.state_dict().items(),
                            tnet.state_dict().values()):
        assert torch.equal(a, b.to(torch.bfloat16)), name


def test_bf16_actor_loop_keeps_fp32_masters():
    """The fused loop with the bf16 actor and ratio 2: the learner's net
    stays float32 and trains, and the chunk acts on the snapshot."""
    cfg = _tiny_cfg(ratio=2, actor_dtype="bfloat16")
    carry, steps = _run(cfg)
    assert steps > 0
    for name, value in carry.learner.net.state_dict().items():
        assert value.dtype == torch.float32, name
        assert bool(torch.isfinite(value).all()), name
