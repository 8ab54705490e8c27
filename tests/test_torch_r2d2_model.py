"""Port parity of the R2D2 network pieces: value rescaling, the recurrent
Q-network and ``from_flax`` on its tree, against the JAX package.

Tolerances: ``value_rescale`` elementwise rtol 1e-6 plus one f32 ulp of
1.0 (``sqrt(|x| + 1) - 1`` cancels to that absolute precision for small
x). ``inv_value_rescale`` squares ``(inner - 1) / 2e-3`` with ``inner =
sqrt(1 + 4e-3 (|x| + 1 + eps))`` near 1, so one f32 ulp of ``inner`` moves
the result by ``|dy/d inner| ulp(inner)``; the two agree to two such ulps
(XLA's own jitted and eager results differ by as much). float32 forwards
atol 1e-5 (summation order
in the matmuls and convs differs between XLA and torch's CPU kernels, and
the cell compounds it over a few steps). bf16 forwards round at other
points in the two frameworks (XLA even drops some bf16 round trips), so
they agree to 5 % of the output scale, the bar of the feed-forward bf16
network (test_torch_models.py).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dist_dqn_tpu import config as jconfig
from dist_dqn_tpu.models import build_network as jax_build
from dist_dqn_tpu.ops import losses as jlosses
from dist_dqn_tpu_torch import config as tconfig
from dist_dqn_tpu_torch.models import build_network as torch_build
from dist_dqn_tpu_torch.models.recurrent import RecurrentQNetwork
from dist_dqn_tpu_torch.ops import losses as tlosses
from dist_dqn_tpu_torch.utils.params import from_flax
from torch_parity import to_numpy_tree

L, B, LSTM = 6, 3, 8


def _net_cfg(torso="mlp", dtype="float32", lstm_dtype="float32",
             remat=False):
    return jconfig.NetworkConfig(
        torso=torso, mlp_features=(16,), hidden=12, dueling=True,
        lstm_size=LSTM, compute_dtype=dtype, lstm_dtype=lstm_dtype,
        remat_torso=remat, lstm_unroll=2)


def _obs(torso, n_lead=(L, B), seed=0):
    rng = np.random.default_rng(seed)
    if torso == "mlp":
        return rng.normal(size=n_lead + (4,)).astype(np.float32)
    return rng.integers(0, 256, n_lead + (84, 84, 4)).astype(np.uint8)


def _pair(net_cfg, obs_shape, num_actions=3, seed=0):
    """(JAX net, its params, the port's net with the same weights)."""
    jnet = jax_build(net_cfg, num_actions)
    example = jnp.zeros((1, 1) + obs_shape,
                        jnp.uint8 if len(obs_shape) == 3 else jnp.float32)
    params = jnet.init(jax.random.PRNGKey(seed), jnet.initial_state(1),
                       example, method=jnet.unroll)
    tnet = torch_build(tconfig.NetworkConfig(**dataclasses.asdict(net_cfg)),
                       num_actions, obs_shape, device="cpu")
    tnet.load_state_dict(from_flax(to_numpy_tree(params), tnet))
    return jnet, params, tnet


def _carry(seed=1, n=B):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=(n, LSTM)).astype(np.float32)
                 for _ in range(2))


def _resets():
    reset = np.zeros((L, B), bool)
    reset[2, 1] = True
    reset[4, 0] = True
    return reset


def test_value_rescale_matches_and_round_trips():
    rng = np.random.default_rng(3)
    x = (rng.normal(size=512) * np.logspace(-3, 3, 512)).astype(np.float32)
    x[:3] = [0.0, 1.0, -1.0]
    ulp = np.finfo(np.float32).eps
    got = tlosses.value_rescale(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jlosses.value_rescale(
        jnp.asarray(x))), rtol=1e-6, atol=ulp)
    inv = tlosses.inv_value_rescale(torch.from_numpy(got)).numpy()
    want = np.asarray(jlosses.inv_value_rescale(jnp.asarray(got)))
    eps = 1e-3
    inner = np.sqrt(1.0 + 4.0 * eps * (np.abs(got.astype(np.float64))
                                       + 1.0 + eps))
    dy_dinner = np.abs(inner - 1.0) / (2.0 * eps ** 2)
    # Two ulps of the inverse's square root, amplified by its conditioning:
    # both the two sides' difference and the round trip's error.
    bound = 2 * dy_dinner * inner * ulp + ulp
    np.testing.assert_array_less(np.abs(inv - want), bound)
    np.testing.assert_array_less(np.abs(inv - x), bound)


@pytest.mark.parametrize("torso", ["mlp", "small"])
def test_recurrent_unroll_f32_matches_jax(torso):
    """Unroll from a given carry with resets mid-sequence, then a burn-in
    style split: unrolling the first steps and continuing from their carry
    gives the same q and carries as the JAX net."""
    obs_shape = (4,) if torso == "mlp" else (84, 84, 4)
    jnet, params, tnet = _pair(_net_cfg(torso), obs_shape)
    obs, reset, (c0, h0) = _obs(torso), _resets(), _carry()
    (jc, jh), jq = jnet.apply(params, (jnp.asarray(c0), jnp.asarray(h0)),
                              jnp.asarray(obs), jnp.asarray(reset),
                              method=jnet.unroll)
    with torch.no_grad():
        burn = 2
        carry, q_burn = tnet.unroll(
            (torch.from_numpy(c0), torch.from_numpy(h0)),
            torch.from_numpy(obs[:burn]), torch.from_numpy(reset[:burn]))
        (tc, th), q_rest = tnet.unroll(carry, torch.from_numpy(obs[burn:]),
                                       torch.from_numpy(reset[burn:]))
    tq = torch.cat([q_burn, q_rest]).numpy()
    assert tq.dtype == np.float32 and tq.shape == (L, B, 3)
    np.testing.assert_allclose(tq, np.asarray(jq), rtol=0, atol=1e-5)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0, atol=1e-5)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=0, atol=1e-5)


def test_recurrent_single_step_f32_matches_jax():
    jnet, params, tnet = _pair(_net_cfg(), (4,))
    obs, (c0, h0) = _obs("mlp", (B,)), _carry()
    reset = np.array([False, True, False])
    (jc, jh), jq = jnet.apply(params, (jnp.asarray(c0), jnp.asarray(h0)),
                              jnp.asarray(obs), jnp.asarray(reset))
    with torch.no_grad():
        (tc, th), tq = tnet((torch.from_numpy(c0), torch.from_numpy(h0)),
                            torch.from_numpy(obs), torch.from_numpy(reset))
    for got, want in ((tq, jq), (tc, jc), (th, jh)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-5)


@pytest.mark.parametrize("torso,dtype,lstm_dtype", [
    ("mlp", "float32", "bfloat16"),
    ("mlp", "bfloat16", "bfloat16"),
    ("small", "bfloat16", "bfloat16"),
])
def test_recurrent_bf16_matches_jax(torso, dtype, lstm_dtype):
    obs_shape = (4,) if torso == "mlp" else (84, 84, 4)
    jnet, params, tnet = _pair(_net_cfg(torso, dtype, lstm_dtype), obs_shape)
    obs, reset, (c0, h0) = _obs(torso), _resets(), _carry()
    (jc, _), jq = jnet.apply(params, (jnp.asarray(c0), jnp.asarray(h0)),
                             jnp.asarray(obs), jnp.asarray(reset),
                             method=jnet.unroll)
    with torch.no_grad():
        (tc, _), tq = tnet.unroll(
            (torch.from_numpy(c0), torch.from_numpy(h0)),
            torch.from_numpy(obs), torch.from_numpy(reset))
    assert tq.dtype == torch.float32 and tc.dtype == torch.float32
    jq = np.asarray(jq, np.float32)
    scale = np.abs(jq).max()
    np.testing.assert_allclose(tq.numpy(), jq, rtol=0, atol=0.05 * scale)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0,
                               atol=0.05 * np.abs(np.asarray(jc)).max())


def test_step_equals_unroll_and_reset_restarts():
    _, _, net = _pair(_net_cfg(), (4,))
    obs = torch.from_numpy(_obs("mlp"))
    carry0 = net.initial_state(B)
    with torch.no_grad():
        _, q_unroll = net.unroll(carry0, obs)
        carry, qs = carry0, []
        for t in range(L):
            carry, q = net(carry, obs[t])
            qs.append(q)
        np.testing.assert_allclose(torch.stack(qs).numpy(), q_unroll.numpy(),
                                   rtol=0, atol=1e-6)
        # A reset at step 3 restarts the hidden state: the tail equals a
        # fresh unroll of obs[3:] from zeros, whatever came before.
        reset = torch.zeros((L, B), dtype=torch.bool)
        reset[3] = True
        _, q_reset = net.unroll(carry0, obs, reset)
        _, q_fresh = net.unroll(net.initial_state(B), obs[3:])
        np.testing.assert_allclose(q_reset[3:].numpy(), q_fresh.numpy(),
                                   rtol=0, atol=1e-6)


def test_remat_torso_same_outputs_and_grads():
    nets = [_pair(_net_cfg(remat=flag), (4,))[2] for flag in (False, True)]
    assert nets[1].remat_torso and not nets[0].remat_torso
    obs = torch.from_numpy(_obs("mlp"))
    outs = []
    for net in nets:
        _, q = net.unroll(net.initial_state(B), obs)
        loss = (q ** 2).sum()
        grads = torch.autograd.grad(loss, list(net.parameters()))
        outs.append((float(loss.detach()), grads))
    assert outs[0][0] == outs[1][0]
    for a, b in zip(outs[0][1], outs[1][1]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                   atol=1e-7)


def test_build_network_routes_lstm_to_the_recurrent_net():
    net = torch_build(tconfig.CONFIGS["r2d2"].network, 6, (84, 84, 4),
                      device="cpu")
    assert isinstance(net, RecurrentQNetwork)
    assert net.lstm_size == 512 and net.lstm_unroll == 8
    assert net.core.dtype == torch.bfloat16
    assert net.compute_dtype == torch.bfloat16
    shapes = {k: tuple(v.shape) for k, v in net.state_dict().items()}
    assert shapes["torso.embed.weight"] == (512, 3136)
    assert shapes["core.weight_ih"] == (2048, 512)
    assert shapes["core.weight_hh"] == (2048, 512)
    assert shapes["core.bias_hh"] == (2048,)
    assert shapes["advantage.weight"] == (6, 512)
    assert net.initial_state(2)[0].shape == (2, 512)


def test_from_flax_recurrent_tree_and_mismatch():
    jnet, params, tnet = _pair(_net_cfg("small"), (84, 84, 4))
    tree = to_numpy_tree(params)["params"]
    state = from_flax(tree, tnet)
    lstm = tree["core"]["lstm"]
    # The port's (i, f, o, g) stacking of flax's gate kernels.
    for k, gate in enumerate("ifog"):
        rows = slice(k * LSTM, (k + 1) * LSTM)
        np.testing.assert_array_equal(state["core.weight_ih"][rows].numpy(),
                                      lstm[f"i{gate}"]["kernel"].T)
        np.testing.assert_array_equal(state["core.weight_hh"][rows].numpy(),
                                      lstm[f"h{gate}"]["kernel"].T)
        np.testing.assert_array_equal(state["core.bias_hh"][rows].numpy(),
                                      lstm[f"h{gate}"]["bias"])
    np.testing.assert_array_equal(
        state["torso.body.convs.0.weight"].numpy(),
        np.transpose(tree["torso"]["CNNTorso_0"]["Conv_0"]["kernel"],
                     (3, 2, 0, 1)))
    # Trees that do not match the module raise KeyError.
    missing = {k: v for k, v in tree.items() if k != "value"}
    with pytest.raises(KeyError):
        from_flax(missing, tnet)
    extra_bias = {**tree, "core": {"lstm": {
        **lstm, "ii": {**lstm["ii"], "bias": np.zeros(LSTM, np.float32)}}}}
    with pytest.raises(KeyError):
        from_flax(extra_bias, tnet)
    no_gate = {**tree, "core": {"lstm": {
        k: v for k, v in lstm.items() if k != "ho"}}}
    with pytest.raises(KeyError):
        from_flax(no_gate, tnet)
    _, mlp_params, _ = _pair(_net_cfg("mlp"), (4,))
    with pytest.raises(KeyError):
        from_flax(to_numpy_tree(mlp_params), tnet)
