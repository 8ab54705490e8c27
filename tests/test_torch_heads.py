"""Port parity: the NoisyNet, C51, QR-DQN and IQN heads
(dist_dqn_tpu_torch/models/qnets.py) against the JAX package's, through
weights shared by ``utils/params.py from_flax``.

Every head type, dueling or not, in f32 and bf16 compute. Noise and taus
are injected: the JAX NoisyDense draws its noise from keys flax derives
from the module path, so the test records the normals the JAX forward
draws (``torch_parity.NormalRecorder``) and hands them to the port.
Tolerances: f32 outputs agree to atol 1e-5 (summation order in XLA and
torch's CPU matmuls differs); bf16 outputs round at other points in the
two frameworks and agree to 5% of the output scale, as the scalar heads
do (tests/test_torch_models.py). The noisy forward with the noise off is
the forward at zero noise, bit for bit; the acting fractions are exact.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dist_dqn_tpu import config as jconfig
from dist_dqn_tpu.models import build_network as jax_build
from dist_dqn_tpu_torch import config as tconfig
from dist_dqn_tpu_torch.loop_common import make_actor_param_cast
from dist_dqn_tpu_torch.models import build_network as torch_build
from dist_dqn_tpu_torch.utils.params import from_flax
from torch_parity import NormalRecorder, to_numpy_tree

A = 3
OBS_SHAPE = (6,)
HEADS = {
    "noisy": dict(noisy=True),
    "c51": dict(num_atoms=11, v_min=-5.0, v_max=5.0),
    "rainbow": dict(noisy=True, num_atoms=11, v_min=-5.0, v_max=5.0),
    "qr": dict(num_atoms=7, quantile=True),
    "noisy_qr": dict(noisy=True, num_atoms=7, quantile=True),
    "iqn": dict(iqn=True, iqn_embed_dim=16, iqn_tau_samples=5,
                iqn_tau_target_samples=4, iqn_tau_act=8),
}


def _cfg(head, dueling, dtype, **extra):
    return jconfig.NetworkConfig(torso="mlp", mlp_features=(32,), hidden=16,
                                 dueling=dueling, compute_dtype=dtype,
                                 **HEADS[head], **extra)


def _obs(n=5, seed=1):
    return np.random.default_rng(seed).normal(
        size=(n,) + OBS_SHAPE).astype(np.float32)


def _pair(cfg, obs_shape=OBS_SHAPE, obs=None):
    obs = _obs() if obs is None else obs
    jnet = jax_build(cfg, A)
    params = jnet.init(jax.random.PRNGKey(0), jnp.asarray(obs[:1]))
    tnet = torch_build(tconfig.NetworkConfig(**dataclasses.asdict(cfg)), A,
                       obs_shape, device="cpu")
    tnet.load_state_dict(from_flax(to_numpy_tree(params), tnet))
    return jnet, params, tnet, obs


def _close(got, want, dtype):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == np.float32 and got.shape == want.shape
    atol = 1e-5 if dtype == "float32" else 0.05 * np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


def _noisy_names(dueling):
    return ["advantage", "value"] if dueling else ["advantage"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dueling", [False, True])
@pytest.mark.parametrize("head", sorted(HEADS))
def test_forward_and_q_values_noise_off(head, dueling, dtype):
    """Raw head output and q_values with the noise off (IQN: at the acting
    fractions)."""
    jnet, params, tnet, obs = _pair(_cfg(head, dueling, dtype))
    x = torch.from_numpy(obs)
    with torch.no_grad():
        _close(tnet(x).numpy(), jnet.apply(params, jnp.asarray(obs)), dtype)
        _close(tnet.q_values(x).numpy(),
               jnet.apply(params, jnp.asarray(obs), method=jnet.q_values),
               dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dueling", [False, True])
@pytest.mark.parametrize("head", ["noisy", "rainbow", "noisy_qr"])
def test_noisy_forward_with_the_jax_noise(monkeypatch, head, dueling,
                                          dtype):
    jnet, params, tnet, obs = _pair(_cfg(head, dueling, dtype))
    recorder = NormalRecorder()
    monkeypatch.setattr(jax.random, "normal", recorder)
    want = jnet.apply(params, jnp.asarray(obs), add_noise=True,
                      rngs={"noise": jax.random.PRNGKey(9)})
    want_q = jnet.apply(params, jnp.asarray(obs), add_noise=True,
                        rngs={"noise": jax.random.PRNGKey(9)},
                        method=jnet.q_values)
    monkeypatch.undo()
    noise, noise_q = recorder.layer_noise(_noisy_names(dueling), 2)
    x = torch.from_numpy(obs)
    with torch.no_grad():
        got = tnet(x, noise)
        _close(got.numpy(), want, dtype)
        _close(tnet.q_values(x, noise_q).numpy(), want_q, dtype)
        # The noise moves the output; zero noise is the noise-off forward.
        assert not torch.equal(got, tnet(x))
        zero = {k: tuple(torch.zeros_like(e) for e in v)
                for k, v in noise.items()}
        assert torch.equal(tnet(x, zero), tnet(x))


def test_noisy_layer_draws_once_per_call_for_the_whole_batch():
    _, _, tnet, obs = _pair(_cfg("rainbow", True, "float32"))
    x = torch.from_numpy(np.concatenate([obs[:1]] * 4))
    with torch.no_grad():
        out = tnet(x, torch.Generator().manual_seed(0))
        again = tnet(x, torch.Generator().manual_seed(0))
    assert torch.equal(out, again)
    assert torch.equal(out[0], out[3])          # one draw, every row
    layer = tnet.advantage
    assert layer.sigma_w.shape == layer.mu_w.shape == (A * 11, 16)
    bound = 1 / np.sqrt(16)
    assert float(layer.mu_w.detach().abs().max()) <= bound
    np.testing.assert_allclose(layer.sigma_b.detach().numpy(), 0.5 * bound,
                               rtol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dueling", [False, True])
def test_iqn_at_given_taus(dueling, dtype):
    jnet, params, tnet, obs = _pair(_cfg("iqn", dueling, dtype))
    taus = np.random.default_rng(2).uniform(size=(obs.shape[0], 5)).astype(
        np.float32)
    want = jnet.apply(params, jnp.asarray(obs), taus=jnp.asarray(taus))
    x, t = torch.from_numpy(obs), torch.from_numpy(taus)
    with torch.no_grad():
        _close(tnet(x, t).numpy(), want, dtype)
        values, drawn = tnet.sample_quantiles(x, 5, t)
        assert drawn is t and torch.equal(values, tnet(x, t))
        values, drawn = tnet.sample_quantiles(x, 4,
                                              torch.Generator().manual_seed(0))
    assert values.shape == (obs.shape[0], A, 4) and drawn.shape == (5, 4)
    assert bool(((drawn >= 0) & (drawn < 1)).all())


@pytest.mark.parametrize("eta", [1.0, 0.25])
def test_iqn_act_taus_and_cvar_q_values(eta):
    cfg = _cfg("iqn", True, "float32", risk_cvar_eta=eta)
    jnet, params, tnet, obs = _pair(cfg)
    np.testing.assert_array_equal(tnet.act_taus().numpy(), jnet.act_taus())
    with torch.no_grad():
        _close(tnet.q_values(torch.from_numpy(obs)).numpy(),
               jnet.apply(params, jnp.asarray(obs), method=jnet.q_values),
               "float32")


@pytest.mark.parametrize("v_min,v_max,m", [(-10.0, 10.0, 51), (0.0, 200.0, 21),
                                           (-5.0, 5.0, 11)])
def test_c51_support_is_jnp_linspace(v_min, v_max, m):
    """``torch.linspace`` and ``jnp.linspace`` round a few atoms apart: to
    one ulp of the support's largest magnitude, no more."""
    cfg = jconfig.NetworkConfig(torso="mlp", mlp_features=(8,), hidden=0,
                                num_atoms=m, v_min=v_min, v_max=v_max)
    jnet = jax_build(cfg, A)
    tnet = torch_build(tconfig.NetworkConfig(**dataclasses.asdict(cfg)), A,
                       OBS_SHAPE, device="cpu")
    got, want = tnet.atoms().numpy(), np.asarray(jnet.atoms())
    assert got.dtype == want.dtype == np.float32
    ulp = np.spacing(np.float32(max(abs(v_min), abs(v_max))))
    np.testing.assert_allclose(got, want, rtol=0, atol=ulp)
    assert got[0] == v_min and got[-1] == v_max


@pytest.mark.parametrize("head", ["rainbow", "qr", "iqn"])
def test_bf16_actor_snapshot_keeps_f32_support(monkeypatch, head):
    """The bf16 actor casts every floating tensor of its copy. The support
    and the tau frequencies are made in f32 at use, so the snapshot's
    q_values equal the JAX net's on bf16-cast params (noisy weights formed
    in f32 from the rounded mu and sigma)."""
    cfg = _cfg(head, True, "float32")
    jnet, params, tnet, obs = _pair(cfg)
    snap = make_actor_param_cast("bfloat16")(tnet)
    assert all(p.dtype == torch.bfloat16 for p in snap.parameters())
    assert not any(b.is_floating_point() for b in snap.buffers())
    cast = jax.tree.map(lambda p: p.astype(jnp.bfloat16), params)
    recorder = NormalRecorder()
    monkeypatch.setattr(jax.random, "normal", recorder)
    noisy = HEADS[head].get("noisy", False)
    rngs = {"noise": jax.random.PRNGKey(4)} if noisy else None
    want = jnet.apply(cast, jnp.asarray(obs), add_noise=noisy, rngs=rngs,
                      method=jnet.q_values)
    monkeypatch.undo()
    noise = recorder.layer_noise(_noisy_names(True))[0] if noisy else None
    with torch.no_grad():
        got = snap.q_values(torch.from_numpy(obs), noise)
    _close(got.numpy(), want, "float32")
    if head == "rainbow":
        assert snap.atoms().dtype == torch.float32


def test_pixel_rainbow_head_bf16():
    """The rainbow preset's network (Nature CNN, dueling, noisy, C51, bf16)
    at a narrow hidden width, on pixels, with the JAX noise."""
    cfg = dataclasses.replace(jconfig.CONFIGS["rainbow"].network, hidden=32)
    obs = np.random.default_rng(3).integers(0, 256, (3, 84, 84, 4)).astype(
        np.uint8)
    jnet, params, tnet, _ = _pair(cfg, (84, 84, 4), obs)
    recorder = NormalRecorder()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "normal", recorder)
        want = jnet.apply(params, jnp.asarray(obs), add_noise=True,
                          rngs={"noise": jax.random.PRNGKey(1)},
                          method=jnet.q_values)
    noise = recorder.layer_noise(_noisy_names(True))[0]
    with torch.no_grad():
        got = tnet.q_values(torch.from_numpy(obs), noise)
    assert got.shape == (3, A)
    _close(got.numpy(), want, "bfloat16")


@pytest.mark.parametrize("fields", [
    dict(iqn=True, noisy=True), dict(iqn=True, num_atoms=51),
    dict(iqn=True, lstm_size=16), dict(iqn=True, risk_cvar_eta=0.0),
    dict(iqn=True, risk_cvar_eta=1.5), dict(lstm_size=16, noisy=True),
    dict(lstm_size=16, num_atoms=51)],
    ids=lambda f: ",".join(f"{k}={v}" for k, v in f.items()))
def test_build_network_raises_the_jax_value_errors(fields):
    cfg = dataclasses.replace(jconfig.NetworkConfig(torso="mlp"), **fields)
    with pytest.raises(ValueError) as want:
        jax_build(cfg, A)
    with pytest.raises(ValueError) as got:
        torch_build(tconfig.NetworkConfig(**dataclasses.asdict(cfg)), A,
                    OBS_SHAPE, device="cpu")
    assert str(got.value) == str(want.value)
