"""Port parity: Q-networks, losses and config (dist_dqn_tpu_torch models/,
ops/losses.py, config.py) against the JAX package.

Weights are shared through ``utils/params.py from_flax``; inputs are made
with numpy. float32 forwards agree to atol 1e-5 (summation order in the
convolutions and matmuls differs between XLA and torch's CPU kernels).
bf16 forwards round at other points in the two frameworks; they agree to
5% of the output scale (8 significant bits through up to five layers).
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
from dist_dqn_tpu_torch.ops import losses as tlosses
from dist_dqn_tpu_torch.utils.params import from_flax
from torch_parity import to_numpy_tree


def _pair(net_cfg, num_actions, obs_shape, obs, seed=0):
    """(JAX output, port output) of one forward through shared weights."""
    jnet = jax_build(net_cfg, num_actions)
    params = jnet.init(jax.random.PRNGKey(seed), jnp.asarray(obs[:1]))
    want = np.asarray(jnet.apply(params, jnp.asarray(obs)))
    tnet = torch_build(tconfig.NetworkConfig(**dataclasses.asdict(net_cfg)),
                       num_actions, obs_shape, device="cpu")
    tnet.load_state_dict(from_flax(to_numpy_tree(params), tnet))
    with torch.no_grad():
        got = tnet(torch.from_numpy(obs)).numpy()
    return want, got


def _pixels(n):
    return np.random.default_rng(0).integers(
        0, 256, (n, 84, 84, 4)).astype(np.uint8)


@pytest.mark.parametrize("dueling", [False, True])
@pytest.mark.parametrize("torso", ["mlp", "nature"])
def test_qnetwork_forward_f32(torso, dueling):
    if torso == "mlp":
        cfg = jconfig.NetworkConfig(torso="mlp", mlp_features=(64, 32),
                                    hidden=16, dueling=dueling)
        obs = np.random.default_rng(1).normal(size=(5, 4)).astype(np.float32)
        want, got = _pair(cfg, 2, (4,), obs)
    else:
        cfg = jconfig.NetworkConfig(torso="nature", hidden=512,
                                    dueling=dueling)
        want, got = _pair(cfg, 6, (84, 84, 4), _pixels(3))
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_qnetwork_forward_bf16():
    """The apex network (Nature CNN, dueling, bf16 compute)."""
    cfg = jconfig.CONFIGS["apex"].network
    want, got = _pair(cfg, 6, (84, 84, 4), _pixels(4))
    assert got.dtype == np.float32
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=0.05 * scale)


def test_build_network_refuses_later_heads():
    """The noisy, C51/QR and IQN heads are built; the head combinations the
    JAX package rejects raise its ValueError (tests/test_torch_heads.py
    compares the messages)."""
    for fields in (dict(noisy=True), dict(num_atoms=51), dict(iqn=True)):
        cfg = dataclasses.replace(tconfig.NetworkConfig(), **fields)
        torch_build(cfg, 6, (84, 84, 4), device="cpu")
    for fields in (dict(iqn=True, noisy=True), dict(iqn=True, num_atoms=51),
                   dict(lstm_size=16, noisy=True),
                   dict(lstm_size=16, num_atoms=51)):
        cfg = dataclasses.replace(tconfig.NetworkConfig(), **fields)
        with pytest.raises(ValueError):
            torch_build(cfg, 6, (84, 84, 4), device="cpu")


def test_losses_exact():
    rng = np.random.default_rng(2)
    x = (rng.normal(size=256) * 3).astype(np.float32)
    x[:3] = [1.0, -1.0, 0.0]
    for delta in (1.0, 0.5):
        np.testing.assert_array_equal(
            tlosses.huber(torch.from_numpy(x), delta).numpy(),
            np.asarray(jlosses.huber(jnp.asarray(x), delta)))
    q_online = rng.normal(size=(64, 6)).astype(np.float32)
    q_online[0] = 1.0                         # ties: first index wins
    q_target = rng.normal(size=(64, 6)).astype(np.float32)
    np.testing.assert_array_equal(
        tlosses.double_q_bootstrap(torch.from_numpy(q_online),
                                   torch.from_numpy(q_target)).numpy(),
        np.asarray(jlosses.double_q_bootstrap(jnp.asarray(q_online),
                                              jnp.asarray(q_target))))


def test_configs_equal_field_for_field():
    assert list(tconfig.CONFIGS) == list(jconfig.CONFIGS)
    for name, jcfg in jconfig.CONFIGS.items():
        assert dataclasses.asdict(tconfig.CONFIGS[name]) == \
            dataclasses.asdict(jcfg), name
    for cls in ("NetworkConfig", "ReplayConfig", "LearnerConfig",
                "ActorConfig", "PopulationConfig", "ExperimentConfig"):
        def defaults(module):
            return [(f.name, dataclasses.asdict(f.default)
                     if dataclasses.is_dataclass(f.default) else f.default)
                    for f in dataclasses.fields(getattr(module, cls))]
        assert defaults(tconfig) == defaults(jconfig), cls


@pytest.mark.parametrize("assignments", [
    ["network.dueling=true", "learner.batch_size=64",
     "replay.capacity=1e6", "network.mlp_features=(32,16)"],
    ["replay.store_final_obs=none", "learner.lr_schedule=linear"],
])
def test_apply_overrides_matches(assignments):
    want = jconfig.apply_overrides(jconfig.CONFIGS["apex"], assignments)
    got = tconfig.apply_overrides(tconfig.CONFIGS["apex"], assignments)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
