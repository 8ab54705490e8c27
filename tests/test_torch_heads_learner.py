"""Port parity: one learner step per head family (agents/dqn.py
``make_learner``) against the JAX package's ``train_step``.

C51 + NoisyNet + dueling (double-Q), QR-DQN, IQN and Munchausen-DQN, each
from shared weights, batch and IS weights. The noise and taus are the JAX
step's own: the normals its NoisyDense layers draw are recorded while the
un-jitted JAX step runs (``torch_parity.NormalRecorder``), and IQN's taus
are recomputed from the step's keys with the same ``sample_quantiles``
call; the port's step takes them through ``draws``. Loss, priorities,
grad norm, updated params and target params agree to f32 rtol 1e-5: the
sums of the forward and backward run in other orders in XLA and torch,
and Adam turns an ulp of gradient into an ulp of update, no more.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dist_dqn_tpu import config as jconfig
from dist_dqn_tpu.agents.dqn import make_learner as jax_make_learner
from dist_dqn_tpu.models import build_network as jax_build
from dist_dqn_tpu.types import Transition as JTransition
from dist_dqn_tpu_torch import config as tconfig
from dist_dqn_tpu_torch.agents.dqn import head_kind
from dist_dqn_tpu_torch.agents.dqn import make_learner as torch_make_learner
from dist_dqn_tpu_torch.models import build_network as torch_build
from dist_dqn_tpu_torch.types import Transition
from dist_dqn_tpu_torch.utils.params import from_flax
from torch_parity import NormalRecorder, to_numpy_tree

A, B = 4, 12
OBS_SHAPE = (6,)
MLP = dict(torso="mlp", mlp_features=(32,), hidden=16)

# family: (preset whose network and learner it takes, network overrides,
# learner overrides)
FAMILIES = {
    "c51_noisy_dueling": ("rainbow", dict(num_atoms=11, v_min=-3.0,
                                          v_max=3.0),
                          dict(target_update_period=1)),
    "qr": ("qrdqn", dict(num_atoms=9), dict(target_tau=0.05)),
    "qr_no_double": ("qrdqn", dict(num_atoms=9),
                     dict(double_dqn=False, target_update_period=1)),
    "iqn": ("iqn", dict(iqn_embed_dim=16, iqn_tau_samples=6,
                        iqn_tau_target_samples=5, iqn_tau_act=4),
            dict(target_update_period=1)),
    "iqn_cvar_no_double": ("iqn", dict(iqn_embed_dim=16, iqn_tau_samples=6,
                                       iqn_tau_target_samples=5,
                                       iqn_tau_act=4, risk_cvar_eta=0.5),
                           dict(double_dqn=False, target_tau=0.05)),
    "munchausen": ("mdqn", {}, dict(target_update_period=2)),
    "c51_no_double": ("rainbow", dict(num_atoms=11, noisy=False,
                                      dueling=False),
                      dict(double_dqn=False, target_update_period=1)),
}


def _configs(family):
    preset, net_over, learner_over = FAMILIES[family]
    cfg = jconfig.CONFIGS[preset]
    network = dataclasses.replace(cfg.network, compute_dtype="float32",
                                  **MLP, **net_over)
    learner = dataclasses.replace(cfg.learner, batch_size=B,
                                  learning_rate=1e-3, max_grad_norm=10.0,
                                  **learner_over)
    return network, learner


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    obs = rng.normal(size=(B,) + OBS_SHAPE).astype(np.float32)
    next_obs = rng.normal(size=(B,) + OBS_SHAPE).astype(np.float32)
    action = rng.integers(0, A, B).astype(np.int32)
    reward = (rng.normal(size=B) * 2).astype(np.float32)
    discount = (0.99 * (rng.uniform(size=B) < 0.8)).astype(np.float32)
    weights = rng.uniform(0.2, 1.0, B).astype(np.float32)
    return (obs, action, reward, discount, next_obs), weights


def _close(got, want, **kw):
    kw = {"rtol": 1e-5, "atol": 1e-6, **kw}
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **kw)


def _iqn_taus(jnet, jl, obs, next_obs):
    """The taus the JAX IQN step draws: its keys (dqn.py:197, :324) through
    the same ``sample_quantiles`` calls."""
    _, k_loss = jax.random.split(jl.rng)
    k_online, _, k_target = jax.random.split(k_loss, 3)
    ids = jnp.arange(B, dtype=jnp.uint32)
    _, online = jnet.apply(jl.params, obs, jnet.num_tau, example_ids=ids,
                           method=jnet.sample_quantiles,
                           rngs={"tau": k_online})
    _, target = jnet.apply(jl.target_params, next_obs, jnet.num_tau_target,
                           example_ids=ids, method=jnet.sample_quantiles,
                           rngs={"tau": k_target})
    return {"online": torch.from_numpy(np.array(online)),
            "target": torch.from_numpy(np.array(target))}


def _step_pair(family, monkeypatch):
    network, learner = _configs(family)
    fields, weights = _batch()
    jbatch = JTransition(*(jnp.asarray(x) for x in fields))
    tbatch = Transition(*(torch.from_numpy(x) for x in fields))
    jnet = jax_build(network, A)
    j_init, j_step = jax_make_learner(jnet, learner)
    jl = j_init(jax.random.PRNGKey(3), jbatch.obs[0])
    tnet = torch_build(tconfig.NetworkConfig(**dataclasses.asdict(network)),
                       A, OBS_SHAPE, device="cpu")
    tnet.load_state_dict(from_flax(to_numpy_tree(jl.params), tnet))
    t_init, t_step = torch_make_learner(
        tconfig.LearnerConfig(**dataclasses.asdict(learner)), tnet)
    tl = t_init(tnet)
    draws = None
    if network.iqn:
        draws = _iqn_taus(jnet, jl, jbatch.obs, jbatch.next_obs)
    recorder = NormalRecorder()
    monkeypatch.setattr(jax.random, "normal", recorder)
    jl2, jm = j_step(jl, jbatch, jnp.asarray(weights))     # un-jitted
    monkeypatch.undo()
    if network.noisy:
        names = ["advantage", "value"] if network.dueling else ["advantage"]
        # The JAX C51 branch's forwards: online, next-online, target.
        online, nxt, target = recorder.layer_noise(names, 3)
        draws = {"online": online, "next": nxt, "target": target}
    else:
        assert not recorder.draws
    tl, tm = t_step(tl, tbatch, torch.from_numpy(weights), draws)
    return network, learner, jl2, jm, tl, tm, tnet


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_one_train_step_matches(monkeypatch, family):
    network, learner, jl2, jm, tl, tm, tnet = _step_pair(family,
                                                         monkeypatch)
    want_kind = {"rainbow": "c51", "qrdqn": "qr", "iqn": "iqn",
                 "mdqn": "scalar"}[FAMILIES[family][0]]
    assert head_kind(tnet) == want_kind
    _close(float(tm["loss"]), float(jm["loss"]))
    _close(float(tm["raw_loss"]), float(jm["raw_loss"]))
    _close(tm["priorities"].numpy(), jm["priorities"])
    _close(float(tm["mean_q_target_gap"]), float(jm["mean_q_target_gap"]))
    _close(float(tm["grad_norm"]), float(jm["grad_norm"]))
    assert float(tm["grad_norm"]) > 0
    if want_kind != "scalar":
        # The distributional priorities are the per-example loss.
        _close(float(tm["raw_loss"]), float(tm["priorities"].mean()),
               rtol=1e-6)
    want = from_flax(to_numpy_tree(jl2.params), tnet)
    want_target = from_flax(to_numpy_tree(jl2.target_params), tnet)
    for name, value in tl.net.state_dict().items():
        _close(value.numpy(), want[name].numpy(), atol=1e-7, err_msg=name)
    for name, value in tl.target_net.state_dict().items():
        _close(value.numpy(), want_target[name].numpy(), atol=1e-7,
               err_msg=name)
    assert tl.steps == int(jl2.steps) == 1


@pytest.mark.parametrize("family", ["c51_noisy_dueling", "iqn"])
def test_generator_draws_fresh_noise_each_step(family):
    """Without injected draws the step draws from the learner generator:
    the same seed gives the same step, another seed another."""
    network, learner = _configs(family)
    fields, weights = _batch(1)
    batch = Transition(*(torch.from_numpy(x) for x in fields))
    tcfg = tconfig.NetworkConfig(**dataclasses.asdict(network))
    losses = []
    for seed in (0, 0, 1):
        net = torch_build(tcfg, A, OBS_SHAPE, device="cpu")
        t_init, t_step = torch_make_learner(
            tconfig.LearnerConfig(**dataclasses.asdict(learner)), net)
        state = t_init(net, torch.Generator().manual_seed(seed))
        before = state.generator.get_state()
        _, m = t_step(state, batch, torch.from_numpy(weights))
        assert not torch.equal(state.generator.get_state(), before)
        assert np.isfinite(float(m["loss"]))
        losses.append(float(m["loss"]))
    assert losses[0] == losses[1] != losses[2]


@pytest.mark.parametrize("change", [
    dict(net="rainbow"), dict(net="qrdqn"), dict(net="iqn"),
    dict(value_rescale=True), dict(n_step=3), dict(double_dqn=True)],
    ids=lambda c: ",".join(f"{k}={v}" for k, v in c.items()))
def test_munchausen_raises_the_jax_value_errors(change):
    change = dict(change)
    preset = change.pop("net", "mdqn")
    network = dataclasses.replace(jconfig.CONFIGS[preset].network, **MLP)
    learner = dataclasses.replace(jconfig.CONFIGS["mdqn"].learner, **change)
    with pytest.raises(ValueError) as want:
        jax_make_learner(jax_build(network, A), learner)
    tnet = torch_build(tconfig.NetworkConfig(**dataclasses.asdict(network)),
                       A, OBS_SHAPE, device="cpu")
    tlearner = tconfig.LearnerConfig(**dataclasses.asdict(learner))
    with pytest.raises(ValueError) as got:
        torch_make_learner(tlearner, tnet)
    assert str(got.value) == str(want.value)
