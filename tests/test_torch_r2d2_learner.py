"""Port parity of the R2D2 sequence learner (agents/r2d2.py), and of the
feed-forward learner's value rescaling (agents/dqn.py), against the JAX
package: one train step from shared weights on the same batch.

Loss, priorities, grad norm, and updated online and target params agree to
f32 rtol 1e-5 (atol 1e-6 on params near zero): forward and backward sums
run in other orders in XLA and torch, the LSTM compounds that over the
window, and Adam divides by ``sqrt(v) + eps``, which turns an ulp of
gradient into an ulp of update, no more. ``inv_value_rescale`` cancels near
1 (test_torch_r2d2_model.py): an ulp of its square root moves its output by
up to ``dy_dinner * inner * eps_f32``, and torch's vectorised CPU square root
is not always the correctly rounded one (ROADMAP.md C4). So value-rescaled
priorities get, beyond rtol 1e-5, that error carried through the target:
``_rescaled_td_atol``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dist_dqn_tpu import config as jconfig
from dist_dqn_tpu.agents.dqn import make_learner as jax_make_learner
from dist_dqn_tpu.agents.r2d2 import make_r2d2_learner as jax_r2d2_learner
from dist_dqn_tpu.models import build_network as jax_build
from dist_dqn_tpu.types import SequenceSample as JSample
from dist_dqn_tpu.types import Transition as JTransition
from dist_dqn_tpu_torch import config as tconfig
from dist_dqn_tpu_torch.agents.dqn import make_learner as torch_make_learner
from dist_dqn_tpu_torch.agents.r2d2 import make_r2d2_learner
from dist_dqn_tpu_torch.models import build_network as torch_build
from dist_dqn_tpu_torch.types import SequenceSample, Transition
from dist_dqn_tpu_torch.utils.params import from_flax
from torch_parity import to_numpy_tree

S, A, LSTM = 4, 3, 8


def _close(got, want, **kw):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **kw)


def _sample(rng, L, obs_shape, start_zero=False):
    """A SequenceSample as numpy arrays: a done at step 3 of sequence 1
    (and its reset at step 4), one of sequence 2 at the last step."""
    if len(obs_shape) == 3:
        obs = rng.integers(0, 256, (L, S) + obs_shape).astype(np.uint8)
    else:
        obs = rng.normal(size=(L, S) + obs_shape).astype(np.float32)
    done = np.zeros((L, S), bool)
    done[3, 1] = True
    done[L - 1, 2] = True
    reset = np.concatenate([np.zeros((1, S), bool), done[:-1]])
    start = [np.zeros((S, LSTM), np.float32) if start_zero
             else rng.normal(size=(S, LSTM)).astype(np.float32)
             for _ in range(2)]
    return dict(obs=obs, action=rng.integers(0, A, (L, S)).astype(np.int32),
                reward=(rng.normal(size=(L, S)) * 3).astype(np.float32),
                done=done, reset=reset, start_state=tuple(start),
                weights=rng.uniform(0.2, 1.0, S).astype(np.float32),
                t_idx=np.arange(S, dtype=np.int32),
                b_idx=np.zeros(S, np.int32))


def _rescaled_td_atol(q_boot, acc_r, acc_d, eps=1e-3):
    """The f32 error a TD error inherits from ``h(acc_r + acc_d h^-1(q))``,
    per leading index of ``q_boot`` [..., A] (the target net's q at the
    bootstrap step; every action, since either side may pick another a*):
    two ulps of the inverse's square root amplified by its conditioning
    (the bound of test_torch_r2d2_model.py), times ``acc_d`` and ``h'(u)``,
    plus the rounding of ``u`` and of ``h`` itself."""
    ulp = float(np.finfo(np.float32).eps)
    q = np.asarray(q_boot, np.float64)
    inner = np.sqrt(1.0 + 4.0 * eps * (np.abs(q) + 1.0 + eps))
    inv_err = 2 * np.abs(inner - 1.0) / (2.0 * eps ** 2) * inner * ulp + ulp
    inv = np.sign(q) * (np.square((inner - 1.0) / (2.0 * eps)) - 1.0)
    u = np.asarray(acc_r, np.float64)[..., None] + (
        np.asarray(acc_d, np.float64)[..., None] * inv)
    dh = 1.0 / (2.0 * np.sqrt(np.abs(u) + 1.0)) + eps
    h = np.sqrt(np.abs(u) + 1.0) - 1.0 + eps * np.abs(u)
    err = (dh * (np.asarray(acc_d, np.float64)[..., None] * inv_err
                 + 2 * ulp * np.abs(u)) + 4 * ulp * (h + 1.0))
    return err.max(axis=-1)


def _to_jax(d):
    return JSample(**{k: (tuple(jnp.asarray(x) for x in v)
                          if k == "start_state" else jnp.asarray(v))
                      for k, v in d.items()})


def _to_torch(d):
    def t(x):
        x = torch.from_numpy(x)
        return x.long() if x.dtype == torch.int32 else x
    return SequenceSample(**{k: (tuple(t(x) for x in v)
                                 if k == "start_state" else t(v))
                             for k, v in d.items()})


def _learners(net_cfg, obs_shape, lcfg, rcfg, example):
    jnet = jax_build(net_cfg, A)
    j_init, j_step = jax_r2d2_learner(jnet, lcfg, rcfg)
    jl = j_init(jax.random.PRNGKey(3), jnp.asarray(example))
    tnet = torch_build(tconfig.NetworkConfig(**dataclasses.asdict(net_cfg)),
                       A, obs_shape, device="cpu")
    tnet.load_state_dict(from_flax(to_numpy_tree(jl.params), tnet))
    t_init, t_step = make_r2d2_learner(
        tconfig.LearnerConfig(**dataclasses.asdict(lcfg)),
        tconfig.ReplayConfig(**dataclasses.asdict(rcfg)))
    return jnet, jl, j_step, tnet, t_init(tnet), t_step


@pytest.mark.parametrize("torso,value_rescale,double_dqn,target_tau,burn", [
    ("mlp", True, True, 0.0, 2),       # the preset's learner, hard sync
    ("mlp", False, True, 0.0, 2),
    ("mlp", True, False, 0.0, 2),      # max bootstrap
    ("mlp", True, True, 0.05, 2),      # Polyak sync
    ("mlp", False, False, 0.0, 0),     # no burn-in
    ("small", True, True, 0.0, 2),     # pixels through the small CNN
])
def test_r2d2_train_step_matches_jax(torso, value_rescale, double_dqn,
                                     target_tau, burn):
    unroll, n = 4, 2
    L = burn + unroll + n
    obs_shape = (4,) if torso == "mlp" else (84, 84, 4)
    net_cfg = jconfig.NetworkConfig(torso=torso, mlp_features=(16,),
                                    hidden=12, dueling=True, lstm_size=LSTM)
    lcfg = dataclasses.replace(
        jconfig.CONFIGS["r2d2"].learner, learning_rate=1e-3, n_step=n,
        value_rescale=value_rescale, double_dqn=double_dqn,
        target_tau=target_tau, target_update_period=1)
    rcfg = dataclasses.replace(jconfig.CONFIGS["r2d2"].replay, burn_in=burn,
                               unroll_length=unroll)
    d = _sample(np.random.default_rng(5), L, obs_shape)
    _, jl, j_step, tnet, tl, t_step = _learners(net_cfg, obs_shape, lcfg,
                                                rcfg, d["obs"][0, 0])
    prio_atol = 1e-6
    if value_rescale:     # the target net's q over the window: the bootstrap
        sample = _to_torch(d)
        with torch.no_grad():
            _, q_all = tnet.unroll(sample.start_state, sample.obs,
                                   sample.reset)
        r = d["reward"][burn:].astype(np.float64)
        disc = lcfg.gamma * (1.0 - d["done"][burn:].astype(np.float64))
        acc_r, acc_d = np.zeros((unroll, S)), np.ones((unroll, S))
        for j in range(n):
            acc_r, acc_d = acc_r + acc_d * r[j:j + unroll], (
                acc_d * disc[j:j + unroll])
        prio_atol = _rescaled_td_atol(
            q_all.numpy()[burn + n:burn + n + unroll], acc_r,
            acc_d).max(axis=0)
    jl2, jm = jax.jit(j_step)(jl, _to_jax(d))
    tl, tm = t_step(tl, _to_torch(d))

    _close(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
    _close(float(tm["raw_loss"]), float(jm["raw_loss"]), rtol=1e-5)
    np.testing.assert_array_less(
        np.abs(tm["priorities"].numpy() - np.asarray(jm["priorities"])),
        1e-5 * np.abs(np.asarray(jm["priorities"])) + prio_atol)
    _close(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-5)
    want = from_flax(to_numpy_tree(jl2.params), tnet)
    want_target = from_flax(to_numpy_tree(jl2.target_params), tnet)
    for name, value in tl.net.state_dict().items():
        _close(value.numpy(), want[name].numpy(), rtol=1e-5, atol=1e-6,
               err_msg=name)
    for name, value in tl.target_net.state_dict().items():
        _close(value.numpy(), want_target[name].numpy(), rtol=1e-5,
               atol=1e-6, err_msg=name)
    assert tl.steps == int(jl2.steps) == 1


def _numpy_r2d2_targets(q_online, q_target, rewards, dones, actions, burn,
                        unroll, n, gamma):
    """Naive per-sequence reference for the within-window n-step TD error
    (the reference of ``tests/test_r2d2.py``)."""
    td = np.zeros((unroll, rewards.shape[1]))
    for s in range(rewards.shape[1]):
        for k in range(unroll):
            ret, disc = 0.0, 1.0
            for j in range(n):
                ret += disc * rewards[burn + k + j, s]
                disc *= gamma * (1.0 - float(dones[burn + k + j, s]))
            a_star = int(np.argmax(q_online[k + n, s]))
            target = ret + disc * q_target[k + n, s, a_star]
            td[k, s] = q_online[k, s, actions[burn + k, s]] - target
    return td


def test_r2d2_learner_td_matches_numpy():
    burn, unroll, n, gamma = 2, 3, 2, 0.9
    L = burn + unroll + n
    net_cfg = tconfig.NetworkConfig(torso="mlp", mlp_features=(16,),
                                    hidden=0, dueling=True, lstm_size=LSTM)
    net = torch_build(net_cfg, A, (4,), device="cpu")
    lcfg = tconfig.LearnerConfig(gamma=gamma, n_step=n, double_dqn=True,
                                 value_rescale=False, huber_delta=1.0)
    rcfg = tconfig.ReplayConfig(burn_in=burn, unroll_length=unroll,
                                priority_mix=0.9)
    init, train_step = make_r2d2_learner(lcfg, rcfg)
    d = _sample(np.random.default_rng(0), L, (4,), start_zero=True)
    d["weights"] = np.ones(S, np.float32)
    sample = _to_torch(d)
    with torch.no_grad():    # online == target before the step
        _, q_all = net.unroll(net.initial_state(S), sample.obs, sample.reset)
    q_all = q_all.numpy()[burn:]
    td_ref = _numpy_r2d2_targets(q_all, q_all, d["reward"], d["done"],
                                 d["action"], burn, unroll, n, gamma)
    prio_ref = 0.9 * np.abs(td_ref).max(0) + 0.1 * np.abs(td_ref).mean(0)
    _, metrics = train_step(init(net), sample)
    _close(metrics["priorities"].numpy(), prio_ref, atol=1e-5)


def test_r2d2_learner_refuses_what_jax_refuses():
    with pytest.raises(ValueError, match="unroll_length"):
        make_r2d2_learner(tconfig.LearnerConfig(), tconfig.ReplayConfig())
    with pytest.raises(ValueError, match="munchausen"):
        make_r2d2_learner(tconfig.LearnerConfig(munchausen=True),
                          tconfig.ReplayConfig(unroll_length=4))


@pytest.mark.parametrize("double_dqn", [True, False])
def test_feed_forward_value_rescale_step_matches_jax(double_dqn):
    """The feed-forward learner with ``learner.value_rescale``: h^-1 on the
    bootstrap, h on the target, as ``dist_dqn_tpu/agents/dqn.py:304-308``."""
    rng = np.random.default_rng(6)
    batch = 8
    net_cfg = jconfig.NetworkConfig(torso="mlp", mlp_features=(32,),
                                    hidden=16, dueling=True)
    lcfg = dataclasses.replace(
        jconfig.CONFIGS["apex"].learner, batch_size=batch,
        learning_rate=1e-3, value_rescale=True, double_dqn=double_dqn,
        target_update_period=1)
    obs, next_obs = (rng.normal(size=(batch, 4)).astype(np.float32)
                     for _ in range(2))
    action = rng.integers(0, 2, batch).astype(np.int32)
    reward = (rng.normal(size=batch) * 20).astype(np.float32)
    discount = np.where(rng.uniform(size=batch) < 0.2, 0.0,
                        0.97).astype(np.float32)
    weights = rng.uniform(0.2, 1.0, batch).astype(np.float32)

    jnet = jax_build(net_cfg, 2)
    j_init, j_step = jax_make_learner(jnet, lcfg)
    jl = j_init(jax.random.PRNGKey(3), jnp.asarray(obs[0]))
    jl2, jm = jax.jit(j_step)(jl, JTransition(
        obs=jnp.asarray(obs), action=jnp.asarray(action),
        reward=jnp.asarray(reward), discount=jnp.asarray(discount),
        next_obs=jnp.asarray(next_obs)), jnp.asarray(weights))

    tnet = torch_build(tconfig.NetworkConfig(**dataclasses.asdict(net_cfg)),
                       2, (4,), device="cpu")
    tnet.load_state_dict(from_flax(to_numpy_tree(jl.params), tnet))
    with torch.no_grad():
        prio_atol = _rescaled_td_atol(tnet(torch.from_numpy(next_obs)).numpy(),
                                      reward, discount)
    t_init, t_step = torch_make_learner(
        tconfig.LearnerConfig(**dataclasses.asdict(lcfg)), tnet)
    tl, tm = t_step(t_init(tnet), Transition(
        obs=torch.from_numpy(obs), action=torch.from_numpy(action).long(),
        reward=torch.from_numpy(reward),
        discount=torch.from_numpy(discount),
        next_obs=torch.from_numpy(next_obs)), torch.from_numpy(weights))

    _close(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
    np.testing.assert_array_less(
        np.abs(tm["priorities"].numpy() - np.asarray(jm["priorities"])),
        1e-5 * np.abs(np.asarray(jm["priorities"])) + prio_atol)
    want = from_flax(to_numpy_tree(jl2.params), tnet)
    for name, value in tl.net.state_dict().items():
        _close(value.numpy(), want[name].numpy(), rtol=1e-5, atol=1e-6,
               err_msg=name)
