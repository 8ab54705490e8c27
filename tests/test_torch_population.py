"""Port parity: the population plane (dist_dqn_tpu_torch/population.py), M
stacked policies trained as one program, against the JAX package's.

Against the JAX package, on the CPU: the spec's parsing and checks, the
member seeds, configs and hyperparameters, the per-member epsilon, one
stacked learner step per head family (JAX's ``jax.vmap`` of
``make_learner`` with ``make_population_optimizer``), the stacked PER draw
(JAX's vmapped Pallas kernel in interpret mode) and the n-step fold with
per-member gammas. Port pins: an M = 1 run with a spec is the plain
program; member k of an M = 2 run is the solo run of member k's config and
seed, for every option of the fused loop; the stacked checkpoint round
trip, with a carry resume bit-equal to a run that never stopped; the CLI.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dist_dqn_tpu import config as jconfig
from dist_dqn_tpu import loop_common as jloop
from dist_dqn_tpu import population as jpop
from dist_dqn_tpu.agents import dqn as jdqn
from dist_dqn_tpu.models import build_network as jax_build
from dist_dqn_tpu.ops import pallas_sampler as jps
from dist_dqn_tpu.replay import device as jring
from dist_dqn_tpu.types import Transition as JTransition
from dist_dqn_tpu_torch import config as tconfig
from dist_dqn_tpu_torch import loop_common as tloop
from dist_dqn_tpu_torch import population as pop
from dist_dqn_tpu_torch.agents import dqn as tdqn
from dist_dqn_tpu_torch.envs import make_env
from dist_dqn_tpu_torch.models import build_network, stack_networks
from dist_dqn_tpu_torch.ops import sampler as tps
from dist_dqn_tpu_torch.replay import device as tring
from dist_dqn_tpu_torch.train import train
from dist_dqn_tpu_torch.train_loop import make_fused_train
from dist_dqn_tpu_torch.types import Transition
from dist_dqn_tpu_torch.utils.checkpoint import (TrainCheckpointer,
                                                 read_population_size,
                                                 state_tree)
from dist_dqn_tpu_torch.utils.params import from_flax
from torch_parity import NormalRecorder, assert_trees_equal, to_numpy_tree
from torch_parity import cli_rows

QUIET = lambda line: None  # noqa: E731
SPEC2 = json.dumps({"epsilon": [0.05, 0.2], "lr": [1e-3, 5e-4],
                    "gamma": [0.99, 0.97]})


def _tiny_cfg(size=1, spec_json="", **replay):
    """tests/test_population.py ``_tiny_cfg``: a cartpole MLP(32), 8 envs,
    batch 16, a 2,048-transition ring."""
    cfg = tconfig.CONFIGS["cartpole"]
    return dataclasses.replace(
        cfg,
        actor=dataclasses.replace(cfg.actor, num_envs=8),
        network=dataclasses.replace(cfg.network, torso="mlp",
                                    mlp_features=(32,), hidden=0,
                                    compute_dtype="float32"),
        replay=dataclasses.replace(cfg.replay, capacity=2048, min_fill=64,
                                   **replay),
        learner=dataclasses.replace(cfg.learner, batch_size=16),
        population=tconfig.PopulationConfig(size=size, spec_json=spec_json))


def _jax_cfg(cfg):
    """The JAX package's ExperimentConfig with the same fields."""
    def conv(obj, cls):
        return cls(**dataclasses.asdict(obj))
    return jconfig.ExperimentConfig(
        name=cfg.name, env_name=cfg.env_name,
        network=conv(cfg.network, jconfig.NetworkConfig),
        replay=conv(cfg.replay, jconfig.ReplayConfig),
        learner=conv(cfg.learner, jconfig.LearnerConfig),
        actor=conv(cfg.actor, jconfig.ActorConfig),
        population=conv(cfg.population, jconfig.PopulationConfig),
        total_env_steps=cfg.total_env_steps, train_every=cfg.train_every,
        updates_per_train=cfg.updates_per_train,
        eval_every_steps=cfg.eval_every_steps,
        eval_episodes=cfg.eval_episodes, seed=cfg.seed)


# --------------------------------------------------------------------------
# The spec, seeds, member configs and hyperparameters.
# --------------------------------------------------------------------------

# JAX test_spec_parsing_and_validation's cases: (text, size), and the
# substring its error names (None: accepted).
SPEC_CASES = [
    (SPEC2, 2, None),
    ("", 4, None),
    ("  ", 3, None),
    ('{"epsilon": [0, 1]}', 2, None),
    ("{nope", 2, "not valid JSON"),
    ("[1, 2]", 2, "JSON object"),
    ('{"tau": [1, 2]}', 2, "unknown keys"),
    ('{"lr": [0.001]}', 2, "length M"),
    ('{"lr": ["a", "b"]}', 2, "numbers"),
    ('{"lr": [true, false]}', 2, "numbers"),
    ('{"epsilon": [0.5, 1.5]}', 2, "epsilon"),
    ('{"lr": [0.001, 0.0]}', 2, "lr"),
    ('{"gamma": [0.99, 0.0]}', 2, "gamma"),
]


@pytest.mark.parametrize("text,size,error", SPEC_CASES)
def test_spec_parsing_matches_jax(text, size, error):
    if error is None:
        got = pop.parse_spec(text, size)
        want = jpop.parse_spec(text, size)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        return
    with pytest.raises(ValueError, match=error) as got:
        pop.parse_spec(text, size)
    with pytest.raises(ValueError) as want:
        jpop.parse_spec(text, size)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("schedule", ["constant", "cosine"])
def test_resolve_spec_lr_schedule_pin_matches_jax(schedule):
    cfg = _tiny_cfg(size=2, spec_json=json.dumps({"lr": [1e-3, 5e-4]}))
    cfg = dataclasses.replace(cfg, learner=dataclasses.replace(
        cfg.learner, lr_schedule=schedule, lr_decay_steps=100))
    if schedule == "constant":
        assert pop.resolve_spec(cfg).lr == jpop.resolve_spec(
            _jax_cfg(cfg)).lr == (1e-3, 5e-4)
        return
    with pytest.raises(ValueError, match="lr_schedule") as got:
        pop.resolve_spec(cfg)
    with pytest.raises(ValueError) as want:
        jpop.resolve_spec(_jax_cfg(cfg))
    assert str(got.value) == str(want.value)
    # The optimizer's own refusal, as the JAX make_population_optimizer's.
    with pytest.raises(ValueError) as got:
        tdqn.make_population_optimizer(cfg.learner, 2)
    with pytest.raises(ValueError) as want:
        jdqn.make_population_optimizer(_jax_cfg(cfg).learner)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("seed,size", [(0, 1), (7, 2), (123, 4), (2**31, 3)])
def test_member_seeds_match_jax(seed, size):
    assert pop.member_seeds(seed, size) == jpop.member_seeds(seed, size)
    # Width-independent: member k's stream does not depend on M.
    assert pop.member_seeds(seed, size + 1)[:size] == \
        pop.member_seeds(seed, size)


@pytest.mark.parametrize("k", [0, 1])
def test_member_config_matches_jax(k):
    cfg = _tiny_cfg(size=2, spec_json=SPEC2)
    got = pop.member_config(cfg, pop.resolve_spec(cfg), k)
    jcfg = _jax_cfg(cfg)
    want = jpop.member_config(jcfg, jpop.resolve_spec(jcfg), k)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.population.size == 1 and not got.population.spec_json


@pytest.mark.parametrize("spec", [SPEC2, json.dumps({"gamma": [0.9, 1.0]}),
                                  ""])
def test_member_hp_matches_jax_bits(spec):
    cfg = _tiny_cfg(size=2, spec_json=spec)
    cfg = dataclasses.replace(cfg, actor=dataclasses.replace(
        cfg.actor, epsilon_start=0.7, epsilon_end=0.013))
    got = pop.member_hp(cfg, pop.resolve_spec(cfg))
    jcfg = _jax_cfg(cfg)
    want = jpop.member_hp(jcfg, jpop.resolve_spec(jcfg))
    for name in ("eps_delta", "eps_end", "gamma", "lr"):
        w = np.asarray(getattr(want, name))
        g = getattr(got, name)
        if name == "lr" and '"lr"' not in spec:
            # The members share the config's schedule: no lr lanes.
            assert g is None
            continue
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy().view(np.uint32),
                                      w.view(np.uint32))


def test_member_epsilon_is_the_solo_schedule_bit_for_bit():
    """M = 3: make_member_epsilon at iterations 0 to steps + 5 equals JAX's
    vmapped eps_at, the JAX solo schedule and the port's solo schedule at
    each member's epsilon_end, bit for bit."""
    ends = [0.01, 0.1, 0.3333]
    cfg = _tiny_cfg(size=3, spec_json=json.dumps({"epsilon": ends}))
    cfg = dataclasses.replace(cfg, actor=dataclasses.replace(
        cfg.actor, epsilon_start=0.9, epsilon_decay_steps=8 * 37))
    B = cfg.actor.num_envs
    steps = cfg.actor.epsilon_decay_steps // B
    hp = pop.member_hp(cfg, pop.resolve_spec(cfg))
    jcfg = _jax_cfg(cfg)
    jhp = jpop.member_hp(jcfg, jpop.resolve_spec(jcfg))
    eps_at = tloop.make_member_epsilon(cfg, B)
    j_eps_at = jax.vmap(jloop.make_member_epsilon(jcfg, B, 1),
                        in_axes=(None, 0, 0))
    solo = [tloop.make_schedules(pop.member_config(cfg, pop.resolve_spec(cfg),
                                                   k), B)[0]
            for k in range(3)]
    jsolo = [jloop.make_schedules(jpop.member_config(
        jcfg, jpop.resolve_spec(jcfg), k), B, 1)[0] for k in range(3)]
    for it in range(steps + 6):
        got = eps_at(it, hp.eps_delta, hp.eps_end).numpy()
        want = np.asarray(j_eps_at(jnp.int32(it), jhp.eps_delta,
                                   jhp.eps_end))
        np.testing.assert_array_equal(got.view(np.uint32),
                                      want.view(np.uint32))
        for k in range(3):
            assert np.float32(solo[k](it)) == got[k]
            assert np.float32(jsolo[k](jnp.int32(it))) == got[k]


def test_extract_member_matches_jax():
    rng = np.random.default_rng(4)
    tree = {"a": rng.normal(size=(3, 2)).astype(np.float32),
            "b": [rng.normal(size=(3,)).astype(np.float32),
                  (rng.integers(0, 9, (3, 4, 2)),)]}
    ttree = {"a": torch.from_numpy(tree["a"]),
             "b": [torch.from_numpy(tree["b"][0]),
                   (torch.from_numpy(tree["b"][1][0]),)]}
    for k in range(3):
        got = pop.extract_member(ttree, k)
        want = jpop.extract_member(tree, k)
        np.testing.assert_array_equal(got["a"].numpy(), want["a"])
        np.testing.assert_array_equal(got["b"][0].numpy(), want["b"][0])
        np.testing.assert_array_equal(got["b"][1][0].numpy(),
                                      want["b"][1][0])


# --------------------------------------------------------------------------
# One stacked learner step per head family, against JAX's vmapped step.
# --------------------------------------------------------------------------

A, S, M = 4, 12, 2
OBS_SHAPE = (6,)
MLP = dict(torso="mlp", mlp_features=(32,), hidden=16)
LRS = (1e-3, 3e-4)
GAMMAS = (0.99, 0.9)

# family: (preset, network overrides, learner overrides, member 1's
# importance-weight scale)
FAMILIES = {
    "scalar_double": ("cartpole", {}, dict(target_update_period=1), 1.0),
    "dueling": ("apex", {}, dict(target_tau=0.05), 1.0),
    "c51_noisy": ("rainbow", dict(num_atoms=11, v_min=-3.0, v_max=3.0),
                  dict(target_update_period=1), 1.0),
    "qr": ("qrdqn", dict(num_atoms=9), dict(target_tau=0.05), 1.0),
    "iqn": ("iqn", dict(iqn_embed_dim=16, iqn_tau_samples=6,
                        iqn_tau_target_samples=5, iqn_tau_act=4),
            dict(target_update_period=1), 1.0),
    "munchausen": ("mdqn", {}, dict(target_update_period=2), 1.0),
    # Member 1's weights 100x: its gradient norm passes max_grad_norm and
    # member 0's does not, so a clip over the whole stack would scale
    # member 0 too.
    "clip_straddle": ("cartpole", {}, dict(target_update_period=1), 100.0),
}


def _family_configs(family):
    preset, net_over, learner_over, _ = FAMILIES[family]
    cfg = jconfig.CONFIGS[preset]
    network = dataclasses.replace(cfg.network, compute_dtype="float32",
                                  **MLP, **net_over)
    learner = dataclasses.replace(cfg.learner, batch_size=S,
                                  learning_rate=1e-3, max_grad_norm=10.0,
                                  lr_schedule="constant", **learner_over)
    return network, learner


def _member_batches(family):
    scale = FAMILIES[family][3]
    rng = np.random.default_rng(5)
    obs = rng.normal(size=(M, S) + OBS_SHAPE).astype(np.float32)
    next_obs = rng.normal(size=(M, S) + OBS_SHAPE).astype(np.float32)
    action = rng.integers(0, A, (M, S)).astype(np.int32)
    reward = (rng.normal(size=(M, S)) * 2).astype(np.float32)
    discount = (np.asarray(GAMMAS, np.float32)[:, None]
                * (rng.uniform(size=(M, S)) < 0.8)).astype(np.float32)
    weights = rng.uniform(0.2, 1.0, (M, S)).astype(np.float32)
    weights[1] *= scale
    return (obs, action, reward, discount, next_obs), weights


def _iqn_taus(jnet, jl, obs, next_obs):
    """The taus one JAX IQN step draws (dqn.py:197, :324)."""
    _, k_loss = jax.random.split(jl.rng)
    k_online, _, k_target = jax.random.split(k_loss, 3)
    ids = jnp.arange(S, dtype=jnp.uint32)
    _, online = jnet.apply(jl.params, obs, jnet.num_tau, example_ids=ids,
                           method=jnet.sample_quantiles,
                           rngs={"tau": k_online})
    _, target = jnet.apply(jl.target_params, next_obs, jnet.num_tau_target,
                           example_ids=ids, method=jnet.sample_quantiles,
                           rngs={"tau": k_target})
    return {"online": torch.from_numpy(np.array(online)),
            "target": torch.from_numpy(np.array(target))}


def _stack_draws(per_member):
    if isinstance(per_member[0], torch.Tensor):
        return torch.stack(per_member)
    if isinstance(per_member[0], dict):
        return {k: _stack_draws([d[k] for d in per_member])
                for k in per_member[0]}
    return tuple(_stack_draws(list(x)) for x in zip(*per_member))


def _close(got, want, **kw):
    kw = {"rtol": 1e-5, "atol": 1e-6, **kw}
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **kw)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_stacked_learner_step_matches_jax_vmap(monkeypatch, family):
    network, learner = _family_configs(family)
    fields, weights = _member_batches(family)
    jnet = jax_build(network, A)
    tx = jdqn.make_population_optimizer(learner)
    j_init, j_step = jdqn.make_learner(jnet, learner, tx=tx)
    keys = jax.random.split(jax.random.PRNGKey(3), M)
    obs0 = jnp.asarray(fields[0][0, 0])
    jl = jax.vmap(lambda k, lr: jdqn.set_member_lr(j_init(k, obs0), lr))(
        keys, jnp.asarray(LRS, jnp.float32))
    jbatch = JTransition(*(jnp.asarray(x) for x in fields))
    jweights = jnp.asarray(weights)

    # The draws of each member's step: the same keys, unbatched.
    draws = None
    if network.iqn:
        draws = _stack_draws([_iqn_taus(
            jnet, jpop.extract_member(jl, k), jbatch.obs[k],
            jbatch.next_obs[k]) for k in range(M)])
    elif network.noisy:
        names = ["advantage", "value"] if network.dueling else ["advantage"]
        per_member = []
        for k in range(M):
            recorder = NormalRecorder()
            monkeypatch.setattr(jax.random, "normal", recorder)
            j_step(jpop.extract_member(jl, k),
                   jpop.extract_member(jbatch, k), jweights[k])
            monkeypatch.undo()
            online, nxt, target = recorder.layer_noise(names, 3)
            per_member.append({"online": online, "next": nxt,
                               "target": target})
        draws = _stack_draws(per_member)
    jl2, jm = jax.vmap(j_step)(jl, jbatch, jweights)

    tcfg = tconfig.NetworkConfig(**dataclasses.asdict(network))
    nets = []
    for k in range(M):
        net = build_network(tcfg, A, OBS_SHAPE, device="cpu")
        net.load_state_dict(from_flax(to_numpy_tree(
            jpop.extract_member(jl.params, k)), net))
        nets.append(net)
    stacked = stack_networks(nets)
    tlearner = tconfig.LearnerConfig(**dataclasses.asdict(learner))
    t_init, t_step = tdqn.make_learner(
        tlearner, stacked, tdqn.make_population_optimizer(tlearner, M))
    tl = tdqn.set_member_lr(
        t_init(stacked, [torch.Generator() for _ in range(M)]),
        torch.tensor(LRS))
    tbatch = Transition(*(torch.from_numpy(x) for x in fields))
    tl, tm = t_step(tl, tbatch, torch.from_numpy(weights), draws)

    _close(tm["loss"].numpy(), jm["loss"])
    _close(tm["raw_loss"].numpy(), jm["raw_loss"])
    _close(tm["grad_norm"].numpy(), jm["grad_norm"])
    _close(tm["priorities"].numpy(), jm["priorities"])
    if family == "clip_straddle":
        norm = np.asarray(jm["grad_norm"])
        assert norm[0] < learner.max_grad_norm < norm[1]
    for k in range(M):
        want = from_flax(to_numpy_tree(jpop.extract_member(jl2.params, k)),
                         nets[k])
        want_t = from_flax(to_numpy_tree(jpop.extract_member(
            jl2.target_params, k)), nets[k])
        for name, value in tl.net.state_dict().items():
            _close(value[k].numpy(), want[name].numpy(), atol=1e-7,
                   err_msg=f"{k} {name}")
        for name, value in tl.target_net.state_dict().items():
            _close(value[k].numpy(), want_t[name].numpy(), atol=1e-7,
                   err_msg=f"{k} {name}")
    assert tl.steps == 1


# --------------------------------------------------------------------------
# The stacked PER draw and the n-step fold with per-member gammas.
# --------------------------------------------------------------------------

@pytest.mark.parametrize("T,B,S_,zero_frac", [(300, 16, 64, 0.3),
                                              (700, 8, 128, 0.9),
                                              (6, 3, 5, 0.5)])
def test_stacked_draw_matches_jax_vmapped_pallas(T, B, S_, zero_frac):
    """M = 3 planes of integer masses (whose sums are exact in float32 and
    float64 alike) at explicit [M, S] uniforms: the plain member-axis draw
    picks exactly the cells of JAX's vmapped kernel (interpret mode)."""
    rng = np.random.default_rng(11)
    w = rng.integers(1, 4, (3, T, B)).astype(np.float32)
    w[rng.uniform(size=(3, T, B)) < zero_frac] = 0.0
    u = ((np.arange(S_) + rng.uniform(size=(3, S_))) / S_).astype(np.float32)
    want = tuple(map(np.asarray, jax.vmap(
        lambda w, u: jps.pallas_stratified_sample(w, u, interpret=True))(
            jnp.asarray(w), jnp.asarray(u))))
    got = tuple(x.numpy() for x in tps.kernel_stratified_sample(
        torch.from_numpy(w), torch.from_numpy(u)))
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[2], want[2], rtol=1e-6)
    np.testing.assert_allclose(got[3], want[3], rtol=1e-5)
    assert got[0].shape == (3, S_) and got[3].shape == (3,)
    # Member m's draw is the 2-D draw on plane m alone.
    for m in range(3):
        solo = tps.plain_stratified_sample(torch.from_numpy(w[m]),
                                           torch.from_numpy(u[m]))
        for g, x in zip(got, solo):
            np.testing.assert_array_equal(g[m], x.numpy())


def test_stacked_cumsum_draw_is_each_members_draw():
    rng = np.random.default_rng(12)
    w = torch.from_numpy(rng.uniform(0.0, 2.0, (3, 50, 4)).astype(np.float32))
    u = torch.from_numpy(rng.uniform(size=(3, 16)).astype(np.float32))
    got = tps.stratified_sample_at(w, u)
    for m in range(3):
        for g, x in zip(got, tps.stratified_sample_at(w[m], u[m])):
            assert torch.equal(g[m], x)


def test_n_step_fold_with_member_gammas_matches_jax_vmap():
    rng = np.random.default_rng(13)
    Mm, Ss, n = 3, 40, 5
    reward = rng.normal(size=(Mm, Ss, n)).astype(np.float32)
    term = rng.uniform(size=(Mm, Ss, n)) < 0.15
    trunc = rng.uniform(size=(Mm, Ss, n)) < 0.1
    gammas = np.asarray([0.99, 0.9, 0.5], np.float32)
    want = jax.vmap(jring.compute_n_step)(
        jnp.asarray(reward), jnp.asarray(term), jnp.asarray(trunc),
        jnp.asarray(gammas))
    got = tring.compute_n_step(torch.from_numpy(reward),
                               torch.from_numpy(term),
                               torch.from_numpy(trunc),
                               torch.from_numpy(gammas))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_member_writeback_stays_in_its_plane():
    """A last-wins write-back over [N, M, S] indices: every member's writes
    land in its own plane, the later sub-step winning where one member
    drew a cell twice, even where another member drew the same cell."""
    from dist_dqn_tpu_torch.replay import prioritized_device as pring
    state = pring.prioritized_ring_init(6, 3, torch.zeros(2), members=2)
    t = torch.tensor([[[1, 1], [1, 4]], [[1, 2], [1, 1]]])     # [N, M, S]
    b = torch.tensor([[[2, 2], [2, 0]], [[2, 1], [2, 2]]])
    p = torch.tensor([[[1.0, 2.0], [10.0, 11.0]],
                      [[3.0, 4.0], [12.0, 13.0]]])
    pring.prioritized_ring_update_batched(state, t, b, p, eps=0.5)
    got = state.priorities
    assert float(got[0, 1, 2]) == 3.5 and float(got[0, 2, 1]) == 4.5
    assert float(got[1, 1, 2]) == 13.5 and float(got[1, 4, 0]) == 11.5
    assert int((got > 0).sum()) == 4
    assert state.max_priority.tolist() == [4.5, 13.5]


# --------------------------------------------------------------------------
# Port pins: the M = 1 program, member independence.
# --------------------------------------------------------------------------

def test_population_m1_with_spec_is_the_plain_program():
    spec1 = json.dumps({"lr": [7e-4], "epsilon": [0.07], "gamma": [0.98]})
    cfg_pop = _tiny_cfg(size=1, spec_json=spec1)
    cfg_solo = pop.member_config(cfg_pop, pop.resolve_spec(cfg_pop), 0)
    kw = dict(total_env_steps=1600, seed=11, chunk_iters=50, log_fn=QUIET,
              device="cpu")
    carry_a, _ = train(cfg_pop, **kw)
    carry_b, _ = train(cfg_solo, **kw)
    assert_trees_equal(state_tree(carry_a.learner),
                       state_tree(carry_b.learner))


_ATARI_CATCH = ["env_name=pixel_catch", "network.torso=small",
                "network.hidden=16", "network.compute_dtype=float32",
                "replay.capacity=512", "replay.min_fill=64",
                "learner.batch_size=8", "actor.num_envs=4", "train_every=2"]

# option -> config. Member 0 of an M = 2 run is held bit for bit across
# two runs that change only member 1's seed: the stacked program computes a
# member from that member's slice alone, whatever BLAS the host has. Against
# its solo run a member is held to rounding: the host's BLAS may round the
# batched products of the stacked net other than the plain ones (ROADMAP.md
# C4), and the PER weights' power and the CNN's grouped convolutions run
# other CPU kernels than the solo program's.
OPTIONS = {
    "uniform": lambda: _tiny_cfg(),
    "per": lambda: _tiny_cfg(prioritized=True, pallas_sampler=True),
    "per_cumsum": lambda: _tiny_cfg(prioritized=True),
    "ratio2": lambda: _tiny_cfg(updates_per_chunk=2),
    "per_ratio2": lambda: _tiny_cfg(prioritized=True, pallas_sampler=True,
                                    updates_per_chunk=2),
    "bf16_actor": lambda: tconfig.apply_overrides(
        _tiny_cfg(), ["network.actor_dtype=bfloat16"]),
    "frame_dedup": lambda: tconfig.apply_overrides(
        tconfig.CONFIGS["atari"],
        _ATARI_CATCH + ["replay.frame_dedup=true"]),
    "noisy_c51": lambda: tconfig.apply_overrides(_tiny_cfg(), [
        "network.noisy=true", "network.num_atoms=11", "network.dueling=true",
        "learner.target_update_period=20"]),
    "iqn": lambda: tconfig.apply_overrides(_tiny_cfg(), [
        "network.iqn=true", "network.iqn_embed_dim=8",
        "network.iqn_tau_samples=4", "network.iqn_tau_target_samples=3",
        "network.iqn_tau_act=4"]),
}


class _DrawSpy:
    """Records the (t_idx, b_idx) of every gather of the replay ring."""

    def __init__(self, monkeypatch):
        self.real = tring.gather_transitions
        self.draws = []
        monkeypatch.setattr(tring, "gather_transitions", self)

    def __call__(self, state, t_idx, b_idx, *args, **kwargs):
        self.draws.append((t_idx.clone(), b_idx.clone()))
        return self.real(state, t_idx, b_idx, *args, **kwargs)


def _run_population(cfg, seeds, chunks=2, iters=40):
    env = make_env(cfg.env_name, device="cpu")
    nets = [build_network(cfg.network, env.num_actions,
                          env.observation_shape, device="cpu", seed=s)
            for s in seeds]
    init, run = pop.make_population_train(cfg, env, stack_networks(nets),
                                          device="cpu")
    carry = init(seeds)
    for _ in range(chunks):
        carry, metrics = run(carry, iters)
    return carry, metrics


def _run_solo(cfg, seed, chunks=2, iters=40):
    env = make_env(cfg.env_name, device="cpu")
    net = build_network(cfg.network, env.num_actions, env.observation_shape,
                        device="cpu", seed=seed)
    init, run = make_fused_train(cfg, env, net, device="cpu")
    carry = init(seed)
    for _ in range(chunks):
        carry, metrics = run(carry, iters)
    return carry, metrics


@pytest.mark.parametrize("option", list(OPTIONS))
def test_member_independence(monkeypatch, option):
    """Member k of an M = 2 run (two chunks of 40 iterations) against the
    solo run of member k's config, seeded with member_seeds(7, 2)[k]: the
    same ring contents and sampled indices, params to rtol 2e-5, atol 1e-7
    (the tolerance of JAX's vmapped program). And member 0 bit for bit
    (params, ring, draws) across a second M = 2 run whose member 1 has
    another seed."""
    cfg = dataclasses.replace(OPTIONS[option](),
                              population=tconfig.PopulationConfig(
                                  size=2, spec_json=SPEC2))
    seeds = pop.member_seeds(7, 2)
    spy = _DrawSpy(monkeypatch)
    carry, metrics = _run_population(cfg, seeds)
    pop_draws = spy.draws
    assert metrics["grad_steps_in_chunk"] > 0 and pop_draws
    ring_p = state_tree(getattr(carry.replay, "ring", carry.replay))

    spy.draws = []
    other, _ = _run_population(cfg, [seeds[0], seeds[1] + 1])
    assert len(spy.draws) == len(pop_draws)
    for (t_p, b_p), (t_o, b_o) in zip(pop_draws, spy.draws):
        assert torch.equal(t_p[0], t_o[0]) and torch.equal(b_p[0], b_o[0])
    assert not all(torch.equal(b_p[1], b_o[1])
                   for (_, b_p), (_, b_o) in zip(pop_draws, spy.draws))
    ring_o = state_tree(getattr(other.replay, "ring", other.replay))
    for name in ("obs", "action", "reward", "terminated", "truncated"):
        assert torch.equal(ring_p[name][0], ring_o[name][0]), name
    if cfg.replay.prioritized:
        assert torch.equal(carry.replay.priorities[0],
                           other.replay.priorities[0])
    for (name, p), (_, q) in zip(carry.learner.net.named_parameters(),
                                 other.learner.net.named_parameters()):
        assert torch.equal(p[0], q[0]), name

    for k in range(2):
        spy.draws = []
        solo, solo_metrics = _run_solo(
            pop.member_config(cfg, pop.resolve_spec(cfg), k), seeds[k])
        assert len(spy.draws) == len(pop_draws)
        for (t_p, b_p), (t_s, b_s) in zip(pop_draws, spy.draws):
            assert torch.equal(t_p[k], t_s) and torch.equal(b_p[k], b_s)
        ring_s = state_tree(getattr(solo.replay, "ring", solo.replay))
        for name in ("obs", "action", "reward", "terminated", "truncated"):
            assert torch.equal(ring_p[name][k], ring_s[name]), name
        assert (ring_p["pos"], ring_p["size"]) == (ring_s["pos"],
                                                   ring_s["size"])
        tol = dict(rtol=2e-5, atol=1e-7)
        if cfg.replay.prioritized:
            np.testing.assert_allclose(carry.replay.priorities[k].numpy(),
                                       solo.replay.priorities.numpy(), **tol)
        for (name, p), (_, q) in zip(carry.learner.net.named_parameters(),
                                     solo.learner.net.named_parameters()):
            np.testing.assert_allclose(p[k].detach().numpy(),
                                       q.detach().numpy(), err_msg=name,
                                       **tol)
        np.testing.assert_allclose(float(metrics["loss"][k]),
                                   float(solo_metrics["loss"]), rtol=1e-4)


def test_member_actor_draws_each_members_solo_numbers():
    """The stacked actor: member k's actions equal a solo act of member k's
    net on member k's obs from a generator of the same state."""
    cfg = tconfig.apply_overrides(_tiny_cfg(), ["network.noisy=true",
                                                "network.dueling=true"])
    nets = [build_network(cfg.network, 2, (4,), device="cpu", seed=s)
            for s in (1, 2, 3)]
    act = tdqn.make_actor_step(2)
    obs = torch.randn(3, 8, 4)
    gens = [torch.Generator().manual_seed(s) for s in (4, 5, 6)]
    got = act(stack_networks(nets), obs, gens, torch.tensor([0.0, 0.5, 1.0]))
    for k, eps in enumerate((0.0, 0.5, 1.0)):
        want = act(nets[k], obs[k], torch.Generator().manual_seed(4 + k), eps)
        assert torch.equal(got[k], want)


# --------------------------------------------------------------------------
# Checkpoints and evaluate.
# --------------------------------------------------------------------------

def test_stacked_checkpoint_roundtrip(tmp_path):
    """The twin of JAX test_stacked_checkpoint_roundtrip, its refusal
    counter included."""
    from dist_dqn_tpu_torch.evaluate import evaluate_checkpoint

    d = str(tmp_path / "pop2")
    cfg = _tiny_cfg(size=2, spec_json=SPEC2)
    kw = dict(total_env_steps=1600, seed=5, chunk_iters=50, device="cpu")
    carry, history = train(cfg, **kw, log_fn=QUIET, checkpoint_dir=d)
    assert read_population_size(d) == 2
    assert history and history[0]["population"] == 2
    assert len(history[0]["loss_members"]) == 2
    assert len(history[0]["eval_return_members"]) == 2
    assert history[0]["eval_return"] == pytest.approx(
        sum(history[0]["eval_return_members"]) / 2)

    mgr = TrainCheckpointer(d)
    example = build_network(cfg.network, 2, (4,), device="cpu", seed=99)
    for k in range(2):
        _, got = mgr.restore_params(example, member=k)
        want = build_network(cfg.network, 2, (4,), device="cpu")
        want.load_state_dict({name: value[k] for name, value in
                              carry.learner.net.state_dict().items()})
        assert_trees_equal(state_tree(got), state_tree(want))
    with pytest.raises(ValueError, match="population-2"):
        mgr.restore_params(example)           # member-less on stacked
    with pytest.raises(ValueError, match="out of range"):
        mgr.restore_params(example, member=5)
    with pytest.raises(ValueError, match="out of range"):
        mgr.restore_params(example, member=-1)

    # evaluate serves a single member of the stacked run.
    out = evaluate_checkpoint(pop.member_config(cfg, pop.resolve_spec(cfg),
                                                1), d, episodes=2,
                              device="cpu", member=1)
    assert out["member"] == 1 and np.isfinite(out["eval_return"])

    # Resume at the same M restores the stacked tree.
    logs = []
    train(cfg, **kw, log_fn=logs.append, checkpoint_dir=d)
    assert json.loads(logs[0]) == {"resumed_at_frames": 1600,
                                   "with_replay": False, "population": 2}

    # Resume at a different M is refused with the cause, and counted.
    from dist_dqn_tpu_torch.telemetry import collectors as tmc
    from dist_dqn_tpu_torch.telemetry import get_registry
    refused = get_registry().counter(
        tmc.CHECKPOINT_REFUSED, "resume attempts refused at the sidecar pins",
        {"loop": "fused", "reason": "population"})
    before = refused.value
    spec3 = json.dumps({"lr": [1e-3, 5e-4, 2e-4]})
    with pytest.raises(ValueError, match="population-2 stacked tree") as e:
        train(_tiny_cfg(size=3, spec_json=spec3), **kw, log_fn=QUIET,
              checkpoint_dir=d)
    assert refused.value == before + 1
    from dist_dqn_tpu.utils.checkpoint import record_population_size
    with pytest.raises(ValueError) as want:
        record_population_size(d, 3)
    assert str(e.value) == str(want.value)


def test_restore_member_on_solo_dir_refused(tmp_path):
    d = str(tmp_path / "solo")
    carry, _ = train(_tiny_cfg(), total_env_steps=800, seed=0,
                     chunk_iters=50, log_fn=QUIET, device="cpu",
                     checkpoint_dir=d)
    mgr = TrainCheckpointer(d)
    example = build_network(_tiny_cfg().network, 2, (4,), device="cpu",
                            seed=9)
    with pytest.raises(ValueError, match="not a population checkpoint"):
        mgr.restore_params(example, member=0)
    _, got = mgr.restore_params(example)   # member-less still works
    assert_trees_equal(state_tree(got), state_tree(carry.learner.net))


@pytest.mark.parametrize("replay", [False, True], ids=["learner", "carry"])
def test_population_saves_and_resumes(tmp_path, replay):
    """A learner-kind and a carry-kind save of an M = 2 run; resumed from
    the carry, the run is bit-equal to one that never stopped."""
    cfg = dataclasses.replace(_tiny_cfg(size=2, spec_json=SPEC2,
                                        prioritized=True,
                                        pallas_sampler=True),
                              eval_every_steps=0)
    kw = dict(chunk_iters=40, device="cpu", seed=3)
    ref, ref_hist = train(cfg, total_env_steps=960, log_fn=QUIET, **kw)
    d = str(tmp_path / "run")
    first, _ = train(cfg, total_env_steps=640, log_fn=QUIET,
                     checkpoint_dir=d, checkpoint_replay=replay, **kw)
    logs = []
    carry, hist = train(cfg, total_env_steps=960, log_fn=logs.append,
                        checkpoint_dir=d, checkpoint_replay=replay, **kw)
    assert json.loads(logs[0]) == {"resumed_at_frames": 640,
                                   "with_replay": replay, "population": 2}
    assert [r["env_frames"] for r in hist] == [960]
    assert read_population_size(d) == 2
    if replay:
        assert hist[0]["loss_members"] == ref_hist[-1]["loss_members"]
        assert_trees_equal(state_tree(ref), state_tree(carry))
        return
    # A learner-kind resume: the restored learner's steps continue, over
    # a fresh ring.
    assert carry.learner.steps == (first.learner.steps
                                   + hist[0]["grad_steps_in_chunk"])
    assert 0 < hist[0]["grad_steps_in_chunk"] < 40


# --------------------------------------------------------------------------
# The CLI.
# --------------------------------------------------------------------------

_TINY_CLI = ["--device", "cpu", "--total-env-steps", "320",
             "--chunk-iters", "40", "--eval-every-steps", "0",
             "--set", "network.mlp_features=(16,)",
             "--set", "replay.min_fill=32", "--set", "learner.batch_size=16",
             "--set", "actor.num_envs=4"]


def test_train_cli_population_flag_routing(monkeypatch, capsys):
    """The twin of JAX test_train_cli_population_flag_routing for the
    fused runtime: the flags reach train(), --population 0 and a bad spec
    are parser errors, and r2d2 prints JAX's line and runs solo."""
    from dist_dqn_tpu_torch import train as train_mod

    seen = {}
    monkeypatch.setattr(train_mod, "train",
                        lambda cfg, **kw: seen.__setitem__("cfg", cfg)
                        or (None, []))
    train_mod.main(["--config", "cartpole", "--population", "2",
                    "--population-spec", SPEC2])
    assert seen["cfg"].population.size == 2
    assert seen["cfg"].population.spec_json == SPEC2

    train_mod.main(["--config", "r2d2", "--population", "2"])
    # Each run's manifest line aside, the first line is the warning.
    out = [line for line in capsys.readouterr().out.splitlines()
           if not line.startswith('{"manifest"')]
    assert out[0] == (
        "# --population is not supported by the recurrent (R2D2) fused "
        "loop yet (its sequence learner has no member axis); ignored")
    assert seen["cfg"].population.size == 1

    for argv, msg in (
            (["--population", "0"], "must be >= 1"),
            (["--population", "2", "--population-spec", '{"lr": [0.001]}'],
             "length M"),
            (["--population", "2", "--population-spec", "{nope"],
             "not valid JSON"),
            (["--population", "2", "--population-spec",
              '{"lr": [0.001, 0.002]}', "--set",
              "learner.lr_schedule=cosine"], "lr_schedule")):
        with pytest.raises(SystemExit):
            train_mod.main(["--config", "cartpole", *argv])
        assert msg in capsys.readouterr().err


def test_train_cli_population_runs(capsys):
    from dist_dqn_tpu_torch.train import main

    main(["--config", "cartpole", *_TINY_CLI, "--population", "2",
          "--population-spec", SPEC2])
    rows = cli_rows(capsys.readouterr().out)
    assert [r["env_frames"] for r in rows] == [160, 320]
    for r in rows:
        assert r["population"] == 2 and len(r["loss_members"]) == 2
        # The logged rates are rounded to three decimals.
        assert r["grad_steps_per_sec"] == pytest.approx(
            2 * r["grad_steps_per_sec_member"], abs=0.01)
    assert rows[-1]["grad_steps_in_chunk"] == 40


def test_evaluate_cli_member(tmp_path, capsys):
    from dist_dqn_tpu_torch.evaluate import main as eval_main

    d = str(tmp_path / "pop")
    train(_tiny_cfg(size=2, spec_json=SPEC2), total_env_steps=400,
          chunk_iters=50, log_fn=QUIET, device="cpu", checkpoint_dir=d)
    argv = ["--config", "cartpole", "--device", "cpu", "--checkpoint-dir", d,
            "--episodes", "2", "--set", "network.mlp_features=(32,)",
            "--set", "network.hidden=0"]
    eval_main(argv + ["--member", "1"])
    row = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert row["member"] == 1 and row["frames"] == 400
    with pytest.raises(ValueError, match="population-2"):
        eval_main(argv)
