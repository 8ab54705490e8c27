"""The port's data-parallel mesh (dist_dqn_tpu_torch/parallel/) on CPU
``gloo`` ranks, against its own whole-batch learner and against the JAX
package's mesh on 2 of the 8 virtual CPU devices.

One group of 2 spawned ranks per module (``torch_mesh_workers``) runs
every case: a sharded train step per head family (dqn, c51, qrdqn, mdqn,
iqn) and for the R2D2 learner, 2 x 16 rows against one learner on 32 rows
(JAX's tolerances, ``tests/test_distributed.py:86-94``: params rtol 2e-5,
atol 1e-6; loss rtol 1e-5; priorities rtol 2e-4, atol 1e-6), and the same
step against JAX's ``make_sharded_train_step`` from the same flax weights
(the same tolerances; IQN with JAX's taus handed in through ``draws``;
R2D2 without value rescaling, whose square root the CPU rounds apart,
ROADMAP.md C4); then tiny CartPole (uniform, PER) and R2D2 chunks on the
mesh trainers, whose replicas must end bit-equal, against JAX's
``make_mesh_fused_train`` at dp 2 for the metrics' keys, ``env_frames``
and ``grad_steps_in_chunk``. A world-size-1 mesh chunk is bit-equal to
the single-device chunk (its rank 0 takes the single-device generators).
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
from dist_dqn_tpu.envs import make_jax_env
from dist_dqn_tpu.models import build_network as jax_build
from dist_dqn_tpu.parallel import learner as jlearner
from dist_dqn_tpu.parallel import make_mesh as jax_make_mesh
from dist_dqn_tpu.parallel import make_mesh_fused_train as jax_mesh_train
from dist_dqn_tpu.types import SequenceSample as JSample
from dist_dqn_tpu.types import Transition as JTransition
from dist_dqn_tpu_torch import config as tconfig
from dist_dqn_tpu_torch.envs import make_env
from dist_dqn_tpu_torch.models import build_network
from dist_dqn_tpu_torch.parallel import distributed, make_mesh
from dist_dqn_tpu_torch.train_loop import make_fused_train
from dist_dqn_tpu_torch.utils.checkpoint import state_tree
from dist_dqn_tpu_torch.utils.params import from_flax
from torch_mesh_workers import (batch_of, build_learner, mesh_carry,
                                run_ranks, step_result)
from torch_parity import assert_trees_equal, to_numpy_tree

ROWS, OBS, A = 32, 6, 3
HEADS = ["dqn", "c51", "qrdqn", "mdqn", "iqn"]
PARAMS_TOL = dict(rtol=2e-5, atol=1e-6)
LOSS_TOL = dict(rtol=1e-5)
PRIO_TOL = dict(rtol=2e-4, atol=1e-6)
# R2D2: 8 sequences (4 per rank) of burn-in 2, unroll 4, n-step 2.
SEQS, LSTM, BURN, UNROLL, N = 8, 8, 2, 4, 2
# The chunk cases: JAX test_distributed.py's tiny CartPole (16 envs,
# batch 32, a 2,048 ring filled at 64) and its tiny R2D2.
CARTPOLE = ["network.mlp_features=(32,)", "actor.num_envs=16",
            "replay.capacity=2048", "replay.min_fill=64",
            "learner.batch_size=32", "total_env_steps=4000"]
R2D2 = ["env_name=cartpole", "network.torso=mlp",
        "network.mlp_features=(16,)", "network.hidden=0",
        "network.lstm_size=8", "network.compute_dtype=float32",
        "network.lstm_dtype=float32", "replay.capacity=2048",
        "replay.min_fill=64", "replay.burn_in=2", "replay.unroll_length=4",
        "replay.sequence_stride=2", "learner.n_step=2",
        "learner.batch_size=32", "actor.num_envs=16",
        "total_env_steps=4000"]
CHUNKS = {
    "uniform": dict(preset="cartpole",
                    overrides=CARTPOLE + ["replay.prioritized=false"],
                    iters=40, chunks=2),
    "per": dict(preset="cartpole",
                overrides=CARTPOLE + ["replay.prioritized=true"],
                iters=40, chunks=2),
    "r2d2": dict(preset="r2d2", overrides=R2D2, iters=40, chunks=2),
}


def _network(head):
    kw = dict(torso="mlp", mlp_features=(32, 16), hidden=0)
    if head == "c51":
        kw.update(num_atoms=11, v_min=-5.0, v_max=5.0)
    elif head == "qrdqn":
        kw.update(num_atoms=8, quantile=True)
    elif head == "iqn":
        kw.update(iqn=True, iqn_embed_dim=8, iqn_tau_samples=4,
                  iqn_tau_target_samples=4, iqn_tau_act=4)
    return jconfig.NetworkConfig(**kw)


def _state_dict(jparams, network, obs_shape):
    tnet = build_network(tconfig.NetworkConfig(**dataclasses.asdict(network)),
                         A, obs_shape, device="cpu")
    return {k: v.numpy() for k, v in
            from_flax(to_numpy_tree(jparams), tnet).items()}


def _feed_forward_case(head):
    """The case's port inputs and JAX's 2-device sharded step on them."""
    network = _network(head)
    lcfg = jconfig.LearnerConfig(learning_rate=1e-2,
                                 munchausen=(head == "mdqn"),
                                 double_dqn=(head != "mdqn"))
    rng = np.random.default_rng(1)
    batch = (rng.normal(size=(ROWS, OBS)).astype(np.float32),
             rng.integers(0, A, ROWS).astype(np.int32),
             rng.normal(size=ROWS).astype(np.float32),
             np.full(ROWS, 0.97, np.float32),
             rng.normal(size=(ROWS, OBS)).astype(np.float32))
    weights = rng.uniform(0.2, 1.0, ROWS).astype(np.float32)
    jnet = jax_build(network, A)
    j_init, _ = jax_make_learner(jnet, lcfg)
    _, j_step = jax_make_learner(jnet, lcfg, axis_name="dp")
    state = j_init(jax.random.PRNGKey(0), jnp.zeros((OBS,)))
    case = dict(network=dataclasses.asdict(network),
                learner=dataclasses.asdict(lcfg), num_actions=A,
                obs_shape=(OBS,), state_dict=_state_dict(
                    state.params, network, (OBS,)),
                batch=batch, weights=weights, draws=None)
    jbatch = JTransition(*(jnp.asarray(x) for x in batch))
    jax_case = None
    if head == "iqn":
        # The taus JAX's step draws for global positions 0..31, which the
        # port takes through ``draws`` (the whole-batch port case draws
        # its own from the learner's generator).
        jax_case = dict(case, draws=_iqn_taus(jnet, state, jbatch))
    fn = jlearner.make_sharded_train_step(
        j_step, _jax_mesh(), *jlearner.train_step_specs("dp"))
    new, metrics = fn(state, jbatch, jnp.asarray(weights))
    return case, jax_case, _jax_result(new, metrics, network, (OBS,))


def _iqn_taus(jnet, state, jbatch):
    _, k_loss = jax.random.split(state.rng)
    k_online, _, k_target = jax.random.split(k_loss, 3)
    ids = jnp.arange(ROWS, dtype=jnp.uint32)
    _, online = jnet.apply(state.params, jbatch.obs, jnet.num_tau,
                           example_ids=ids, method=jnet.sample_quantiles,
                           rngs={"tau": k_online})
    _, target = jnet.apply(state.target_params, jbatch.next_obs,
                           jnet.num_tau_target, example_ids=ids,
                           method=jnet.sample_quantiles,
                           rngs={"tau": k_target})
    return {"online": np.array(online), "target": np.array(target)}


def _r2d2_case():
    L = BURN + UNROLL + N
    network = jconfig.NetworkConfig(torso="mlp", mlp_features=(16,),
                                    hidden=12, dueling=True, lstm_size=LSTM)
    lcfg = dataclasses.replace(
        jconfig.CONFIGS["r2d2"].learner, learning_rate=1e-3, n_step=N,
        value_rescale=False, target_update_period=1)
    rcfg = dataclasses.replace(jconfig.CONFIGS["r2d2"].replay,
                               burn_in=BURN, unroll_length=UNROLL)
    rng = np.random.default_rng(5)
    done = np.zeros((L, SEQS), bool)
    done[3, 1] = done[L - 1, 6] = True
    batch = dict(
        obs=rng.normal(size=(L, SEQS, 4)).astype(np.float32),
        action=rng.integers(0, A, (L, SEQS)).astype(np.int32),
        reward=(rng.normal(size=(L, SEQS)) * 3).astype(np.float32),
        done=done, reset=np.concatenate([np.zeros((1, SEQS), bool),
                                         done[:-1]]),
        start_state=tuple(rng.normal(size=(SEQS, LSTM)).astype(np.float32)
                          for _ in range(2)),
        weights=rng.uniform(0.2, 1.0, SEQS).astype(np.float32),
        t_idx=np.arange(SEQS, dtype=np.int32),
        b_idx=np.zeros(SEQS, np.int32))
    jnet = jax_build(network, A)
    j_init, _ = jax_r2d2_learner(jnet, lcfg, rcfg)
    _, j_step = jax_r2d2_learner(jnet, lcfg, rcfg, axis_name="dp")
    state = j_init(jax.random.PRNGKey(3), jnp.asarray(batch["obs"][0, 0]))
    case = dict(network=dataclasses.asdict(network),
                learner=dataclasses.asdict(lcfg),
                replay=dataclasses.asdict(rcfg), num_actions=A,
                obs_shape=(4,), state_dict=_state_dict(state.params,
                                                       network, (4,)),
                batch=batch)
    jsample = JSample(**{k: (tuple(jnp.asarray(x) for x in v)
                             if k == "start_state" else jnp.asarray(v))
                         for k, v in batch.items()})
    fn = jlearner.make_sharded_train_step(
        j_step, _jax_mesh(), *jlearner.train_step_specs("dp",
                                                        recurrent=True))
    new, metrics = fn(state, jsample)
    return case, _jax_result(new, metrics, network, (4,))


def _jax_mesh():
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-device CPU mesh from conftest")
    return jax_make_mesh(devices=jax.devices()[:2])


def _jax_result(state, metrics, network, obs_shape):
    out = {k: np.asarray(v) for k, v in metrics.items()}
    out["params"] = _state_dict(state.params, network, obs_shape)
    out["target_params"] = _state_dict(state.target_params, network,
                                       obs_shape)
    return out


def _whole_batch(case):
    """The port's single learner on the whole batch."""
    net, init, step = build_learner(case)
    data, kw = batch_of(case)
    learner, metrics = step(init(net), *data, **kw)
    return step_result(learner, metrics)


def _jax_chunks(name):
    cfg = jconfig.apply_overrides(jconfig.CONFIGS["cartpole"],
                                  CHUNKS[name]["overrides"])
    env = make_jax_env(cfg.env_name)
    net = jax_build(cfg.network, env.num_actions)
    init, run = jax_mesh_train(cfg, env, net, _jax_mesh())
    carry = init(jax.random.PRNGKey(0))
    rows = []
    for _ in range(CHUNKS[name]["chunks"]):
        carry, metrics = run(carry, CHUNKS[name]["iters"])
        rows.append({k: float(v) for k, v in metrics.items()})
    return rows


@pytest.fixture(scope="module")
def mesh_run():
    """Every case's JAX side, then the one spawned group of 2 ranks."""
    steps, jax_side, names = [], {}, []
    for head in HEADS:
        case, jax_case, jax_result = _feed_forward_case(head)
        steps.append(case)
        names.append(head)
        if jax_case is not None:
            steps.append(jax_case)
            names.append(head + "_jax_draws")
        jax_side[head] = jax_result
    case, jax_side["r2d2"] = _r2d2_case()
    steps.append(case)
    names.append("r2d2")
    ranks = run_ranks([("sharded_steps", steps),
                       ("chunks", list(CHUNKS.values()))])
    sharded = {n: [r[0][i] for r in ranks] for i, n in enumerate(names)}
    chunks = {n: [r[1][i] for r in ranks] for i, n in enumerate(CHUNKS)}
    return dict(cases=dict(zip(names, steps)), sharded=sharded,
                jax=jax_side, chunks=chunks)


def _close_params(got, want, **tol):
    assert set(got) == set(want)
    for name in got:
        np.testing.assert_allclose(got[name], want[name], err_msg=name,
                                   **tol)


def _assert_step(got, want):
    _close_params(got["params"], want["params"], **PARAMS_TOL)
    _close_params(got["target_params"], want["target_params"],
                  **PARAMS_TOL)
    np.testing.assert_allclose(got["loss"], want["loss"], **LOSS_TOL)
    np.testing.assert_allclose(got["priorities"], want["priorities"],
                               **PRIO_TOL)


@pytest.mark.parametrize("head", HEADS + ["r2d2"])
def test_sharded_step_matches_whole_batch(mesh_run, head):
    """2 ranks on 16 rows each + the gradient all-reduce == 1 learner on
    32 rows; IQN's ranks keep their rows of the global tau block, so they
    see the whole-batch step's fractions. The two replicas are equal bit
    for bit."""
    ranks = mesh_run["sharded"][head]
    for name, value in ranks[0]["params"].items():
        np.testing.assert_array_equal(value, ranks[1]["params"][name])
    np.testing.assert_array_equal(ranks[0]["priorities"],
                                  ranks[1]["priorities"])
    assert ranks[0]["priorities"].shape[0] == (SEQS if head == "r2d2"
                                               else ROWS)
    _assert_step(ranks[0], _whole_batch(mesh_run["cases"][head]))


@pytest.mark.parametrize("head", HEADS + ["r2d2"])
def test_sharded_step_matches_jax_mesh(mesh_run, head):
    """The port's 2-rank step against JAX's sharded step on 2 virtual CPU
    devices, from the same flax weights and batch, at the tolerances
    above."""
    key = head + "_jax_draws" if head == "iqn" else head
    _assert_step(mesh_run["sharded"][key][0], mesh_run["jax"][head])
    if head != "r2d2":
        np.testing.assert_allclose(
            mesh_run["sharded"][key][0]["mean_q_target_gap"],
            mesh_run["jax"][head]["mean_q_target_gap"], rtol=2e-4)


@pytest.mark.parametrize("name", list(CHUNKS))
def test_two_rank_chunks_keep_equal_replicas(mesh_run, name):
    """Bit-equal parameters, target and new-item priority seed across the
    ranks; global env frames (iterations x all lanes) and episodes (the
    sum of the ranks' own)."""
    r0, r1 = mesh_run["chunks"][name]
    case = CHUNKS[name]
    np.testing.assert_array_equal(r0["params"], r1["params"])
    np.testing.assert_array_equal(r0["target_params"], r1["target_params"])
    assert np.all(np.isfinite(r0["params"]))
    assert r0["max_priority"] == r1["max_priority"] or name == "uniform"
    assert r0["rows"] == r1["rows"]
    assert [r["env_frames"] for r in r0["rows"]] == [
        case["iters"] * 16 * (i + 1) for i in range(case["chunks"])]
    for i, row in enumerate(r0["rows"]):
        assert row["episodes"] == r0["local_episodes"][i] + \
            r1["local_episodes"][i]
    assert r0["steps"] == sum(r["grad_steps_in_chunk"] for r in r0["rows"])
    assert r0["steps"] > 0 and all(np.isfinite(r["loss"])
                                   for r in r0["rows"])


@pytest.mark.parametrize("name", ["uniform", "per"])
def test_two_rank_chunks_match_jax_mesh_counts(mesh_run, name):
    """Against JAX's make_mesh_fused_train at dp 2 on the same config:
    the metrics' keys, env_frames and grad steps per chunk."""
    want = _jax_chunks(name)
    got = mesh_run["chunks"][name][0]["rows"]
    assert [sorted(r) for r in got] == [sorted(r) for r in want]
    for g, w in zip(got, want):
        assert g["env_frames"] == w["env_frames"]
        assert g["grad_steps_in_chunk"] == w["grad_steps_in_chunk"]


@pytest.fixture
def solo_group():
    """A gloo group of one rank in this process."""
    distributed.initialize(f"127.0.0.1:{distributed.free_port()}", 1, 0,
                           device="cpu", timeout_s=60.0)
    try:
        yield make_mesh()
    finally:
        distributed.shutdown()


def test_world_size_one_mesh_is_the_single_device_chunk(solo_group):
    """Mechanism pin: rank 0 of a mesh takes the single-device run's four
    generators (``loop_common.rank_generators``), the all-reduces of one
    rank change no bit, so a world-size-1 mesh carry (PER, two chunks)
    equals the single-device one bit for bit: learner, optimizer, ring,
    priorities, env state and every generator."""
    case = CHUNKS["per"]
    mesh_state = state_tree(mesh_carry(solo_group, case))
    cfg = tconfig.apply_overrides(tconfig.CONFIGS["cartpole"],
                                  case["overrides"])
    env = make_env(cfg.env_name, device="cpu")
    net = build_network(cfg.network, env.num_actions, env.observation_shape,
                        device="cpu", seed=cfg.seed)
    init, run = make_fused_train(cfg, env, net, device="cpu")
    carry = init(cfg.seed)
    for _ in range(case["chunks"]):
        carry, _ = run(carry, case["iters"])
    assert carry.learner.steps > 0
    assert_trees_equal(state_tree(carry), mesh_state)


def test_mesh_layouts_other_than_one_dp_axis_raise(solo_group):
    with pytest.raises(ValueError, match="one 'dp' axis"):
        make_mesh(axis_names=("dp", "ep"))
    with pytest.raises(ValueError, match="one 'dp' axis"):
        make_mesh(axis_sizes=[2])
    assert solo_group.shape == {"dp": 1} and solo_group.backend == "gloo"
    assert solo_group.rows(16) == slice(0, 16)
    x = torch.arange(3.0)
    assert torch.equal(solo_group.pmean([x])[0], x)
    assert torch.equal(solo_group.pmax(x), x)
