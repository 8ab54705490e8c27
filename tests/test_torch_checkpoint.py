"""The port's checkpointer (dist_dqn_tpu_torch/utils/checkpoint.py) on the
CPU: a learner round trip that steps on bit for bit, retention and the save
cadence, the explicit-step restore, the config-drift and kind errors, the
``LATEST`` pointer and its fallback, the bounded wait, and two parities
with the JAX package: the pointer's param checksum, and a learner step
taken after restoring a state carried across from JAX (params, target and
Adam's count and moments), to the lockstep tests' tolerance (rtol 1e-5,
atol 1e-7; tests/test_torch_slice.py)."""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dist_dqn_tpu import config as jconfig
from dist_dqn_tpu_torch import config as tconfig
from dist_dqn_tpu_torch.agents.dqn import make_learner
from dist_dqn_tpu_torch.models import build_network
from dist_dqn_tpu_torch.types import Transition
from dist_dqn_tpu_torch.utils import checkpoint as tck
from dist_dqn_tpu_torch.utils.checkpoint import TrainCheckpointer
from dist_dqn_tpu_torch.utils.params import from_flax
from torch_parity import assert_trees_equal, to_numpy_tree

OBS = (4,)
A = 3
S = 8

HEADS = {
    # Deterministic scalar head; IQN draws its taus from the learner's
    # generator, so the generator's state must round-trip too.
    "scalar": dict(torso="mlp", mlp_features=(16,), hidden=0, dueling=True),
    "iqn": dict(torso="mlp", mlp_features=(16,), hidden=0, iqn=True,
                iqn_embed_dim=8, iqn_tau_samples=4, iqn_tau_target_samples=4,
                iqn_tau_act=4),
}


def _learner(head="scalar", seed=0, **learner):
    netcfg = tconfig.NetworkConfig(**HEADS[head])
    net = build_network(netcfg, A, OBS, device="cpu", seed=seed)
    cfg = dataclasses.replace(tconfig.LearnerConfig(), batch_size=S,
                              target_update_period=2, **learner)
    init, step = make_learner(cfg, net)
    gen = torch.Generator().manual_seed(100 + seed)
    return init(net, gen), step


def _batch(seed):
    rng = np.random.default_rng(seed)
    f = lambda *shape: torch.from_numpy(  # noqa: E731
        rng.normal(size=shape).astype(np.float32))
    return Transition(obs=f(S, *OBS), action=torch.from_numpy(
        rng.integers(0, A, S)), reward=f(S),
        discount=torch.full((S,), 0.97), next_obs=f(S, *OBS))


@pytest.mark.parametrize("head", sorted(HEADS))
def test_round_trip_then_one_more_step_is_bit_equal(tmp_path, head):
    state, step = _learner(head, seed=0)
    for k in range(3):
        step(state, _batch(k))
    ckpt = TrainCheckpointer(str(tmp_path / "ckpt"), save_every_frames=100)
    assert ckpt.restore_latest(state) is None          # empty dir
    assert ckpt.save(1000, state)
    other, other_step = _learner(head, seed=1)          # different values
    before = {n: p.clone() for n, p in other.net.named_parameters()}
    frames, restored = ckpt.restore_latest(other)
    assert frames == 1000 and restored is other
    assert any(not torch.equal(before[n], p)
               for n, p in restored.net.named_parameters())
    assert_trees_equal(tck.state_tree(state), tck.state_tree(restored))
    step(state, _batch(9))
    other_step(restored, _batch(9))
    assert_trees_equal(tck.state_tree(state), tck.state_tree(restored))
    assert restored.steps == state.steps == 4
    assert restored.opt_state.count == 4


def test_checkpointer_retention_and_cadence(tmp_path):
    state, _ = _learner()
    ckpt = TrainCheckpointer(str(tmp_path / "ckpt"), save_every_frames=100,
                             max_to_keep=2)
    assert ckpt.maybe_save(0, state)               # first boundary
    assert not ckpt.maybe_save(50, state)          # below next boundary
    assert ckpt.maybe_save(120, state)
    assert ckpt.maybe_save(500, state)
    ckpt.wait()
    frames, _ = ckpt.restore_latest(state)
    assert frames == 500
    assert ckpt.all_steps() == (120, 500)          # retention kept two
    # A step at or below the newest is not written, as orbax skips it.
    assert not ckpt.save(500, state) and not ckpt.save(300, state)
    assert sorted(os.listdir(ckpt.directory)) == ["120", "500", "LATEST"]
    ckpt.close()


def test_explicit_step_restore_keeps_save_schedule(tmp_path):
    state, _ = _learner()
    ckpt = TrainCheckpointer(str(tmp_path / "ckpt"), save_every_frames=100)
    ckpt.save(100, state)
    ckpt.save(200, state)
    frames, _ = ckpt.restore_latest(state)
    assert frames == 200 and ckpt._next_save == 300
    frames, _ = ckpt.restore_latest(state, step=100)
    assert frames == 100 and ckpt._next_save == 300
    assert not ckpt.maybe_save(250, state)
    assert ckpt.all_steps() == (100, 200)


def _tiny_cartpole(**network):
    cfg = tconfig.CONFIGS["cartpole"]
    return dataclasses.replace(
        cfg,
        network=dataclasses.replace(cfg.network, mlp_features=(16,),
                                    **network),
        replay=dataclasses.replace(cfg.replay, capacity=512, min_fill=64),
        learner=dataclasses.replace(cfg.learner, batch_size=16),
        actor=dataclasses.replace(cfg.actor, num_envs=4),
        eval_every_steps=0)


def test_checkpoint_kind_mismatch_names_the_flag(tmp_path):
    from dist_dqn_tpu_torch.train import train

    d = str(tmp_path / "run")
    cfg = _tiny_cartpole()
    train(cfg, total_env_steps=300, chunk_iters=75, log_fn=lambda s: None,
          device="cpu", checkpoint_dir=d)
    assert tck.read_checkpoint_kind(d) == "learner"
    with pytest.raises(ValueError, match="checkpoint-replay"):
        train(cfg, total_env_steps=600, chunk_iters=75,
              log_fn=lambda s: None, device="cpu", checkpoint_dir=d,
              checkpoint_replay=True)


@pytest.mark.parametrize("saved_dueling", [False, True])
def test_architecture_drift_names_the_cause(tmp_path, saved_dueling):
    """A learner saved with one network and read with another (dueling on
    at save and off at read, or the reverse) raises the config-drift
    error, from the params-only read and from the full restore."""
    netcfg = tconfig.NetworkConfig(torso="mlp", mlp_features=(16,), hidden=0,
                                   dueling=saved_dueling)
    net = build_network(netcfg, A, OBS, device="cpu")
    init, _ = make_learner(tconfig.LearnerConfig(), net)
    ckpt = TrainCheckpointer(str(tmp_path / "ckpt"))
    ckpt.save(10, init(net))
    drifted_cfg = dataclasses.replace(netcfg, dueling=not saved_dueling)
    drifted = build_network(drifted_cfg, A, OBS, device="cpu")
    with pytest.raises(ValueError,
                       match="same --config and --set overrides"):
        ckpt.restore_params(drifted)
    init2, _ = make_learner(tconfig.LearnerConfig(), drifted)
    with pytest.raises(ValueError,
                       match="same --config and --set overrides"):
        ckpt.restore_latest(init2(drifted))
    # A same-shaped template of another dtype drifts too.
    bf16 = build_network(dataclasses.replace(netcfg), A, OBS, device="cpu")
    bf16.to(torch.float64)
    with pytest.raises(ValueError, match="shape/dtype drift"):
        ckpt.restore_params(bf16)


def test_torn_latest_pointer_falls_back_to_the_listing(tmp_path):
    state, _ = _learner()
    d = str(tmp_path / "ckpt")
    ckpt = TrainCheckpointer(d)
    ckpt.save(100, state)
    ckpt.save(200, state)
    pointer = tck.read_latest_pointer(d)
    assert pointer["step"] == 200 and pointer["manifest_hash"] is None
    with open(os.path.join(d, "LATEST"), "w") as fh:
        fh.write('{"st')                               # torn
    assert tck.read_latest_pointer(d) is None
    assert ckpt.latest_step() == 200
    assert ckpt.restore_latest(state)[0] == 200
    # A stale pointer never hides a newer listed step.
    tck.write_latest_pointer(d, 100)
    assert ckpt.latest_step() == 200
    # A half-written step (a dot-named temporary directory) is not a step.
    os.makedirs(os.path.join(d, ".tmp-300-1"))
    assert ckpt.all_steps() == (100, 200)
    assert tck.checkpoint_present(d)
    assert not tck.checkpoint_present(str(tmp_path / "absent"))
    assert not os.path.exists(tmp_path / "absent")


def test_wait_for_checkpoint_retries_only_the_missing_error(monkeypatch):
    monkeypatch.setattr(tck.time, "sleep", lambda s: None)
    calls = []

    def missing_twice():
        calls.append(1)
        if len(calls) < 3:
            raise tck.CheckpointMissingError("not yet")
        return "ok"

    assert tck.wait_for_checkpoint(missing_twice, 60.0) == "ok"
    assert len(calls) == 3
    calls.clear()

    def other_error():
        calls.append(1)
        raise FileNotFoundError("no ROM")

    with pytest.raises(FileNotFoundError, match="no ROM"):
        tck.wait_for_checkpoint(other_error, 60.0)
    assert len(calls) == 1
    calls.clear()
    with pytest.raises(tck.CheckpointMissingError):
        tck.wait_for_checkpoint(missing_twice, 0.0)   # fail fast
    assert len(calls) == 1


def _jax_learner(head):
    from dist_dqn_tpu.agents.dqn import make_learner as jax_make_learner
    from dist_dqn_tpu.models import build_network as jax_build

    netcfg = jconfig.NetworkConfig(**HEADS[head])
    learner = dataclasses.replace(jconfig.LearnerConfig(), batch_size=S,
                                  target_update_period=2,
                                  learning_rate=1e-3)
    jnet = jax_build(netcfg, A)
    init, step = jax_make_learner(jnet, learner)
    return init(jax.random.PRNGKey(3), jnp.zeros(OBS)), jax.jit(step), \
        netcfg, learner


def _jax_batch(seed):
    from dist_dqn_tpu.types import Transition as JTransition

    b = _batch(seed)
    return JTransition(*(jnp.asarray(x.numpy()) for x in b))


def test_latest_checksum_matches_the_jax_package(tmp_path):
    from dist_dqn_tpu.utils.checkpoint import _pointer_checksum

    jl, jstep, netcfg, _ = _jax_learner("scalar")
    jl, _ = jstep(jl, _jax_batch(0), jnp.ones((S,)))
    net = build_network(tconfig.NetworkConfig(**dataclasses.asdict(netcfg)),
                        A, OBS, device="cpu")
    net.load_state_dict(from_flax(to_numpy_tree(jl.params), net))
    init, _ = make_learner(tconfig.LearnerConfig(), net)
    d = str(tmp_path / "ckpt")
    TrainCheckpointer(d).save(5, init(net))
    with open(os.path.join(d, "LATEST")) as fh:
        got = json.load(fh)["param_checksum"]
    np.testing.assert_allclose(got, _pointer_checksum(jl), rtol=1e-9)


def test_restore_then_step_matches_the_jax_step(tmp_path):
    """A JAX learner after two steps (Adam's moments and count non-zero),
    carried across with from_flax (params, target params, mu, nu), saved,
    restored into a fresh port learner and stepped once more, lands where
    the JAX learner's third step does."""
    jl, jstep, netcfg, learner = _jax_learner("scalar")
    ones = jnp.ones((S,))
    for k in range(2):
        jl, _ = jstep(jl, _jax_batch(k), ones)
    tcfg = tconfig.NetworkConfig(**dataclasses.asdict(netcfg))
    net = build_network(tcfg, A, OBS, device="cpu")
    init, _ = make_learner(tconfig.LearnerConfig(**dataclasses.asdict(
        learner)), net)
    carried = init(net)
    adam = jl.opt_state[1][0]
    net.load_state_dict(from_flax(to_numpy_tree(jl.params), net))
    carried.target_net.load_state_dict(
        from_flax(to_numpy_tree(jl.target_params), net))
    names = [n for n, _ in net.named_parameters()]
    mu = from_flax(to_numpy_tree(adam.mu), net)
    nu = from_flax(to_numpy_tree(adam.nu), net)
    carried.opt_state.mu = [mu[n].clone() for n in names]
    carried.opt_state.nu = [nu[n].clone() for n in names]
    carried.opt_state.count = int(adam.count)
    carried.steps = int(jl.steps)
    ckpt = TrainCheckpointer(str(tmp_path / "ckpt"))
    ckpt.save(2, carried)

    fresh_net = build_network(tcfg, A, OBS, device="cpu", seed=7)
    init2, step2 = make_learner(tconfig.LearnerConfig(**dataclasses.asdict(
        learner)), fresh_net)
    _, restored = ckpt.restore_latest(init2(fresh_net))
    restored, tm = step2(restored, _batch(2))
    jl, jm = jstep(jl, _jax_batch(2), ones)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    assert restored.steps == int(jl.steps) == 3
    for live, tree in ((restored.net, jl.params),
                       (restored.target_net, jl.target_params)):
        want = from_flax(to_numpy_tree(tree), net)
        for name, value in live.state_dict().items():
            np.testing.assert_allclose(value.numpy(), want[name].numpy(),
                                       rtol=1e-5, atol=1e-7, err_msg=name)


def test_atomic_savez_and_pytree_files_land_whole(tmp_path):
    """``atomic_savez`` and ``save_pytree`` write through a temporary name:
    the target is either absent or whole, and no temporary is left."""
    path = str(tmp_path / "ring.npz")
    tck.atomic_savez(path, a=np.arange(5), b=np.ones((2, 3)))
    with np.load(path) as z:
        np.testing.assert_array_equal(z["a"], np.arange(5))
    state, _ = _learner()
    tck.save_pytree(str(tmp_path / "params.pt"), state.net)
    other, _ = _learner(seed=1)
    restored = tck.restore_pytree(str(tmp_path / "params.pt"), other.net)
    for a, b in zip(state.net.parameters(), restored.parameters()):
        assert torch.equal(a, b)
    assert sorted(os.listdir(tmp_path)) == ["params.pt", "ring.npz"]
    with pytest.raises(FileNotFoundError):
        tck.save_pytree(str(tmp_path / "absent" / "p.pt"), state.net)
