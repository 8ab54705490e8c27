"""R2D2 on the port's Ape-X split against the JAX package's:

* ``SequenceAssembler``: windows and stride, reset flags across episodes,
  the q planes, multi-lane independence and ``reset`` (the JAX tests'
  streams fed to both assemblers): bit-equal, plus JAX's own asserts;
* ``initial_sequence_priorities`` with and without value rescale on
  random sequences (numpy, seeded): bit-equal; ``_h`` / ``_h_inv`` bit-equal
  to JAX's and, to rtol 1e-5 / atol 1e-6, to the port's
  ``ops/losses.value_rescale`` (JAX's own tolerance for the same check);
* the recurrent act with ``return_q`` against JAX's
  ``make_recurrent_actor_step(net, return_q=True)``, params carried by
  ``utils/params.py from_flax``, at f32 compute: greedy actions equal,
  carries and ``(q_sel, q_max)`` to atol 1e-5 (matmul summation order);
* the split end to end on the CPU with actor processes, on a small config
  like JAX's ``test_apex_r2d2_split_end_to_end``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dist_dqn_tpu import config as jconfig
from dist_dqn_tpu.actors import assembler as jasm
from dist_dqn_tpu.agents.r2d2 import \
    make_recurrent_actor_step as jax_recurrent_act
from dist_dqn_tpu.models import build_network as jax_build
from dist_dqn_tpu_torch import config as tconfig
from dist_dqn_tpu_torch.actors import assembler as tasm
from dist_dqn_tpu_torch.actors import service as tservice
from dist_dqn_tpu_torch.agents.r2d2 import make_recurrent_actor_step
from dist_dqn_tpu_torch.models import build_network as torch_build
from dist_dqn_tpu_torch.ops import losses as tlosses
from dist_dqn_tpu_torch.utils.params import from_flax
from torch_parity import to_numpy_tree


def _feed(asms, steps, lanes=1, dones=(), lstm=4, q=False):
    rng = np.random.default_rng(7)
    for t in range(steps):
        args = [np.full((lanes, 2), float(t)),
                np.full((lanes,), t % 3),
                np.full((lanes,), float(t)),
                np.full((lanes,), t in dones),
                np.zeros((lanes,), bool),
                np.full((lanes, lstm), float(t)),   # carry_c entering t
                np.full((lanes, lstm), -float(t))]
        if q:
            args += [rng.normal(size=lanes).astype(np.float32),
                     rng.normal(size=lanes).astype(np.float32)]
        for a in asms:
            a.step(*args)


def _pair(lanes, seq_len, stride):
    return (tasm.SequenceAssembler(lanes, seq_len, stride),
            jasm.SequenceAssembler(lanes, seq_len, stride))


def _drained_equal(ours, theirs):
    a, b = ours.drain(), theirs.drain()
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    return a


def test_sequence_assembler_windows_and_stride():
    ours, theirs = _pair(1, 4, 2)
    _feed((ours, theirs), steps=9)
    out = _drained_equal(ours, theirs)
    assert out["obs"].shape == (3, 4, 2)
    np.testing.assert_array_equal(out["obs"][:, 0, 0], [0.0, 2.0, 4.0])
    np.testing.assert_array_equal(out["state_c"][:, 0], [0.0, 2.0, 4.0])
    np.testing.assert_array_equal(out["state_h"][:, 0], [0.0, -2.0, -4.0])
    assert out["action"].dtype == np.int32
    assert ours.drain() is None and theirs.drain() is None


def test_sequence_assembler_reset_flags_cross_episode():
    ours, theirs = _pair(1, 4, 1)
    _feed((ours, theirs), steps=8, dones=(3,))
    out = _drained_equal(ours, theirs)
    np.testing.assert_array_equal(out["reset"][1],
                                  [False, False, False, True])
    assert not out["reset"][4][0]
    np.testing.assert_array_equal(out["done"][1],
                                  [False, False, True, False])


def test_sequence_assembler_q_planes_multilane_and_reset():
    ours, theirs = _pair(3, 5, 2)
    _feed((ours, theirs), steps=11, lanes=3, dones=(4, 7), q=True)
    out = _drained_equal(ours, theirs)
    assert out["q_sel"].shape == (12, 5) and out["q_sel"].dtype == np.float32
    # A reconnect drops partial windows on both; drained output stays.
    _feed((ours, theirs), steps=3, lanes=3, q=True)
    for a in (ours, theirs):
        a.reset()
    _feed((ours, theirs), steps=9, lanes=3, dones=(2,), q=True)
    out = _drained_equal(ours, theirs)
    assert not out["reset"][:, 0].any()


@pytest.mark.parametrize("value_rescale", [False, True])
def test_initial_sequence_priorities_bit_equal(value_rescale):
    rng = np.random.default_rng(3)
    S, L, burn, unroll = 6, 12, 3, 6
    seqs = {"q_sel": rng.normal(scale=5, size=(S, L)).astype(np.float32),
            "q_max": rng.normal(scale=5, size=(S, L)).astype(np.float32),
            "reward": rng.normal(size=(S, L)).astype(np.float32),
            "done": rng.random((S, L)) < 0.1}
    want = jasm.initial_sequence_priorities(seqs, burn, unroll, 0.997, 0.9,
                                            value_rescale)
    got = tasm.initial_sequence_priorities(seqs, burn, unroll, 0.997, 0.9,
                                           value_rescale)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_value_rescale_twins():
    x = np.linspace(-40.0, 40.0, 41)
    np.testing.assert_array_equal(tasm._h(x), jasm._h(x))
    np.testing.assert_array_equal(tasm._h_inv(x), jasm._h_inv(x))
    np.testing.assert_allclose(
        tasm._h(x), tlosses.value_rescale(torch.from_numpy(x)).numpy(),
        rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tasm._h_inv(tasm._h(x)), x, rtol=1e-4,
                               atol=1e-4)


def test_recurrent_act_q_planes_match_jax():
    net_cfg = jconfig.NetworkConfig(
        torso="mlp", mlp_features=(16,), hidden=12, dueling=True,
        lstm_size=8, compute_dtype="float32", lstm_dtype="float32")
    jnet = jax_build(net_cfg, 3)
    params = jnet.init(jax.random.PRNGKey(0), jnet.initial_state(1),
                       jnp.zeros((1, 1, 4)), method=jnet.unroll)
    tnet = torch_build(tconfig.NetworkConfig(**dataclasses.asdict(net_cfg)),
                       3, (4,), device="cpu")
    tnet.load_state_dict(from_flax(to_numpy_tree(params), tnet))
    rng = np.random.default_rng(1)
    obs = rng.normal(size=(5, 4)).astype(np.float32)
    carry = tuple(rng.normal(size=(5, 8)).astype(np.float32)
                  for _ in range(2))
    # Epsilon 0: greedy, so the two frameworks' draws do not enter.
    jc, ja, jqs, jqm = jax.jit(jax_recurrent_act(jnet, return_q=True))(
        params, tuple(map(jnp.asarray, carry)), jnp.asarray(obs),
        jax.random.PRNGKey(2), jnp.zeros(5))
    tc, ta, tqs, tqm = make_recurrent_actor_step(3, return_q=True)(
        tnet, tuple(map(torch.from_numpy, carry)), torch.from_numpy(obs),
        torch.Generator().manual_seed(2), torch.zeros(5))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    for got, want in ((tc[0], jc[0]), (tc[1], jc[1]), (tqs, jqs),
                      (tqm, jqm)):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    # Epsilon 1 explores: q_sel is the q of the action taken.
    _, ta, tqs, tqm = make_recurrent_actor_step(3, return_q=True)(
        tnet, tuple(map(torch.from_numpy, carry)), torch.from_numpy(obs),
        torch.Generator().manual_seed(2), torch.ones(5))
    q = tnet(tuple(map(torch.from_numpy, carry)),
             torch.from_numpy(obs))[1].float()
    torch.testing.assert_close(tqs, q.gather(-1, ta[:, None])[:, 0])
    torch.testing.assert_close(tqm, q.amax(-1))


R2D2_TINY = ["network.torso=mlp", "network.mlp_features=(32,)",
             "network.hidden=0", "network.lstm_size=16",
             "network.dueling=false", "network.compute_dtype=float32",
             "network.lstm_dtype=float32", "replay.capacity=2048",
             "replay.min_fill=64", "replay.burn_in=2",
             "replay.unroll_length=6", "replay.sequence_stride=3",
             "learner.batch_size=16", "learner.n_step=2"]


def test_apex_r2d2_split_end_to_end():
    """Two actor processes of four CartPole lanes feed the recurrent
    service on the CPU: sequences, not transitions, fill the shard, each
    with its act-time priority, and the sequence learner trains."""
    cfg = tconfig.apply_overrides(tconfig.CONFIGS["r2d2"], R2D2_TINY)
    rt = tservice.ApexRuntimeConfig(host_env="CartPole-v1", num_actors=2,
                                    envs_per_actor=4, total_env_steps=1500,
                                    inserts_per_grad_step=16)
    svc = tservice.ApexLearnerService(cfg, rt, log_fn=lambda s: None,
                                      device="cpu")
    added = []
    add = svc.replay.add
    svc.replay.add = lambda items, priorities=None, shard=None: (
        added.append((items["obs"].shape, priorities)),
        add(items, priorities=priorities, shard=shard))
    result = svc.run()
    assert result["env_steps"] >= 1500
    assert result["replay_size"] > 50      # sequences, not transitions
    assert result["grad_steps"] >= 5
    assert result["ring_dropped"] == 0 and result["bad_records"] == 0
    assert result["actor_priorities"] is False
    assert result["ingest_device_calls_per_pass"] == 1.0
    assert np.isfinite(result["loss"])
    assert all(shape[1] == 2 + 6 + 2 and p is not None
               and np.isfinite(p).all() for shape, p in added)
    assert sum(shape[0] for shape, _ in added) == svc.replay.added
