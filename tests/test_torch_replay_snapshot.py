"""Warm-replay snapshots of the port's Ape-X service (``--checkpoint-replay``
under ``--runtime apex``) and ``replay/sharded.py restore_replay_snapshot``:

* the twin of JAX's ``test_apex_replay_snapshot_resume``: a resumed service
  starts from the previous run's shard (every saved item restored) and
  keeps training from it; here its ``min_fill`` is above what the second
  run inserts, so it trains only because the shard came back warm;
* the same through the device plane (``device_sampling``, on the CPU): the
  restore rewrites the plane's mass, equal bit for bit to the snapshot's;
* a snapshot written by the JAX package's ``PrioritizedHostReplay.
  state_dict`` (and its ``atomic_savez``) restores in the port and draws
  the same items, indices and IS weights as the JAX store restored from
  it (exact: both draw from the same seeded numpy stream);
* a sharded snapshot is refused naming ROADMAP.md A6 (the migration).
"""
import dataclasses
import json
import os

import numpy as np
import pytest

from dist_dqn_tpu.replay import host as jhost
from dist_dqn_tpu.utils.checkpoint import atomic_savez as jax_atomic_savez
from dist_dqn_tpu_torch import config as tconfig
from dist_dqn_tpu_torch.actors import service as tservice
from dist_dqn_tpu_torch.replay import host as thost
from dist_dqn_tpu_torch.replay.sharded import restore_replay_snapshot

_FF = ["network.torso=mlp", "network.mlp_features=(32,)", "network.hidden=0",
       "network.compute_dtype=float32", "replay.capacity=4096",
       "replay.min_fill=200", "learner.batch_size=32"]


def _rows(logs, key):
    out = []
    for line in logs:
        try:
            row = json.loads(line)
        except (TypeError, ValueError):
            continue
        if key in row:
            out.append(row)
    return out


@pytest.mark.parametrize("device_sampling", [False, True])
def test_apex_replay_snapshot_resume(tmp_path, device_sampling):
    cfg = tconfig.apply_overrides(tconfig.CONFIGS["apex"], _FF)
    d = str(tmp_path / "run")
    rt = tservice.ApexRuntimeConfig(host_env="CartPole-v1", num_actors=2,
                                    envs_per_actor=4, total_env_steps=1200,
                                    checkpoint_dir=d, checkpoint_replay=True,
                                    save_every_steps=600,
                                    device_sampling=device_sampling)
    logs1 = []
    first = tservice.run_apex(cfg, rt, log_fn=logs1.append, device="cpu")
    assert first["replay_size"] > 500 and first["replay_snapshot"] is None
    saves = _rows(logs1, "replay_snapshot_items")
    assert len(saves) >= 2
    assert saves[-1]["replay_snapshot_items"] == first["replay_size"]
    assert os.path.exists(os.path.join(d, "replay_shard.npz"))
    with np.load(os.path.join(d, "replay_shard.npz")) as f:
        saved_mass = f["mass"].copy()

    # The second run inserts about 800 transitions: fewer than its
    # min_fill, so it trains only from the restored shard.
    cfg2 = tconfig.apply_overrides(cfg, ["replay.min_fill=1000"])
    svc = tservice.ApexLearnerService(
        cfg2, dataclasses.replace(rt, total_env_steps=2000),
        log_fn=(logs2 := []).append, device="cpu")
    assert len(svc.replay) == first["replay_size"]
    if device_sampling:
        svc.replay.device_sampler._flush_writes()
        plane = svc.replay.device_sampler.plane.reshape(-1)[:4096].numpy()
        assert plane.dtype == np.float32
        np.testing.assert_array_equal(plane, saved_mass.astype(np.float32))
    else:
        np.testing.assert_array_equal(
            svc.replay.tree.get(np.arange(4096)), saved_mass)
    second = svc.run()
    restored = _rows(logs2, "replay_snapshot_restored_items")
    assert restored and restored[0]["replay_snapshot_restored_items"] \
        == first["replay_size"]
    assert restored[0]["replay_snapshot_resharded"] is False
    assert second["replay_snapshot"] == restored[0]
    assert second["env_steps"] >= 2000
    assert second["replay_size"] >= first["replay_size"]
    assert second["replay_size"] - first["replay_size"] < 1000
    assert second["grad_steps"] > 0
    if device_sampling:
        assert second["device_calls"]["replay_sample"] \
            == second["grad_steps"]


def _items(rng, n, start):
    return {"obs": rng.integers(0, 255, (n, 3, 2)).astype(np.uint8),
            "action": rng.integers(0, 4, n).astype(np.int32),
            "reward": rng.normal(size=n).astype(np.float32),
            "id": np.arange(start, start + n, dtype=np.int64)}


def test_a_jax_snapshot_restores_and_draws_like_jax(tmp_path):
    rng = np.random.default_rng(5)
    src = jhost.PrioritizedHostReplay(500, alpha=0.6, native=False)
    for step in range(4):
        src.add(_items(rng, 180, step * 180),
                priorities=np.abs(rng.normal(size=180)) + 0.1)
        idx = rng.integers(0, len(src), 64)
        src.update_priorities(idx, np.abs(rng.normal(size=64)),
                              expected_gen=src.generation(idx))
    path = str(tmp_path / "replay_shard.npz")
    jax_atomic_savez(path, **src.state_dict())
    with np.load(path) as f:
        state = dict(f)
    theirs = jhost.PrioritizedHostReplay(500, alpha=0.6, native=False)
    theirs.load_state_dict(state)
    # The numpy tree on both sides (JAX's C++ tree does not compile with
    # g++ 12; the port's agrees with numpy to rtol 1e-12 only).
    ours = thost.PrioritizedHostReplay(500, alpha=0.6, native=False)
    info = restore_replay_snapshot(ours, state)
    assert info == {"records": 500, "from_shards": 1, "to_shards": 1,
                    "resharded": False}
    for beta in (0.4, 1.0):
        (gi, gidx, gw), (wi, widx, ww) = (ours.sample(64, beta),
                                          theirs.sample(64, beta))
        np.testing.assert_array_equal(gidx, widx)
        np.testing.assert_array_equal(gw, ww)
        for k in wi:
            np.testing.assert_array_equal(gi[k], wi[k])
    np.testing.assert_array_equal(ours.generation(np.arange(500)),
                                  theirs.generation(np.arange(500)))
    # Into the device plane (on the CPU): the mass is the snapshot's, in
    # f32, and a draw at explicit uniforms lands on live slots.
    dev = thost.PrioritizedHostReplay(500, alpha=0.6, sampler="device",
                                      sampler_device="cpu")
    restore_replay_snapshot(dev, state)
    dev.device_sampler._flush_writes()
    np.testing.assert_array_equal(
        dev.device_sampler.plane.reshape(-1)[:500].numpy(),
        state["mass"].astype(np.float32))
    assert dev.device_sampler.total == pytest.approx(
        float(state["mass"].astype(np.float32).astype(np.float64).sum()))
    idx, mass = dev.device_sampler.sample_at(
        (np.arange(32) + 0.5) / 32, len(dev))
    assert (idx < 500).all() and (mass > 0).all()


def test_a_sharded_snapshot_is_refused_naming_a6():
    """A sharded snapshot, once refused, now migrates: JAX's 2-shard store
    restored into one shard lands every live record once with its saved
    mass, into the port's store exactly as into JAX's (records, mass,
    cursors, the evidence dict)."""
    from dist_dqn_tpu.replay.host import PrioritizedHostReplay as JStore
    from dist_dqn_tpu.replay.sharded import \
        ShardedPrioritizedReplay as JSharded
    from dist_dqn_tpu.replay.sharded import \
        restore_replay_snapshot as jax_restore

    rng = np.random.default_rng(5)
    src = JSharded(2, 64, native=False)
    for s in (0, 1, 0):
        n = 40
        src.add({"id": rng.random(n).astype(np.float32),
                 "action": rng.integers(0, 4, n).astype(np.int32)},
                priorities=rng.random(n) + 0.1, shard=s)
    state = src.state_dict()
    theirs = JStore(48, native=False)
    want = jax_restore(theirs, state)
    ours = thost.PrioritizedHostReplay(48, native=False)
    got = restore_replay_snapshot(ours, state)
    assert got == want and got["resharded"] and got["from_shards"] == 2
    for k, v in theirs.state_dict().items():
        np.testing.assert_array_equal(ours.state_dict()[k], v, err_msg=k)
