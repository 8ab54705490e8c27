"""The port's in-RAM trajectory feeders (dist_dqn_tpu_torch/actors/feeder.py)
against dist_dqn_tpu/actors/feeder.py, mirroring tests/test_feeder.py: the
spec names, the spec env's draws and the pre-encoded pools equal JAX's
exactly at one seed, and feeder processes drive the port's service end to
end (drain, batched act, assembly, priorities, insert, train), unbatched
and with four records per slot publish."""
import dataclasses
import multiprocessing
import os
import time

import numpy as np
import pytest

from dist_dqn_tpu.actors import feeder as jfeeder
from dist_dqn_tpu_torch.actors import feeder as tfeeder
from dist_dqn_tpu_torch.actors.service import (ApexLearnerService,
                                               ApexRuntimeConfig)
from dist_dqn_tpu_torch.config import CONFIGS
from dist_dqn_tpu_torch.envs.gym_adapter import make_host_env


def test_constants_equal_jax():
    assert (tfeeder.POOL_RECORDS, tfeeder.P_TERMINATED,
            tfeeder.P_TRUNCATED) == (jfeeder.POOL_RECORDS,
                                     jfeeder.P_TERMINATED,
                                     jfeeder.P_TRUNCATED)


@pytest.mark.parametrize("name", ["feeder:pixel", "feeder:vector",
                                  "feeder:bogus"])
def test_parse_feeder_spec_like_jax(name):
    try:
        want = jfeeder.parse_feeder_spec(name)
    except ValueError as e:
        with pytest.raises(ValueError, match="unknown feeder spec") as got:
            tfeeder.parse_feeder_spec(name)
        assert str(got.value) == str(e)
        return
    assert tfeeder.parse_feeder_spec(name) == want


@pytest.mark.parametrize("spec", ["feeder:pixel", "feeder:vector"])
def test_feeder_spec_env_draws_like_jax(spec):
    """The null env's contract (reset obs of the spec's shape, the 5-tuple
    with scalar flags) and its draws, equal to JAX's at one seed."""
    ours, theirs = tfeeder.FeederSpecEnv(spec, 0), jfeeder.FeederSpecEnv(
        spec, 0)
    assert (ours.obs_shape, ours.obs_dtype, ours.num_actions) == (
        theirs.obs_shape, theirs.obs_dtype, theirs.num_actions)
    a, _ = ours.reset(seed=1)
    b, _ = theirs.reset(seed=1)
    assert a.shape == ours.obs_shape and a.dtype == ours.obs_dtype
    np.testing.assert_array_equal(a, b)
    for step in range(400):
        got, want = ours.step(step % 2), theirs.step(step % 2)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1:4] == want[1:4]
        assert isinstance(got[1], float) and isinstance(got[2], bool)
        assert not (got[2] and got[3])


@pytest.mark.parametrize("transport", ["legacy", "zerocopy"])
@pytest.mark.parametrize("spec", ["feeder:pixel", "feeder:vector"])
def test_build_pool_bytes_equal_jax(monkeypatch, transport, spec):
    """The hello and every pool record, byte for byte, at one seed; the
    zero-copy records carry their birth time, pinned here."""
    monkeypatch.setattr(time, "time", lambda: 1234.5)
    shape, dtype, _ = tfeeder.parse_feeder_spec(spec)
    got = tfeeder._build_pool(np.random.default_rng(3), 1, 4, shape, dtype,
                              transport=transport)
    want = jfeeder._build_pool(np.random.default_rng(3), 1, 4, shape, dtype,
                               transport=transport)
    assert got[0] == want[0]
    assert len(got[1]) == len(want[1]) == tfeeder.POOL_RECORDS
    for a, b in zip(got[1], want[1]):
        assert bytes(a) == bytes(b)


def test_make_host_env_feeder():
    env = make_host_env("feeder:vector", 3)
    assert env.num_actions == 2
    assert env.reset().shape == (3, 4)
    pixel = make_host_env("feeder:pixel", 2)
    assert pixel.num_actions == 6
    assert pixel.reset().shape == (2, 84, 84, 4)


def _leftovers(run_id: str):
    shm = "/dev/shm"
    if not os.path.isdir(shm):
        return []
    left = [n for n in os.listdir(shm) if n.startswith(f"req_{run_id}")]
    if os.path.exists(os.path.join(shm, "dqn_torch", run_id)):
        left.append(f"dqn_torch/{run_id}")
    return left


@pytest.mark.parametrize("shm_batch", [1, 4])
def test_feeders_drive_the_service(shm_batch, tmp_path):
    """Two feeder processes of 4 lanes through the shared-memory slot rings
    fill a small store, and the learner trains on it: tests/test_feeder.py's
    bars, no torn or bad record, and after the run no feeder process and
    no shared-memory entry is left. The batched run also traces its first
    train event, whose export the loop's split counts apart."""
    traced = shm_batch > 1
    cfg = CONFIGS["apex"]
    cfg = dataclasses.replace(
        cfg,
        network=dataclasses.replace(cfg.network, torso="mlp",
                                    mlp_features=(32,), hidden=0,
                                    compute_dtype="float32"),
        replay=dataclasses.replace(cfg.replay, capacity=4096, min_fill=64),
        learner=dataclasses.replace(cfg.learner, batch_size=32),
    )
    rt = ApexRuntimeConfig(host_env="feeder:vector", num_actors=2,
                           envs_per_actor=4, total_env_steps=6000,
                           inserts_per_grad_step=64, shm_batch=shm_batch,
                           profile_dir=(str(tmp_path / "profile") if traced
                                        else None))
    svc = ApexLearnerService(cfg, rt, log_fn=lambda s: None, device="cpu")
    t0 = time.perf_counter()
    result = svc.run()
    assert time.perf_counter() - t0 < 60
    assert result["env_steps"] >= 6000
    assert result["replay_size"] > 500
    assert result["grad_steps"] >= 4
    assert result["bad_records"] == 0
    assert result["ingest_torn_reads"] == 0
    assert result["ingest_decode_errors"] == 0
    # Feeders never wait on their mailbox, so a full ring is expected
    # backpressure (retried, not lost); no feeder restarts.
    assert result["actor_restarts"] == 0
    assert result["shm_batch"] == shm_batch
    assert result["ingest_device_calls_per_pass"] == 1.0
    assert np.isfinite(result["loss"])
    # The loop's parts are timed apart and add up to at most the run's
    # wall; every grad step fell in a pass that trained (at most
    # train_steps_per_pass of them each).
    loop_s = result["loop_s"]
    assert set(loop_s) == {"drain", "act", "bootstrap", "train", "trace",
                           "idle"}
    assert (loop_s["trace"] > 0.0) == traced
    assert (svc.profile_row is not None) == traced
    assert all(v >= 0.0 for v in loop_s.values())
    assert loop_s["train"] > 0.0 and sum(loop_s.values()) <= result["run_s"]
    assert 0 < result["train_passes"] <= result["ingest_passes"]
    assert result["grad_steps"] <= \
        rt.train_steps_per_pass * result["train_passes"]
    assert svc.procs == {}
    assert not multiprocessing.active_children()
    assert _leftovers(svc.run_id) == []
