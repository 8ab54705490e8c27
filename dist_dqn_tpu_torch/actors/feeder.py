"""In-RAM trajectory feeders (twin of ``dist_dqn_tpu/actors/feeder.py``): a
load generator for the learner service.

A feeder process replays pre-generated, pre-encoded step records through
the service's shared-memory transport as fast as the ring takes them, so
the service runs its whole path (drain, batched act, n-step assembly,
priority seeding, PER insert, train, priority write-back) with no emulator
in the loop: what saturates is the service, not the envs. A feeder speaks
the actor protocol (a hello, then step records) but waits on its act
mailbox only for the hello's reply; the service cannot tell it from an
actor.

``host_env="feeder:pixel"`` (84x84x4 uint8, 6 actions: the Atari frame
contract) or ``"feeder:vector"`` (4-dim float32, 2 actions) makes the
service spawn :func:`run_feeder` in place of ``actors/actor.py run_actor``;
``make_host_env`` serves the same names (:class:`FeederSpecEnv`), so the
service's env probe and evaluation work unchanged.

The JAX module's registry counters, watchdog heartbeat and chaos seams are
not ported (ROADMAP.md A10). This module imports numpy and no torch.
"""
from __future__ import annotations

import os
import time
from typing import Tuple

import numpy as np

from dist_dqn_tpu_torch import ingest
from dist_dqn_tpu_torch.actors.transport import (ShmMailbox, ShmRing,
                                                 encode_arrays)

#: Records pre-encoded per feeder, cycled round-robin while pumping.
POOL_RECORDS = 48
#: Per-lane episode end rates of the synthetic stream: high enough that
#: every episode-boundary path of the assembler runs all the time.
P_TERMINATED = 1.0 / 300.0
P_TRUNCATED = 1.0 / 2000.0


def parse_feeder_spec(name: str) -> Tuple[Tuple[int, ...], np.dtype, int]:
    """``feeder:<preset>`` -> (obs_shape, obs_dtype, num_actions)."""
    preset = name.split(":", 1)[1]
    if preset == "pixel":
        return (84, 84, 4), np.dtype(np.uint8), 6
    if preset == "vector":
        return (4,), np.dtype(np.float32), 2
    raise ValueError(
        f"unknown feeder spec {name!r}; expected feeder:pixel or "
        f"feeder:vector")


class FeederSpecEnv:
    """A single env of random draws with a feeder spec's shapes (the
    service's env probe and evaluation; ``make_host_env`` vectorises it)."""

    def __init__(self, spec: str, seed: int = 0):
        self.obs_shape, self.obs_dtype, self.num_actions = \
            parse_feeder_spec(spec)
        self._rng = np.random.default_rng(seed)

    def _obs(self) -> np.ndarray:
        if self.obs_dtype == np.uint8:
            return self._rng.integers(
                0, 256, self.obs_shape).astype(np.uint8)
        return self._rng.normal(size=self.obs_shape).astype(self.obs_dtype)

    def reset(self, seed=None):
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        return self._obs(), {}

    def step(self, action):
        nxt = self._obs()
        reward = float(self._rng.normal())
        terminated = bool(self._rng.random() < P_TERMINATED)
        # The flags exclude each other, as every real env adapter's do.
        truncated = (not terminated
                     and bool(self._rng.random() < P_TRUNCATED))
        return nxt, reward, terminated, truncated, {}


def _build_pool(rng: np.random.Generator, actor_id: int, lanes: int,
                obs_shape: Tuple[int, ...], obs_dtype: np.dtype,
                transport: str = "legacy"):
    """(hello payload, [step payloads]): one synthetic trajectory slice,
    encoded once up front so the pump loop is a pure ring copy.

    ``transport="zerocopy"`` builds zero-copy records, each with a
    synthetic q-plane pair (the priority inputs real actors echo from their
    act replies), so a feeder run drives the service's actor-priority
    ingest; their lineage trailer says "born at pool build, params version
    0", since a feeder never acts.
    """
    def obs_batch():
        if obs_dtype == np.uint8:
            return rng.integers(0, 256, (lanes,) + obs_shape
                                ).astype(np.uint8)
        return rng.normal(size=(lanes,) + obs_shape).astype(obs_dtype)

    from dist_dqn_tpu_torch.actors.actor import _hello_meta

    zc = transport == "zerocopy"
    schema = (ingest.step_schema(obs_shape, obs_dtype, lanes)
              if zc else None)
    enc = ingest.StepEncoder(schema) if zc else None
    hello = encode_arrays({"obs": obs_batch()},
                          _hello_meta(actor_id, 0, transport, schema))
    steps = []
    for t in range(POOL_RECORDS):
        terminated = rng.random((lanes,)) < P_TERMINATED
        # Never both flags on one step, as real actors report them.
        truncated = (rng.random((lanes,)) < P_TRUNCATED) & ~terminated
        arrays = {
            "obs": obs_batch(),
            "reward": rng.normal(size=(lanes,)).astype(np.float32),
            "terminated": terminated.astype(np.uint8),
            "truncated": truncated.astype(np.uint8),
            "next_obs": obs_batch()}
        if zc:
            # A bytes copy: pool records outlive the encoder's reusable
            # buffer.
            steps.append(bytes(enc.encode_step(
                arrays, actor=actor_id, t=t + 1,
                q_sel=rng.normal(size=(lanes,)).astype(np.float32),
                q_max=rng.normal(size=(lanes,)).astype(np.float32),
                birth_time=time.time(), params_version=0)))
        else:
            steps.append(encode_arrays(
                arrays, {"kind": "step", "actor": actor_id, "t": t + 1}))
    return hello, steps


def run_feeder(actor_id: int, spec: str, num_envs: int, seed: int,
               req_ring: str, act_box: str, stop_path: str,
               max_env_steps: int = 10 ** 12,
               transport: str = "legacy", shm_batch: int = 1) -> None:
    """Entry point of one feeder process (the ``spawn`` target).

    The arguments are ``actors/actor.py run_actor``'s, so the service spawns
    either the same way: ``req_ring`` names the slot ring's prefix
    (zero-copy: ``{req_ring}_zc_{actor_id}``) or the shared request ring
    (legacy). ``act_box`` is read only for the hello's reply. With
    ``shm_batch`` > 1 on the zero-copy ring, each slot publish carries that
    many step records; the service sizes the slots for it. 1 is the
    unbatched wire.
    """
    obs_shape, obs_dtype, _ = parse_feeder_spec(spec)
    rng = np.random.default_rng(seed)
    hello, pool = _build_pool(rng, actor_id, num_envs, obs_shape,
                              obs_dtype, transport=transport)
    ring = (ingest.ShmSlotRing(f"{req_ring}_zc_{actor_id}")
            if transport == "zerocopy" else ShmRing(req_ring))
    box = ShmMailbox(act_box)
    steps = 0
    i = 0
    stop = False
    try:
        while not ring.push(hello):
            if os.path.exists(stop_path):
                return
            time.sleep(0.001)
        # Wait for the hello's reply once: then the service has set this
        # actor's lanes before its first step record arrives. After that
        # the feeder pumps unthrottled.
        while not os.path.exists(stop_path):
            _, ver = box.read()
            if ver >= 1:
                break
            time.sleep(0.001)
        batching = shm_batch > 1 and transport == "zerocopy"
        last_mark = 0
        while steps < max_env_steps and not stop:
            if batching:
                pushed = ring.push_batch([pool[(i + k) % POOL_RECORDS]
                                          for k in range(shm_batch)])
            else:
                pushed = ring.push(pool[i % POOL_RECORDS])
            if pushed:
                n = shm_batch if batching else 1
                i += n
                steps += num_envs * n
                # The stop file is checked every 256 records, off the hot
                # path (a batched push may step over any single value).
                if i - last_mark >= 256:
                    stop = os.path.exists(stop_path)
                    last_mark = i
            else:
                # Ring full: the service is the bottleneck, which is what
                # a feeder run measures. Yield briefly and retry.
                time.sleep(0.0005)
                stop = os.path.exists(stop_path)
    finally:
        # The slot ring holds numpy views of the mapping: release them
        # before interpreter teardown.
        if hasattr(ring, "close"):
            ring.close()
