"""Ape-X rollout actor process (the zero-copy path of
``dist_dqn_tpu/actors/actor.py``): env stepping only, no network.

All inference runs batched on the card inside the learner service, so an
actor never sees parameters: it sends its observations, waits for its act
mailbox, steps its vector env, and streams the step results back as
zero-copy records through its shared-memory slot ring. The q planes of
each act reply ride the next step record, and the service seeds the
transitions' insertion priorities from them.

This module imports numpy and no torch: the service starts actors with the
``spawn`` method, and an actor never initialises CUDA.
"""
from __future__ import annotations

import os
import time

import numpy as np

from dist_dqn_tpu_torch import ingest
from dist_dqn_tpu_torch.actors.transport import ShmMailbox, encode_arrays
from dist_dqn_tpu_torch.envs.gym_adapter import make_host_env


def _step_and_encode_zc(env, actions, enc, actor_id: int, t: int,
                        shard: int, q_sel, q_max, params_version: int = 0):
    """Step the vector env and encode the zero-copy step record into the
    encoder's reusable buffer. The q planes (from the act reply this step
    consumed) are Q(obs, action) and max_a Q(obs) of this record's
    ``obs``; the lineage trailer carries the record's birth wall-time and
    ``params_version``, the learner's grad-step count echoed from that
    reply. Returns (obs, t + 1, payload memoryview, consumed before the
    next call)."""
    obs, next_obs, reward, terminated, truncated = env.step(actions)
    payload = enc.encode_step(
        {"obs": obs, "reward": np.asarray(reward, np.float32),
         "terminated": terminated.astype(np.uint8),
         "truncated": truncated.astype(np.uint8),
         "next_obs": next_obs},
        actor=actor_id, t=t + 1, shard=shard, q_sel=q_sel, q_max=q_max,
        birth_time=time.time(), params_version=params_version)
    return obs, t + 1, payload


def _hello_meta(actor_id: int, t: int, transport: str,
                schema=None, dedup_stack: int = 0) -> dict:
    """Hello metadata: the wire protocol version (a mismatch fails at
    connect), the transport, the trajectory schema every later frame is
    decoded with, and, for a dedup-capable actor, its frame-stack depth
    (a capability: an actor that omits it ships the plain layout)."""
    meta = {"kind": "hello", "actor": actor_id, "t": t,
            "proto": ingest.PROTOCOL_VERSION, "transport": transport}
    if schema is not None:
        meta["schema"] = schema.to_dict()
    if dedup_stack:
        meta["dedup"] = int(dedup_stack)
    return meta


def _negotiate_dedup(env, obs: np.ndarray, transport: str,
                     dedup: bool) -> int:
    """Frame-stack depth to declare in the hello, or 0: dedup engages
    only when the env declares the stacked-stream contract
    (``frame_stack``) and the obs layout matches it."""
    if transport != "zerocopy" or not dedup:
        return 0
    fs = int(getattr(env, "frame_stack", 0) or 0)
    if fs < 2:
        return 0
    if obs.ndim < 3 or obs.shape[-1] != fs:
        return 0
    return fs


def run_actor(actor_id: int, env_name: str, num_envs: int, seed: int,
              req_ring: str, act_box: str, stop_path: str,
              max_env_steps: int = 10 ** 12,
              transport: str = "zerocopy", dedup: bool = True) -> None:
    """Entry point of one actor process (the ``spawn`` target).

    Trajectories publish into this actor's slot ring
    (``{req_ring}_zc_{actor_id}``, created by the service) as
    schema-negotiated zero-copy records; act replies arrive in the
    ``act_box`` mailbox, versioned by the step they answer. ``dedup``: on
    frame-stacked pixel envs each physical frame ships once (the dedup
    plane). The loop ends at ``max_env_steps`` or when ``stop_path``
    exists.
    """
    if transport != "zerocopy":
        raise NotImplementedError(
            f"--transport {transport}: only the zerocopy actor is ported "
            "(ROADMAP.md A8)")
    env = make_host_env(env_name, num_envs, seed=seed)
    obs = env.reset()
    t = 0
    shard = 0
    schema = ingest.step_schema(obs.shape[1:], obs.dtype, num_envs)
    fs = _negotiate_dedup(env, obs, transport, dedup)
    enc = (ingest.DedupStepEncoder(schema, fs) if fs
           else ingest.StepEncoder(schema))
    ring = ingest.ShmSlotRing(f"{req_ring}_zc_{actor_id}")
    payload = encode_arrays({"obs": obs},
                            _hello_meta(actor_id, t, transport, schema,
                                        dedup_stack=fs))
    box = ShmMailbox(act_box)
    steps = 0
    params_ver = 0
    try:
        while not ring.push(payload):
            if os.path.exists(stop_path):
                return
            time.sleep(0.001)
        while steps < max_env_steps and not os.path.exists(stop_path):
            # Wait for the actions computed for our step-t observations.
            data, ver = box.read()
            if data is None or ver != t + 1:
                time.sleep(0.0002)
                continue
            actions, q_sel, q_max, hdr = ingest.decode_reply(data)
            shard = hdr["shard"]       # the sticky routing tag, echoed
            params_ver = hdr.get("params_version", params_ver)
            obs, t, payload = _step_and_encode_zc(
                env, actions, enc, actor_id, t, shard, q_sel, q_max,
                params_version=params_ver)
            steps += num_envs
            while not ring.push(payload):
                if os.path.exists(stop_path):
                    return
                time.sleep(0.001)
    finally:
        # The slot ring holds numpy views of the mapping: release them
        # before interpreter teardown closes the segment.
        ring.close()
