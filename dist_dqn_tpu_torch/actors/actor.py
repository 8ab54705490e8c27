"""Ape-X rollout actor processes (twin of ``dist_dqn_tpu/actors/actor.py``):
env stepping only, no network.

All inference runs batched on the card inside the learner service, so an
actor never sees parameters: it sends its observations, waits for the
actions, steps its vector env, and streams the step results back.
:func:`run_actor` (same host) publishes through its shared-memory slot ring
(zero-copy records; the q planes of each act reply ride the next record,
and the service seeds insertion priorities from them) or, with the legacy
codec, through the shared request ring, and reads its act mailbox.
:func:`run_remote_actor` (another host) speaks the same records over TCP in
lock-step, reconnecting with a fresh hello when the connection drops.

Each actor process keeps its own telemetry registry (a wall-clock
heartbeat gauge, its env steps and, remote, its connects) and dumps it at
exit or SIGTERM where ``DQN_TELEMETRY_SNAPSHOT`` names a file (``{pid}`` and
``{tag}`` expand per process). Where ``DQN_FORENSICS_DIR`` is set each
actor arms its own stall watchdog and beats an ``actor.loop`` heartbeat
every step, so a worker wedged inside ``env.step`` or a transport wait
dumps its own forensics bundle. Each actor arms its slice of the parent's
chaos plan from ``DQN_CHAOS_PLAN`` and fires the ``actor.step`` seam once a
step-loop pass (wedge, crash, slow_start); a remote actor's re-established,
re-hello'd connection marks ``transport.send`` recovered. This module
imports numpy and no torch: the service starts actors with the ``spawn``
method, and an actor never initialises CUDA.
"""
from __future__ import annotations

import os
import time

import numpy as np

from dist_dqn_tpu_torch import chaos, ingest
from dist_dqn_tpu_torch.actors.transport import (CORRUPT_FRAME_NACK_KIND,
                                                 PROTO_MISMATCH_NACK_KIND,
                                                 ShmMailbox, ShmRing,
                                                 decode_arrays, encode_arrays)
from dist_dqn_tpu_torch.envs.gym_adapter import make_host_env
from dist_dqn_tpu_torch.telemetry import (get_registry,
                                          maybe_install_snapshot_from_env)
from dist_dqn_tpu_torch.telemetry import watchdog


def _actor_telemetry(actor_id: int, tag: str):
    """Per-process liveness instruments (JAX ``actors/actor.py:32-56``): a
    wall-clock heartbeat gauge and the steps counter. Actors are separate
    processes, so the registry is process-local; ``DQN_TELEMETRY_SNAPSHOT``
    dumps it on exit (SIGTERM included), which is how a post-mortem tells
    a wedged actor (stale heartbeat) from a dead one.

    Also arms the process's stall watchdog from ``DQN_FORENSICS_DIR`` (the
    service CLI's ``--forensics-dir`` exports it) and returns the
    ``actor.loop`` stage heartbeat."""
    reg = get_registry()
    maybe_install_snapshot_from_env(tag=f"{tag}{actor_id}")
    watchdog.maybe_install_from_env()
    # Spawned workers arm their slice of the parent's fault plan from
    # DQN_CHAOS_PLAN, like the watchdog/snapshot env twins above — a game
    # day reaches into every process of the fleet.
    chaos.maybe_install_from_env()
    labels = {"actor": str(actor_id)}
    return (reg.gauge("dqn_actor_heartbeat_timestamp",
                      "unix time of the last step-loop pass", labels),
            reg.counter("dqn_actor_env_steps_total",
                        "env steps taken by this actor process", labels),
            # Startup grace: the first pass waits on the service's first
            # act, which pays its one-time set-up.
            watchdog.heartbeat("actor.loop",
                               startup_grace_s=watchdog.STARTUP_GRACE_S))


def _chaos_step_seam() -> None:
    """The per-pass ``actor.step`` seam: wedge (sleep through heartbeat
    deadlines — the watchdog's prey), crash (kill -9 semantics: no
    cleanup, no snapshot flush — supervision must restart us), or
    slow_start (spawn-time stagger). Interpreted here so the local and
    remote step loops cannot drift."""
    ev = chaos.fire("actor.step")
    if ev is None:
        return
    if ev.fault == "crash":
        os._exit(137)           # SIGKILL's exit code: die WITHOUT cleanup
    chaos.sleep_for(ev)         # wedge / slow_start
    chaos.mark_recovered("actor.step")


def _step_and_encode(env, actions, actor_id: int, t: int,
                     compress: "bool | str" = False):
    """Step the vector env and build the legacy-codec step record (shared
    by the shared-memory and TCP paths). The TCP caller passes
    ``compress="auto"``: large pixel records shrink under zlib before they
    cross hosts. Returns (obs, t + 1, payload)."""
    obs, next_obs, reward, terminated, truncated = env.step(actions)
    payload = encode_arrays(
        {"obs": obs, "reward": reward,
         "terminated": terminated.astype(np.uint8),
         "truncated": truncated.astype(np.uint8),
         "next_obs": next_obs},
        {"kind": "step", "actor": actor_id, "t": t + 1},
        compress=compress)
    return obs, t + 1, payload


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
    """Entry point of one same-host actor process (the ``spawn`` target).

    ``transport="zerocopy"``: trajectories publish into this actor's slot
    ring (``{req_ring}_zc_{actor_id}``, created by the service) as
    schema-negotiated zero-copy records, and act replies carry the q planes
    the next record echoes; ``dedup``: on frame-stacked pixel envs each
    physical frame ships once. ``"legacy"``: JSON-header records through
    the shared request ring ``req_ring``. Act replies arrive in the
    ``act_box`` mailbox, versioned by the step they answer. The loop ends
    at ``max_env_steps`` or when ``stop_path`` exists.
    """
    env = make_host_env(env_name, num_envs, seed=seed)
    obs = env.reset()
    t = 0
    enc = None
    shard = 0
    if transport == "zerocopy":
        schema = ingest.step_schema(obs.shape[1:], obs.dtype, num_envs)
        fs = _negotiate_dedup(env, obs, transport, dedup)
        enc = (ingest.DedupStepEncoder(schema, fs) if fs
               else ingest.StepEncoder(schema))
        ring = ingest.ShmSlotRing(f"{req_ring}_zc_{actor_id}")
        payload = encode_arrays({"obs": obs},
                                _hello_meta(actor_id, t, transport, schema,
                                            dedup_stack=fs))
    else:
        ring = ShmRing(req_ring)
        payload = encode_arrays({"obs": obs},
                                _hello_meta(actor_id, t, transport))
    box = ShmMailbox(act_box)
    heartbeat, steps_total, hb_stage = _actor_telemetry(actor_id, "actor")
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
            if enc is not None:
                actions, q_sel, q_max, hdr = ingest.decode_reply(data)
                shard = hdr["shard"]       # the sticky routing tag, echoed
                params_ver = hdr.get("params_version", params_ver)
                _chaos_step_seam()
                obs, t, payload = _step_and_encode_zc(
                    env, actions, enc, actor_id, t, shard, q_sel, q_max,
                    params_version=params_ver)
            else:
                # A rejected same-host hello raises in the service itself
                # (a deploy bug, not wire churn): no NACK handling here.
                arrays, _ = decode_arrays(data)
                _chaos_step_seam()
                obs, t, payload = _step_and_encode(env, arrays["action"],
                                                   actor_id, t)
            steps += num_envs
            steps_total.inc(num_envs)
            heartbeat.set(time.time())
            hb_stage.beat()
            while not ring.push(payload):
                if os.path.exists(stop_path):
                    return
                time.sleep(0.001)
    finally:
        # The slot ring holds numpy views of the mapping: release them
        # before interpreter teardown closes the segment.
        if hasattr(ring, "close"):
            ring.close()


def run_remote_actor(actor_id: int, env_name: str, num_envs: int, seed: int,
                     address, stop_path: str,
                     max_env_steps: int = 10 ** 12,
                     max_consecutive_failures: int = 60,
                     reconnect_backoff_s: float = 0.5,
                     transport: str = "zerocopy",
                     dedup: bool = True) -> None:
    """An actor on another host: the same stepping loop over TCP.

    Lock-step per actor: push an observation record, block on the action
    reply, step the vector env, stream the results back. On a dropped
    connection (or a corrupt-frame NACK) the actor reconnects and
    introduces itself with a fresh hello, which restarts its dedup chain;
    the service then resets the actor's assembly lanes and recurrent carry,
    so the gap never reaches stored experience. A protocol-mismatch NACK
    raises: that is build drift, not churn.

    Reconnects back off exponentially (doubling per consecutive failure up
    to 10 s) with jitter in [0.5, 1) of the step, drawn from a stream
    seeded by ``seed``, so a replay sees the same schedule. The worker
    exits after ``max_consecutive_failures`` failed connects in a row (the
    learner is gone) or when ``stop_path`` exists.
    """
    from dist_dqn_tpu_torch.actors.transport import TcpRecordClient

    env = make_host_env(env_name, num_envs, seed=seed)
    max_reconnect_backoff_s = 10.0
    jitter_rng = np.random.default_rng(
        np.random.SeedSequence(seed, spawn_key=(0x6A17,)))
    enc = None
    schema = None
    dedup_fs = 0

    def connect_and_hello(obs, t):
        client = TcpRecordClient(tuple(address))
        if enc is not None and hasattr(enc, "reset"):
            # A fresh hello is a fresh dedup chain: the service rebuilds
            # its decoder on the hello.
            enc.reset()
        client.push(encode_arrays(
            {"obs": obs}, _hello_meta(actor_id, t, transport, schema,
                                      dedup_stack=dedup_fs),
            compress="auto"))
        return client

    heartbeat, steps_total, hb_stage = _actor_telemetry(actor_id, "remote")
    reconnects = get_registry().counter(
        "dqn_actor_reconnects_total",
        "remote-actor connection (re)establishments",
        labels={"actor": str(actor_id)})
    obs = env.reset()
    t = 0
    shard = 0
    params_ver = 0
    if transport == "zerocopy":
        schema = ingest.step_schema(obs.shape[1:], obs.dtype, num_envs)
        dedup_fs = _negotiate_dedup(env, obs, transport, dedup)
        enc = (ingest.DedupStepEncoder(schema, dedup_fs) if dedup_fs
               else ingest.StepEncoder(schema))
    failures = 0
    client = None       # the first connect goes through the retry path too
    steps = 0

    def keep_waiting():
        return not os.path.exists(stop_path)

    while steps < max_env_steps and not os.path.exists(stop_path) \
            and failures < max_consecutive_failures:
        if client is None:
            try:
                client = connect_and_hello(obs, t)
                failures = 0
                reconnects.inc()
                # A re-established, re-hello'd connection IS the
                # recovery proof for send-side faults (disconnect,
                # truncate, drop) — close any open transport.send trip.
                chaos.mark_recovered("transport.send")
            except OSError:
                failures += 1
                hb_stage.beat()      # retrying is responsive, not wedged
                backoff = min(reconnect_backoff_s
                              * (2.0 ** min(failures - 1, 6)),
                              max_reconnect_backoff_s)
                # Jitter below the cap: the cap stays a true bound on
                # every sleep while capped lanes still spread out.
                time.sleep(backoff * jitter_rng.uniform(0.5, 1.0))
            continue
        reply = client.read_reply(keep_waiting)
        if reply is None:            # connection lost: reconnect + re-hello
            client.close()
            client = None
            continue
        q_sel = q_max = None
        if enc is not None and ingest.is_zc(reply):
            actions, q_sel, q_max, hdr = ingest.decode_reply(reply)
            shard = hdr["shard"]
            params_ver = hdr.get("params_version", params_ver)
        else:
            arrays, meta = decode_arrays(reply)
            if meta.get("kind") == CORRUPT_FRAME_NACK_KIND:
                # Our last frame was dropped at the integrity gate: the
                # action will never come. Reconnect and re-hello now.
                client.close()
                client = None
                continue
            if meta.get("kind") == PROTO_MISMATCH_NACK_KIND:
                raise RuntimeError(
                    f"actor {actor_id}: service rejected hello — "
                    f"{meta.get('detail', 'protocol mismatch')}")
            actions = arrays["action"]
        _chaos_step_seam()
        if enc is not None:
            obs, t, payload = _step_and_encode_zc(
                env, actions, enc, actor_id, t, shard, q_sel, q_max,
                params_version=params_ver)
        else:
            obs, t, payload = _step_and_encode(env, actions, actor_id, t,
                                               compress="auto")
        steps += num_envs
        steps_total.inc(num_envs)
        heartbeat.set(time.time())
        hb_stage.beat()
        if not client.push(payload):
            client.close()
            client = None
    if client is not None:
        client.close()
