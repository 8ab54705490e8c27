"""Standalone policy-inference service CLI of the port (twin of
``python -m dist_dqn_tpu.serving``):
``python -m dist_dqn_tpu_torch.serving --config cartpole --checkpoint-dir d``.

Serves greedy (or per-tenant epsilon) actions from one or more training
runs' checkpoints over HTTP with dynamic micro-batching, checkpoint
hot-reload and SLO-backed backpressure. Runs on ``cuda`` unless
``--device cpu`` is given. Prints JSON lines: ``serving_warmup_*`` once
the bucket ladder ran, ``serving_port`` once requests are accepted, and
``serving_drained`` after SIGINT/SIGTERM, which drain the admitted
requests and exit 0 (also while still waiting for a first checkpoint).
``--telemetry-port`` also serves the registry on a separate telemetry
endpoint (logged as ``telemetry_port``), and ``--telemetry-snapshot``
dumps it at exit. ``--forensics-dir`` arms the stall watchdog (the
``serving.batcher`` heartbeat) and the divergence sentinel with forensics
bundles, as on the train CLI; ``--fleet-dir`` (or ``DQN_FLEET_DIR``)
announces the replica to the run's fleet. ``DQN_CHAOS_PLAN`` (inline JSON
or a file path) arms a fault plan for serving game days
(``serving.dispatch``, ``serving.reload``), as on the train CLI.
"""
from __future__ import annotations

import argparse
import json
import os
import signal
import threading

from dist_dqn_tpu_torch.config import CONFIGS, apply_overrides


def _parse_kv(pairs, what, cast=str):
    out = {}
    for raw in pairs:
        if "=" not in raw:
            raise ValueError(f"{what} expects NAME=VALUE, got {raw!r}")
        name, value = raw.split("=", 1)
        out[name] = cast(value)
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--config", choices=sorted(CONFIGS), required=True)
    parser.add_argument("--checkpoint-dir", default=None,
                        help="shorthand for --policy default=DIR")
    parser.add_argument("--policy", action="append", default=[],
                        metavar="NAME=DIR",
                        help="make checkpoint directory DIR resident as "
                             "tenant NAME (repeatable; all tenants share "
                             "the config's network architecture)")
    parser.add_argument("--policy-epsilon", action="append", default=[],
                        metavar="NAME=EPS",
                        help="per-tenant exploration epsilon (default: "
                             "--epsilon)")
    parser.add_argument("--epsilon", type=float, default=0.0,
                        help="default tenant epsilon (0 = greedy serving)")
    parser.add_argument("--host", default="127.0.0.1",
                        help="bind address for the act endpoint (loopback "
                             "by default — the surface is unauthenticated)")
    parser.add_argument("--port", type=int, default=0,
                        help="act endpoint port (0 = ephemeral, reported "
                             "as a serving_port log line)")
    parser.add_argument("--max-batch-rows", type=int, default=256,
                        help="row cap per dispatched act step (rounded "
                             "up to a power of two — the bucket ladder "
                             "tops out here)")
    parser.add_argument("--max-wait-ms", type=float, default=2.0,
                        help="micro-batch coalescing deadline: the queue "
                             "head never waits longer than this for "
                             "fan-in (bounds p99 at low load)")
    parser.add_argument("--queue-limit", type=int, default=256,
                        help="bounded admission queue: requests past this "
                             "are shed with 429 + Retry-After")
    parser.add_argument("--no-batching", action="store_true",
                        help="serialize one dispatch per request (the "
                             "A/B baseline)")
    parser.add_argument("--slo-p99-ms", type=float, default=0.0,
                        help="flip /healthz to 503 while the rolling p99 "
                             "request latency exceeds this (0 disables)")
    parser.add_argument("--slo-queue-depth", type=int, default=0,
                        help="flip /healthz to 503 while the admission "
                             "queue is deeper than this (0 disables)")
    parser.add_argument("--drain-timeout-s", type=float, default=5.0,
                        help="graceful-shutdown budget: on SIGTERM/"
                             "SIGINT the server stops accepting (new "
                             "requests answer 503), completes every "
                             "already-admitted request within this "
                             "window, then exits 0; stragglers past it "
                             "are failed at teardown")
    parser.add_argument("--poll-interval-s", type=float, default=10.0,
                        help="checkpoint hot-reload watcher period (reads "
                             "the run dir's atomic LATEST pointer)")
    parser.add_argument("--wait-for-checkpoint", type=float, default=0.0,
                        metavar="SECONDS",
                        help="at startup, retry an empty/absent "
                             "checkpoint directory for up to this long "
                             "instead of failing — for servers launched "
                             "alongside a fresh training run")
    parser.add_argument("--host-env", default=None,
                        help="probe this HOST env for the network's "
                             "action count/obs shape instead of the "
                             "config's env (apex-trained checkpoints, e.g. "
                             "CartPole-v1, ale:Pong)")
    parser.add_argument("--seed", type=int, default=0,
                        help="seed of the exploration draws")
    parser.add_argument("--device", choices=("cuda", "cpu"), default=None,
                        help="default: cuda, which must be present")
    parser.add_argument("--set", dest="overrides", action="append",
                        metavar="PATH=VALUE", default=[],
                        help="override config fields by dotted path (must "
                             "match how the checkpoints were trained)")
    parser.add_argument("--telemetry-port", type=int, default=None,
                        help="ALSO serve the registry on a separate "
                             "telemetry endpoint (the act server already "
                             "exposes /metrics + /healthz)")
    parser.add_argument("--telemetry-host", default="127.0.0.1",
                        help="bind address for --telemetry-port")
    parser.add_argument("--telemetry-snapshot", default=None,
                        help="dump a registry JSON snapshot here at exit")
    parser.add_argument("--fleet-dir", default=None,
                        help="fleet registry directory: "
                             "announce this replica's metrics endpoint "
                             "(the telemetry server when started, else "
                             "the act server — it serves /metrics + "
                             "/healthz too) to the run's aggregator; "
                             "defaults to $DQN_FLEET_DIR")
    parser.add_argument("--forensics-dir", default=None,
                        help="arm the stall watchdog (serving.batcher "
                             "heartbeat) + forensics bundles, as on the "
                             "train CLI")
    parser.add_argument("--watchdog-deadline-s", type=float, default=120.0)
    args = parser.parse_args(argv)
    if args.telemetry_snapshot:
        # Written at exit: the drain below ends in a normal exit, whose
        # atexit leg dumps it whichever SIGTERM handler came first.
        from dist_dqn_tpu_torch.telemetry import install_snapshot_dump
        install_snapshot_dump(args.telemetry_snapshot)
    if args.forensics_dir:
        from dist_dqn_tpu_torch.telemetry import watchdog
        watchdog.install_watchdog(forensics_dir=args.forensics_dir,
                                  deadline_s=args.watchdog_deadline_s)
        watchdog.install_sentinel(forensics_dir=args.forensics_dir)

    try:
        cfg = apply_overrides(CONFIGS[args.config], args.overrides)
        policies = _parse_kv(args.policy, "--policy")
        policy_epsilon = _parse_kv(args.policy_epsilon, "--policy-epsilon",
                                   cast=float)
    except ValueError as e:
        parser.error(str(e))
    if args.checkpoint_dir:
        policies.setdefault("default", args.checkpoint_dir)
    if not policies:
        parser.error("pass --checkpoint-dir DIR or --policy NAME=DIR")
    unknown = sorted(set(policy_epsilon) - set(policies))
    if unknown:
        parser.error(f"--policy-epsilon for unregistered policies: "
                     f"{unknown}")

    # Handlers BEFORE the (multi-second) torch import + warmup/build: a
    # TERM landing mid-bucket-ladder must still produce the graceful
    # close-and-rc-0 exit the CLI contract promises, not a
    # default-disposition kill that skips server.close().
    stop = threading.Event()
    for sig in (signal.SIGINT, signal.SIGTERM):
        signal.signal(sig, lambda *_: stop.set())

    # Serving game days (reload-under-load, slow dispatch) arm their
    # fault plan via DQN_CHAOS_PLAN like the training CLIs and spawned
    # workers do.
    from dist_dqn_tpu_torch import chaos
    chaos.maybe_install_from_env()

    from dist_dqn_tpu_torch.serving.server import build_server

    # A server launched beside a fresh training run retries the
    # missing-checkpoint startup window instead of crash-looping. The
    # shared helper retries ONLY the distinct CheckpointMissingError — an
    # unrelated startup failure (bad config, no card) stays loud on the
    # first attempt.
    from dist_dqn_tpu_torch.utils.checkpoint import (CheckpointMissingError,
                                                     wait_for_checkpoint)

    try:
        server = wait_for_checkpoint(
            lambda: build_server(
                cfg, policies, host_env=args.host_env, device=args.device,
                policy_epsilon=policy_epsilon, epsilon=args.epsilon,
                host=args.host, port=args.port,
                max_rows=args.max_batch_rows,
                max_wait_ms=args.max_wait_ms,
                queue_limit=args.queue_limit,
                batching=not args.no_batching,
                slo_p99_ms=args.slo_p99_ms,
                slo_queue_depth=args.slo_queue_depth,
                poll_interval_s=args.poll_interval_s, seed=args.seed),
            args.wait_for_checkpoint, stop=stop)
    except CheckpointMissingError:
        if stop.is_set():
            # TERM'd while still waiting for the first checkpoint:
            # graceful rc-0 exit, same contract as a TERM while serving.
            print("# serving: terminated during checkpoint wait",
                  flush=True)
            return
        raise

    from dist_dqn_tpu_torch import telemetry
    from dist_dqn_tpu_torch.telemetry import fleet
    # A replica is a fleet member like any actor: the descriptor points at
    # whichever endpoint scrapes (the act server serves /metrics and
    # /healthz too).
    if args.fleet_dir:
        os.environ[fleet.FLEET_ENV] = args.fleet_dir
    telemetry_server = telemetry.serve_if_asked(
        args.telemetry_port, args.telemetry_host,
        lambda line: print(line, flush=True), role="serving")
    registration = None
    if telemetry_server is None:
        registration = fleet.register_endpoint("serving", server.port,
                                               host=server.host)
    print(json.dumps({
        "serving_port": server.port, "serving_host": server.host,
        "policies": {pid: {"version": hdr["version"], "step": hdr["step"]}
                     for pid, hdr in server.router.policies().items()},
        "batching": not args.no_batching,
        "max_batch_rows": server.batcher.max_rows,
    }), flush=True)

    try:
        while not stop.wait(1.0):
            pass
    finally:
        # Graceful drain: complete what was admitted, refuse what was
        # not, exit 0 — in-flight requests never race the teardown.
        drained = server.drain(args.drain_timeout_s)
        print(json.dumps({"serving_drained": bool(drained),
                          "drain_timeout_s": args.drain_timeout_s}),
              flush=True)
        if telemetry_server is not None:
            telemetry_server.close()
        if registration is not None:
            registration.close()


if __name__ == "__main__":
    main()
