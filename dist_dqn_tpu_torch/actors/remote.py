"""Standalone remote-actor entry (twin of ``dist_dqn_tpu/actors/remote.py``):
rollout workers on other hosts stream into one learner service over TCP.

The service listens on ``--tcp-port`` (``python -m dist_dqn_tpu_torch.train
--runtime apex --tcp-port 7000 --num-remote-actors N --remote-actor-mode
external``); each worker host runs

    python -m dist_dqn_tpu_torch.actors.remote \\
        --address <learner-host>:7000 --actor-id 8 --env pong --num-envs 8

Actor ids must be unique across the fleet and lie in ``[num_actors,
num_actors + num_remote_actors)`` of the service's id space. Workers are
stateless: on a dropped connection they reconnect and introduce themselves
again, so killing and restarting one costs at most one assembly window.

``--telemetry-port P`` serves the worker's telemetry registry (its env
steps and connects) at ``/metrics`` (0: an ephemeral port, printed as
``{"telemetry_port": N}``) and, with ``--fleet-dir`` (or
``DQN_FLEET_DIR``), announces it to the run's fleet as an ``actor``-role
member; ``--forensics-dir`` arms the worker's stall watchdog. This module
imports numpy and no torch.
"""
from __future__ import annotations

import argparse
import functools
import os
import tempfile

from dist_dqn_tpu_torch import telemetry
from dist_dqn_tpu_torch.actors.actor import run_remote_actor
from dist_dqn_tpu_torch.telemetry import fleet, watchdog


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--address", required=True,
                        help="learner service endpoint, host:port")
    parser.add_argument("--actor-id", type=int, required=True)
    parser.add_argument("--env", default="CartPole-v1")
    parser.add_argument("--num-envs", type=int, default=8)
    parser.add_argument("--seed", type=int, default=None)
    parser.add_argument("--max-env-steps", type=int, default=10 ** 12)
    parser.add_argument("--stop-file",
                        default=os.path.join(tempfile.gettempdir(),
                                             "dqn_actor_stop"),
                        help="existence of this file stops the worker")
    parser.add_argument("--max-reconnect-failures", type=int, default=60,
                        help="exit after this many consecutive failed "
                             "reconnects (the learner is gone)")
    parser.add_argument("--transport", choices=("zerocopy", "legacy"),
                        default="zerocopy",
                        help="wire codec; must match the service's "
                             "--transport (a zerocopy hello against a "
                             "legacy service is refused at connect)")
    parser.add_argument("--no-wire-dedup", action="store_true",
                        help="ship full frame stacks on frame-stacked "
                             "pixel envs instead of each frame once")
    parser.add_argument("--telemetry-port", type=int, default=None,
                        help="serve this worker's /metrics (Prometheus "
                             "text) on this port; 0 = ephemeral. Worker "
                             "hosts are scraped independently of the "
                             "learner (docs/observability.md)")
    parser.add_argument("--fleet-dir", default=None,
                        help="announce this worker's telemetry endpoint "
                             "as an actor-role descriptor so the fleet "
                             "aggregator (python -m dist_dqn_tpu_torch."
                             "telemetry.fleet) federates it; defaults "
                             "to $DQN_FLEET_DIR")
    parser.add_argument("--forensics-dir", default=None,
                        help="arm this worker's stall watchdog: a wedged "
                             "step loop dumps a forensics bundle (named "
                             "thread stacks, flight-recorder tail, "
                             "registry snapshot, manifest) under this "
                             "directory and flips the worker's /healthz "
                             "to 503 (the hang runbook in README.md)")
    args = parser.parse_args(argv)
    # Through the environment, so the watchdog arms where spawned workers
    # arm theirs (actors/actor.py _actor_telemetry); an explicit flag
    # overrides whatever the supervisor exported.
    if args.forensics_dir:
        os.environ[watchdog.FORENSICS_ENV] = args.forensics_dir
    if args.fleet_dir:
        os.environ[fleet.FLEET_ENV] = args.fleet_dir
    # Registered after bind, so the descriptor carries the real port.
    server = telemetry.serve_if_asked(
        args.telemetry_port, "127.0.0.1",
        functools.partial(print, flush=True), role="actor",
        labels={"actor_id": str(args.actor_id)})
    host, port = args.address.rsplit(":", 1)
    seed = args.seed if args.seed is not None else 1000 + 7 * args.actor_id
    run_remote_actor(args.actor_id, args.env, args.num_envs, seed,
                     (host, int(port)), args.stop_file,
                     max_env_steps=args.max_env_steps,
                     max_consecutive_failures=args.max_reconnect_failures,
                     transport=args.transport,
                     dedup=not args.no_wire_dedup)
    if server is not None:
        server.close()


if __name__ == "__main__":
    main()
