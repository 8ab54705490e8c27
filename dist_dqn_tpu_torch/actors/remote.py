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

This module imports numpy and no torch. The JAX entry's
``--telemetry-port``, ``--fleet-dir`` and ``--forensics-dir`` are refused
(ROADMAP.md A10).
"""
from __future__ import annotations

import argparse
import os
import tempfile

from dist_dqn_tpu_torch.actors.actor import run_remote_actor


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
    # Flags of the JAX entry that are not ported: refused, never ignored.
    parser.add_argument("--telemetry-port", type=int, default=None)
    parser.add_argument("--fleet-dir", default=None)
    parser.add_argument("--forensics-dir", default=None)
    args = parser.parse_args(argv)
    refused = [flag for flag, given in (
        ("--telemetry-port", args.telemetry_port is not None),
        ("--fleet-dir", args.fleet_dir is not None),
        ("--forensics-dir", args.forensics_dir is not None)) if given]
    if refused:
        raise SystemExit(f"not ported yet: {', '.join(refused)} "
                         "(ROADMAP.md A10)")
    host, port = args.address.rsplit(":", 1)
    seed = args.seed if args.seed is not None else 1000 + 7 * args.actor_id
    run_remote_actor(args.actor_id, args.env, args.num_envs, seed,
                     (host, int(port)), args.stop_file,
                     max_env_steps=args.max_env_steps,
                     max_consecutive_failures=args.max_reconnect_failures,
                     transport=args.transport,
                     dedup=not args.no_wire_dedup)


if __name__ == "__main__":
    main()
