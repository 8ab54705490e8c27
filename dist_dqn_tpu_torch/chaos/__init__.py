"""Deterministic chaos harness of the port (twin of
``dist_dqn_tpu/chaos/``): seeded fault injection with named seams
threaded through the real code paths.

Public surface::

    from dist_dqn_tpu_torch import chaos

    plan = chaos.FaultPlan.generate(seed=7, seams=["transport.recv"])
    with chaos.installed(plan) as inj:
        ...                       # run the system under test
    assert not inj.open_trips()   # every injection recovered

Seam call sites use ``chaos.fire("seam.name")`` (a no-op global read
while nothing is armed) and prove recovery with
``chaos.mark_recovered``. Every entry point arms a plan from
``DQN_CHAOS_PLAN`` (inline JSON or a file path): the train CLI, each
actor and feeder process, each spawned mesh rank and the serving CLI.
The process-level game-day runner is ``python -m
dist_dqn_tpu_torch.chaos.run``.

Stdlib only at import: actor and feeder processes load no torch.
"""
from dist_dqn_tpu_torch.chaos.injector import (CHAOS_PLAN_ENV,  # noqa: F401
                                               ChaosInjectedError,
                                               ChaosInjector, corrupt_bytes,
                                               fire, get_injector, install,
                                               installed,
                                               maybe_install_from_env,
                                               mark_recovered, sleep_for,
                                               truncate_bytes, uninstall)
from dist_dqn_tpu_torch.chaos.plan import (SEAMS, FaultEvent,  # noqa: F401
                                           FaultPlan)
