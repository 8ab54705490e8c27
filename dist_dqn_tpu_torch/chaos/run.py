"""Game-day runner of the port (twin of ``scripts/chaos_run.py``): execute
REAL CartPole runs of the apex, host-replay and serving stacks under a
seeded fault schedule and assert the survival invariants the chaos
harness exists to prove.

Scenarios (each armed with a FaultPlan derived from ``--seed``; the
same seed derives the same schedule — ``--print-plan`` emits it without
running, byte for byte the JAX runner's):

  apex_fleet      actor kill -9 (every actor dies and is restarted by
                  supervision, repeatedly), transport bit-flip (the
                  corrupt frame is CRC-dropped + counted server-side
                  and the actor NACK-reconnects) and transport
                  disconnect — training must reach its target anyway.
  pipeline_wedge  evac + prefetch worker stalls past a short watchdog
                  deadline — each stall must produce exactly one
                  forensics bundle and a /healthz 503 -> 200 round
                  trip, and the run must finish with correct numerics.
  ckpt_crash      commit-without-stamp checkpoint crash, torn LATEST
                  pointer, then a hard kill at chunk k — the resumed
                  run must be BIT-IDENTICAL to an uninterrupted,
                  never-checkpointed reference, with every injected
                  trip recovered.
  sharded_ckpt_crash  the data-parallel twin: a dp=2 host-replay run
                  (two spawned ranks: gloo on the CPU; on the card both
                  ranks on cuda:0 over gloo, as chip_smoke.py's two-rank
                  phases, since NCCL refuses two ranks on one card) takes
                  a commit-without-stamp crash, a TORN SIDECAR (truncated
                  npz at the final path while the learner step commits)
                  and a hard kill at chunk k — resume must delete the
                  unusable step, fall back to the previous intact one,
                  and still end BIT-IDENTICAL to an uninterrupted dp=2
                  reference, all trips recovered. Each rank arms the plan
                  itself and counts its own hits; rank 0's evidence is
                  the scenario's (it alone saves and composes).
  fleet_pane      fleet observability game day: a real apex learner +
                  two real remote-actor CLI processes registered in one
                  fleet dir; SIGKILL one worker — within one registry
                  sweep /fleet/status must name it dead and trip
                  ingest_degraded, a restarted worker must flip the
                  fleet back to healthy, and the run still reaches its
                  step target.
  serving_reload  hot-reload under live load with a slowed restore and
                  a slowed + failed dispatch — every request answers
                  (the one injected failure as a structured error),
                  versions never tear or regress per client, and the
                  SIGTERM drain completes with admissions refused.

Every scenario also reports its injector's ``open_trips()`` — the
runner exits non-zero when ANY scenario ends with an unrecovered trip,
so game days are CI-gateable on the recovery evidence itself, not only
on each scenario's bespoke invariants.

Run from the repo root::

    python -m dist_dqn_tpu_torch.chaos.run --device cpu --seed 0
    python -m dist_dqn_tpu_torch.chaos.run --seed 0 --print-plan
    python -m dist_dqn_tpu_torch.chaos.run --seed 0 --host-env synthstack

The last runs on the card; ``--host-env`` picks the actors' env of
apex_fleet and fleet_pane (JAX's CartPole-v1 needs gymnasium, which a
machine may lack; the numpy envs need nothing).

Exit 0 = every invariant held. Each scenario prints one JSON line of
evidence.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import random
import sys
import tempfile
import threading
import time

from dist_dqn_tpu_torch import chaos
from dist_dqn_tpu_torch.chaos.plan import FaultEvent, FaultPlan

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


class InvariantError(AssertionError):
    pass


def _check(cond, msg):
    if not cond:
        raise InvariantError(msg)


def _counter_total(name, **labels):
    """Sum a family's counters matching the given labels."""
    from dist_dqn_tpu_torch.telemetry import get_registry

    total = 0.0
    for inst in get_registry().collect().get(name, []):
        if all(inst.labels.get(k) == v for k, v in labels.items()):
            total += inst.value
    return total


def _quiet(*_args, **_kwargs):
    """A log function that drops its lines (picklable, for spawned
    ranks)."""


# ---------------------------------------------------------------------------
# Seeded schedules: same seed -> same plan, per scenario (JAX's, verbatim)
# ---------------------------------------------------------------------------

def plan_apex_fleet(seed: int) -> FaultPlan:
    rng = random.Random(f"{seed}:apex_fleet")
    return FaultPlan(seed=seed, events=(
        # Every actor process arms this slice: each dies (SIGKILL
        # semantics) once per ~this many step passes and supervision
        # must restart it — repeated fleet churn, not a one-off.
        FaultEvent("actor.step", "crash", at_hit=100 + rng.randrange(40)),
        # Remote actors only (the seam sits on the TCP client): one
        # frame's payload corrupted on the wire, one hard disconnect.
        FaultEvent("transport.send", "bit_flip",
                   at_hit=40 + rng.randrange(20),
                   args={"bit": 200 + rng.randrange(4000)}),
        FaultEvent("transport.send", "disconnect",
                   at_hit=70 + rng.randrange(20)),
    ))


def plan_pipeline_wedge(seed: int, stall_s: float) -> FaultPlan:
    rng = random.Random(f"{seed}:pipeline_wedge")
    return FaultPlan(seed=seed, events=(
        FaultEvent("evac.drain", "stall", at_hit=2 + rng.randrange(2),
                   args={"delay_s": stall_s}),
        # Far later in the batch stream than the evac stall so the two
        # wedges are distinct episodes (=> one bundle EACH).
        FaultEvent("prefetch.sample", "stall",
                   at_hit=30 + rng.randrange(8),
                   args={"delay_s": stall_s}),
    ))


def plan_ckpt_crash(seed: int) -> FaultPlan:
    rng = random.Random(f"{seed}:ckpt_crash")
    return FaultPlan(seed=seed, events=(
        # Save 2 commits its step but dies before stamping LATEST.
        FaultEvent("checkpoint.save", "crash_before_stamp", at_hit=2),
        # Save 3's stamp lands torn (crash mid-write without rename).
        FaultEvent("latest.write", "torn", at_hit=3),
        # Then the run itself is killed right after chunk k's save.
        FaultEvent("host_replay.chunk", "crash",
                   at_hit=4 + rng.randrange(2)),
    ))


def plan_sharded_ckpt_crash(seed: int) -> FaultPlan:
    rng = random.Random(f"{seed}:sharded_ckpt_crash")
    # The torn sidecar and the kill share one chunk (one save per
    # chunk at this scenario's cadence): the NEWEST step at kill time
    # is the unusable one, so resume must exercise the fallback. A
    # later kill would leave a newer intact step and the torn one
    # would never be read.
    k = 4 + rng.randrange(2)
    return FaultPlan(seed=seed, events=(
        # Save 2 commits its step but dies before stamping LATEST.
        FaultEvent("checkpoint.save", "crash_before_stamp", at_hit=2),
        # Save k's sidecar lands TORN at the final path while the
        # learner step still commits (crash mid-write on a
        # non-atomic-rename filesystem) — the newest step is unusable.
        FaultEvent("sidecar.write", "torn", at_hit=k),
        # And the run is killed right after that save.
        FaultEvent("host_replay.chunk", "crash", at_hit=k),
    ))


def plan_serving_reload(seed: int) -> FaultPlan:
    rng = random.Random(f"{seed}:serving_reload")
    return FaultPlan(seed=seed, events=(
        # Hit 1 is the startup restore; the slowed one is the watcher's
        # reload-under-load.
        FaultEvent("serving.reload", "slow_reload", at_hit=2,
                   args={"delay_s": 0.5}),
        FaultEvent("serving.dispatch", "slow_model",
                   at_hit=3 + rng.randrange(3),
                   args={"delay_s": 0.3}),
        FaultEvent("serving.dispatch", "exception",
                   at_hit=10 + rng.randrange(5)),
    ))


def plan_fleet_pane(seed: int) -> FaultPlan:
    # No seam events: the fault here is PROCESS-LEVEL (a SIGKILL the
    # runner itself delivers to a worker the seed picks), because the
    # invariant under test is the fleet pane's VIEW of a death, not a
    # seam's recovery path. The plan still derives from the seed so
    # --print-plan shows the (empty) schedule and the victim choice
    # replays byte-for-byte.
    return FaultPlan(seed=seed, events=())


# ---------------------------------------------------------------------------
# Configurations (JAX's runner's, on the port's config)
# ---------------------------------------------------------------------------

def _apex_cfg():
    from dist_dqn_tpu_torch.config import CONFIGS

    cfg = CONFIGS["apex"]
    return dataclasses.replace(
        cfg,
        network=dataclasses.replace(cfg.network, torso="mlp",
                                    mlp_features=(32,), hidden=0,
                                    dueling=False,
                                    compute_dtype="float32"),
        replay=dataclasses.replace(cfg.replay, capacity=4096, min_fill=150),
        learner=dataclasses.replace(cfg.learner, batch_size=16, n_step=2))


def host_replay_cfg():
    """The host-replay scenarios' config: 8 CartPole lanes, an MLP of 32,
    a 4,096-slot uniform ring filled at 64, batches of 16."""
    from dist_dqn_tpu_torch.config import CONFIGS

    cfg = CONFIGS["cartpole"]
    return dataclasses.replace(
        cfg,
        actor=dataclasses.replace(cfg.actor, num_envs=8),
        network=dataclasses.replace(cfg.network, torso="mlp",
                                    mlp_features=(32,), hidden=0,
                                    compute_dtype="float32"),
        replay=dataclasses.replace(cfg.replay, capacity=4096, min_fill=64,
                                   prioritized=False),
        learner=dataclasses.replace(cfg.learner, batch_size=16))


# ---------------------------------------------------------------------------
# Scenarios
# ---------------------------------------------------------------------------

def scenario_apex_fleet(seed: int, workdir: str, opts) -> dict:
    from dist_dqn_tpu_torch.actors.service import ApexRuntimeConfig, run_apex

    cfg = _apex_cfg()
    rt = ApexRuntimeConfig(host_env=opts.host_env, num_actors=1,
                           envs_per_actor=4, total_env_steps=4000,
                           inserts_per_grad_step=32,
                           num_remote_actors=2, log_every_s=2.0)
    plan = plan_apex_fleet(seed)
    corrupt_before = _counter_total("dqn_transport_corrupt_frames_total",
                                    reason="crc", side="server")
    # export_env: spawned actor processes arm their own copy of the
    # plan (hit counters are per process — every actor lives the same
    # schedule, which is what decimates the fleet).
    inj = chaos.install(plan, export_env=True, log_fn=None)
    try:
        out = run_apex(cfg, rt, log_fn=lambda s: None, device=opts.device)
        open_trips = inj.open_trips()
    finally:
        chaos.uninstall()
        os.environ.pop(chaos.CHAOS_PLAN_ENV, None)
    corrupt = _counter_total("dqn_transport_corrupt_frames_total",
                             reason="crc", side="server") - corrupt_before
    # Survival: progress to target with actors dying under us.
    _check(out["env_steps"] >= rt.total_env_steps,
           f"apex run stalled at {out['env_steps']} env steps")
    _check(out["grad_steps"] > 0, "no training happened")
    _check(out["actor_restarts"] >= 1,
           "no actor was killed+restarted — the crash seam never fired")
    # The flipped bit was dropped at the CRC gate, counted, and the
    # run STILL finished: it never reached the codec or the learner.
    _check(corrupt >= 1, "no corrupt frame was counted server-side")
    _check(out["bad_records"] == 0,
           "a corrupt frame leaked past the integrity gate")
    return {"scenario": "apex_fleet", "plan": plan.to_dict(),
            "env_steps": out["env_steps"],
            "grad_steps": out["grad_steps"],
            "actor_restarts": out["actor_restarts"],
            "corrupt_frames_dropped": int(corrupt),
            "parent_injections": inj.injected,
            "open_trips": open_trips}


def scenario_pipeline_wedge(seed: int, workdir: str, opts) -> dict:
    from dist_dqn_tpu_torch.host_replay_loop import run_host_replay
    from dist_dqn_tpu_torch.telemetry import watchdog as tm_watchdog

    cfg = host_replay_cfg()
    stall_s, deadline_s = 4.0, 1.5
    plan = plan_pipeline_wedge(seed, stall_s)
    forensics = os.path.join(workdir, "forensics")
    bundles_before = len(os.listdir(forensics)) \
        if os.path.isdir(forensics) else 0
    tm_watchdog.install_watchdog(forensics_dir=forensics,
                                 deadline_s=deadline_s, poll_s=0.25,
                                 log_fn=None)

    # /healthz sampler: the wedge must flip health to 503 and the
    # recovery back to 200 — sampled while the run executes.
    health_samples, stop = [], threading.Event()

    def poll_health():
        while not stop.is_set():
            ok, detail = tm_watchdog.health_state()
            health_samples.append(bool(ok))
            time.sleep(0.1)

    poller = threading.Thread(target=poll_health,
                              name="chaos-health-poller", daemon=True)
    poller.start()
    try:
        with chaos.installed(plan, log_fn=None) as inj:
            out = run_host_replay(cfg, total_env_steps=6400,
                                  chunk_iters=50, log_fn=lambda s: None,
                                  device=opts.device)
            injected = list(inj.injected)
            open_trips = inj.open_trips()
    finally:
        stop.set()
        poller.join(5)
        # Relax the deadline so later scenarios / idle time can't trip.
        tm_watchdog.install_watchdog(forensics_dir=None, deadline_s=600.0,
                                     log_fn=None)
    bundles = sorted(os.listdir(forensics)) if os.path.isdir(forensics) \
        else []
    n_bundles = len(bundles) - bundles_before
    stalls = [e for e in injected if e["fault"] == "stall"]
    _check(len(stalls) == 2, f"expected 2 stall injections, got {stalls}")
    _check(out["env_steps"] >= 6400, "wedged run did not finish")
    # Exactly one bundle per injected stall: the watchdog latches a
    # stale stage until it recovers, so each wedged WORKER stage shows
    # up newly-stale in exactly one bundle — no bundle storm. (A wedge
    # can additionally stall the main-loop stages blocked on its fence;
    # those cascade bundles name OTHER stages, never the same wedge
    # twice.)
    named = []
    for b in bundles:
        with open(os.path.join(forensics, b, "reason.json")) as fh:
            named.append(json.load(fh)["detail"]["newly_stale"])
    for stage in ("evac.host_replay", "prefetch.host_replay"):
        hits = sum(1 for stages in named if stage in stages)
        _check(hits == 1,
               f"wedged stage {stage} appears newly-stale in {hits} "
               f"bundles (want exactly 1): {named}")
        _check(_counter_total("dqn_watchdog_stalls_total",
                              stage=stage) == 1,
               f"stall episodes for {stage} != 1")
    _check(n_bundles >= 2, f"missing bundles: {named}")
    _check(not all(health_samples),
           "healthz never went 503 during a 4s wedge")
    _check(health_samples and health_samples[-1],
           "healthz did not recover to 200 after the wedges")
    _check(open_trips == [],
           f"stall trips never marked recovered: {open_trips}")
    return {"scenario": "pipeline_wedge", "plan": plan.to_dict(),
            "env_steps": out["env_steps"], "bundles": n_bundles,
            "healthz_ever_503": not all(health_samples),
            "healthz_final_200": bool(health_samples[-1]),
            "injections": injected, "open_trips": open_trips}


def scenario_ckpt_crash(seed: int, workdir: str, opts) -> dict:
    from dist_dqn_tpu_torch.host_replay_loop import run_host_replay

    cfg = host_replay_cfg()
    kw = dict(total_env_steps=3200, chunk_iters=50,
              log_fn=lambda s: None, device=opts.device)
    ref = run_host_replay(cfg, **kw)

    plan = plan_ckpt_crash(seed)
    ckpt_dir = os.path.join(workdir, "ckpt_crash")
    killed = False
    with chaos.installed(plan, log_fn=None) as inj:
        try:
            run_host_replay(cfg, **kw, checkpoint_dir=ckpt_dir,
                            save_every_frames=400)
        except chaos.ChaosInjectedError:
            killed = True
        _check(killed, "the injected chunk crash never fired")
        # Resume under the SAME armed injector: resuming IS the
        # recovery proof for the crash, and the resumed run's first
        # completed save+stamp proves the checkpoint seams recovered.
        out = run_host_replay(cfg, **kw, checkpoint_dir=ckpt_dir,
                              save_every_frames=400)
        injected = sorted((e["seam"], e["fault"], e["hit"])
                          for e in inj.injected)
        open_trips = inj.open_trips()
    expected = sorted((e.seam, e.fault, e.at_hit) for e in plan.events)
    _check(injected == expected,
           f"injection sequence diverged from the plan: {injected} != "
           f"{expected}")
    _check(out["param_checksum"] == ref["param_checksum"],
           "resumed run is NOT bit-identical to the uninterrupted one: "
           f"{out['param_checksum']} != {ref['param_checksum']}")
    _check(out["grad_steps"] == ref["grad_steps"],
           "resumed run trained a different number of steps")
    _check(open_trips == [],
           f"unrecovered trips after resume: {open_trips}")
    return {"scenario": "ckpt_crash", "plan": plan.to_dict(),
            "param_checksum": out["param_checksum"],
            "reference_checksum": ref["param_checksum"],
            "bit_identical": True, "injections": injected,
            "open_trips": open_trips}


def _sharded_rank(rank: int, address: str, device: str, plan_json: str,
                  ckpt_dir: str, out_dir: str) -> None:
    """One rank of sharded_ckpt_crash: join a group of two (gloo; both
    ranks on cuda:0 on the card), run the reference, the killed and the
    resumed run under this rank's own armed injector, and leave this
    rank's evidence in ``out_dir``."""
    import datetime

    import torch
    import torch.distributed as dist

    from dist_dqn_tpu_torch.host_replay_loop import run_host_replay
    from dist_dqn_tpu_torch.parallel import distributed, make_mesh

    torch.set_num_threads(1)
    if device == "cuda":
        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
        # gloo, not NCCL: NCCL refuses two ranks on one card, and gloo
        # carries the collectives the port uses on it.
        dist.init_process_group("gloo", init_method=f"tcp://{address}",
                                world_size=2, rank=rank,
                                timeout=datetime.timedelta(seconds=300))
    else:
        dev = distributed.initialize(address, 2, rank, device="cpu")
    try:
        mesh = make_mesh(device=dev)
        cfg = host_replay_cfg()
        kw = dict(total_env_steps=3200, chunk_iters=50, mesh=mesh,
                  mesh_devices=2)
        ref = run_host_replay(cfg, **kw, log_fn=_quiet)
        plan = FaultPlan.from_json(plan_json)
        killed = False
        logs = []
        with chaos.installed(plan, log_fn=None) as inj:
            try:
                run_host_replay(cfg, **kw, log_fn=_quiet,
                                checkpoint_dir=ckpt_dir,
                                save_every_frames=400)
            except chaos.ChaosInjectedError:
                killed = True
            out = run_host_replay(cfg, **kw, log_fn=logs.append,
                                  checkpoint_dir=ckpt_dir,
                                  save_every_frames=400)
            evidence = {"killed": killed, "injected": inj.injected,
                        "open_trips": inj.open_trips()}
        evidence.update(
            logs=logs, dp_size=ref["dp_size"],
            param_checksum=out["param_checksum"],
            reference_checksum=ref["param_checksum"],
            grad_steps=out["grad_steps"],
            reference_grad_steps=ref["grad_steps"])
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as fh:
            json.dump(evidence, fh)
    finally:
        distributed.shutdown()


def scenario_sharded_ckpt_crash(seed: int, workdir: str, opts) -> dict:
    """The data-parallel game day: dp=2 host-replay under checkpoint
    chaos. Invariants: the injected sequence equals the plan; the torn
    sidecar forces a LOGGED fallback to the previous step; the resumed
    run is bit-identical (param_checksum + grad steps) to an
    uninterrupted never-checkpointed dp=2 reference; every trip
    recovered, on both ranks."""
    from dist_dqn_tpu_torch.parallel import distributed

    plan = plan_sharded_ckpt_crash(seed)
    ckpt_dir = os.path.join(workdir, "sharded_ckpt_crash")
    with tempfile.TemporaryDirectory() as out_dir:
        distributed.spawn(_sharded_rank,
                          (f"127.0.0.1:{distributed.free_port()}",
                           opts.device, plan.to_json(), ckpt_dir, out_dir),
                          2,
                          deadline_s=900.0)
        ranks = []
        for r in range(2):
            with open(os.path.join(out_dir, f"rank{r}.json")) as fh:
                ranks.append(json.load(fh))
    ev = ranks[0]
    _check(ev["dp_size"] == 2, "reference run was not data-parallel")
    _check(all(r["killed"] for r in ranks),
           "the injected chunk crash never fired on every rank")
    injected = sorted((e["seam"], e["fault"], e["hit"])
                      for e in ev["injected"])
    expected = sorted((e.seam, e.fault, e.at_hit) for e in plan.events)
    _check(injected == expected,
           f"injection sequence diverged from the plan: {injected} != "
           f"{expected}")
    fallback = [s for s in ev["logs"] if "sidecar unreadable" in s]
    _check(fallback, "the torn sidecar never forced a logged fallback")
    resumed = [json.loads(s) for s in ev["logs"]
               if "resumed_at_frames" in s]
    _check(resumed and resumed[0].get("resumed_dp") == 2,
           f"resume evidence missing/wrong: {resumed}")
    _check(ev["param_checksum"] == ev["reference_checksum"],
           "resumed dp=2 run is NOT bit-identical to the uninterrupted "
           f"one: {ev['param_checksum']} != {ev['reference_checksum']}")
    _check(ev["grad_steps"] == ev["reference_grad_steps"],
           "resumed run trained a different number of steps")
    open_trips = sorted({t for r in ranks for t in r["open_trips"]})
    _check(open_trips == [],
           f"unrecovered trips after resume: {open_trips}")
    return {"scenario": "sharded_ckpt_crash", "plan": plan.to_dict(),
            "dp_size": 2, "param_checksum": ev["param_checksum"],
            "reference_checksum": ev["reference_checksum"],
            "bit_identical": True,
            "resumed_at_frames": resumed[0]["resumed_at_frames"],
            "torn_sidecar_fallbacks": len(fallback),
            "injections": injected, "open_trips": open_trips}


def scenario_fleet_pane(seed: int, workdir: str, opts) -> dict:
    """Fleet observability game day: a real apex learner + two REAL
    remote-actor CLI processes, all registered in one fleet dir. SIGKILL
    one worker mid-run: within ONE registry sweep the /fleet/status
    rollup must name it ``dead`` and trip ``ingest_degraded`` (half the
    actor quorum gone); a restarted worker must flip the fleet back to
    healthy; and the run itself must still reach its step target — the
    pane observes the death, the stateless-worker protocol absorbs it."""
    import signal
    import subprocess

    from dist_dqn_tpu_torch.actors.service import (ApexLearnerService,
                                                   ApexRuntimeConfig)
    from dist_dqn_tpu_torch.telemetry import fleet

    fleet_dir = os.path.join(workdir, "fleet")
    os.makedirs(fleet_dir, exist_ok=True)
    os.environ[fleet.FLEET_ENV] = fleet_dir
    stop_file = os.path.join(workdir, "fleet_pane_stop")

    cfg = _apex_cfg()
    rt = ApexRuntimeConfig(host_env=opts.host_env, num_actors=1,
                           envs_per_actor=4, total_env_steps=4000,
                           inserts_per_grad_step=32,
                           num_remote_actors=2,
                           spawn_remote_actors=False,  # real CLI workers
                           telemetry_port=0, log_every_s=5.0)
    service = ApexLearnerService(cfg, rt, log_fn=lambda s: None,
                                 device=opts.device)
    host, port = service.tcp_address

    def _spawn_worker(actor_id: int):
        return subprocess.Popen(
            [sys.executable, "-m", "dist_dqn_tpu_torch.actors.remote",
             "--address", f"127.0.0.1:{port}", "--actor-id",
             str(actor_id), "--env", opts.host_env, "--num-envs", "4",
             "--telemetry-port", "0", "--fleet-dir", fleet_dir,
             "--stop-file", stop_file],
            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
            cwd=REPO)

    workers = {1: _spawn_worker(1), 2: _spawn_worker(2)}
    agg = fleet.FleetAggregator(fleet_dir, sweep_interval_s=0.5,
                                scrape_timeout_s=2.0)
    out = {}
    runner = threading.Thread(
        target=lambda: out.update(service.run()), name="chaos-service",
        daemon=True)
    runner.start()
    try:
        # Quorum up: learner + both workers on the pane.
        deadline = time.time() + 120.0
        while time.time() < deadline:
            agg.sweep_once()
            st = agg.status()
            if st["counts"]["live"] >= 3:
                break
            time.sleep(0.3)
        _check(st["counts"]["live"] >= 3,
               f"fleet never converged to 3 live members: {st['counts']}")
        _check(not st["ingest_degraded"],
               "degraded with the whole quorum live")

        victim_id = random.Random(f"{seed}:fleet_pane").choice([1, 2])
        victim = workers[victim_id]
        victim.send_signal(signal.SIGKILL)
        victim.wait(timeout=30.0)
        # ONE sweep later the pane must tell the truth: the descriptor
        # is still on disk (SIGKILL skips the exit lifecycle), the pid
        # is gone, so the member is dead — and one of two actors dead
        # trips the quorum gauge.
        agg.sweep_once()
        st = agg.status()
        dead_name = f"actor-{victim.pid}"
        _check(st["members"][dead_name]["state"] == "dead",
               f"killed worker not dead on the pane: "
               f"{st['members'].get(dead_name)}")
        _check(st["ingest_degraded"],
               "half the actor fleet is dead but ingest_degraded is 0")
        _check(any(dead_name in a for a in st["alerts"]),
               f"no alert names the dead member: {st['alerts']}")

        # Restart (new pid, same actor id): the stateless worker
        # re-introduces itself and the fleet flips back to healthy.
        workers[victim_id] = _spawn_worker(victim_id)
        deadline = time.time() + 120.0
        while time.time() < deadline:
            agg.sweep_once()
            st = agg.status()
            back = st["members"].get(
                f"actor-{workers[victim_id].pid}", {})
            if back.get("state") == "live" and not st["ingest_degraded"]:
                break
            time.sleep(0.3)
        _check(back.get("state") == "live",
               f"restarted worker never went live: {back}")
        _check(not st["ingest_degraded"],
               "fleet still degraded after the restart")
        # The merged pane carries the workers' own families under
        # process/role labels — one scrape for the whole fleet.
        merged = agg.render_metrics()
        _check('dqn_actor_env_steps_total' in merged
               and 'role="actor"' in merged,
               "worker families missing from the federated exposition")

        runner.join(timeout=300.0)
        _check(not runner.is_alive(), "apex run did not finish")
        _check(out.get("env_steps", 0) >= rt.total_env_steps,
               f"run stalled at {out.get('env_steps')} env steps")
    finally:
        with open(stop_file, "w") as f:
            f.write("stop\n")
        for w in workers.values():
            try:
                w.wait(timeout=30.0)
            except subprocess.TimeoutExpired:
                w.kill()
        os.environ.pop(fleet.FLEET_ENV, None)
        try:
            os.unlink(stop_file)
        except OSError:
            pass
    return {"scenario": "fleet_pane",
            "plan": plan_fleet_pane(seed).to_dict(),
            "victim_actor_id": victim_id,
            "env_steps": out.get("env_steps"),
            "grad_steps": out.get("grad_steps"),
            "fleet_counts": st["counts"],
            "open_trips": []}


def scenario_serving_reload(seed: int, workdir: str, opts) -> dict:
    import numpy as np

    from dist_dqn_tpu_torch.agents.dqn import make_learner
    from dist_dqn_tpu_torch.config import CONFIGS
    from dist_dqn_tpu_torch.envs import make_env
    from dist_dqn_tpu_torch.models import build_network
    from dist_dqn_tpu_torch.serving import ServerClosedError, build_server
    from dist_dqn_tpu_torch.utils.checkpoint import TrainCheckpointer

    cfg = CONFIGS["cartpole"]
    env = make_env(cfg.env_name, device="cpu")

    def learner(k: int):
        net = build_network(cfg.network, env.num_actions,
                            env.observation_shape, device="cpu", seed=k)
        return make_learner(cfg.learner, net)[0](net)

    directory = os.path.join(workdir, "serving_ckpt")
    ckpt = TrainCheckpointer(directory, save_every_frames=1)
    ckpt.save(100, learner(0))
    ckpt.wait()

    plan = plan_serving_reload(seed)
    reloads_before = _counter_total("dqn_serving_reloads_total")
    srv = build_server(cfg, {"default": directory}, max_rows=8,
                       max_wait_ms=1.0, queue_limit=64,
                       poll_interval_s=0.2, log_fn=lambda *_: None,
                       device=opts.device)
    results, errors = [], []
    try:
        with chaos.installed(plan, log_fn=None) as inj:
            def client(tid):
                rng = np.random.default_rng(tid)
                for _ in range(20):
                    obs = rng.standard_normal((2, 4)).astype(np.float32)
                    try:
                        r = srv.batcher.submit(obs, greedy=True)
                        results.append((tid, r.version, r.step))
                    except chaos.ChaosInjectedError as e:
                        errors.append((tid, repr(e)))
                    time.sleep(0.01)

            threads = [threading.Thread(target=client, args=(t,),
                                        name=f"chaos-client-{t}",
                                        daemon=True) for t in range(4)]
            for t in threads:
                t.start()
            # Reload under load: two version bumps while clients hammer
            # and the injected slow_reload holds a restore mid-flight.
            time.sleep(0.2)
            ckpt.save(200, learner(1))
            ckpt.wait()
            time.sleep(0.4)
            ckpt.save(300, learner(2))
            ckpt.wait()
            for t in threads:
                t.join(60)
                _check(not t.is_alive(), "a serving client hung")
            # Keep serving until the second reload demonstrably landed:
            # the act path must pick up step 300 while never tearing.
            deadline = time.monotonic() + 30
            while time.monotonic() < deadline:
                r = srv.batcher.submit(
                    np.zeros((1, 4), np.float32), greedy=True)
                results.append((0, r.version, r.step))
                if r.step == 300:
                    break
                time.sleep(0.05)
            injected = list(inj.injected)
            open_trips = inj.open_trips()
        # Every request answered: results + the structured errors of
        # the ONE injected dispatch failure (each rider coalesced into
        # that batch gets it).
        _check(len(results) + len(errors) >= 80,
               f"lost requests: {len(results)} ok + {len(errors)} err")
        _check(1 <= len(errors) <= 4,
               f"expected 1 failed dispatch (<=4 riders), got {errors}")
        # No version tears or regressions per client: a later request
        # rides the same or a newer snapshot, never an older one.
        for tid in range(4):
            seq = [v for t, v, _ in results if t == tid]
            _check(seq == sorted(seq),
                   f"client {tid} saw a version regression: {seq}")
        steps_seen = {s for _, _, s in results}
        _check(max(steps_seen) == 300,
               f"hot reload never landed while serving: {steps_seen}")
        reloads = _counter_total("dqn_serving_reloads_total") \
            - reloads_before
        _check(reloads >= 2, f"expected >=2 reloads, got {reloads}")
        _check(open_trips == [],
               f"unrecovered serving trips: {open_trips}")
        # Graceful drain: admitted work completes, new work is refused,
        # the server closes clean — the SIGTERM path minus the signal.
        drained = srv.drain(5.0)
        _check(drained, "drain timed out with requests in flight")
        refused = False
        try:
            srv.batcher.submit(np.zeros((1, 4), np.float32), greedy=True)
        except ServerClosedError:
            refused = True
        _check(refused, "a post-drain admission was not refused")
    finally:
        srv.close()
        ckpt.close()
    return {"scenario": "serving_reload", "plan": plan.to_dict(),
            "answered": len(results), "injected_failures": len(errors),
            "steps_seen": sorted(steps_seen), "reloads": int(reloads),
            "drained": True, "injections": injected,
            "open_trips": open_trips}


SCENARIOS = {
    "apex_fleet": scenario_apex_fleet,
    "fleet_pane": scenario_fleet_pane,
    "pipeline_wedge": scenario_pipeline_wedge,
    "ckpt_crash": scenario_ckpt_crash,
    "sharded_ckpt_crash": scenario_sharded_ckpt_crash,
    "serving_reload": scenario_serving_reload,
}

PLANS = {
    "apex_fleet": plan_apex_fleet,
    "fleet_pane": plan_fleet_pane,
    "pipeline_wedge": lambda seed: plan_pipeline_wedge(seed, 4.0),
    "ckpt_crash": plan_ckpt_crash,
    "sharded_ckpt_crash": plan_sharded_ckpt_crash,
    "serving_reload": plan_serving_reload,
}


def print_plans(seed: int, names) -> str:
    """The ``--print-plan`` text: every named scenario's schedule."""
    return json.dumps({name: PLANS[name](seed).to_dict() for name in names},
                      sort_keys=True, indent=2)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--seed", type=int, default=0,
                        help="schedule seed: the same seed derives the "
                             "same fault plan for every scenario")
    parser.add_argument("--scenario", action="append", default=[],
                        choices=sorted(SCENARIOS),
                        help="run only these (repeatable; default all)")
    parser.add_argument("--print-plan", action="store_true",
                        help="emit every scenario's derived schedule "
                             "as JSON and exit — diff two invocations "
                             "to verify seed replayability")
    parser.add_argument("--workdir", default=None,
                        help="scratch directory (default: a fresh "
                             "tempdir)")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="where the scenarios' learners, rings and "
                             "servers run (default: the card)")
    parser.add_argument("--host-env", default="CartPole-v1",
                        help="the host env of apex_fleet's and fleet_pane's "
                             "actors (JAX's CartPole-v1 needs gymnasium; "
                             "synthstack, pong or breakout need none)")
    args = parser.parse_args(argv)

    names = args.scenario or sorted(SCENARIOS)
    if args.print_plan:
        print(print_plans(args.seed, names))
        return 0
    if args.device == "cuda":
        import torch

        if not torch.cuda.is_available():
            raise SystemExit("--device cuda: no CUDA device is visible "
                             "(pass --device cpu to run on the CPU)")

    workdir = args.workdir or tempfile.mkdtemp(prefix="chaos_run_")
    failures = []
    t_all = time.perf_counter()
    for name in names:
        t0 = time.perf_counter()
        try:
            result = SCENARIOS[name](args.seed, workdir, args)
            result["wall_s"] = round(time.perf_counter() - t0, 1)
            # CI gate: an unrecovered injection is a game-day failure
            # even when every scenario-specific invariant held — a seam
            # whose recovery proof never fired must fail the run, not
            # pass silently.
            if result.get("open_trips"):
                failures.append(name)
                result["ok"] = False
                result["invariant_failed"] = (
                    "open trips (injections without a recovery proof): "
                    f"{result['open_trips']}")
            else:
                result["ok"] = True
        except InvariantError as e:
            failures.append(name)
            result = {"scenario": name, "ok": False,
                      "invariant_failed": str(e),
                      "wall_s": round(time.perf_counter() - t0, 1)}
        print(json.dumps(result), flush=True)
    print(json.dumps({
        "chaos_run": {"seed": args.seed, "scenarios": names,
                      "failures": failures,
                      "wall_s": round(time.perf_counter() - t_all, 1)}}),
        flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
