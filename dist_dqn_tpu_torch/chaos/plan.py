"""FaultPlan of the port (twin of ``dist_dqn_tpu/chaos/plan.py``): a
seeded, replayable schedule of fault injections.

A plan is ``seed`` + an ordered list of :class:`FaultEvent`
``(seam, fault, trigger, args)`` entries. Two trigger kinds:

  * ``at_hit`` — fire on the Nth time execution passes through the
    named seam (1-based). Deterministic regardless of wall time, which
    is what makes an in-process chaos test bit-replayable: the same
    seed produces the same events at the same dataflow positions.
  * ``at_s`` — fire once the seam is hit at/after this many seconds
    from injector arm time. Used by the process-level game-day runner
    for faults whose whole point is wall-clock shape (kill -9 mid-run,
    stall past a watchdog deadline).

``FaultPlan.generate(seed, seams)`` derives a schedule from a seed via
its own ``random.Random(seed)`` stream — same seed, same plan, byte for
byte the JAX package's — and every armed plan is recorded into the run
manifest (telemetry/manifest.py), so any chaos run's forensics bundle
says exactly which faults were injected where.

Stdlib only: actor and feeder processes (torch-free by contract) arm
plans from the environment.
"""
from __future__ import annotations

import dataclasses
import json
import random
from typing import Dict, List, Optional, Sequence, Tuple

#: Seam registry: every injection point threaded through the real code
#: paths, with the faults it interprets. A plan naming an unknown seam
#: or fault fails at arm time, not silently at run time.
SEAMS: Dict[str, Tuple[str, ...]] = {
    # actors/transport.py TcpRecordClient.push (the actor-side wire).
    "transport.send": ("drop", "delay", "bit_flip", "truncate",
                       "disconnect"),
    # actors/transport.py TcpRecordServer._serve (the learner-side wire,
    # applied to the raw frame BEFORE integrity verification).
    "transport.recv": ("drop", "delay", "bit_flip", "disconnect"),
    # actors/actor.py step loops (local + remote workers).
    "actor.step": ("wedge", "crash", "slow_start"),
    # replay/staging.py EvacuationWorker drain.
    "evac.drain": ("exception", "stall"),
    # replay/staging.py SamplePrefetcher worker.
    "prefetch.sample": ("exception", "stall"),
    # utils/checkpoint.py TrainCheckpointer.save.
    "checkpoint.save": ("fail", "crash_before_stamp"),
    # utils/checkpoint.py write_latest_pointer (the LATEST stamp).
    "latest.write": ("torn",),
    # host_replay_loop.py _save_checkpoint sidecar write:
    # "torn" lands a truncated sidecar at the final path while the
    # learner step still commits — resume must delete the unusable step
    # and fall back to the previous intact one.
    "sidecar.write": ("torn",),
    # serving/batcher.py MicroBatcher._dispatch.
    "serving.dispatch": ("slow_model", "exception"),
    # serving/model_store.py ModelStore._restore (hot-reload path).
    "serving.reload": ("slow_reload", "fail"),
    # host_replay_loop.py chunk boundary (the deliberate mid-run crash
    # the resume-bit-identical pin kills the run with).
    "host_replay.chunk": ("crash",),
    # host_replay_loop.py per-shard collect dispatch: fires
    # once per SHARD dispatch, so an at_hit schedule can crash or stall
    # any one shard of a dp mesh. "stall" recovery = the dispatch pass
    # completes; "crash" recovery = the next process's resume (same
    # proof as host_replay.chunk, anchored at the resume site).
    "host_replay.collect": ("crash", "stall"),
    # actors/service.py run loop (learner-process kill for game days).
    "service.loop": ("crash",),
    # ingest/shm_ring.py ShmSlotRing.push (the zero-copy same-host
    # publish). "torn" = die-mid-write semantics: the seq
    # advances but the seqlock stamp stays odd — the consumer must
    # drop + count, never decode.
    "shm.publish": ("torn", "stall", "drop"),
    # ingest/codec.py StepDecoder.decode (the zero-copy record gate,
    # applied to the payload BEFORE validation — a corrupt record must
    # reject whole, mirroring the transport.recv bit_flip invariant).
    "ingest.decode": ("bit_flip", "truncate"),
    # replay/host.py DevicePrioritySampler draw path: fires
    # once per SHARD draw dispatch, so an at_hit schedule can fail or
    # stall any one shard's device plane. Recovery is anchored at the
    # next draw that materializes on that path (mark_recovered in
    # materialize_at/sample).
    "replay.device_sample": ("exception", "stall"),
}


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One scheduled injection. Exactly one of ``at_hit``/``at_s`` is
    set. ``args`` parameterizes the fault (e.g. ``{"delay_s": 2.0}``,
    ``{"bit": 12345}``)."""

    seam: str
    fault: str
    at_hit: Optional[int] = None
    at_s: Optional[float] = None
    args: Dict = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        if self.seam not in SEAMS:
            raise ValueError(f"unknown chaos seam {self.seam!r} "
                             f"(known: {sorted(SEAMS)})")
        if self.fault not in SEAMS[self.seam]:
            raise ValueError(
                f"seam {self.seam!r} does not interpret fault "
                f"{self.fault!r} (known: {SEAMS[self.seam]})")
        if (self.at_hit is None) == (self.at_s is None):
            raise ValueError("exactly one of at_hit/at_s must be set")
        if self.at_hit is not None and self.at_hit < 1:
            raise ValueError("at_hit is 1-based (first pass == 1)")

    def to_dict(self) -> Dict:
        d = {"seam": self.seam, "fault": self.fault, "args": self.args}
        if self.at_hit is not None:
            d["at_hit"] = self.at_hit
        else:
            d["at_s"] = self.at_s
        return d

    @classmethod
    def from_dict(cls, d: Dict) -> "FaultEvent":
        return cls(seam=d["seam"], fault=d["fault"],
                   at_hit=d.get("at_hit"), at_s=d.get("at_s"),
                   args=dict(d.get("args") or {}))


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """Seed + ordered fault schedule. Immutable once built; arming one
    (chaos/injector.py ``install``) records it into the run manifest so
    every chaos run is replayable from its provenance line."""

    seed: int
    events: Tuple[FaultEvent, ...] = ()

    def to_dict(self) -> Dict:
        return {"seed": self.seed,
                "events": [e.to_dict() for e in self.events]}

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), sort_keys=True)

    @classmethod
    def from_dict(cls, d: Dict) -> "FaultPlan":
        return cls(seed=int(d["seed"]),
                   events=tuple(FaultEvent.from_dict(e)
                                for e in d["events"]))

    @classmethod
    def from_json(cls, s: str) -> "FaultPlan":
        return cls.from_dict(json.loads(s))

    def for_seams(self, seams: Sequence[str]) -> "FaultPlan":
        """The sub-plan touching only ``seams`` — how a multi-process
        run hands each process the slice it can interpret."""
        keep = set(seams)
        return FaultPlan(self.seed, tuple(e for e in self.events
                                          if e.seam in keep))

    @classmethod
    def generate(cls, seed: int, seams: Sequence[str],
                 events_per_seam: int = 1,
                 max_hit: int = 40, horizon_s: float = 30.0) -> "FaultPlan":
        """Derive a deterministic schedule: ``events_per_seam`` events
        per listed seam, each picking a fault uniformly from the seam's
        registry and a trigger position from the seed's own stream.
        Hit-triggered seams draw ``at_hit`` in [2, max_hit] (never the
        very first pass — startup paths deserve one clean pass);
        wall-clock faults (process kills, stalls) are the game-day
        runner's to place explicitly, so generate() stays hit-based.
        Same (seed, seams, knobs) -> same plan, pinned by test."""
        rng = random.Random(seed)
        events: List[FaultEvent] = []
        for seam in seams:
            faults = SEAMS[seam]
            for _ in range(events_per_seam):
                fault = faults[rng.randrange(len(faults))]
                at_hit = rng.randint(2, max(max_hit, 2))
                args: Dict = {}
                if fault in ("delay", "wedge", "stall", "slow_model",
                             "slow_reload", "slow_start"):
                    args["delay_s"] = round(
                        rng.uniform(0.05, max(horizon_s / 10.0, 0.05)), 3)
                if fault == "bit_flip":
                    args["bit"] = rng.randrange(1 << 16)
                if fault == "truncate":
                    args["keep_frac"] = round(rng.uniform(0.1, 0.9), 3)
                events.append(FaultEvent(seam=seam, fault=fault,
                                         at_hit=at_hit, args=args))
        # Stable order: by seam name then hit position — the schedule
        # reads chronologically per seam and never depends on dict order.
        events.sort(key=lambda e: (e.seam, e.at_hit or 0, e.fault))
        return cls(seed=seed, events=tuple(events))
