"""Metric family names and cross-layer collector helpers of the port
(twin of ``dist_dqn_tpu/telemetry/collectors.py``).

The per-layer collectors live next to the code they observe (replay/host.py
owns its occupancy gauges, actors/transport.py its queue counters); what
lives HERE is the glue that must be shared so names cannot drift between
layers, plus helpers for state the owning module cannot observe itself:
the device rings, whose occupancy the loops read between chunks.

Every name, help text and bucket tuple is the JAX package's, so a
``/metrics`` scrape of either package reads the same series. The
``CHAOS_*`` families' writers (``chaos_injected_counter``,
``chaos_recovery_histogram``) are the chaos injector's.

Stdlib only, no torch: the actor and feeder processes import this
package. A device scalar is never read here; callers pass host values.
"""
from __future__ import annotations

from typing import Optional, Tuple

from dist_dqn_tpu_torch.telemetry.registry import Registry, get_registry

# Canonical family names. Every layer records
# through these constants so a rename is one edit, not a grep.
REPLAY_SIZE = "dqn_replay_size"
REPLAY_CAPACITY = "dqn_replay_capacity"
REPLAY_OCCUPANCY = "dqn_replay_occupancy_ratio"
REPLAY_ADDED = "dqn_replay_added_total"
REPLAY_SAMPLED = "dqn_replay_sampled_total"
REPLAY_EVICTED = "dqn_replay_evicted_total"
REPLAY_MAX_PRIORITY = "dqn_replay_max_priority"
REPLAY_PRIORITY_MASS = "dqn_replay_priority_mass"

ENV_STEPS = "dqn_env_steps_total"
ENV_RATE = "dqn_env_steps_per_sec"
GRAD_STEPS = "dqn_grad_steps_total"
GRAD_LATENCY = "dqn_grad_step_latency_seconds"
PARAM_STALENESS = "dqn_param_broadcast_staleness_seconds"

# Ingest fast path: device round-trip accounting for the actor
# service, H2D staging for both learner paths. DEVICE_CALLS labels each
# dispatch by {call="act"|"fused_act_bootstrap"|"bootstrap"|"train"};
# DISPATCH_FANIN observes ROWS per batched act/fused dispatch (a count
# histogram — the one deliberate exception to the _seconds rule).
SERVICE_DEVICE_CALLS = "dqn_service_device_calls_total"
DISPATCH_FANIN = "dqn_service_dispatch_fanin_rows"
INGEST_PASSES = "dqn_service_ingest_passes_total"
PRIO_WRITEBACK_PENDING = "dqn_service_prio_writeback_pending"
STAGING_OCCUPANCY = "dqn_staging_buffer_occupancy"
STAGING_STAGED = "dqn_staging_batches_total"
STAGING_BYTES = "dqn_staging_bytes_total"

# Host-replay D2H pipeline: the evacuation half of the
# staging story — streamed sub-chunk D2H fetches, the background
# evacuation worker, and the per-chunk overlap accounting. All labeled
# {loop="host_replay"} to mirror the H2D staging families above.
HOST_REPLAY_D2H_BYTES = "dqn_host_replay_d2h_bytes_total"
HOST_REPLAY_EVAC_SLICES = "dqn_host_replay_evac_slices_total"
HOST_REPLAY_EVAC_SECONDS = "dqn_host_replay_evac_seconds"
HOST_REPLAY_SLICE_LAG_SECONDS = "dqn_host_replay_slice_lag_seconds"
HOST_REPLAY_FENCE_WAIT_SECONDS = "dqn_host_replay_fence_wait_seconds"
HOST_REPLAY_OVERLAP = "dqn_host_replay_evac_overlap_frac"

# Sharded collect: data-parallel acting for the host-replay
# runtime. COLLECT_SECONDS observes each shard's collect DISPATCH
# enqueue wall ({loop, shard} — async dispatch, so growth means that
# shard's device queue is full and the host is rate-limited by it, the
# dqn_mesh_chunk_dispatch_seconds semantic); COLLECT_LANE_BLOCK is the
# env lanes each shard's own collect program acts over; the SHARD_*
# evac pair carries the per-shard D2H evidence — each shard's bytes
# leave ITS OWN device for ITS OWN ring, so per-shard conservation is
# the zero-cross-shard-scatter proof.
HOST_REPLAY_COLLECT_SECONDS = "dqn_host_replay_collect_seconds"
HOST_REPLAY_COLLECT_LANE_BLOCK = "dqn_host_replay_collect_lane_block"
HOST_REPLAY_SHARD_EVAC_SECONDS = "dqn_host_replay_shard_evac_seconds"
HOST_REPLAY_SHARD_D2H_BYTES = "dqn_host_replay_shard_d2h_bytes_total"

# Host-replay sample-side pipeline: the H2D prefetcher — the
# sample/gather wall moved off the critical path, the residual
# main-thread wait, generation-stale drops, and the batched PER
# write-back stream. Labeled {loop="host_replay"} like the D2H half.
HOST_REPLAY_SAMPLE_SECONDS = "dqn_host_replay_sample_seconds"
HOST_REPLAY_PREFETCH_WAIT_SECONDS = \
    "dqn_host_replay_prefetch_wait_seconds"
HOST_REPLAY_PREFETCH_DEPTH = "dqn_host_replay_prefetch_depth"
HOST_REPLAY_STALE_BATCHES = "dqn_host_replay_stale_batches_total"
HOST_REPLAY_PRIO_WB_BATCHES = \
    "dqn_host_replay_prio_writeback_batches_total"
HOST_REPLAY_PRIO_WB_ROWS = "dqn_host_replay_prio_writeback_rows_total"
HOST_REPLAY_PRIO_WB_DROPPED = \
    "dqn_host_replay_prio_writeback_dropped_total"

# Learner-utilization engine: the replay-ratio / batch-width
# / actor-dtype configuration that produced a process's learner
# throughput, plus the achieved rate and (where a chip peak is known,
# a benchmark) MFU. Config gauges are labeled {loop=...} like the
# host-replay families; ACTOR_DTYPE_INFO is a Prometheus info-style
# gauge — constant 1 with the dtype in the {dtype=...} label.
LEARNER_REPLAY_RATIO = "dqn_learner_replay_ratio"
LEARNER_TRAIN_BATCH = "dqn_learner_train_batch_size"
LEARNER_ACTOR_DTYPE_INFO = "dqn_learner_actor_dtype_info"
LEARNER_GRAD_RATE = "dqn_learner_grad_steps_per_sec"
LEARNER_MFU = "dqn_learner_mfu"

# Chip-time attribution plane (telemetry/devtime.py): the per-program
# device-time ledger. PROGRAM_* are labeled
# {program, loop}: FLOPS/BYTES are the cost totals for ONE execution of
# the program; DISPATCHES counts host-side launches; DEVICE_SECONDS
# accumulates device time sampled at fences the loops already hold —
# an attribution, not a hardware counter. CHIP_IDLE/CHIP_BUSY decompose
# chunk wall-time per {loop}: idle is labeled by {cause} from the fixed
# vocabulary sample|evac_fence|prefetch_wait|h2d|other. DEVICE_MEMORY
# mirrors the device's memory statistics per {kind, device} (absent on
# backends that report nothing, e.g. CPU); kind="peak_bytes_in_use_seen" is a
# host-tracked high-water mark for backends whose native peak resets.
PROGRAM_FLOPS = "dqn_program_flops"
PROGRAM_BYTES = "dqn_program_bytes"
PROGRAM_DISPATCHES = "dqn_program_dispatches_total"
PROGRAM_DEVICE_SECONDS = "dqn_program_device_seconds_total"
CHIP_IDLE_SECONDS = "dqn_chip_idle_seconds_total"
CHIP_BUSY_SECONDS = "dqn_chip_busy_seconds_total"
DEVICE_MEMORY_BYTES = "dqn_device_memory_bytes"

# Serving tier: the standalone policy-inference service
# (dist_dqn_tpu_torch/serving/). REQUESTS/LATENCY are per accepted request
# (LATENCY spans admission -> response split, the client-visible
# service time minus transport); BATCH_FANIN observes real (unpadded)
# ROWS per dispatched act program — the count-histogram exception,
# like DISPATCH_FANIN above; SHED counts admissions refused by the
# bounded queue (HTTP 429 + retry-after); RELOADS/POLICY_VERSION track
# the ModelStore's checkpoint hot-reload per {policy}; SLO_BREACHES
# counts /healthz flips per {slo="p99_latency"|"queue_depth"}.
SERVING_REQUESTS = "dqn_serving_requests_total"
SERVING_SHED = "dqn_serving_shed_total"
SERVING_QUEUE_DEPTH = "dqn_serving_queue_depth"
SERVING_LATENCY = "dqn_serving_latency_seconds"
SERVING_BATCH_FANIN = "dqn_serving_batch_fanin_rows"
SERVING_DISPATCHES = "dqn_serving_dispatches_total"
SERVING_RELOADS = "dqn_serving_reloads_total"
SERVING_POLICY_VERSION = "dqn_serving_policy_version"
SERVING_SLO_BREACHES = "dqn_serving_slo_breaches_total"

# Chaos harness + proven graceful degradation: injections are
# labeled {seam, fault} (the seam registry is chaos/plan.py SEAMS);
# RECOVERY_SECONDS measures injection -> recovery-proof per {seam}
# (which call site proves which fault).
# TRANSPORT_CORRUPT counts frames failing the wire integrity check
# (magic/length/CRC32) per {reason}; TRANSPORT_SHED counts records the
# TCP listener dropped after the bounded backpressure wait (shed +
# alarm instead of wedging the serve thread); INGEST_DEGRADED is 1
# while supervision sees at least half the actor fleet dead.
CHAOS_INJECTED = "dqn_chaos_injected_total"
CHAOS_RECOVERY_SECONDS = "dqn_recovery_seconds"
TRANSPORT_CORRUPT = "dqn_transport_corrupt_frames_total"
TRANSPORT_SHED = "dqn_transport_tcp_shed_total"
INGEST_DEGRADED = "dqn_ingest_degraded"

# Checkpoint/resume: fleet-grade sharded checkpointing in
# the data-parallel era. SAVE_SECONDS is the whole quiesced save wall
# (fence + sidecar + orbax commit) per {loop}; BYTES counts sidecar +
# snapshot bytes written; SHARDS_SAVED is the replay shard count each
# save carries (1 = single ring; dp/ingest shards otherwise); RESUMES
# counts successful whole-state restores per {loop}; REFUSED counts
# resume attempts rejected at the pins, per {reason=
# "sidecar_version"|"chunk_iters"|"dp"|"per"|"prio_writeback_batch"|
# "torn_sidecar"|"population"} — the sidecar pins are enumerated in
# ("population": a stacked
# tree's member-axis width is checkpoint structure, pinned by the
# POPULATION marker in utils/checkpoint.py and the sidecar scalar).
CHECKPOINT_SAVE_SECONDS = "dqn_checkpoint_save_seconds"
CHECKPOINT_BYTES = "dqn_checkpoint_bytes_total"
CHECKPOINT_SHARDS_SAVED = "dqn_checkpoint_shards_saved"
CHECKPOINT_RESUMES = "dqn_checkpoint_resumes_total"
CHECKPOINT_REFUSED = "dqn_checkpoint_refused_resumes_total"

# Population training plane: M stacked policies in ONE
# fused program (population.py). SIZE is the member-axis
# width M of the running program; LOSS/EVAL_RETURN are the per-{member}
# twins of dqn_loss and the eval_return log column — the selection
# signals a PBT controller would read. All three labeled {loop} like
# the learner families; the shared fused counters (dqn_env_steps_total,
# dqn_learner_grad_steps_total) count AGGREGATE member-steps under a
# population, because that is what the chip actually sustained.
POPULATION_SIZE = "dqn_population_size"
POPULATION_LOSS = "dqn_population_loss"
POPULATION_EVAL_RETURN = "dqn_population_eval_return"

# Zero-copy ingest subsystem: the schema-negotiated
# experience path (ingest/). RECORDS/BYTES are labeled
# {transport="shm"|"tcp"|"legacy"} (slot ring / zero-copy wire / the
# JSON-codec fallback paths); SHARD_RECORDS counts sticky-router
# placement per {shard} (backed by the sharded store when
# --ingest-shards > 1; one shard otherwise);
# DECODE_ERRORS counts records rejected whole at the codec gate per
# {reason}; SHM_TORN counts slot-ring records dropped on a seqlock
# stamp mismatch; ACTOR_PRIO_TRANSITIONS counts transitions inserted
# with frame-shipped |TD| priorities (zero learner-side bootstrap
# dispatches).
INGEST_RECORDS = "dqn_ingest_records_total"
INGEST_BYTES = "dqn_ingest_bytes_total"
INGEST_SHARDS = "dqn_ingest_shards"
INGEST_SHARD_RECORDS = "dqn_ingest_shard_records_total"
INGEST_DECODE_ERRORS = "dqn_ingest_decode_errors_total"
INGEST_SHM_TORN = "dqn_ingest_shm_torn_reads_total"
INGEST_ACTOR_PRIO_TRANSITIONS = \
    "dqn_ingest_actor_priority_transitions_total"

# Near-data experience plane: DEDUP_FRAMES_REUSED counts
# frame-stack slots served by back-references into the per-lane frame
# ring instead of wire bytes, DEDUP_BYTES_SAVED the wire bytes those
# references avoided (vs the undeduped zero-copy layout, tables
# already netted out); SHM_BATCH_FANIN is records per slot publish
# (1 = the unbatched lock-step actor path); SHARD_SAMPLE_SECONDS is
# the per-{shard} ingest-side stratified-draw + gather wall and
# SHARD_SAMPLE_WAIT the learner's residual wait on the pre-packed
# block queue (near zero when the per-shard samplers keep ahead).
INGEST_DEDUP_FRAMES_REUSED = "dqn_ingest_dedup_frames_reused_total"
INGEST_DEDUP_BYTES_SAVED = "dqn_ingest_dedup_bytes_saved_total"
INGEST_SHM_BATCH_FANIN = "dqn_ingest_shm_batch_fanin"
REPLAY_SHARD_SAMPLE_SECONDS = "dqn_replay_shard_sample_seconds"
REPLAY_SHARD_SAMPLE_WAIT = "dqn_replay_shard_sample_wait_seconds"

# Sharded on-device priority sampling: DEVICE_SAMPLE_SECONDS
# is the per-{shard} device-plane draw wall (write-back flush + kernel
# launch + host materialization — what the host tree's sample+get
# used to cost the learner thread), DEVICE_WRITEBACK_ROWS the priority
# rows scattered into each shard's plane (post last-write-wins dedup).
REPLAY_DEVICE_SAMPLE_SECONDS = "dqn_replay_device_sample_seconds"
REPLAY_DEVICE_WRITEBACK_ROWS = "dqn_replay_device_writeback_rows_total"

#: Slot-publish fan-in buckets: a feeder batch is bounded by slot
#: sizing well below the act-dispatch fan-ins FANIN_BUCKETS covers.
SHM_FANIN_BUCKETS = (1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0)

# Flight recorder / stall watchdog / crash forensics: stage
# heartbeats are labeled {stage="host_replay.collect"|"apex.ingest"|...}
# (one per pipeline stage), divergence trips
# {signal="loss_nonfinite"|...}, bundles {trigger="watchdog_stall"|
# "divergence_*"}.
WATCHDOG_STALLS = "dqn_watchdog_stalls_total"
WATCHDOG_HEARTBEAT_AGE = "dqn_watchdog_heartbeat_age_seconds"
WATCHDOG_STAGES = "dqn_watchdog_stages"
DIVERGENCE_TRIPS = "dqn_divergence_trips_total"
FORENSICS_BUNDLES = "dqn_forensics_bundles_total"
FLIGHT_EVENTS = "dqn_flight_events"
FLIGHT_CAPACITY = "dqn_flight_capacity"

#: Fan-in histogram buckets: powers of two from a single-lane record up
#: to the largest plausible burst (hundreds of actors x lanes).
FANIN_BUCKETS = (1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0, 256.0,
                 512.0, 1024.0, 2048.0, 4096.0, 8192.0)

# Experience-lineage staleness accounting: every sampled
# batch ages its records' wire lineage stamps. SAMPLE_AGE observes
# now - birth wall-time (seconds); SAMPLE_STALENESS observes
# current_grad_steps - acting_params_version — a count histogram, the
# FANIN-style exception to the _seconds rule.
# Both are labeled {loop="fused"|"apex"|"host_replay"} so the three
# runtimes land in ONE family the fleet aggregator can federate.
REPLAY_SAMPLE_AGE = "dqn_replay_sample_age_seconds"
REPLAY_SAMPLE_STALENESS = "dqn_replay_sample_staleness_versions"

#: Staleness-version buckets: grad-step gaps from lockstep (<=1) up to
#: the deep off-policy tail a wedged actor or cold shard produces.
STALENESS_BUCKETS = (1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0,
                     256.0, 512.0, 1024.0, 4096.0, 16384.0, 65536.0)

#: Sample-age buckets: sub-second lockstep sampling out to the
#: hour-scale tail of a big, slowly-refreshed replay.
SAMPLE_AGE_BUCKETS = (0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0,
                      60.0, 120.0, 300.0, 600.0, 1800.0, 3600.0)


def lineage_histograms(loop: str, registry: Optional[Registry] = None):
    """(sample-age, staleness-versions) histograms for one runtime loop
    — the shared constructor all three runtimes use, so the families
    cannot drift apart (the fused-vs-host-replay parity pin)."""
    reg = registry if registry is not None else get_registry()
    labels = {"loop": loop}
    return (reg.histogram(REPLAY_SAMPLE_AGE,
                          "age of sampled experience: sample wall-time "
                          "minus the record's birth stamp",
                          labels, buckets=SAMPLE_AGE_BUCKETS),
            reg.histogram(REPLAY_SAMPLE_STALENESS,
                          "grad steps between a sampled record's "
                          "acting-params version and the current step",
                          labels, buckets=STALENESS_BUCKETS))


def observe_sample_lineage(items, current_version: float, age_hist,
                           staleness_hist, now: Optional[float] = None
                           ) -> bool:
    """Age one sampled batch's lineage stamps into the histograms.
    ``items`` is any mapping of sampled arrays; batches without lineage
    keys (legacy-codec actors, pre-v4 checkpoints mid-migration) are a
    silent no-op — staleness accounting degrades, it never gates
    sampling. Returns whether anything was observed."""
    births = items.get("lineage_birth_time")
    if births is None or len(births) == 0:
        return False
    import time as _time

    now = _time.time() if now is None else now
    age_hist.observe_many([max(now - float(b), 0.0) for b in births])
    versions = items.get("lineage_params_version")
    if versions is not None:
        cur = float(current_version)
        staleness_hist.observe_many(
            [max(cur - float(v), 0.0) for v in versions])
    return True


class FusedLineageTable:
    """Host-side lineage accounting for the fused (on-device) runtime.
    The device ring carries no wall-clock lanes — adding them would
    cost device memory for data the chunk never reads — so
    the fused loop stamps at COLLECT instead: each chunk boundary
    records (birth wall-time, params version) for the slots that chunk
    appended. Sampling inside the compiled chunk is uniform over the
    live ring window and every chunk contributes the same slot count,
    so observing each live chunk once per boundary matches the true
    sample-age distribution in expectation — same families, same
    buckets as the off-device runtimes' record-granular stamps."""

    def __init__(self, registry: Optional[Registry] = None):
        self._age, self._staleness = lineage_histograms("fused", registry)
        self._chunks: list = []  # (birth_time, params_version), newest last

    def on_chunk(self, grad_steps_total: float, window_chunks: int,
                 now: Optional[float] = None) -> None:
        """Record one collect boundary and age the live window.
        ``window_chunks`` is how many chunks the device ring holds
        (ring slots // chunk_iters) — older stamps have been evicted."""
        import time as _time

        now = _time.time() if now is None else now
        self._chunks.append((now, float(grad_steps_total)))
        del self._chunks[:-max(1, int(window_chunks))]
        cur = float(grad_steps_total)
        self._age.observe_many([max(now - b, 0.0)
                                for b, _ in self._chunks])
        self._staleness.observe_many([max(cur - v, 0.0)
                                      for _, v in self._chunks])


def chaos_injected_counter(seam: str, fault: str,
                           registry: Optional[Registry] = None):
    """``dqn_chaos_injected_total{seam,fault}``: one fault the chaos
    injector (chaos/injector.py) fired at a seam."""
    reg = registry if registry is not None else get_registry()
    return reg.counter(CHAOS_INJECTED, "faults injected by the chaos harness",
                       labels={"seam": seam, "fault": fault})


def chaos_recovery_histogram(seam: str, registry: Optional[Registry] = None):
    """``dqn_recovery_seconds{seam}``: injection -> recovery proof."""
    reg = registry if registry is not None else get_registry()
    return reg.histogram(CHAOS_RECOVERY_SECONDS,
                         "fault injection -> recovery proof, per seam",
                         labels={"seam": seam})


def histogram_quantile(hist, q: float) -> float:
    """Prometheus-style ``histogram_quantile``: linear interpolation
    within the bucket where the q-th observation falls. Operates on any
    instrument exposing ``cumulative_buckets()``/``count`` (including a
    just-rendered snapshot via ``telemetry.registry``). NaN when empty;
    the highest finite bound when the quantile lands in +Inf."""
    total = hist.count
    if not total:
        return float("nan")
    rank = q * total
    prev_bound, prev_cum = 0.0, 0
    for bound, cum in hist.cumulative_buckets():
        if cum >= rank:
            if bound == float("inf"):
                return prev_bound
            if cum == prev_cum:
                return bound
            frac = (rank - prev_cum) / (cum - prev_cum)
            return prev_bound + (bound - prev_bound) * frac
        prev_bound, prev_cum = bound, cum
    return prev_bound


def replay_gauges(store: str, registry: Optional[Registry] = None):
    """(size, capacity, ratio) gauges for one replay store. ``store``
    labels which buffer implementation is reporting (host / host_ring /
    device) — several can coexist in one process."""
    reg = registry if registry is not None else get_registry()
    labels = {"store": store}
    return (reg.gauge(REPLAY_SIZE, "replay items currently held", labels),
            reg.gauge(REPLAY_CAPACITY, "replay item capacity", labels),
            reg.gauge(REPLAY_OCCUPANCY, "replay fill fraction [0, 1]",
                      labels))


def observe_device_ring(replay_state, registry: Optional[Registry] = None,
                        max_priority: Optional[float] = None
                        ) -> Tuple[int, int]:
    """Record occupancy of a device ring between chunks.

    Accepts any of the device replay states (``TimeRingState``, or the
    prioritized/sequence states that carry one as ``.ring``); the ring
    cannot emit from inside the chunk, so host loops call this at their
    chunk boundary. Returns (filled_slots, total_slots). ``size`` and the
    slot shape are host values in the port, so this reads nothing from
    the device. A prioritized or sequence state's running max priority
    is a device scalar: the caller passes its host value as
    ``max_priority`` (read in the chunk's one stacked fetch), and the
    ``{store="device"}`` max-priority gauge is set from it.
    """
    ring = getattr(replay_state, "ring", replay_state)
    slots, lanes = (int(n) for n in ring.action.shape[-2:])
    size = int(ring.size)
    g_size, g_cap, g_ratio = replay_gauges("device", registry)
    g_size.set(size * lanes)
    g_cap.set(slots * lanes)
    g_ratio.set(size / slots if slots else 0.0)
    if max_priority is not None:
        reg = registry if registry is not None else get_registry()
        reg.gauge(REPLAY_MAX_PRIORITY, "running max |TD| priority",
                  {"store": "device"}).set(float(max_priority))
    return size, slots
