#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/H100 port (dist_dqn_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA card and nvcc; exits nonzero, printing no result, without
them or outside a checkout of the repository. Phases, each fatal:

0. dqnlint (host only, first; ``--only dqnlint`` selects it): ``python -m
   dist_dqn_tpu_torch.analysis --all --json`` over this checkout in a
   subprocess of this Python. It prints one ``dqnlint`` line (each check's
   unsuppressed and baselined counts, the phase's seconds) and fails on any
   unsuppressed finding, a stale baseline entry, a check count other than
   eleven, or a report that is not the JSON artifact.
1. Build every kernel of the port from ``dist_dqn_tpu_torch/csrc/`` (one
   nvcc per source, all started together).
2. Hold each kernel against its plain PyTorch version on the card, at the
   shapes the main paths give it (the sampler: the apex PER plane, a ragged
   mostly-zero plane, R2D2's sequence plane with mass in every 40th row,
   the PixelCatch bar's small plane, the host-replay device plane
   ``[1954, 512]`` of apex's 1M slots with its last 448 cells empty (and
   the card time of ``stratified_sample_rows``, the plane's draw below
   the kernel's crossover, and whether it repeats), a host-replay mesh
   rank's plane ``[977, 512]`` with S = 256 (500,000 live cells, also each
   shard plane of the two-shard 1M store), and the population's
   four apex planes ``[4, 62500, 16]`` in one member-axis launch, which
   must equal four 2-D launches bit for bit; then the wide-row path at
   ragged widths, 500, 520 and 510 lanes), and time both beside one
   PyTorch library call computing the same function and the card's bound.
   Every case must pick the plain version's cells. A ``sampler_width_sweep``
   line times both kernel paths at about 1M cells for each B of
   ``SWEEP_LANES``, beside the routed one, the library call and the bound.
   Times are device times (CUDA events around replays of a CUDA graph of
   20 calls); the ``*eager_ms`` keys time the same calls launched from
   Python one by one, which is what the main path pays. The kernel's
   outputs from CUDA graph replays must equal an eager call's, and
   ``device_launches_per_call`` counts the kernels the card runs per
   call (torch.profiler).
3. Frame dedup on the card: PixelBreakout (64 lanes, random actions,
   episodes cut at 50 steps so resets fall inside stack contexts) fills a
   stacked and a dedup ring side by side, 160 slots wrapped 2.5 times; the
   dedup rebuild must equal the stacked gather bit for bit, for every
   transition start (obs and next_obs, merged rows) and for 64 windows of
   R2D2's 125 steps.
3b. helpers (host-cheap, after dedup_gather; ``--only helpers`` selects
   it): the JAX helpers the port keeps for its tests and benchmarks.
   ``ops/losses.py n_step_from_rollout`` on CUDA tensors at apex's widths
   (batch 512, a rollout of 40 steps, n = 3, float32) and
   ``q_learning_error`` (batch 512, 6 actions) with its gradient must
   equal the same calls on CPU copies within ``HELPERS_ATOL``, the
   gradient reaching ``q`` only; then ``ShmSlotRing.push_wait`` from a
   producer thread (``poll_s=0.0``) into the port's ring on this host
   (2,000 records of 1-511 bytes, 8 slots of 512 bytes) must deliver every
   record once, in order, with 0 torn reads. It prints one ``helpers``
   line with the max abs errors it saw.
4. Drive the main paths through ``dist_dqn_tpu_torch.train.train``, each
   at full width past ``min_fill`` for a few hundred grad steps (apex and
   apex_dedup with ``min_fill`` 22,000 in place of 50,000; only r2d2
   evaluates inside its run; atari_breakout, rainbow and qrdqn evaluate
   once after it, and the later phases drive the evaluator), with
   the kernel launch counters zeroed just before and read just after
   each:
   * apex: 1M-transition PER ring, batch 512, Nature CNN, bf16;
   * r2d2 with ``replay.pallas_sampler=True``: the recurrent Nature-CNN +
     LSTM-512 net (bf16), 6,250 x 16 sequence ring, 64 sequences of 125
     steps per grad step, one sampler launch per grad step (69 of them);
   * atari_breakout: the atari preset on PixelBreakout with a frame-dedup
     ring (200k transitions), the bf16 actor and replay ratio 2;
   * apex_dedup: apex with a frame-dedup ring (1M transitions, at most 12
     GB of device memory) and replay ratio 2: two sampler launches per
     train event, one last-wins priority flush after them;
   * rainbow, qrdqn, iqn and mdqn, each preset as it stands (rainbow on
     PixelReacher: dueling, noisy, 51-atom C51; qrdqn 200 quantiles; iqn
     64/64/32 taus; mdqn the Munchausen soft bootstrap at n-step 1):
     200,000-transition PER rings drawn through the cumsum twin, so no
     sampler launch, batch 256, a grad step every 4th iteration of 64
     envs, about 110 grad steps past the fill at 20,000 frames;
   * population_apex_dedup, after apex_dedup: ``--population 4`` with a
     spec of four epsilons, learning rates and gammas, 26,000 frames per
     member (502 grad steps each, one sampler launch per grad step for
     all four), peak memory at most four times apex_dedup's bar, and
     fewer than twice apex_dedup's device kernels per training iteration
     (each path's carry runs 10 more training iterations under
     torch.profiler after its run); then one evaluation of every member.
5. The learning bars (``dist_dqn_tpu_torch/learning_bars.py``): CartPole
   to a greedy eval return of 475 within 360,000 frames, PixelCatch
   (PER through the sampler kernel, dedup ring) from a random start to an
   episode return of +0.5 within 96,000 frames, the rainbow preset on
   CartPole to 475 within 300,000, and qrdqn, iqn and mdqn on the scaled
   CartPole to 150 within 160,000; each stops at its bar. The bars run one
   after the other in a process of their own, started after
   population_learner_lockstep, beside the later phases
   (``start_bars``); the script waits for it at its end.
6. Check each path's outputs: finite loss and priorities (for r2d2, live
   exactly where the loop's host predicate says), one sampler launch per
   grad step on the paths that draw through it and none on the others,
   f32 learner masters, and head outputs and Q-values (``q_values``: the
   C51 expectation, the quantile mean) of the expected shape that agree
   with a float32 reference forward of the same weights, noise off.
7. Checkpoints, each right after the path it reuses (selecting one with
   ``--only`` runs its path too):
   * checkpoint_apex: the apex path saves its learner every 14,000 frames
     into a checkpoint dir; the same call relaunched to 56,000 frames
     must resume at 28,000, refill the ring and take as many grad steps
     as the first leg, one sampler launch each, its learner's ``steps``
     continuing from the saved count; then ``evaluate_checkpoint`` (with
     ``export_params``, read back bit-equal) and
     ``evaluate_checkpoint_curve`` over the retained steps play finite
     returns;
   * resume_r2d2: r2d2 as its path runs it (without its evaluation),
     stopped at 3,200 frames with ``checkpoint_replay`` (the whole carry,
     about 3.3 GB on disk) and resumed to 3,600 frames, must equal the
     uninterrupted path bit for bit: learner, optimizer, ring,
     priorities, env state, actor carry and every generator;
   * evaluate_iqn_risk: the iqn path saves its learner at its end, and
     ``evaluate_checkpoint`` plays it at ``risk_cvar_eta`` 1.0 and 0.25
     (finite returns);
   * population_checkpoint: the population path's directory holds the
     ``POPULATION`` marker 4, ``evaluate_checkpoint(member=2)`` plays a
     finite return, a relaunch at M = 4 logs ``resumed_at_frames`` with
     ``population: 4`` and trains nothing more, and one at M = 3 is
     refused with the width's text.
   Their save and restore seconds and bytes are printed; the checkpoint
   dirs live in one temporary directory, removed at the end.
8. The host-replay runtime (host_replay_loop.py) at apex's full width:
   * host_replay_apex_dedup: ``--runtime host-replay --config apex --set
     replay.frame_dedup=true --per --device-sampling``, 54,000 frames in
     chunks of 125 iterations (a 7.06 GB dedup ring in host memory, PER
     through the device plane ``[1954, 512]``, S = 512): at least 300
     grad steps past the fill, one sampler launch per grad step, a finite
     loss; prints the rows' rates, the evacuation columns, host RSS and
     the card's peak memory;
   * host_replay_uniform_pair: uniform, pipelined and prefetched against
     the serial ``--no-pipeline --no-prefetch`` reference (2,000 frames,
     100 grad steps each): equal final params on the card; the pipelined
     leg traces its first training chunk for the device's busy share.
9. apex_service_pong, the Ape-X actor/learner service (``--runtime apex
   --config apex --host-env pong --device-sampling``) at apex's full width:
   8 actor processes of 8 numpy PixelPong envs stream zero-copy records
   through shared memory; one batched act per ingest pass; a 1M host PER
   shard whose device plane ``[1954, 512]`` is drawn through the sampler
   kernel, S = 512; training from 20,000 transitions to 28,000 env steps.
   Holds at least 300 grad steps, one sampler launch per grad step, one
   act dispatch per ingest pass, no dropped, bad or undecodable records,
   a finite loss; prints the rates, peak device memory, host RSS and the
   device's busy share over the first train event (torch.profiler); then
   the learner checkpoint saved at the end is restored and played by the
   evaluate CLI.
10. The rest of the Ape-X service, each phase on its own fleet of actor
   processes, the kernel launch counters zeroed just before each run:
   * apex_service_r2d2_pong: ``--runtime apex --config r2d2 --host-env
     pong --device-sampling`` at r2d2's full width (Nature CNN, dueling,
     LSTM 512, bf16, burn-in 40, unroll 80, n = 5, batch 64), 8 actor
     processes of 8 envs, the shard cut to 2,048 sequences of 125 steps
     (7.2 GB of host memory); training from the preset's fill of 128
     sequences to 11,800 env steps, about 60 grad steps. Holds a finite
     loss, at least 40 grad steps,
     every inserted sequence carrying its ``initial_sequence_priorities``
     priority, one act dispatch per ingest pass, one plane draw per grad
     step through ``stratified_sample_rows`` (the plane has 2,048 cells,
     under the kernel's 100,000) and no kernel launch, no torn read,
     restart or bad record;
   * apex_service_remote_bootstrap: ``--config apex --host-env pong
     --device-sampling --no-actor-priorities --num-actors 4
     --num-remote-actors 4 --remote-actor-mode local`` at apex's full width
     (the 1M shard, plane ``[1954, 512]``): 4 actors over shared memory
     and 4 over TCP, the learner-side bootstrap fused into the act
     dispatch over the C++ assembler, training from 16,000 transitions to
     22,000 env steps. Holds one sampler launch per grad step, the native
     assembler, fused bootstraps (a standalone one only at the final
     forced flush), one act dispatch per ingest pass, records from every
     remote id, no corrupt frame, rejected hello, torn read or restart;
   * apex_service_snapshot_synthstack: ``--config apex --host-env
     synthstack --device-sampling --checkpoint-dir D --checkpoint-replay``
     at the full 1M capacity (the MLP torso, as the CLI swaps in for this
     non-pixel env; the shard's arrays 0.5 GB), training from 20,000
     transitions: run 1 to 40,000 env steps, run 2 resumed to 52,000.
     Holds ``replay_snapshot_restored_items`` equal to run 1's
     ``replay_size``, the restored plane's mass equal to the snapshot's
     bit for bit, run 2 training before it inserted ``min_fill`` items of
     its own, and one sampler launch per grad step in both runs.
11. Feeders in place of the actors (actors/feeder.py: processes replaying
   pre-encoded records as fast as the rings take them), at apex's full
   width (the 1M shard, training from 20,000 transitions), 2 feeders of 8
   lanes:
   * apex_service_feeder_pixel: ``--host-env feeder:pixel --transport
     zerocopy --shm-batch 8 --device-sampling`` to 80,000 env steps, actor
     priorities from the pool's q planes, the plane ``[1954, 512]``. Holds
     one sampler launch per grad step, one act dispatch per ingest pass,
     no torn, bad or undecodable record, no restart, a finite loss; prints
     records/s, env steps/s, grad steps/s in training, host RSS, peak
     device memory and the busy share of the first train event; saves
     the learner at its end;
   * apex_service_feeder_legacy_tree: the same with ``--transport legacy``
     (one record per publish into the request ring, the learner-side
     bootstrap over the C++ assembler) from 16,000 transitions to 64,000
     env steps, drawing from the host sum-tree: the ``NativeSumTree``, no
     kernel launch, one tree draw per grad step; the request ring's
     refused pushes (the feeders' backpressure, retried) are printed.
     Both feeder phases print the service thread's seconds by part of
     its loop (ring drain, act, bootstrap, grad steps, idle);
   * evaluate_fake_ale: with ``DQN_FAKE_ALE=1``, the evaluate CLI plays the
     pixel phase's checkpoint on the fake ALE's Pong (``--host-env
     ale:Pong``, 2 whole games): a finite return in [-21, 21]; then
     ``atari57 --mode eval --games Pong`` over a root holding it as
     ``Pong/`` prints the HNS rollup from the shipped table. No sampler
     launch.
12. serving_apex, the serving tier (``dist_dqn_tpu_torch/serving/``) over
   an apex learner checkpoint made from the seed at full width (Nature
   CNN, dueling, bf16, 6 actions, uint8 obs [84, 84, 4], ``max_rows`` 256,
   a ladder of 9 buckets): served greedy actions must equal
   ``make_actor_step`` on the restored net at epsilon 0 on the same padded
   bucket bit for bit (fan-in 1, three concurrent 1-row clients in one
   dispatch, a full bucket of 256); rows whose action differs between
   buckets of 4 and of 256 are counted and must have a top-2 gap within
   the bf16 torso's error (2 x 0.05 x max|Q_f32|); a hot reload (step 200
   from other params) under 8 clients for 2 s must serve one version per
   dispatch, never go back, and serve the step-200 net's actions after the
   swap; a queue limit of 4 under 32 concurrent clients must answer 429
   with Retry-After and no 5xx; the CLI (``python -m
   dist_dqn_tpu_torch.serving --config apex``) must announce its port,
   answer, serve /healthz and /metrics and drain to rc 0 on SIGTERM.
   Prints warmup seconds and the act step's time per bucket, a lone
   request's p50/p99, closed loops of 16 one-row clients with batching on
   and off, peak device memory, and no sampler launch.
13. population_learner_lockstep: the cartpole learner at its preset width
   as a population of two (own learning rates) and as two solo learners,
   on the same batches for 100 grad steps: params within rtol 1e-5, atol
   1e-6. Then a 4,000-frame two-member fused run beside the two solo runs
   of the same seeds, one iteration at a time; the first iteration at
   which a member's actions or replay draws differ from its solo twin's
   is reported, not held to a bar.

14. The data-parallel mesh (``dist_dqn_tpu_torch/parallel/``):
   * mesh_apex_nccl: ``python -m dist_dqn_tpu_torch.train --config apex
     --mesh-devices 0`` (its ``main``, in this process) at apex's full
     width with the apex path's fill and depth cuts and a learner
     checkpoint at its end: the group must be NCCL of size 1, the rows
     rank 0's only, the sampler launches equal the grad steps, the saved
     learner finite; prints grad steps/s;
   * mesh_apex_2rank: two spawned ranks sharing the card over a ``gloo``
     group this script builds, each calling ``make_mesh_fused_train`` at
     apex's full width (a 500,000-cell shard, 256 of the 512 rows, 8 of
     the 16 lanes): the ranks' learners must end bit-equal (rank 0's flat
     copy broadcast and compared on rank 1), ``env_frames`` must be
     ``iteration x 16`` and each rank's sampler launches its grad steps
     (its own counter, zeroed before its run). Prints each rank's peak
     device memory, grad steps/s and the all-reduce's ms per step (CUDA
     events around the gradient-sized all-reduce): a mechanism check, as
     two ranks on one card say nothing of multi-card speed. Then one apex
     learner step on 512 rows whole beside the same step as 2 x 256
     through the group, from the same weights, on each rank: the
     gradient the optimizer is handed (the all-reduced mean) within 4 x
     2^-8 of the whole batch's by relative norm, and the loss within 4 x
     2^-8 of its size (four bf16 roundings: a forward and a backward on
     each side); every number finite. Two controls must fail
     the gradient bound, or the phase fails: the rank's own 256-row
     gradient (no all-reduce) and the all-reduced sum without the divide;
   * mesh_r2d2_2rank: ``make_mesh_r2d2_train`` at the r2d2 preset's width
     on the two ranks, two chunks past its fill: bit-equal learners, one
     sampler launch per grad step;
   * mesh_resume_r2d2_2rank: mesh_r2d2_2rank through ``train()`` with
     ``checkpoint_replay`` on the two ranks, killed right after its save
     at 2,800 frames (its second; every rank writes its own carry shard,
     rank 0 the step) and relaunched to 3,200: rank 0 alone logs the
     resume, and
     every leaf of each rank's carry (learner, optimizer, ring,
     priorities, env state, LSTM carry, generators) must equal
     mesh_r2d2_2rank's own, bit for bit; one sampler launch per grad step;
   * mesh_host_replay_2rank: ``run_host_replay`` on the two ranks (the
     path of ``--runtime host-replay --config apex --set
     replay.frame_dedup=true --per --device-sampling --mesh-devices 2``):
     each rank 8 of the 16 lanes, a 62,500-slot x 8-lane dedup ring in
     host memory, its own evacuation worker and prefetcher, the plane
     ``[977, 512]`` and 256 of the 512 rows; filled at 8,000 frames, 250
     grad steps per rank by 10,000. Each rank must launch the sampler once
     per grad step (with the stale batches' draws), end with rank 0's
     learner bit for bit, report the same global row columns,
     ``env_frames`` = iterations x 16 and per-shard bytes that sum to the
     total and equal each ring's appends, with a finite loss. Prints each
     rank's rates, evacuation columns, host RSS and peak device memory;
     it runs first in the spawn, so the RSS is its own.
15. sharded_store_device: the two-shard item store
   (``replay/sharded.py ShardedPrioritizedReplay``, 1M items, one plane
   ``[977, 512]`` per shard on the card) with integer priorities (alpha
   1), 20 draws of S = 512: one kernel launch per shard per draw, every
   picked slot equal to the plain version's at the same uniforms (max
   abs err 0; integer masses keep every float32 partial sum exact), the
   items those slots'; then 1,000 inserts overwrite slots of shard 0 and
   a write-back of the last draw's rows and 500 of those slots, with the
   generations read before, must skip the overwritten ones (the
   generation guard) and land on the rest.
16. The Ape-X service's distributed paths, at apex's full width on pixel
   pong (8 x 8 actors, filled at 6,000 transitions, run to 9,000 env
   steps), the kernel's launch counters zeroed just before each run:
   * apex_service_shards_pong: ``--ingest-shards 2 --device-sampling``:
     two item shards of 500,000, each drawing on its own plane ``[977,
     512]`` through the kernel. Holds both shards fed, the inserts by shard
     summing to the store's, the launches equal to the store's plane
     dispatches and the ``replay_sample`` calls and a multiple of 2, and
     each shard plane's draw at explicit uniforms equal to the plain
     version's (max abs err 0);
   * apex_service_shard_sampling_pong: ``--ingest-shards 2
     --shard-sampling`` on the host trees: at least one pre-packed batch
     per grad step, no kernel launch;
   * apex_service_learners_2rank: ``--learner-devices 2`` as two ``gloo``
     ranks on this card (the service leads one learner rank; every train
     event broadcasts the 512-row batch, each rank trains on 256): before
     the run, one event on a seeded batch against the whole batch's step
     from the same weights (the all-reduced gradient within 4 x 2^-8 by
     relative norm, the priorities in global row order within it, and
     three controls off it: rank 0's own gradient, the sum without the
     divide, the rank blocks swapped); then bit-equal replicas at the end
     and one sampler launch per grad step on the plane ``[1954, 512]``;
   * apex_service_multihost_2proc: two service processes in one ``gloo``
     group on this card (the group built here: NCCL refuses two ranks on
     one card), each with 4 x 8 actors and a 1M store whose plane ``[1954,
     512]`` draws 256 rows through the kernel, agreeing on the counters
     and training in lockstep to 9,000 global env steps; rank 0 evaluates
     in a thread. Holds equal grad steps, the global cursor, no rate rows
     and no eval on process 1, bit-equal learners, launches equal to each
     process's plane draws and grad steps; prints each process's grad
     steps/s, the all-reduce's ms, peak memory and host RSS. Then the
     CLI's ``--coordinator`` path at world size 1 over NCCL (``train.main
     --runtime apex --coordinator 127.0.0.1:P --num-processes 1``): an
     NCCL group of one, left at the end, one launch per grad step.

17. The telemetry plane, read in four of the phases above (no phase of
   its own): apex, host_replay_apex_dedup, apex_service_pong and
   serving_apex each set a run manifest, ask their runtime for its
   telemetry endpoint on port 0 (the runtime must log the bound port),
   and serve the process registry on a port-0 endpoint of their own,
   which the phase's end scrapes over HTTP (``/metrics``, every line held
   to the Prometheus text rules of the JAX package's tests,
   ``/metrics.json`` and ``/debug/config``, whose config hash must be the
   manifest's). The counters' growth over the phase must equal the
   phase's own counts: apex's grad and env steps and its ring's size and
   capacity; the host-replay ring's size, appends, draws, D2H bytes and
   priority write-back rows; the service's env and grad steps, ingest
   records and train dispatches; serving's requests (and the serving
   CLI's own ``--telemetry-port``). apex_service_pong also times 100,000
   counter, gauge and histogram updates on the host and prints the
   microseconds per update, per service grad step
   (``SERVICE_UPDATES_PER_GRAD_STEP``) and per ingested record
   (``SERVICE_UPDATES_PER_RECORD``).
18. The chip-time plane and the host-loop spans, in the same four phases
   (telemetry/devtime.py, utils/flops.py, utils/trace.py), each phase
   with a fresh program table: apex's ``fused.chunk`` dispatches equal
   its chunks, its census lies within 1.5x of the analytic count of a
   training chunk (five Nature-CNN forwards per grad step over the batch
   and one act forward per iteration), ``dqn_learner_mfu{loop="fused"}``
   in (0, 1], the card's ``bytes_in_use`` under its ``bytes_limit``, the
   ledger's busy and idle series summing to the walls of the chunks it
   filed within 1e-6 s (the fused loop files a chunk a profiler traced
   only, and the phase traces none), and one more chunk's attributed seconds printed beside
   torch.profiler's kernel union and sum (``chunk_attribution``);
   host_replay_apex_dedup's ``sampler.draw_writeback`` dispatches equal
   the kernel's launches, its scraped ledger the summary's
   ``chip_time``, and ``host_replay.train_step`` carries a census;
   apex_service_pong runs with ``trace_path``: the trace holds the
   service's span names, the summary's ``programs`` (a census on
   ``apex.train_step``) and ``chip_time`` are set, a
   ``/debug/profile?seconds=1`` capture on the telemetry server's thread
   while the service trains holds the sampler kernel launched on the
   service's thread (retried while a window retired fewer than two grad
   steps), and it prints µs per
   span over 100,000 spans and the thread's seconds by part from the
   spans beside ``loop_s``; serving_apex's ``serving.act`` dispatches
   equal the batcher's, and a capture during a closed loop holds a CUDA
   kernel.
19. Crash forensics and the fleet plane (telemetry/flight.py,
   watchdog.py, fleet.py). host_replay_apex_dedup, apex_service_pong and
   serving_apex run armed, at their depths: a forensics dir and a fleet
   dir of their own (exported to the processes they spawn), the watchdog
   at the CLI's 120 s deadline and the divergence sentinel installed.
   Each healthy run must end with 0 stalls, 0 trips and 0 bundles (the
   actors' included), its fleet descriptors gone, and a /debug/flight
   tail holding the loop's own events (host replay: the evacuation
   worker's submits and drains, the chunk fences and train events; the
   service: its spans; the serving tier records none, as JAX's does not,
   and must have had its ``serving.batcher`` heartbeat swept); each
   prints µs per flight ``record()`` and per ``FlightTracer`` span over
   100,000 each (``flight_overhead``). While apex_service_pong trains, an
   in-process FleetAggregator over its fleet dir finds the service live
   and healthy, labels every merged sample line of it with ``process``
   and ``role``, and a ``/fleet/profile?seconds=1`` capture through the
   aggregator holds the sampler kernel; serving_apex's CLI, given
   ``--forensics-dir`` and ``--fleet-dir``, is a ``serving`` member while
   it serves. Then watchdog_device_wait (at most 15 s): a stage with a
   1 s deadline waits in ``torch.cuda.synchronize()`` behind a
   ``torch.cuda._sleep`` spin of about 5 s; the bundle must land while
   the wait is pending, its ``stacks.txt`` name the waiting thread in
   ``synchronize``, ``/healthz`` answer 503 then, and 200 once the stage
   beats again.
20. chaos (after population_learner_lockstep, before the learning bars
   start; about a minute): the chaos plane (``dist_dqn_tpu_torch/chaos/``),
   the sizing gate and the device cleanup on the card.
   * The ``replay.device_sample`` seam on the sampler kernel's dispatch
     at the host plane ``[1954, 512]`` (apex's 1M slots, S = 512), with
     writes pending: an injected exception must raise before any launch
     and leave the pending writes and the plane as they were; the next
     draw launches and closes the trip; it and the 19 after it (one
     stalled 0.05 s) must pick the plain version's cells at the same
     uniforms, max abs err 0.0, one launch per draw.
   * The seeded chaos smoke's plan (an ``evac.drain`` stall of 0.8 s, a
     ``prefetch.sample`` stall, a commit-without-stamp
     ``checkpoint.save``, a torn ``latest.write``) on a uniform
     host-replay run at apex_dedup's widths (Nature CNN, bf16, batch 512,
     a dedup ring cut to 16,384 slots), 3,200 frames in chunks of 25
     iterations with a save every other chunk, twice: the same sorted (seam,
     fault, hit) list as the plan's both times, no open trip, no stale
     batch, the params of an unarmed run (``param_checksum``), and at
     least 0.4 s of the stall filed under the ledger's ``evac_fence``.
   * A CartPole train CLI on the card, SIGTERM'd after its first row: it
     must exit ``128 + SIGTERM`` within 30 s (utils/device_cleanup.py),
     leave ``nvidia-smi --query-compute-apps`` within 10 s of that (by
     pid; by the list's length where the list shows other pids than this
     machine's, or none), and the card's free memory, lower while it ran,
     come back to within 512 MB of before (half of it allocated again at
     once).
   * For each fused main path this call ran, the sizing gate's
     ``sizing_predicted_s`` (utils/sizing.py, the CLI's
     ``fused_gate_args``) beside its measured wall: none may be below.
   It prints µs per unarmed ``chaos.fire()`` and the seconds from each
   injection to its recovery per seam.

It prints one ``main_path`` line per path (the learning bars with their
frames to the bar), then the ``kernels`` JSON line, the card's name and
power limit, and as the last line ``{"ok": true, "device": {...}}``.

Reference numerics: float32 matmuls and convolutions run without TF32
(``torch.backends.cuda.matmul.allow_tf32 = False``,
``torch.backends.cudnn.allow_tf32 = False``), so f32 references are f32.
"""
from __future__ import annotations

import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor

# The card's published peaks (H100 SXM data sheet): HBM bandwidth and the
# float32 rate outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# The helpers phase: apex's batch, a rollout of 40 steps at the preset's
# n-step 3, PixelPong's 6 actions; the hammer of JAX's ring test. The two
# devices' elementwise float32 ops round alike, so the tolerance is far
# above any difference they could show at these magnitudes.
HELPERS_ROLLOUT = (512, 40, 3)
HELPERS_TD = (512, 6)
HELPERS_RING = (2_000, 512, 8)           # records, slot bytes, slots
HELPERS_ATOL = 1e-5
# Main paths: name -> (preset, --set overrides, total env frames,
# iterations per chunk). apex and apex_dedup fill their rings at 22,000
# frames here (the preset's min_fill is 50,000: a depth cut, see PERF.md
# §4); 6,000 more are 376 grad steps at 16 frames per step (apex_dedup:
# iterations 1,374 to 1,749, 376 events of two grad steps, as many per
# member as its population). r2d2 fills at 2,500 frames (157 iterations of
# 16 envs); 3,600 frames are 225 iterations, 69 of them with a grad step.
# atari_breakout fills at 20,000 frames (iteration 312 of 64 envs) and
# trains every 4th iteration, two grad steps at a time: 204 events, 408
# grad steps in 72,000 frames. rainbow, qrdqn, iqn and
# mdqn fill at 20,000 frames (iteration 312 of 64 envs) and train every 4th
# iteration: 110 grad steps in 48,000 frames. Only r2d2 evaluates inside
# its run (as its preset sets it): a greedy PixelPong evaluation plays
# 2,000 steps whatever the episodes do, 8-18 s. The END_EVAL_PATHS
# evaluate once after their run, and the evaluator is driven on the card
# by checkpoint_apex, evaluate_iqn_risk, the population phases and every
# learning bar as well.
MAIN_PATHS = {
    "apex": ("apex", ["replay.min_fill=22000", "eval_every_steps=0"],
             28_000, 250),
    "r2d2": ("r2d2", ["replay.pallas_sampler=true"], 3_600, 25),
    "atari_breakout": ("atari", ["env_name=pixel_breakout",
                                 "replay.frame_dedup=true",
                                 "network.actor_dtype=bfloat16",
                                 "replay.updates_per_chunk=2",
                                 "eval_every_steps=0"], 72_000, 125),
    "apex_dedup": ("apex", ["replay.frame_dedup=true",
                            "replay.updates_per_chunk=2",
                            "replay.min_fill=22000",
                            "eval_every_steps=0"], 28_000, 125),
    **{preset: (preset, ["eval_every_steps=0"], 48_000, 125)
       for preset in ("rainbow", "qrdqn", "iqn", "mdqn")},
}
APEX_DEDUP_MAX_GB = 12.0
# The paths evaluated once after their run: those whose evaluator no other
# phase drives at full width (the bf16 actor on PixelBreakout, noisy C51
# on PixelReacher, the QR head).
END_EVAL_PATHS = ("atari_breakout", "rainbow", "qrdqn")
# Where the paths train and evaluate: the card.
DEVICE = "cuda"
# The host-replay path: apex at full width (Nature CNN, bf16, batch 512, 16
# lanes, 1M slots) with a frame-dedup host ring (62,500 x 16 frames, 7.06
# GB of DRAM) and PER through the device plane [1954, 512] (S = 512 per
# draw). Chunks of 125 iterations are 2,000 frames; chunks 24-26 follow the
# 50,000-frame fill, 125 grad steps each (chunk 27 went with the serving
# phase's seconds: a depth cut).
HOST_REPLAY_PATH = ("apex", ["replay.frame_dedup=true",
                             "eval_every_steps=0"], 54_000, 125)
HOST_REPLAY_MIN_GRAD_STEPS = 300
# The Ape-X service path (--runtime apex --config apex --host-env pong
# --device-sampling): apex's full width (Nature CNN, bf16, batch 512, n-step
# 3, a 1M-transition host PER shard whose device plane is [1954, 512], S =
# 512 per draw), 8 actor processes of 8 numpy PixelPong envs each. Training
# starts at 20,000 transitions (the preset's 50,000: a depth cut) and the
# run ends at 28,000 env steps (32,000 before the serving phase); at one
# grad step per 64 inserts the learner owes about 310 grad steps at the
# fill and about 440 at the end.
APEX_SERVICE_PATH = ("apex", ["replay.min_fill=20000", "eval_every_steps=0"],
                     28_000)
APEX_SERVICE_ACTORS = (8, 8)
APEX_SERVICE_MIN_GRAD_STEPS = 300
# The rest of the service (PERF.md §4 lists the cuts). R2D2 at full width
# with 8 actors of 8 envs (the preset's layout is 256 x 16) and a shard of
# 2,048 sequences (the preset's 100,000 would need 353 GB of host memory):
# the fill of 128 sequences lands at about 10,600 env steps (two windows
# per lane), and the learner owes one grad step per sequence, at most 4
# per pass of 64 env steps; past the fill the service trains about 3 grad
# steps and steps about 60 env steps a second: about 60 grad steps by
# 11,800 (cut from 12,800 for the distributed service phases' seconds,
# from 13,500 before that for the serving phase's).
APEX_R2D2_PATH = ("r2d2", ["replay.capacity=2048"], 11_800)
APEX_R2D2_ACTORS = (8, 8)
APEX_R2D2_MIN_GRAD_STEPS = 40
# Remote actors and the learner-side bootstrap: apex's full width, 4 local
# and 4 remote actors of 8 envs, training from 16,000 transitions (the
# preset's 50,000: a depth cut) to 22,000 env steps (24,000 before the
# serving phase), about 340 grad steps.
APEX_REMOTE_PATH = ("apex", ["replay.min_fill=16000"], 22_000)
APEX_REMOTE_ACTORS = (4, 4, 8)
APEX_REMOTE_MIN_GRAD_STEPS = 250
# Warm-replay snapshots: apex's 1M shard on synthstack (MLP torso), training
# from 20,000 transitions; run 1 to 40,000 env steps (snapshots at 40,000
# and at the end), run 2 resumed to 52,000.
APEX_SNAPSHOT_PATH = ("apex", ["replay.min_fill=20000"], 40_000, 52_000)
APEX_SNAPSHOT_ACTORS = (8, 8)
# Feeders in place of actors (actors/feeder.py): the service's ceiling once
# env stepping is gone. apex's full width (Nature CNN, bf16, batch 512, the
# 1M shard; with --device-sampling its plane [1954, 512], S = 512), 2 feeder
# processes of 8 lanes (benchmarks/apex_feeder_bench.py's layout), training
# from 20,000 transitions (the preset's 50,000: a depth cut). The zero-copy
# phase publishes 8 records per slot (that bench's shm batch); the legacy
# phase (the JSON codec, the learner-side bootstrap over the C++
# assembler, the host tree: legacy refuses --device-sampling) one. Feeders
# keep the rings full, so an ingest pass drains its whole burst of 256
# records per ring (zero-copy: about 3,600 env steps a pass, 0.7-1.2 s of
# host time at pixel width; PERF.md §5) and trains at most
# train_steps_per_pass (4) grad steps: from 20,000 to 80,000 env steps
# 16 passes and 64 grad steps (PERF.md §6). The legacy request ring (64 MB)
# gives about 240 records of 0.45 MB a pass (1,700-1,900 env steps): from
# 16,000 to 64,000 about 26 passes and 100 grad steps. Each phase is held
# to a grad-step bar near what it reaches.
APEX_FEEDER_PATH = ("apex", ["replay.min_fill=20000", "eval_every_steps=0"])
APEX_FEEDER_PIXEL_TOTAL = 80_000
APEX_FEEDER_PIXEL_MIN_GRAD_STEPS = 50
APEX_FEEDER_LEGACY = (16_000, 64_000)
APEX_FEEDER_LEGACY_MIN_GRAD_STEPS = 80
APEX_FEEDER_ACTORS = (2, 8)
APEX_FEEDER_SHM_BATCH = 8
# evaluate_fake_ale: the feeder phase's checkpoint played on the fake ALE's
# Pong (DQN_FAKE_ALE=1) by the evaluate CLI and by atari57 --mode eval,
# FAKE_ALE_EPISODES whole games each.
FAKE_ALE_EPISODES = 2
# The uniform pair: the same net, batch and ring in chunks of 25
# iterations (400 frames), filled at 800 frames, then four chunks of 25
# grad steps each. The pipelined leg traces chunk 1, the first that trains
# (exporting the trace of a 50-iteration chunk took about 20 s).
HOST_REPLAY_PAIR = ("apex", ["replay.frame_dedup=true", "replay.min_fill=800",
                             "eval_every_steps=0"], 2_000, 25)
# The population path: apex_dedup's preset with four members, each trained
# as a solo apex_dedup run of its own epsilon, lr and gamma. 26,000 frames
# per member (cut from 28,000; PERF.md §4): the fill at 22,000, then
# 251 train events of two grad steps.
POPULATION_SIZE = 4
POPULATION_SPEC = json.dumps({"epsilon": [0.01, 0.05, 0.1, 0.02],
                              "lr": [1e-4, 5e-5, 2e-4, 1e-4],
                              "gamma": [0.99, 0.99, 0.98, 0.995]})
POPULATION_FRAMES = 26_000
POPULATION_CHUNK = 125
POPULATION_GRAD_STEPS = 502
POPULATION_MAX_GB = POPULATION_SIZE * APEX_DEDUP_MAX_GB
# After apex_dedup's and the population's runs, PROFILED_ITERS more
# training iterations of each are traced with torch.profiler (no trace is
# written: exporting a whole chunk's took about 100 s in PR 7's first
# call). The population must launch fewer than
# POPULATION_MAX_LAUNCH_RATIO times the solo path's device kernels per
# iteration (a loop over members would launch 4x).
PROFILED_ITERS = 10
# Training iterations of the one apex chunk whose attributed seconds are
# held beside torch.profiler's kernel sum (_chunk_attribution).
CHUNK_ATTRIBUTION_ITERS = 25
POPULATION_MAX_LAUNCH_RATIO = 2.0
# population_learner_lockstep: the cartpole learner at its preset width, two
# members, on the same batches as two solo learners.
LOCKSTEP_STEPS = 100
LOCKSTEP_FRAMES = 4_000
# The checkpoint phases and the main path each one reuses. checkpoint_apex
# relaunches apex (saved every 14,000 frames) from 28,000 to 56,000
# frames; resume_r2d2 stops r2d2 at 3,200 frames, after 44 of its grad
# steps, and resumes it for its last chunk of 400 frames.
FOLLOW_UPS = {"apex": ("checkpoint_apex",), "r2d2": ("resume_r2d2",),
              "iqn": ("evaluate_iqn_risk",),
              "apex_dedup": ("population_apex_dedup",
                             "population_checkpoint")}
APEX_SAVE_EVERY = 14_000
APEX_RESUMED_TOTAL = 56_000
R2D2_STOP = 3_200
RISK_ETAS = (1.0, 0.25)
TIMING_ITERS = 200
# Idle seconds after a counted torch.profiler session opens and before it
# closes (see _profile_device).
PROFILE_SETTLE_S = 0.05
# serving_apex: the serving tier over an apex checkpoint at full width
# (max_rows 256: a ladder of 9 buckets). The pin server coalesces for 25
# ms so three concurrent 1-row clients ride one dispatch; the timed
# servers wait 2 ms. SERVING_SEEDS make the step-100 and step-200 nets.
SERVING_MAX_ROWS = 256
SERVING_PIN_WAIT_MS = 25.0
SERVING_WAIT_MS = 2.0
SERVING_SEEDS = (0, 7)
SERVING_RELOAD = (8, 2.0, 0.5)       # clients, seconds, save at
SERVING_SHED = (4, 32)               # queue limit, concurrent clients
SERVING_LONE_REQUESTS = 200
# The untimed closed loop during which /debug/profile captures one second,
# this many seconds into it.
SERVING_CAPTURE_LOOP_S = 1.5
SERVING_CAPTURE_DELAY_S = 0.25
# /debug/profile captures apex_service_pong takes until one window
# retired two grad steps (_CaptureWhileTraining).
CAPTURE_TRIES = 4
# The crash-forensics and fleet plane (telemetry/flight.py, watchdog.py,
# fleet.py), armed around host_replay_apex_dedup, apex_service_pong and
# serving_apex at their depths: the stall deadline of those healthy runs
# (the train CLI's default), the flight events each run's /debug/flight
# tail must hold (fnmatch patterns; the serving tier records none, as
# JAX's does not), and the records and spans the overhead is timed over.
FORENSICS_DEADLINE_S = 120.0
FLIGHT_TAIL_WANT = {
    "host_replay_apex_dedup": ("evac.host_replay.submit",
                               "evac.host_replay.drained",
                               "host_replay.chunk",
                               "host_replay.train_event"),
    "apex_service_pong": ("act.batched", "replay.sample",
                          "train_step.dispatch"),
    "serving_apex": (),
}
FLIGHT_OVERHEAD_N = 100_000
# watchdog_device_wait: a stage with a 1 s deadline waits in
# torch.cuda.synchronize() behind a torch.cuda._sleep spin of about 5 s;
# the phase must end within 15 s.
DEVICE_WAIT_DEADLINE_S = 1.0
DEVICE_WAIT_SPIN_S = 5.0
DEVICE_WAIT_MAX_S = 15.0
# A forensics bundle's directory name (telemetry/watchdog.py
# dump_forensics); profile captures beside them are "profile-*".
_BUNDLE_RE = re.compile(r"_pid\d+_\d{3}_\w+$")
SERVING_CLOSED_LOOP = (16, 1.5)      # 1-row clients, seconds per arm
SERVING_ACT_ITERS = 50
# The mesh phases. mesh_apex_nccl is the apex path (fill, depth, chunk)
# through the CLI at world size 1. The two-rank phases share the card over
# gloo: apex fills at 8,000 frames (4,000 per rank, 500 iterations of 8
# lanes), then 101 grad steps per rank by 9,600; r2d2 fills at 2,500
# frames (iteration 156 of 8 lanes per rank) and trains to 3,200, two
# chunks of 25 iterations past the fill: 44 grad steps per rank.
MESH_NCCL_PATH = ("apex", ["replay.min_fill=22000", "eval_every_steps=0"],
                  28_000, 250)
MESH_2RANK_PATHS = {
    "mesh_apex_2rank": ("apex", ["replay.min_fill=8000",
                                 "eval_every_steps=0"], 9_600, 50),
    "mesh_r2d2_2rank": ("r2d2", ["replay.pallas_sampler=true",
                                 "eval_every_steps=0"], 3_200, 25),
}
# The host-replay runtime on the two ranks: apex at full width with a
# frame-dedup ring, PER on the device plane; each rank 8 of the 16 lanes, a
# 62,500-slot x 8-lane ring in host memory, the plane [977, 512] and 256
# of the 512 rows. It fills at 8,000 frames (the preset's 50,000: a depth
# cut): chunks of 125 iterations are 2,000 frames, chunks 4 and 5 train,
# 250 grad steps per rank by 10,000.
MESH_HOST_REPLAY_PATH = ("apex", ["replay.frame_dedup=true",
                                  "replay.min_fill=8000",
                                  "eval_every_steps=0"], 10_000, 125)
MESH_HOST_REPLAY_MIN_GRAD_STEPS = 200
# The host-replay row columns every rank computes alike (the others are
# each rank's own clock).
MESH_GLOBAL_ROW_KEYS = ("env_frames", "grad_steps", "episode_return",
                        "evac_s", "evac_fence_wait_s", "d2h_bytes",
                        "ring_transitions", "ring_gb", "sample_s",
                        "prefetch_wait_s", "prefetch_depth", "stale_batches",
                        "h2d_staged_bytes", "loss")
# mesh_resume_r2d2_2rank: mesh_r2d2_2rank through train() with
# checkpoint_replay, saving at its first chunk (400 frames) and every
# 2,400 after, killed right after its 2nd save (2,800 frames, past the
# fill) and relaunched to 3,200 (one chunk), against mesh_r2d2_2rank's own
# carry.
MESH_RESUME_SAVE_EVERY = 2_400
MESH_RESUME_AT = 2_800
# The host-replay phase runs first in the spawn, so that its ranks' host
# RSS holds no earlier phase's freed memory.
MESH_2RANK_PHASES = ("mesh_host_replay_2rank", *MESH_2RANK_PATHS,
                     "mesh_resume_r2d2_2rank")
MESH_RANKS = 2
MESH_DEADLINE_S = 600
MESH_ALLREDUCE_ITERS = 20
# sharded_store_device: ShardedPrioritizedReplay of 2 shards over 1M items
# with device planes (each [977, 512]), S = 512 per draw, 20 draws. alpha
# 1 and eps 0 keep every priority an integer mass (1-8), so every partial
# sum is exact in float32 and the kernel must pick exactly the plain
# version's cells; write-backs of 512 rows after 1,000 fresh inserts.
SHARDED_STORE = (2, 1_000_000, 512, 20)
SHARDED_STORE_OVERWRITE = 1_000
# The Ape-X service's distributed paths: apex's full width on pixel pong
# (Nature CNN, bf16, batch 512, a 1M store), 8 actor processes of 8 envs,
# filled at 6,000 transitions (the preset's 50,000: a depth cut) and run to
# 9,000 env steps: at one grad step per 64 inserts, about 94 owed at the
# fill and 140 at the end, at most 4 a pass. The shard phases split the
# store in two (500,000 each: planes [977, 512] under device_sampling).
APEX_DIST_PATH = ("apex", ["replay.min_fill=6000", "eval_every_steps=0"],
                  9_000)
APEX_DIST_ACTORS = (8, 8)
APEX_SHARDS = 2
APEX_DIST_MIN_GRAD_STEPS = 100
# Two service processes sharing the card, each with 4 actors of 8 envs and
# a 1M store (plane [1954, 512], 256 of the 512 rows per process), each
# filled at 3,000 of its own transitions, to 9,000 global env steps; rank
# 0 evaluates every 4,500 in a thread, 2 games capped at the env's 2,000
# steps. Then the CLI's --coordinator path at world size 1 over NCCL, 4 x 8
# actors, filled at 2,000 and run to 4,000.
MULTIHOST_PATH = ("apex", ["replay.min_fill=3000"], 9_000)
MULTIHOST_ACTORS = (4, 8)
MULTIHOST_EVAL = (4_500, 2)
MULTIHOST_MIN_GRAD_STEPS = 100
COORDINATOR_PATH = ("apex", ["replay.min_fill=2000", "eval_every_steps=0"],
                    4_000)


#: Prometheus text-format line shapes (format 0.0.4), the rules the JAX
#: package's tests/test_telemetry.py holds its exposition to: comments,
#: and samples with optional labels and a float, Inf or NaN value.
_SAMPLE_RE = re.compile(
    r'^[a-zA-Z_:][a-zA-Z0-9_:]*'
    r'(\{[a-zA-Z_][a-zA-Z0-9_]*="[^"\\]*"'
    r'(,[a-zA-Z_][a-zA-Z0-9_]*="[^"\\]*")*\})?'
    r' [-+]?(\d+(\.\d+)?([eE][-+]?\d+)?|\+?Inf|NaN)$')
_COMMENT_RE = re.compile(
    r'^# (HELP|TYPE) [a-zA-Z_:][a-zA-Z0-9_:]*( .*)?$')

#: Registry updates the Ape-X service makes per grad step on
#: apex_service_pong's path (ratio 1, device plane, staged batches), from
#: the code: counters: the grad-step and the ``train`` and
#: ``replay_sample`` device-call counters, the plane's write-back rows,
#: the store's sampled items, the stager's batches and bytes; gauges: the
#: stager's occupancy at stage and at pop, and the store's max priority
#: once per batched write-back (every ``prio_writeback_batch`` = 8 grad
#: steps); histograms: the plane's draw seconds and the grad-step latency
#: at retirement.
SERVICE_UPDATES_PER_GRAD_STEP = {"counter": 7, "gauge": 2 + 1 / 8,
                                 "histogram": 2}
#: And per ingested step record: counters: env steps, the router's records,
#: bytes and shard records, the actor-priority transitions, the store's
#: added items; gauges: the store's size, occupancy and max priority at
#: the insert; histogram: the slot ring's fan-in.
SERVICE_UPDATES_PER_RECORD = {"counter": 6, "gauge": 3, "histogram": 1}
TELEMETRY_UPDATES = 100_000


class _PhaseTelemetry:
    """The telemetry plane around one phase: a run manifest (its config
    hash printed), the registry as it stood before the phase, and a
    port-0 endpoint serving the process registry, scraped over HTTP by
    :meth:`scrape` at the phase's end."""

    def __init__(self, phase: str, cfg):
        import torch

        from dist_dqn_tpu_torch import telemetry

        self.phase = phase
        man = telemetry.build_manifest(cfg, argv=[sys.argv[0], phase],
                                       extra={"device": {
                                           "name": torch.cuda.get_device_name(
                                               0),
                                           "cuda": torch.version.cuda}})
        telemetry.set_run_manifest(man)
        self.config_hash = man["config_hash"]
        print(json.dumps({"phase_manifest": phase,
                          "config_hash": self.config_hash}), flush=True)
        # The phase's own program table (telemetry/devtime.py): its
        # records' tallies and censuses start here.
        telemetry.reset_program_registry()
        self.before = telemetry.get_registry().snapshot()
        self.server = telemetry.start_server(0)

    def _get(self, path: str) -> bytes:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{self.server.port}{path}",
                timeout=30) as r:
            return r.read()

    def scrape(self) -> "_Scrape":
        """One scrape of ``/metrics``, ``/metrics.json`` and
        ``/debug/config``; fails the phase on an invalid exposition line
        or a config hash other than the manifest's."""
        try:
            text = self._get("/metrics").decode()
            after = json.loads(self._get("/metrics.json"))
            config = json.loads(self._get("/debug/config"))
        finally:
            self.server.close()
        bad = [ln for ln in text.strip().splitlines()
               if not (_COMMENT_RE.match(ln) or _SAMPLE_RE.match(ln))]
        if not text.endswith("\n") or bad:
            _fail(f"{self.phase}: invalid exposition lines: {bad[:5]}")
        if config.get("config_hash") != self.config_hash:
            _fail(f"{self.phase}: /debug/config hash "
                  f"{config.get('config_hash')}, manifest "
                  f"{self.config_hash}")
        samples = sum(1 for ln in text.splitlines()
                      if ln and not ln.startswith("#"))
        return _Scrape(self.phase, self.before, after, samples)


class _Scrape:
    """A phase's scrape: ``grew(key)`` is a series' growth over the phase
    (its value for a gauge), ``sum_grew(prefix)`` over every series of a
    family; ``hold`` compares them with the phase's own counts."""

    def __init__(self, phase, before, after, samples):
        self.phase, self.before, self.after = phase, before, after
        self.samples = samples

    def grew(self, key: str) -> float:
        now = self.after.get(key)
        if now is None:
            _fail(f"{self.phase}: /metrics.json has no series {key}")
        if now["type"] == "gauge":
            return now["value"]
        return now["value"] - self.before.get(key, {}).get("value", 0.0)

    def sum_grew(self, family: str) -> float:
        return sum(self.grew(k) for k in self.after
                   if k == family or k.startswith(family + "{"))

    def hold(self, pairs: dict) -> dict:
        """``pairs``: series -> (scraped, the phase's own count). Prints
        them and fails on any difference."""
        held = {k: [float(got), float(want)]
                for k, (got, want) in pairs.items()}
        print(json.dumps({"telemetry_scrape": self.phase,
                          "samples": self.samples, "held": held}),
              flush=True)
        off = {k: v for k, v in held.items() if v[0] != v[1]}
        if off:
            _fail(f"{self.phase}: scraped counters differ from the "
                  f"phase's own counts: {off}")
        return held


def _logged_telemetry_port(phase: str, rows) -> int:
    """The port a runtime logged for ``telemetry_port=0``."""
    ports = [r["telemetry_port"] for r in rows if "telemetry_port" in r]
    if len(ports) != 1 or ports[0] <= 0:
        _fail(f"{phase}: the runtime logged telemetry ports {ports}")
    return ports[0]


def time_registry_updates(n: int = TELEMETRY_UPDATES) -> dict:
    """Host microseconds per counter, gauge and histogram update of the
    port's registry (``n`` of each on a fresh registry), and per grad
    step of the service at SERVICE_UPDATES_PER_GRAD_STEP."""
    from dist_dqn_tpu_torch.telemetry import Registry

    reg = Registry()
    c = reg.counter("dqn_bench_total", "bench")
    g = reg.gauge("dqn_bench", "bench")
    h = reg.histogram("dqn_bench_seconds", "bench")
    us = {}
    for kind, fn in (("counter", c.inc), ("gauge", lambda: g.set(1.5)),
                     ("histogram", lambda: h.observe(0.003))):
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        us[kind] = (time.perf_counter() - t0) / n * 1e6
    if c.value != n or h.count != n:
        _fail(f"registry timing: {c.value} counts, {h.count} observations")
    return {"updates_each": n, "us_per_update": us,
            "updates_per_service_grad_step": SERVICE_UPDATES_PER_GRAD_STEP,
            "us_per_service_grad_step": sum(
                SERVICE_UPDATES_PER_GRAD_STEP[k] * us[k] for k in us),
            "updates_per_service_record": SERVICE_UPDATES_PER_RECORD,
            "us_per_service_record": sum(
                SERVICE_UPDATES_PER_RECORD[k] * us[k] for k in us)}


def _fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


_T0 = time.perf_counter()


def _clock(phase: str) -> None:
    """One line at the end of each phase: the script's seconds so far."""
    print(json.dumps({"phase_done": phase,
                      "elapsed_s": time.perf_counter() - _T0}), flush=True)


def check_dqnlint() -> dict:
    """Phase 0: the port's static checks over this checkout, on the card
    machine's Python; returns the ``dqnlint`` line's payload."""
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "dist_dqn_tpu_torch.analysis", "--all",
         "--json", "--root", root], cwd=root, capture_output=True,
        text=True, timeout=300)
    seconds = time.perf_counter() - t0
    try:
        report = json.loads(proc.stdout)
    except ValueError:
        _fail(f"dqnlint: rc {proc.returncode} and no JSON report: "
              f"{(proc.stderr or proc.stdout).strip()[-2000:]}")
    row = {"checks": {c["name"]: {"findings": len(c["findings"]),
                                  "suppressed": len(c["suppressed"])}
                      for c in report["checks"]},
           "summary": report["summary"], "rc": proc.returncode,
           "seconds": seconds}
    print(json.dumps({"dqnlint": row}), flush=True)
    findings = [f"{f['check']} {f['path']}:{f['line']}: {f['message']}"
                for c in report["checks"] for f in c["findings"]]
    if proc.returncode != 0 or not report["ok"] or findings \
            or report["summary"]["checks_run"] != 11:
        _fail(f"dqnlint: rc {proc.returncode}, "
              f"{report['summary']['checks_run']} checks, findings: "
              + "; ".join(findings))
    return row


def _eager_ms(fn, iters: int, warmup: int = 10) -> float:
    """Per-call time of ``fn`` launched from Python back to back: the
    device time, or the host's launch time where that is longer."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _device_ms(fn, calls_per_graph: int = 20, replays: int = 10) -> float:
    """Per-call device time of ``fn``: ``calls_per_graph`` calls captured
    in one CUDA graph and replayed, so no Python runs between launches."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls_per_graph):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * calls_per_graph)


def _device_launches_per_call(fn, calls: int = 10) -> float:
    """Kernels (and copies or memsets) the card runs per call of ``fn``,
    from torch.profiler's device events over ``calls`` calls."""
    return _profile_device(fn, calls)["events"] / calls


def _profile_device(fn, calls: int) -> dict:
    """``calls`` calls of ``fn`` under torch.profiler: the device events
    (kernels, copies, memsets), the seconds in which one ran, and the
    wall time."""
    import torch

    from dist_dqn_tpu_torch.train import _busy_seconds, _device_spans
    fn()
    torch.cuda.synchronize()
    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        # Room for the profiler's clock error at both ends of its window:
        # a kernel launched right after the session opens can be stamped
        # before it and dropped (ROADMAP.md C7).
        time.sleep(PROFILE_SETTLE_S)
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        time.sleep(PROFILE_SETTLE_S)
    return {"events": len(_device_spans(prof)), "busy_s": _busy_seconds(prof),
            "wall_s": wall}


def _graph_replay_matches(fn, calls: int = 20, replays: int = 2) -> bool:
    """Whether a CUDA graph of ``calls`` calls of ``fn``, replayed
    ``replays`` times, and two back-to-back eager calls, all return
    exactly what one eager call returns."""
    import torch
    want = [x.clone() for x in fn()]

    def same(got):
        return all(torch.equal(g, x) for g, x in zip(got, want))

    ok = same(fn()) and same(fn())
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [fn() for _ in range(calls)]
    for _ in range(replays):
        graph.replay()
        torch.cuda.synchronize()
        ok = ok and all(same(o) for o in outs)
    return ok and same(fn())


def _mass(rng, T, B, zero_frac, row_stride=1):
    """A [T, B] plane of masses in [0.1, 2): a ``zero_frac`` share of its
    cells zero, and only every ``row_stride``-th row with mass at all."""
    import numpy as np
    w = rng.uniform(0.1, 2.0, (T, B)).astype(np.float32)
    w[rng.uniform(size=(T, B)) < zero_frac] = 0.0
    w[np.arange(T) % row_stride != 0] = 0.0
    return w


# name: (T, B, S, zero share, row stride). The apex PER plane; a ragged,
# mostly zero one; R2D2's sequence plane, where window starts are seeded
# every sequence_stride=40 writes, so only every 40th row has mass; the
# PixelCatch learning bar's 16,384-transition plane of 32 lanes; the
# host-replay plane; one rank's plane of the two-rank apex mesh (8 of
# the 16 lanes, 256 of the 512 rows); and one rank's host-replay plane of
# the two-rank host-replay mesh (62,500 slots x 8 lanes, 256 rows), which
# is also each shard plane of the two-shard 1M store (500,000 slots); then
# the wide-row path at ragged widths: 500 lanes (a partial span), 520 (a
# second span of 8 cells) and 510 (B % 4 != 0: scalar loads).
SAMPLER_CASES = {"apex": (62500, 16, 512, 0.3, 1),
                 "ragged": (700, 8, 128, 0.9, 1),
                 "r2d2": (6250, 16, 64, 0.0, 40),
                 "catch": (512, 32, 32, 0.0, 1),
                 "host_plane": (1954, 512, 512, 0.3, 1),
                 "mesh_rank": (62500, 8, 256, 0.3, 1),
                 "mesh_host_plane": (977, 512, 256, 0.3, 1),
                 "wide_500": (977, 500, 256, 0.3, 1),
                 "wide_520": (977, 520, 512, 0.3, 1),
                 "wide_510": (977, 510, 256, 0.9, 1)}
TIMED_CASES = ("apex", "r2d2", "catch", "host_plane", "mesh_rank",
               "mesh_host_plane", "wide_500", "wide_520", "wide_510")
# The width sweep: about 1M cells (T = ceil(1e6 / B)) at each B, S = 512,
# both kernel paths timed beside the routed one, the library call and the
# bound; it places SAMPLER_WIDE_MIN_LANES.
SWEEP_LANES = (16, 32, 64, 128, 256, 512)
# The host-replay device planes' written cells: apex's 1M slots in
# [ceil(1e6 / 512), 512] (the last 448 cells are never written), and a
# rank's (or a store shard's) 500,000 in [977, 512] (the last 224).
PLANE_LIVE_CELLS = {"host_plane": 1_000_000, "mesh_host_plane": 500_000}


def _time_sampler(sampler, w, u, iters: int) -> dict:
    """Kernel, plain version and library call at one shape: device and
    eager times, the card's bound, graph-replay equality and device
    kernels per call. Fails if graph replays differ from an eager call.
    With a member axis (w [M, T, B], u [M, S]) the library call is the
    stacked cumsum with searchsorted, and ``one_launch_per_member_ms``
    times M 2-D launches, one per plane."""
    M, T, B = w.shape if w.dim() == 3 else (1, *w.shape)
    S = u.shape[-1]

    def kernel():
        return sampler.kernel_stratified_sample(w, u)

    launches_per_call = _device_launches_per_call(kernel)
    replay_ok = _graph_replay_matches(kernel)
    if not replay_ok:
        _fail(f"sampler kernel outputs differ between eager calls and CUDA "
              f"graph replays (M={M}, T={T})")
    fns = {"": kernel,
           "plain_": lambda: sampler.plain_stratified_sample(w, u),
           "library_": _library_draw(w, u)}
    if w.dim() == 3:
        fns["one_launch_per_member_"] = lambda: [
            sampler.kernel_stratified_sample(w[m], u[m]) for m in range(M)]
    device = {f"{k}ms": _device_ms(fn) for k, fn in fns.items()}
    eager = {f"{k}eager_ms": _eager_ms(fn, iters) for k, fn in fns.items()}
    return {**device, **_sampler_bound(T, B, S, M), **eager,
            "graph_replay_equal": replay_ok,
            "device_launches_per_call": launches_per_call}


def _library_draw(w, u):
    """The library call the kernel is timed beside: torch.cumsum of each
    flattened plane and torch.searchsorted of its targets."""
    import torch
    M = w.shape[0] if w.dim() == 3 else 1
    flat = w.reshape(M, -1)
    u2 = u.reshape(M, -1)

    def library():
        cdf = torch.cumsum(flat, dim=1)
        return torch.searchsorted(cdf, u2 * cdf[:, -1:])

    return library


def _sampler_bound(T: int, B: int, S: int, M: int = 1) -> dict:
    """The card's least time for one draw (utils/flops.py
    stratified_sample_cost): read the planes and u once, write the three
    [S] outputs and the total of each member once; add every cell once,
    scan the T row sums, and per sample search log2(T) rows and walk B
    lanes; over the card's memory rate and float32 rate."""
    from dist_dqn_tpu_torch.utils.flops import stratified_sample_cost
    cost = stratified_sample_cost(T, B, S, members=M)
    bound_bytes = cost["bytes"] / HBM_BYTES_PER_S * 1e3
    bound_ops = cost["flops"] / F32_OPS_PER_S * 1e3
    return {"bound_ms": max(bound_bytes, bound_ops),
            "bound_by": "bytes" if bound_bytes >= bound_ops
            else "operations"}


def _time_rows_twin(sampler, w, u, iters: int) -> dict:
    """The host-replay plane's torch draw below the kernel's crossover,
    ``stratified_sample_rows`` over the plane's SAMPLE_BLOCK block sums,
    timed at the same shape (device and eager), and whether two calls
    agree bit for bit (its row scan has a fixed order)."""
    import torch
    T, B = w.shape
    blk = w.reshape(T, B // sampler.SAMPLE_BLOCK,
                    sampler.SAMPLE_BLOCK).sum(dim=2)

    def rows():
        return sampler.stratified_sample_rows(w, blk, u)

    first, again = rows(), rows()
    return {"rows_twin_ms": _device_ms(rows),
            "rows_twin_eager_ms": _eager_ms(rows, iters),
            "rows_twin_repeats": all(torch.equal(a, b)
                                     for a, b in zip(first, again))}


def check_sampler(sampler, iters: int) -> dict:
    """Kernel vs plain version at every case of SAMPLER_CASES. Bars: >= 98%
    (t, b) agreement, mass_sel == w[t, b] to rtol 1e-6, no zero-mass pick,
    t < T, total to rtol 1e-5. Times the TIMED_CASES; returns the largest
    error and each timed case's numbers."""
    import numpy as np
    import torch

    rng = np.random.default_rng(0)
    dev = torch.device("cuda")
    report = {"max_abs_err": 0.0}
    for name, (T, B, S, zero, row_stride) in SAMPLER_CASES.items():
        w_np = _mass(rng, T, B, zero, row_stride)
        if name in PLANE_LIVE_CELLS:
            w_np.reshape(-1)[PLANE_LIVE_CELLS[name]:] = 0.0
        u_np = ((np.arange(S) + rng.uniform(size=S)) / S).astype(np.float32)
        w = torch.from_numpy(w_np).to(dev)
        u = torch.from_numpy(u_np).to(dev)
        tk, bk, pk, totk = sampler.kernel_stratified_sample(w, u)
        tp, bp, pp, totp = sampler.plain_stratified_sample(w, u)
        torch.cuda.synchronize()
        tk, bk, pk = (x.cpu().numpy() for x in (tk, bk, pk))
        tp, bp, pp = (x.cpu().numpy() for x in (tp, bp, pp))
        totk, totp = float(totk), float(totp)
        agree_mask = (tk == tp) & (bk == bp)
        agree = float(agree_mask.mean())
        total64 = float(w_np.astype(np.float64).sum())
        checks = {
            "agreement>=0.98": agree >= 0.98,
            "picks==plain": agree == 1.0,
            "mass_sel==w[t,b]": bool(np.allclose(pk, w_np[tk, bk], rtol=1e-6,
                                                 atol=0.0)),
            "no_zero_mass_pick": bool((pk > 0).all() and
                                      (w_np[tk, bk] > 0).all()),
            "t<T": bool((tk < T).all() and (tk >= 0).all()),
            "b<B": bool((bk < B).all() and (bk >= 0).all()),
            "total_vs_plain": math.isclose(totk, totp, rel_tol=1e-5),
            "total_vs_float64": math.isclose(totk, total64, rel_tol=1e-5),
        }
        err = max(abs(totk - totp),
                  float(np.abs(pk - pp)[agree_mask].max(initial=0.0)))
        report["max_abs_err"] = max(report["max_abs_err"], err)
        print(json.dumps({"sampler_check": name, "T": T, "B": B, "S": S,
                          "rows_with_mass": int((w_np > 0).any(1).sum()),
                          "agreement": agree, "max_abs_err": err,
                          "checks": checks}), flush=True)
        if not all(checks.values()):
            _fail(f"sampler kernel disagrees with its plain version "
                  f"({name}): {checks}")
        if name in TIMED_CASES:
            timing = _time_sampler(sampler, w, u, iters)
            if name in PLANE_LIVE_CELLS:
                timing.update(_time_rows_twin(sampler, w, u, iters))
            print(json.dumps({"sampler_timing": name, "T": T, "B": B,
                              "S": S, **timing}), flush=True)
            report[name] = {"T": T, "B": B, "S": S, **timing}
    report["population"] = check_sampler_members(sampler, rng, iters)
    report["max_abs_err"] = max(report["max_abs_err"],
                                report["population"]["max_abs_err"])
    report["width_sweep"] = sampler_width_sweep(sampler, rng)
    return report


def sampler_width_sweep(sampler, rng) -> list:
    """At about 1M cells for each B of SWEEP_LANES (S = 512, a 0.3 zero
    share): the routed kernel's device time and path, both paths' times
    (each must pick the plain version's cells), the library call's and
    the bound. Prints one ``sampler_width_sweep`` line."""
    import numpy as np
    import torch

    dev = torch.device("cuda")
    S = 512
    rows = []
    for B in SWEEP_LANES:
        T = -(-1_000_000 // B)
        w = torch.from_numpy(_mass(rng, T, B, 0.3)).to(dev)
        u = torch.from_numpy(((np.arange(S) + rng.uniform(size=S)) / S)
                             .astype(np.float32)).to(dev)
        want = sampler.plain_stratified_sample(w, u)
        routed = sampler.launch_geometry(T, S, B=B)
        row = {"B": B, "T": T, "S": S,
               "path": "wide" if routed.wide else "narrow"}
        for path in ("narrow", "wide"):
            geo = sampler.launch_geometry(T, S, B=B, wide=path == "wide")

            def kernel(geo=geo):
                return sampler._launch(w, u, geo)

            got = kernel()
            same = all(torch.equal(g, x) for g, x in zip(got, want[:3]))
            if not (same and math.isclose(float(got[3]), float(want[3]),
                                          rel_tol=1e-5)):
                _fail(f"sampler {path} path at [{T}, {B}] disagrees with "
                      f"its plain version")
            row[f"{path}_ms"] = _device_ms(kernel)
        row["ms"] = row[f"{row['path']}_ms"]
        row["library_ms"] = _device_ms(_library_draw(w, u))
        rows.append({**row, **_sampler_bound(T, B, S)})
    print(json.dumps({"sampler_width_sweep": rows,
                      "wide_min_lanes": sampler.SAMPLER_WIDE_MIN_LANES}),
          flush=True)
    return rows


# The population_apex_dedup plane: M members' [T, B] planes, S per member.
POPULATION_PLANE = (4, 62500, 16, 512, 0.3)


def check_sampler_members(sampler, rng, iters: int) -> dict:
    """The member-axis launch at POPULATION_PLANE: each member's draw bit
    for bit that of a 2-D launch on its plane alone, and against the plain
    member-axis version under the 2-D bars; then timed."""
    import numpy as np
    import torch

    M, T, B, S, zero = POPULATION_PLANE
    dev = torch.device("cuda")
    w_np = np.stack([_mass(rng, T, B, zero) for _ in range(M)])
    u_np = ((np.arange(S) + rng.uniform(size=(M, S))) / S).astype(np.float32)
    w = torch.from_numpy(w_np).to(dev)
    u = torch.from_numpy(u_np).to(dev)
    got = sampler.kernel_stratified_sample(w, u)
    solo = [sampler.kernel_stratified_sample(w[m], u[m]) for m in range(M)]
    plain = sampler.plain_stratified_sample(w, u)
    torch.cuda.synchronize()
    tk, bk, pk, totk = (x.cpu().numpy() for x in got)
    tp, bp, pp, totp = (x.cpu().numpy() for x in plain)
    agree_mask = (tk == tp) & (bk == bp)
    members = np.arange(M)[:, None]
    checks = {
        "bit_equal_to_2d_launches": all(
            torch.equal(g[m], x) for m in range(M)
            for g, x in zip(got, solo[m])),
        "agreement>=0.98": bool((agree_mask.mean(axis=1) >= 0.98).all()),
        "mass_sel==w[m,t,b]": bool(np.allclose(pk, w_np[members, tk, bk],
                                               rtol=1e-6, atol=0.0)),
        "no_zero_mass_pick": bool((pk > 0).all()),
        "t<T": bool((tk < T).all() and (tk >= 0).all()),
        "b<B": bool((bk < B).all() and (bk >= 0).all()),
        "total_vs_plain": bool(np.allclose(totk, totp, rtol=1e-5, atol=0)),
        "total_vs_float64": bool(np.allclose(
            totk, w_np.astype(np.float64).sum(axis=(1, 2)), rtol=1e-5,
            atol=0)),
    }
    err = max(float(np.abs(totk - totp).max()),
              float(np.abs(pk - pp)[agree_mask].max(initial=0.0)))
    print(json.dumps({"sampler_check": "population", "M": M, "T": T, "B": B,
                      "S": S, "agreement": float(agree_mask.mean()),
                      "max_abs_err": err, "checks": checks}), flush=True)
    if not all(checks.values()):
        _fail(f"member-axis sampler launch disagrees with its 2-D launches "
              f"or its plain version: {checks}")
    timing = _time_sampler(sampler, w, u, iters)
    print(json.dumps({"sampler_timing": "population", "M": M, "T": T,
                      "B": B, "S": S, **timing}), flush=True)
    return {"M": M, "T": T, "B": B, "S": S, "max_abs_err": err, **timing}


def check_dedup_gather(lanes: int = 64, slots: int = 160, steps: int = 400,
                       seq_len: int = 125, n_step: int = 3,
                       windows: int = 64) -> dict:
    """PixelBreakout on the card into a stacked and a dedup sequence ring
    (merged rows) side by side; the dedup rebuild must equal the stacked
    gather bit for bit: every transition start of every lane through
    ``gather_transitions``, and ``windows`` random R2D2 windows through
    ``_rebuild_seq_stacks``."""
    import torch

    from dist_dqn_tpu_torch.envs import make_env
    from dist_dqn_tpu_torch.replay import device as ring
    from dist_dqn_tpu_torch.replay import sequence_device as sring

    dev = torch.device("cuda")
    stack = 4
    frame = (84, 84, 1)
    env = make_env("pixel_breakout", device=dev, max_steps=50)
    gen = torch.Generator(device=dev).manual_seed(0)
    state, obs = env.v_reset(lanes, gen)
    rings = {name: sring.sequence_ring_init(slots, lanes, ex.reshape(-1), 1,
                                            merge_obs_rows=True)
             for name, ex in (("full", obs[0]), ("dedup", obs[0, ..., -1:]))}
    carry = (torch.zeros((lanes, 1), device=dev),) * 2
    for _ in range(steps):
        actions = torch.randint(0, env.num_actions, (lanes,), generator=gen,
                                device=dev)
        state, out = env.v_step(state, actions, gen)
        for name, o in (("full", obs), ("dedup", obs[..., -1:])):
            sring.sequence_ring_add(rings[name], o.reshape(lanes, -1),
                                    actions, out.reward, out.terminated,
                                    out.truncated, carry, seq_len, 1,
                                    merge_obs_rows=True)
        obs = out.obs
    full, dd = rings["full"].ring, rings["dedup"].ring
    oldest = (dd.pos - dd.size) % slots
    lane = torch.arange(lanes, device=dev)

    def starts(last_offset):
        offs = torch.arange(stack - 1, last_offset, device=dev)
        t = ((oldest + offs) % slots).repeat_interleave(lanes)
        return t, lane.repeat(offs.shape[0])

    t_idx, b_idx = starts(dd.size - n_step)
    got = ring.gather_transitions(dd, t_idx, b_idx, n_step, 0.99,
                                  merge_obs_rows=True, frame_stack=stack,
                                  frame_shape=frame)
    want = ring.gather_transitions(full, t_idx, b_idx, n_step, 0.99,
                                   merge_obs_rows=True)
    done = full.terminated | full.truncated
    in_context = torch.zeros_like(t_idx, dtype=torch.bool)
    for j in range(1, stack):
        in_context |= done[(t_idx - j) % slots, b_idx]
    checks = {f: torch.equal(getattr(got, f),
                             getattr(want, f).reshape(getattr(got, f).shape))
              for f in ("obs", "next_obs", "reward", "discount")}
    # R2D2 windows: random starts whose context and window are stored.
    t_all, b_all = starts(dd.size - seq_len + 1)
    pick = torch.randperm(t_all.shape[0], generator=gen, device=dev)[:windows]
    t_w, b_w = t_all[pick], b_all[pick]
    got_w = sring._rebuild_seq_stacks(dd, t_w, b_w, seq_len, stack, True,
                                      frame)
    tt = (t_w[None, :] + torch.arange(seq_len, device=dev)[:, None]) % slots
    want_w = full.obs[tt * lanes + b_w[None, :]].reshape(got_w.shape)
    checks["sequence_obs"] = torch.equal(got_w, want_w)
    report = {"lanes": lanes, "slots": slots, "steps": steps,
              "transitions": int(t_idx.shape[0]),
              "starts_with_reset_in_context": int(in_context.sum()),
              "windows": int(t_w.shape[0]), "seq_len": seq_len,
              "checks": checks}
    print(json.dumps({"dedup_gather": report}), flush=True)
    if not all(checks.values()) or not report["starts_with_reset_in_context"]:
        _fail(f"dedup rebuild differs from the stacked gather, or no reset "
              f"fell inside a stack context: {report}")
    return report


def _ring_round_trip(records: int, slot_size: int, nslots: int) -> dict:
    """``push_wait`` from a producer thread into the port's slot ring, the
    consumer popping on this thread: what arrived, in what order."""
    import threading
    import uuid

    import numpy as np

    from dist_dqn_tpu_torch.ingest.shm_ring import ShmSlotRing

    rng = np.random.default_rng(6)
    msgs = [rng.integers(0, 256, rng.integers(1, slot_size))
            .astype(np.uint8).tobytes() for _ in range(records)]
    name = f"chip_smoke_helpers_{uuid.uuid4().hex[:8]}"
    ring = ShmSlotRing(name, slot_size=slot_size, nslots=nslots, create=True)
    producer_ring = ShmSlotRing(name)
    try:
        def produce():
            for m in msgs:
                producer_ring.push_wait(m, poll_s=0.0)

        t0 = time.perf_counter()
        th = threading.Thread(target=produce, daemon=True,
                              name="chip-smoke-helpers-producer")
        th.start()
        got = []
        deadline = time.monotonic() + 60.0
        while len(got) < records and time.monotonic() < deadline:
            b = ring.pop()
            if b is not None:
                got.append(b)
        seconds = time.perf_counter() - t0
        th.join(timeout=10)
        return {"records": records, "received": len(got),
                "in_order": got == msgs, "torn_reads": ring.torn_reads,
                "producer_done": not th.is_alive(), "seconds": seconds,
                "records_per_s": len(got) / seconds}
    finally:
        producer_ring.close()
        ring.close()
        ring.unlink()


def check_helpers() -> dict:
    """``n_step_from_rollout`` and ``q_learning_error`` (with its gradient)
    on the card against the same calls on CPU copies, and a ``push_wait``
    round trip through the port's slot ring; prints one ``helpers`` line
    and fails on any mismatch."""
    import numpy as np
    import torch

    from dist_dqn_tpu_torch.ops import losses

    t0 = time.perf_counter()
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    batch, steps, n = HELPERS_ROLLOUT
    rewards = rng.normal(size=(batch, steps)).astype(np.float32)
    discounts = (0.99 * (rng.random((batch, steps)) > 0.1)).astype(
        np.float32)
    want = losses.n_step_from_rollout(torch.from_numpy(rewards),
                                      torch.from_numpy(discounts), n)
    got = losses.n_step_from_rollout(torch.from_numpy(rewards).to(dev),
                                     torch.from_numpy(discounts).to(dev), n)
    out_shape = (batch, steps - n + 1)
    rollout = {
        "shape": [batch, steps], "n": n,
        "out_shape": list(got[0].shape),
        "on_card": all(g.device.type == "cuda" for g in got),
        "finite": all(bool(torch.isfinite(g).all()) for g in got),
        "max_abs_err": {k: float((g.cpu() - w).abs().max()) for k, g, w in
                        zip(("returns", "discounts"), got, want)}}

    rows, actions_n = HELPERS_TD
    q = rng.normal(size=(rows, actions_n)).astype(np.float32)
    actions = rng.integers(0, actions_n, rows).astype(np.int32)
    target_parts = [rng.normal(size=rows).astype(np.float32),
                    (0.99 * (rng.random(rows) > 0.1)).astype(np.float32),
                    rng.normal(size=rows).astype(np.float32)]

    def td(device):
        tq = torch.from_numpy(q).to(device).requires_grad_()
        parts = [torch.from_numpy(x).to(device).requires_grad_()
                 for x in target_parts]
        err = losses.q_learning_error(
            tq, torch.from_numpy(actions).to(device), *parts)
        err.sum().backward()
        return (err.detach(), tq.grad,
                all(p.grad is None for p in parts))

    want_err, want_grad, _ = td(torch.device("cpu"))
    got_err, got_grad, no_target_grad = td(dev)
    td_error = {
        "shape": [rows, actions_n], "out_shape": list(got_err.shape),
        "on_card": got_err.device.type == "cuda",
        "finite": bool(torch.isfinite(got_err).all()),
        "target_grads_none": no_target_grad,
        "max_abs_err": {
            "error": float((got_err.cpu() - want_err).abs().max()),
            "grad_q": float((got_grad.cpu() - want_grad).abs().max())}}

    ring = _ring_round_trip(*HELPERS_RING)
    report = {"n_step_from_rollout": rollout, "q_learning_error": td_error,
              "atol": HELPERS_ATOL, "push_wait": ring,
              "seconds": time.perf_counter() - t0}
    print(json.dumps({"helpers": report}), flush=True)
    errors = [*rollout["max_abs_err"].values(),
              *td_error["max_abs_err"].values()]
    if (rollout["out_shape"] != list(out_shape)
            or td_error["out_shape"] != [rows]
            or not (rollout["on_card"] and td_error["on_card"])
            or not (rollout["finite"] and td_error["finite"])
            or not no_target_grad
            or not all(e <= HELPERS_ATOL for e in errors)
            or ring["received"] != ring["records"] or not ring["in_order"]
            or ring["torn_reads"] or not ring["producer_done"]):
        _fail(f"helpers: {report}")
    return report


class _LedgerWalls:
    """Keeps the wall of every chunk a ``UtilizationLedger`` files while
    open: the sum the ledger's busy and idle series must conserve."""

    def __enter__(self):
        from dist_dqn_tpu_torch.telemetry import devtime

        self.cls, self.real = devtime.UtilizationLedger, \
            devtime.UtilizationLedger.observe_chunk
        self.walls = []
        real, walls = self.real, self.walls

        def observe(ledger, wall_s, busy_s, **causes):
            walls.append(float(wall_s))
            return real(ledger, wall_s, busy_s, **causes)

        self.cls.observe_chunk = observe
        return self

    def __exit__(self, *exc):
        self.cls.observe_chunk = self.real


class _FlushWatch:
    """Counts the batched priority flushes of a run and keeps, on the
    device, whether each one changed the plane (read once, at the end)."""

    def __init__(self):
        from dist_dqn_tpu_torch.replay import prioritized_device as pring
        self.module = pring
        self.real = pring.prioritized_ring_update_batched
        self.changed = []

    def __enter__(self):
        def watched(state, t_idx, b_idx, prios, eps=1e-6):
            before = state.priorities.clone()
            out = self.real(state, t_idx, b_idx, prios, eps=eps)
            self.changed.append((state.priorities != before).any())
            return out

        self.module.prioritized_ring_update_batched = watched
        return self

    def __exit__(self, *exc):
        self.module.prioritized_ring_update_batched = self.real

    def all_changed(self) -> bool:
        import torch
        return bool(torch.stack(self.changed).all()) if self.changed else False


def _fused_chunk_analytic_flops(cfg, chunk_iters: int) -> float:
    """A training chunk of the feed-forward fused loop, analytically: its
    grad steps at five Nature-CNN forwards each over the batch (online,
    target and double-Q forwards, a backward of about two), and one act
    forward over the env lanes per iteration (utils/flops.py)."""
    from dist_dqn_tpu_torch.envs import make_env
    from dist_dqn_tpu_torch.utils import flops

    actions = make_env(cfg.env_name, device=DEVICE).num_actions
    grads = chunk_iters * cfg.updates_per_train / max(cfg.train_every, 1)
    return (grads * 5 * flops.nature_cnn_fwd_flops(cfg.learner.batch_size,
                                                   num_actions=actions)
            + chunk_iters * flops.nature_cnn_fwd_flops(cfg.actor.num_envs,
                                                       num_actions=actions))


def _hold_fused_chip_time(scrape, cfg, history, chunk_iters: int,
                          walls) -> dict:
    """apex's chip-time plane: one ``fused.chunk`` dispatch per chunk, its
    census within 1.5x of the analytic count of a training chunk, the
    learner MFU in (0, 1], the card's memory in use under its total, and
    the ledger's busy and idle series summing to the walls of the chunks
    it filed (those a profiler traced)."""
    prog = "{loop=fused,program=fused.chunk}"
    flops = scrape.grew("dqn_program_flops" + prog)
    analytic = _fused_chunk_analytic_flops(cfg, chunk_iters)
    mfu = scrape.grew("dqn_learner_mfu{loop=fused}")
    mem = {k: scrape.grew("dqn_device_memory_bytes{device=0,kind=" + k + "}")
           for k in ("bytes_in_use", "peak_bytes_in_use", "bytes_reserved",
                     "bytes_limit", "peak_bytes_in_use_seen")}
    ledger = scrape.grew("dqn_chip_busy_seconds_total{loop=fused}") + sum(
        scrape.grew("dqn_chip_idle_seconds_total{cause=" + c + ",loop=fused}")
        for c in ("sample", "evac_fence", "prefetch_wait", "h2d", "other"))
    out = {"fused_chunk_dispatches": scrape.grew(
               "dqn_program_dispatches_total" + prog),
           "chunks": len(history),
           "fused_chunk_device_s": scrape.grew(
               "dqn_program_device_seconds_total" + prog),
           "census_flops": flops, "analytic_flops": analytic,
           "census_over_analytic": flops / analytic,
           "census_bytes": scrape.grew("dqn_program_bytes" + prog),
           "learner_mfu": mfu, "device_memory_bytes": mem,
           "ledger_s": ledger, "chunk_walls_s": sum(walls)}
    print(json.dumps({"chip_time": "apex", **out}), flush=True)
    if out["fused_chunk_dispatches"] != len(history):
        _fail(f"apex: {out['fused_chunk_dispatches']} fused.chunk "
              f"dispatches for {len(history)} chunks")
    if not analytic / 1.5 < flops < analytic * 1.5:
        _fail(f"apex: fused.chunk census {flops} FLOPs, analytic "
              f"{analytic}")
    if not 0.0 < mfu <= 1.0:
        _fail(f"apex: dqn_learner_mfu {mfu} outside (0, 1]")
    if not 0 < mem["bytes_in_use"] <= mem["bytes_limit"]:
        _fail(f"apex: device memory {mem}")
    if abs(ledger - sum(walls)) > 1e-6:
        _fail(f"apex: ledger {ledger} s against chunk walls {sum(walls)} s")
    return out


def _chunk_attribution(cfg, carry, iters: int = CHUNK_ATTRIBUTION_ITERS
                       ) -> dict:
    """One more chunk of ``iters`` training iterations of apex's finished
    carry (the loop rebuilt around its net), attributed as the fused loop
    attributes ``fused.chunk``: dispatch to the fence of the chunk's one
    stacked read. Timed once alone, then once under torch.profiler beside
    the kernels' busy union and duration sum: the attribution is a span
    with the gaps between launches, the kernel sum the card's work."""
    import torch

    from dist_dqn_tpu_torch.envs import make_env
    from dist_dqn_tpu_torch.train import _busy_seconds, _device_spans
    from dist_dqn_tpu_torch.train_loop import make_fused_train

    env = make_env(cfg.env_name, device=DEVICE)
    # devtime: a timing fixture over the apex path's carry; the path's own
    # chunk program was registered by train() as fused.chunk.
    _, run_chunk = make_fused_train(cfg, env, carry.learner.net,
                                    device=DEVICE)
    held = {"carry": carry}

    def chunk() -> float:
        t0 = time.perf_counter()
        held["carry"], m = run_chunk(held["carry"], iters)
        torch.stack([m["episode_return"], m["episodes"],
                     m["loss"]]).tolist()
        return time.perf_counter() - t0

    t0 = time.perf_counter()
    alone = chunk()
    # The card's activity alone: the host ops' events would only cost
    # the profile's parse.
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILE_SETTLE_S)
        traced = chunk()
        time.sleep(PROFILE_SETTLE_S)
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    kernel_sum = sum(e.time_range.end - e.time_range.start
                     for e in kernels) / 1e6
    out = {"iterations": iters, "attributed_s": alone,
           "attributed_s_traced": traced,
           "kernel_busy_s": _busy_seconds(prof), "kernel_sum_s": kernel_sum,
           "device_events": len(_device_spans(prof))}
    out["attributed_over_kernel_busy"] = alone / max(out["kernel_busy_s"],
                                                     1e-12)
    out["seconds"] = time.perf_counter() - t0
    print(json.dumps({"chunk_attribution": "apex", **out}), flush=True)
    if not out["kernel_busy_s"] > 0:
        _fail(f"apex: the profiled chunk shows no kernel: {out}")
    return out


def _hold_fused_scrape(tm, logged, carry, history, launches: int):
    """apex's scrape: the grad and env steps its rows count, its device
    ring's size and capacity, and one sampler launch per grad step.
    Returns the scrape."""
    _logged_telemetry_port(tm.phase, logged)
    scrape = tm.scrape()
    ring = carry.replay.ring
    slots, lanes = ring.action.shape[-2:]
    grad_steps = sum(r["grad_steps_in_chunk"] for r in history)
    scrape.hold({
        "dqn_grad_steps_total": (scrape.grew("dqn_grad_steps_total"),
                                 grad_steps),
        "dqn_env_steps_total": (scrape.grew("dqn_env_steps_total"),
                                history[-1]["env_frames"]),
        "dqn_replay_size{store=device}": (
            scrape.grew("dqn_replay_size{store=device}"), ring.size * lanes),
        "dqn_replay_capacity{store=device}": (
            scrape.grew("dqn_replay_capacity{store=device}"), slots * lanes),
        "sampler_launches_per_grad_step": (launches / max(grad_steps, 1),
                                           1.0)})
    return scrape


def drive_main_path(cfg, total_env_steps: int, chunk_iters: int,
                    stop_fn=None, logged=None, **checkpoint):
    """One config through the port's train() on the card. ``checkpoint``
    passes train()'s checkpoint and profile options; ``logged`` collects
    the rows it logs besides the metric rows (resume, checkpoint and
    profile rows)."""
    import torch

    from dist_dqn_tpu_torch.train import train

    def log(line):
        print(line, flush=True)
        row = json.loads(line)
        if logged is not None and "env_frames" not in row:
            logged.append(row)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    carry, history = train(cfg, total_env_steps=total_env_steps,
                           chunk_iters=chunk_iters, log_fn=log,
                           device=DEVICE, stop_fn=stop_fn, **checkpoint)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return carry, history, wall


def _check_live_starts(cfg, replay) -> int:
    """R2D2's host predicate against the priority plane: live rows (every
    lane > 0) exactly at the slots of ``live_start_writes``. Returns how
    many there are."""
    import torch

    from dist_dqn_tpu_torch.replay.sequence_device import live_start_writes

    num_slots = replay.priorities.shape[0]
    rcfg = cfg.replay
    seq_len = rcfg.burn_in + rcfg.unroll_length + cfg.learner.n_step
    stride = rcfg.sequence_stride or rcfg.unroll_length
    want = sorted(s % num_slots for s in live_start_writes(
        replay.writes, num_slots, seq_len, stride))
    live = replay.priorities > 0
    rows = live.any(dim=1)
    got = rows.nonzero()[:, 0].tolist()
    if got != want or not bool(live[rows].all()):
        _fail(f"live priority rows {got} differ from the host predicate's "
              f"{want}")
    return len(got)


def check_outputs(name: str, cfg, carry, history, launches: int) -> dict:
    """Grad steps taken (through the kernel where the path draws through
    it), finite loss and priorities, f32 learner masters, and Q-values of
    the trained net that agree with a float32 reference forward of the same
    weights on a small input."""
    import dataclasses

    import torch

    from dist_dqn_tpu_torch.models import build_network

    grad_steps = int(sum(r["grad_steps_in_chunk"] for r in history))
    losses = [r["loss"] for r in history if r["grad_steps_in_chunk"]]
    if grad_steps <= 0:
        _fail(f"{name}: the main path took no grad steps")
    if not all(math.isfinite(x) for x in losses):
        _fail(f"{name}: non-finite loss: {losses}")
    recurrent = bool(cfg.network.lstm_size)
    # A path that draws through the kernel draws once per grad step, and
    # never otherwise; a uniform path never launches it.
    draws = cfg.replay.prioritized and cfg.replay.pallas_sampler
    if launches != (grad_steps if draws else 0):
        _fail(f"{name}: sampler kernel launched {launches} times for "
              f"{grad_steps} grad steps")
    if cfg.eval_every_steps and not any("eval_return" in r for r in history):
        _fail(f"{name}: no eval ran")
    if cfg.replay.prioritized:
        pr = carry.replay.priorities
        if not bool(torch.isfinite(pr).all()) or bool((pr < 0).any()):
            _fail(f"{name}: non-finite or negative priorities")
    net = carry.learner.net
    if any(p.dtype != torch.float32 for p in net.parameters()):
        _fail(f"{name}: the learner's master params are not all float32")
    out = {"grad_steps": grad_steps, "final_loss": losses[-1]}
    if recurrent:
        out["live_starts"] = _check_live_starts(cfg, carry.replay)
    obs = carry.obs[:8]
    ref = build_network(dataclasses.replace(cfg.network,
                                            compute_dtype="float32",
                                            lstm_dtype="float32"),
                        net.num_actions, tuple(obs.shape[1:]),
                        device=obs.device)
    ref.load_state_dict(net.state_dict())
    with torch.no_grad():
        if recurrent:
            state = tuple(x[:8] for x in carry.actor_carry)
            q, q32 = net(state, obs)[1], ref(state, obs)[1]
            raw, raw32 = q, q32
        else:
            # The head's own output (C51 logits, quantiles; IQN at its
            # acting fractions) and its Q-values, with the noise off.
            raw, raw32 = net(obs), ref(obs)
            q, q32 = net.q_values(obs), ref.q_values(obs)
    shape = (obs.shape[0], net.num_actions)
    if tuple(q.shape) != shape or not bool(torch.isfinite(q).all()):
        _fail(f"{name}: Q-values of shape {tuple(q.shape)} (want {shape}) "
              "or non-finite")
    # bf16 keeps 8 significant bits through five layers (and the cell).
    scale = float(raw32.abs().max().clamp(min=1e-3))
    raw_err = float((raw - raw32).abs().max())
    q_err = float((q - q32).abs().max())
    # A C51 expectation moves by at most 2 max|atom| times the logits'
    # largest error; a quantile mean or a scalar head by that error.
    c51 = getattr(net, "num_atoms", 1) > 1 and not net.quantile
    q_bound = 0.05 * scale * (2 * max(abs(net.v_min), abs(net.v_max))
                              if c51 else 1.0)
    if raw_err > 0.05 * scale or q_err > q_bound:
        _fail(f"{name}: bf16 head output off the f32 reference by "
              f"{raw_err} (scale {scale}), or Q-values by {q_err} (bound "
              f"{q_bound})")
    return {**out, "q_vs_f32_max_abs": q_err, "q_bound": q_bound,
            "head_vs_f32_max_abs": raw_err, "q_scale": scale}


def evaluate_at_end(cfg, net):
    """One greedy evaluation of a finished path's net, as train() runs
    one on its eval cadence: the run's evaluator, from its evaluation
    generator (seed + 1; each member's for a population). Returns (the
    mean return, or the members' list of them, seconds)."""
    import torch

    from dist_dqn_tpu_torch import population as pop
    from dist_dqn_tpu_torch.envs import make_env
    from dist_dqn_tpu_torch.train_loop import make_evaluator

    env = make_env(cfg.env_name, device=DEVICE)
    evaluate = make_evaluator(cfg, env, num_episodes=cfg.eval_episodes)
    M = cfg.population.size
    seeds = pop.member_seeds(cfg.seed, M) if M > 1 else [cfg.seed]
    gens = [torch.Generator(device=DEVICE).manual_seed(s + 1)
            for s in seeds]
    t0 = time.perf_counter()
    returns = evaluate(net, gens if M > 1 else gens[0]).tolist()
    return returns, time.perf_counter() - t0


def _main_path_row(name, history, wall, launches, outputs) -> dict:
    import torch
    steady = history[1:]
    return {
        "main_path": name, "device": torch.cuda.get_device_name(0),
        "wall_s": wall, "env_frames": history[-1]["env_frames"],
        "env_steps_per_sec_last": history[-1]["env_steps_per_sec"],
        "grad_steps_per_sec_last": history[-1]["grad_steps_per_sec"],
        "env_steps_per_sec_chunks": [r["env_steps_per_sec"]
                                     for r in steady],
        "grad_steps_per_sec_chunks": [r["grad_steps_per_sec"]
                                      for r in steady],
        "grad_steps_in_chunks": [r["grad_steps_in_chunk"] for r in history],
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "sampler_launches": launches, **outputs}


def run_learning_bar(name: str, sampler) -> int:
    """Train one learning bar's config to its bar (or its frame cap) with
    the launch counter zeroed just before; fails if the bar is missed.
    Returns the sampler launches of the run."""
    import torch

    from dist_dqn_tpu_torch import learning_bars as bars

    config_fn, bar, key = bars.BARS[name]
    cfg, cap, chunk_iters = config_fn()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    sampler.kernel_stratified_sample.launches = 0
    carry, history, wall = drive_main_path(
        cfg, cap, chunk_iters, stop_fn=lambda row: row.get(key, -1e9) >= bar)
    launches = sampler.kernel_stratified_sample.launches
    outputs = check_outputs(name, cfg, carry, history, launches)
    reached = [r["env_frames"] for r in history if r.get(key, -1e9) >= bar]
    first = history[0]["episode_return"]
    print(json.dumps({**_main_path_row(name, history, wall, launches,
                                       outputs),
                      "learning_bar": key, "bar": bar, "frame_cap": cap,
                      "frames_to_bar": reached[0] if reached else None,
                      "first_chunk_return": first,
                      "evals": [r["eval_return"] for r in history
                                if "eval_return" in r]}), flush=True)
    if not reached:
        _fail(f"{name}: {key} never reached {bar} within {cap} frames")
    if name == "catch" and not first < bars.CATCH_RANDOM_CEILING:
        _fail(f"{name}: the first chunk's return {first} is not a random "
              f"policy's (< {bars.CATCH_RANDOM_CEILING})")
    return launches


def _checkpoint_rows(logged) -> dict:
    """Save and restore seconds and bytes from train()'s checkpoint rows."""
    saves = [r for r in logged if "checkpoint_save_s" in r]
    restores = [r for r in logged if "checkpoint_restore_s" in r]
    return {"saved_at_frames": [r["checkpoint_save_at_frames"]
                                for r in saves],
            "save_s": [r["checkpoint_save_s"] for r in saves],
            "restore_s": [r["checkpoint_restore_s"] for r in restores],
            "checkpoint_bytes": sorted({r["checkpoint_bytes"]
                                        for r in saves + restores})}


def _tree_diff(a, b, path="carry") -> list:
    """Paths at which two state trees differ (tensors bit for bit)."""
    import torch
    if isinstance(a, torch.Tensor):
        same = (isinstance(b, torch.Tensor) and a.dtype == b.dtype
                and a.shape == b.shape and torch.equal(a, b.to(a.device)))
        return [] if same else [path]
    if isinstance(a, dict):
        if not isinstance(b, dict) or set(a) != set(b):
            return [path]
        return [p for k in a for p in _tree_diff(a[k], b[k], f"{path}.{k}")]
    if isinstance(a, list):
        if not isinstance(b, list) or len(a) != len(b):
            return [path]
        return [p for i, (x, y) in enumerate(zip(a, b))
                for p in _tree_diff(x, y, f"{path}[{i}]")]
    return [] if a == b else [path]


def check_checkpoint_apex(cfg, chunk_iters: int, directory: str,
                          first_leg: dict, sampler) -> int:
    """Relaunch the apex path, which saved into ``directory``, to
    APEX_RESUMED_TOTAL frames; then evaluate what it saved. Returns the
    sampler launches of the relaunch."""
    import torch

    from dist_dqn_tpu_torch.evaluate import (_build_eval,
                                             evaluate_checkpoint,
                                             evaluate_checkpoint_curve)
    from dist_dqn_tpu_torch.utils.checkpoint import (TrainCheckpointer,
                                                     list_checkpoint_steps,
                                                     restore_pytree)

    name = "checkpoint_apex"
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    logged = []
    sampler.kernel_stratified_sample.launches = 0
    carry, history, wall = drive_main_path(
        cfg, APEX_RESUMED_TOTAL, chunk_iters, logged=logged,
        checkpoint_dir=directory, save_every_frames=APEX_SAVE_EVERY)
    launches = sampler.kernel_stratified_sample.launches
    resumed = [r for r in logged if "resumed_at_frames" in r]
    want = [{"resumed_at_frames": first_leg["frames"], "with_replay": False}]
    if resumed != want or history[0]["env_frames"] <= first_leg["frames"]:
        _fail(f"{name}: resumed {resumed} (want {want}), first row at "
              f"{history[0]['env_frames']}")
    outputs = check_outputs(name, cfg, carry, history, launches)
    if (outputs["grad_steps"] != first_leg["steps"]
            or carry.learner.steps != first_leg["steps"] * 2):
        _fail(f"{name}: {outputs['grad_steps']} grad steps after the "
              f"resume (first leg {first_leg['steps']}), learner steps "
              f"{carry.learner.steps}")
    row = _main_path_row(name, history, wall, launches, outputs)
    del carry, history
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    export = os.path.join(directory, "exported_params.pt")
    single = evaluate_checkpoint(cfg, directory,
                                 episodes=cfg.eval_episodes, device=DEVICE,
                                 export_params=export)
    single_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    curve = evaluate_checkpoint_curve(cfg, directory,
                                      episodes=cfg.eval_episodes,
                                      device=DEVICE)
    curve_s = time.perf_counter() - t0
    net, _, _ = _build_eval(cfg, 1, 0.0, 1, DEVICE)
    exported = [x.clone() for x in restore_pytree(export, net).state_dict()
                .values()]
    _, direct = TrainCheckpointer(directory).restore_params(net)
    export_equal = all(torch.equal(a, b) for a, b in
                       zip(exported, direct.state_dict().values()))
    steps = list(list_checkpoint_steps(directory))
    returns = [single["eval_return"]] + [r["eval_return"] for r in curve]
    report = {
        **row, "resumed_at_frames": first_leg["frames"],
        "first_leg": first_leg,
        **_checkpoint_rows(logged),
        "retained_steps": steps, "evaluate_frames": single["frames"],
        "evaluate_return": single["eval_return"], "evaluate_s": single_s,
        "curve": [[r["frames"], r["eval_return"]] for r in curve],
        "curve_s": curve_s, "export_params_equal": export_equal}
    print(json.dumps(report), flush=True)
    if (not all(math.isfinite(x) for x in returns)
            or [r["frames"] for r in curve] != steps
            or single["frames"] != APEX_RESUMED_TOTAL or not export_equal):
        _fail(f"{name}: evaluate returned {returns} at {steps}, or the "
              "exported params differ from the checkpoint's")
    return launches


def check_resume_r2d2(cfg, chunk_iters: int, total: int, directory: str,
                      reference, sampler) -> int:
    """The r2d2 path stopped after R2D2_STOP frames with the whole carry
    saved, then resumed to ``total``: the carry must equal ``reference``
    (the uninterrupted path's) bit for bit. Returns the sampler launches
    of both legs."""
    import dataclasses

    import torch

    from dist_dqn_tpu_torch.utils.checkpoint import state_tree

    name = "resume_r2d2"
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    logged = []
    ckpt = dict(checkpoint_dir=directory, checkpoint_replay=True,
                save_every_frames=R2D2_STOP, logged=logged)
    # Evaluation reads the carry and changes none of it, so the legs skip
    # it. The stopped leg runs as one chunk, so it saves once, at its end:
    # chunk boundaries only reset the chunk's metric accumulators, which
    # the resumed leg's one chunk resets again.
    cfg = dataclasses.replace(cfg, eval_every_steps=0)
    sampler.kernel_stratified_sample.launches = 0
    _, first, wall_a = drive_main_path(
        cfg, R2D2_STOP, R2D2_STOP // cfg.actor.num_envs, **ckpt)
    carry, second, wall_b = drive_main_path(cfg, total, chunk_iters, **ckpt)
    launches = sampler.kernel_stratified_sample.launches
    history = first + second
    grad_steps = int(sum(r["grad_steps_in_chunk"] for r in history))
    diff = _tree_diff(state_tree(reference), state_tree(carry))
    resumed = [r for r in logged if "resumed_at_frames" in r]
    report = {**_main_path_row(name, history, wall_a + wall_b, launches,
                               {"grad_steps": grad_steps}),
              "resumed": resumed, **_checkpoint_rows(logged),
              "bit_equal_to_uninterrupted": not diff,
              "differing_leaves": diff[:8],
              "learner_steps": carry.learner.steps}
    print(json.dumps(report), flush=True)
    if resumed != [{"resumed_at_frames": R2D2_STOP, "with_replay": True}]:
        _fail(f"{name}: resumed {resumed}")
    if launches != grad_steps or grad_steps != reference.learner.steps:
        _fail(f"{name}: {launches} sampler launches, {grad_steps} grad "
              f"steps, the uninterrupted path {reference.learner.steps}")
    if diff:
        _fail(f"{name}: the resumed carry differs from the uninterrupted "
              f"path at {len(diff)} leaves: {diff[:8]}")
    return launches


def check_evaluate_iqn_risk(cfg, directory: str) -> None:
    """Play the iqn path's saved learner at each of RISK_ETAS."""
    from dist_dqn_tpu_torch.evaluate import _apply_risk_eta, \
        evaluate_checkpoint

    out = {}
    for eta in RISK_ETAS:
        t0 = time.perf_counter()
        row = evaluate_checkpoint(_apply_risk_eta(cfg, eta), directory,
                                  episodes=cfg.eval_episodes, device=DEVICE)
        out[str(eta)] = {"eval_return": row["eval_return"],
                         "frames": row["frames"],
                         "seconds": time.perf_counter() - t0}
    print(json.dumps({"evaluate_iqn_risk": out}), flush=True)
    if not all(math.isfinite(v["eval_return"]) for v in out.values()):
        _fail(f"evaluate_iqn_risk: non-finite returns {out}")


def _host_rss_gb() -> dict:
    """This process's resident host memory now and at its peak, GB."""
    out = {}
    with open("/proc/self/status") as fh:
        for line in fh:
            key, _, value = line.partition(":")
            if key == "VmRSS":
                out[key] = int(value.split()[0]) * 1024 / 1e9
    import resource
    peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024 / 1e9
    return {"host_rss_gb": out.get("VmRSS"), "host_rss_peak_gb": peak}


def _drive_host_replay(cfg, total_env_steps: int, chunk_iters: int,
                       logged=None, **options):
    """One run of the port's host-replay runtime on the card; returns
    (summary, wall seconds). ``logged`` collects the JSON rows it logs
    besides the chunk rows."""
    import torch

    from dist_dqn_tpu_torch.host_replay_loop import run_host_replay

    def log(line):
        print(line, flush=True)
        if logged is not None and line.startswith("{") \
                and "env_frames" not in line:
            logged.append(json.loads(line))

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = run_host_replay(cfg, total_env_steps=total_env_steps,
                          chunk_iters=chunk_iters, log_fn=log,
                          device=DEVICE, **options)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def check_host_replay_apex_dedup(sampler, directory: str) -> int:
    """HOST_REPLAY_PATH through the host-replay runtime (pipelined and
    prefetched, PER on the device plane): one sampler launch per grad
    step at the plane [1954, 512], a finite loss. Prints the rows' rates,
    the evacuation columns, host RSS and the card's peak memory; returns
    the launches. Runs armed (:class:`_ArmedForensics`): no stall, trip
    or bundle, and the loop's evacuation, fence and train events in its
    /debug/flight tail."""
    import torch

    from dist_dqn_tpu_torch.config import CONFIGS, apply_overrides

    preset, overrides, total, chunk_iters = HOST_REPLAY_PATH
    cfg = apply_overrides(CONFIGS[preset], overrides)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    armed = _ArmedForensics("host_replay_apex_dedup", directory)
    try:
        tm = _PhaseTelemetry("host_replay_apex_dedup", cfg)
        logged = []
        sampler.kernel_stratified_sample.launches = 0
        out, wall = _drive_host_replay(cfg, total, chunk_iters,
                                       logged=logged, prioritized=True,
                                       device_sampling=True,
                                       telemetry_port=0)
        launches = sampler.kernel_stratified_sample.launches
        _logged_telemetry_port(tm.phase, logged)
        armed.hold(tm)
        scrape = tm.scrape()
    finally:
        armed.close()
    ring_key = "{store=host_ring}"
    scrape.hold({
        "dqn_replay_size" + ring_key: (
            scrape.grew("dqn_replay_size" + ring_key),
            out["history"][-1]["ring_transitions"]),
        "dqn_replay_added_total" + ring_key: (
            scrape.grew("dqn_replay_added_total" + ring_key),
            out["env_steps"]),
        "dqn_replay_sampled_total" + ring_key: (
            scrape.grew("dqn_replay_sampled_total" + ring_key),
            (out["grad_steps"] + out["stale_batches"]) * out["train_batch"]),
        "dqn_host_replay_d2h_bytes_total{loop=host_replay}": (
            scrape.grew("dqn_host_replay_d2h_bytes_total{loop=host_replay}"),
            out["d2h_bytes_total"]),
        "dqn_host_replay_prio_writeback_rows_total{loop=host_replay}": (
            scrape.grew("dqn_host_replay_prio_writeback_rows_total"
                        "{loop=host_replay}"), out["prio_writeback_rows"]),
        "sampler_launches_per_grad_step": (
            launches / max(out["grad_steps"] + out["stale_batches"], 1),
            1.0),
        "dqn_program_dispatches_total{loop=sampler,"
        "program=sampler.draw_writeback}": (
            scrape.grew("dqn_program_dispatches_total{loop=sampler,"
                        "program=sampler.draw_writeback}"), launches),
        "dqn_program_dispatches_total{loop=host_replay,"
        "program=host_replay.train_step}": (
            scrape.grew("dqn_program_dispatches_total{loop=host_replay,"
                        "program=host_replay.train_step}"),
            out["grad_steps"])})
    chip = _hold_host_replay_chip_time(scrape, out)
    history = out["history"]
    losses = [r["loss"] for r in history if "loss" in r]
    training = [r for r in history if "loss" in r]
    row = {"main_path": "host_replay_apex_dedup",
           "device": torch.cuda.get_device_name(0), "wall_s": wall,
           "env_frames": out["env_steps"], "grad_steps": out["grad_steps"],
           "sampler_launches": launches,
           "sampler": out["sampler"], "stale_batches": out["stale_batches"],
           "final_loss": losses[-1] if losses else None,
           "plane_shape": [-(-CONFIGS[preset].replay.capacity // 512), 512],
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           **_host_rss_gb(), "ring_gb": out["ring_gb"],
           "env_steps_per_sec_chunks": [r["env_steps_per_sec"]
                                        for r in history[1:]],
           "grad_steps_per_sec_training": [
               (r["grad_steps"] - p["grad_steps"]) / r["chunk_train_s"]
               for p, r in zip(history, history[1:]) if "loss" in r],
           **{k: [r[k] for r in history] for k in (
               "evac_s", "evac_fence_wait_s", "evac_overlap_frac",
               "device_idle_est_s", "chip_busy_s", "prefetch_wait_s",
               "sample_s")},
           "evac_fence_wait_s_total": out["evac_fence_wait_s_total"],
           "d2h_bytes_total": out["d2h_bytes_total"],
           "h2d_staged_bytes": out["h2d_staged_bytes"],
           "chip_time": out["chip_time"], "programs": chip["programs"],
           "training_chunks": len(training),
           "summary_grad_steps_per_sec": out["grad_steps_per_sec"],
           "summary_env_steps_per_sec": out["env_steps_per_sec"]}
    print(json.dumps(row), flush=True)
    if out["grad_steps"] < HOST_REPLAY_MIN_GRAD_STEPS:
        _fail(f"host_replay_apex_dedup: {out['grad_steps']} grad steps, "
              f"want >= {HOST_REPLAY_MIN_GRAD_STEPS}")
    if launches != out["grad_steps"] + out["stale_batches"]:
        _fail(f"host_replay_apex_dedup: sampler kernel launched {launches} "
              f"times for {out['grad_steps']} grad steps")
    if not losses or not all(math.isfinite(x) for x in losses):
        _fail(f"host_replay_apex_dedup: non-finite loss: {losses}")
    return launches


def _hold_host_replay_chip_time(scrape, out: dict) -> dict:
    """host_replay_apex_dedup's chip-time plane: the scraped ledger equal
    to the summary's ``chip_time``, and a census on the train step."""
    loop = "loop=host_replay"
    chip = out["chip_time"]
    got = {"busy": scrape.grew("dqn_chip_busy_seconds_total{" + loop + "}")}
    for cause in ("sample", "evac_fence", "prefetch_wait", "h2d", "other"):
        got[cause] = scrape.grew(
            "dqn_chip_idle_seconds_total{cause=" + cause + "," + loop + "}")
    progs = out["programs"]
    res = {"ledger_scraped": got, "chip_time": chip, "programs": progs,
           "learner_mfu": scrape.after.get(
               "dqn_learner_mfu{" + loop + "}", {}).get("value")}
    print(json.dumps({"chip_time": "host_replay_apex_dedup", **res}),
          flush=True)
    off = {k: (v, chip[k]) for k, v in got.items()
           if abs(v - chip[k]) > 1e-6}
    if off:
        _fail(f"host_replay_apex_dedup: scraped ledger differs from the "
              f"summary's chip_time: {off}")
    train = progs.get("host_replay.train_step", {})
    if not train.get("flops") or not train.get("bytes"):
        _fail(f"host_replay_apex_dedup: host_replay.train_step has no "
              f"census: {train}")
    return res


def check_apex_service_pong(sampler, directory: str) -> int:
    """APEX_SERVICE_PATH through the port's Ape-X service: actor processes
    over shared memory, one batched act per ingest pass, actor-shipped
    priorities, PER through the device plane. Holds: at least
    APEX_SERVICE_MIN_GRAD_STEPS grad steps, one sampler launch per grad
    step, one act dispatch per ingest pass, no dropped, torn or bad
    records and no actor restarts, a finite loss; traces the first train
    event (torch.profiler) for the device's busy share; then the learner
    checkpoint it saved at the end is restored and played by the port's
    evaluate CLI. Runs armed (:class:`_ArmedForensics`): no stall, trip
    or bundle, the service's spans in its /debug/flight tail, and a
    fleet aggregator finds it live while it trains (:func:`_fleet_check`).
    Returns the launches."""
    import contextlib
    import io

    import torch

    from dist_dqn_tpu_torch import evaluate
    from dist_dqn_tpu_torch.actors.service import (ApexLearnerService,
                                                   ApexRuntimeConfig)
    from dist_dqn_tpu_torch.config import CONFIGS, apply_overrides

    preset, overrides, total = APEX_SERVICE_PATH
    actors, lanes = APEX_SERVICE_ACTORS
    cfg = apply_overrides(CONFIGS[preset], overrides)
    ckpt_dir = os.path.join(directory, "checkpoint")
    trace_path = os.path.join(directory, "trace.json")
    rt = ApexRuntimeConfig(host_env="pong", num_actors=actors,
                           envs_per_actor=lanes, total_env_steps=total,
                           device_sampling=True, checkpoint_dir=ckpt_dir,
                           save_every_steps=total,
                           profile_dir=os.path.join(directory, "profile"),
                           telemetry_port=0, trace_path=trace_path)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    armed = _ArmedForensics("apex_service_pong", directory)
    try:
        tm = _PhaseTelemetry("apex_service_pong", cfg)
        logged = []

        def log(line):
            print(line, flush=True)
            if line.startswith('{"telemetry_port"'):
                logged.append(json.loads(line))

        service = ApexLearnerService(cfg, rt, log_fn=log, device=DEVICE)
        capture = _CaptureWhileTraining(tm, service, armed.fleet_dir)
        sampler.kernel_stratified_sample.launches = 0
        out = service.run()
        launches = sampler.kernel_stratified_sample.launches
        capture.join()
        _logged_telemetry_port(tm.phase, logged)
        fleet_res = capture.fleet
        armed.hold(tm, {"fleet": fleet_res})
        scrape = tm.scrape()
    finally:
        armed.close()
    profile_ok = (fleet_res or {}).get("profile", {})
    if not fleet_res or fleet_res["member"]["state"] != "live" \
            or fleet_res["member"]["healthy"] is not True \
            or fleet_res["member"]["labels"] != {"loop": "apex"} \
            or fleet_res["unlabeled"] or not fleet_res["merged_samples"] \
            or not profile_ok.get("sample_kernels"):
        _fail(f"apex_service_pong: the fleet check: {fleet_res}")
    scrape.hold({
        "dqn_env_steps_total": (scrape.grew("dqn_env_steps_total"),
                                out["env_steps"]),
        "dqn_grad_steps_total": (scrape.grew("dqn_grad_steps_total"),
                                 out["grad_steps"]),
        "dqn_ingest_records_total": (
            scrape.sum_grew("dqn_ingest_records_total"),
            sum(out["records_by_shard"].values())),
        "dqn_service_device_calls_total{call=train}": (
            scrape.grew("dqn_service_device_calls_total{call=train}"),
            out["device_calls"]["train"]),
        "dqn_replay_size{store=host}": (
            scrape.grew("dqn_replay_size{store=host}"), out["replay_size"]),
        "sampler_launches_per_grad_step": (
            launches / max(out["grad_steps"], 1), 1.0)})
    overhead = time_registry_updates()
    print(json.dumps({"telemetry_overhead": overhead}), flush=True)
    _hold_service_chip_time(out, trace_path, capture.result)
    profile = service.profile_row or {}
    t_fill = out["run_s"] - out["train_s"]
    row = {"main_path": "apex_service_pong",
           "device": torch.cuda.get_device_name(0),
           "actors": actors, "envs_per_actor": lanes,
           "env_steps": out["env_steps"], "grad_steps": out["grad_steps"],
           "sampler_launches": launches,
           "run_s": out["run_s"], "train_s": out["train_s"],
           "env_steps_per_sec": out["env_steps"] / out["run_s"],
           "env_steps_per_sec_before_fill": cfg.replay.min_fill / t_fill,
           "grad_steps_per_sec_training": out["grad_steps"] / out["train_s"],
           "ingest_passes": out["ingest_passes"],
           "ingest_device_calls_per_pass":
               out["ingest_device_calls_per_pass"],
           "device_calls": out["device_calls"],
           "ring_dropped": out["ring_dropped"],
           "ingest_torn_reads": out["ingest_torn_reads"],
           "actor_restarts": out["actor_restarts"],
           "bad_records": out["bad_records"],
           "ingest_decode_errors": out["ingest_decode_errors"],
           "replay_size": out["replay_size"],
           "episodes_completed": out["episodes_completed"],
           "episode_return_recent": out["episode_return_recent"],
           "bytes_on_wire": out["bytes_on_wire"],
           "final_loss": out["loss"],
           "plane_shape": list(service.replay.device_sampler.plane.shape),
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           **_host_rss_gb(),
           "traced_train_event": {k: profile.get(k) for k in (
               "profile_wall_s", "device_busy_s", "device_busy_share",
               "device_events")}}
    del service
    if out["grad_steps"] < APEX_SERVICE_MIN_GRAD_STEPS:
        _fail(f"apex_service_pong: {out['grad_steps']} grad steps, want >= "
              f"{APEX_SERVICE_MIN_GRAD_STEPS}")
    if launches != out["grad_steps"]:
        _fail(f"apex_service_pong: sampler kernel launched {launches} times "
              f"for {out['grad_steps']} grad steps")
    if out["ingest_device_calls_per_pass"] != 1.0:
        _fail(f"apex_service_pong: {out['ingest_device_calls_per_pass']} "
              "act dispatches per ingest pass, want 1.0")
    # The zero-copy actors publish into their slot rings, so a lost record
    # shows as a torn read there (ring_dropped reads the request ring,
    # which this path does not write); a respawned actor lost its lanes.
    if out["ring_dropped"] or out["ingest_torn_reads"] \
            or out["bad_records"] or out["ingest_decode_errors"] \
            or out["actor_restarts"]:
        _fail(f"apex_service_pong: dropped {out['ring_dropped']}, torn "
              f"{out['ingest_torn_reads']}, bad {out['bad_records']}, "
              f"undecodable {out['ingest_decode_errors']} records, "
              f"{out['actor_restarts']} actor restarts")
    if not math.isfinite(out["loss"]):
        _fail(f"apex_service_pong: non-finite loss {out['loss']}")
    if profile.get("device_busy_share") is None:
        _fail("apex_service_pong: the first train event was not traced")
    # The port's evaluate CLI restores the learner checkpoint the run saved
    # at its end and plays it on the card.
    text = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(text):
        evaluate.main(["--config", preset, "--checkpoint-dir", ckpt_dir,
                       "--episodes", "1", "--device", DEVICE,
                       *(a for o in overrides for a in ("--set", o))])
    restored = json.loads(text.getvalue().strip().splitlines()[-1])
    row["evaluate"] = {**restored, "seconds": time.perf_counter() - t0}
    print(json.dumps(row), flush=True)
    if restored["frames"] != out["env_steps"] \
            or not math.isfinite(restored["eval_return"]):
        _fail(f"apex_service_pong: evaluate restored {restored}, want the "
              f"checkpoint at {out['env_steps']} env steps and a finite "
              "return")
    return launches


class _CaptureWhileTraining:
    """``/debug/profile?seconds=1`` captures from the phase's telemetry
    server, on a thread of its own, once the service has retired (and
    stopped tracing) its first train event: each runs on the server's
    thread while the service thread works. A window in which the service
    retired fewer than two grad steps may hold no sampler kernel, so up
    to CAPTURE_TRIES captures are taken until one window retired two.
    ``result`` is the last capture's JSON and kernel counts, with the
    grad steps retired during it and the tries. With ``fleet_dir`` the
    thread then runs :func:`_fleet_check` (``fleet``) while the service
    still trains."""

    def __init__(self, tm, service, fleet_dir: str = None):
        import threading

        self.result = None
        self.fleet = None

        def work():
            while service.profile_row is None:
                if service._t_end is not None:
                    return
                time.sleep(0.05)
            for tries in range(1, CAPTURE_TRIES + 1):
                if service._t_end is not None:
                    return
                steps = service.grad_steps
                got = _capture_profile(tm)
                self.result = {**got, "tries": tries,
                               "grad_steps_during": service.grad_steps
                               - steps}
                if self.result["grad_steps_during"] >= 2:
                    break
            if fleet_dir is not None:
                self.fleet = _fleet_check(fleet_dir, service)

        self._thread = threading.Thread(target=work, daemon=True,
                                        name="profile-capture")
        self._thread.start()

    def join(self) -> None:
        self._thread.join(timeout=180)


def _capture_profile(tm, delay_s: float = 0.0) -> dict:
    """``/debug/profile?seconds=1`` from the phase's telemetry server after
    ``delay_s``: the endpoint's JSON, the CUDA kernel events its trace
    holds and how many of them are the sampler kernel's."""
    time.sleep(delay_s)
    t0 = time.perf_counter()
    got = json.loads(tm._get("/debug/profile?seconds=1"))
    counts = (_count_trace_kernels(got["trace_dir"]) if "trace_dir" in got
              else {"kernels": 0, "sample_kernels": 0})
    return {"capture": got, **counts, "seconds": time.perf_counter() - t0}


def time_span_overhead(n: int = TELEMETRY_UPDATES) -> dict:
    """Host microseconds per span of the service's tracer (utils/trace.py
    SpanTracer: the event and its registry histogram), over ``n`` spans,
    and the seconds their flush to disk takes."""
    from dist_dqn_tpu_torch.telemetry import Registry
    from dist_dqn_tpu_torch.utils.trace import SpanTracer

    with tempfile.TemporaryDirectory() as d:
        tr = SpanTracer(os.path.join(d, "t.json"), registry=Registry())
        t0 = time.perf_counter()
        for _ in range(n):
            with tr.span("replay.sample"):
                pass
        us = (time.perf_counter() - t0) / n * 1e6
        t0 = time.perf_counter()
        tr.close()
        flush_s = time.perf_counter() - t0
    return {"spans": n, "us_per_span": us, "flush_s": flush_s}


def time_flight_overhead(n: int = FLIGHT_OVERHEAD_N) -> dict:
    """Host microseconds per flight-recorder ``record()`` and per
    ``FlightTracer`` span (the service's default tracer without a trace
    path), each over ``n`` events into a ring of their own."""
    from dist_dqn_tpu_torch.telemetry.flight import FlightRecorder
    from dist_dqn_tpu_torch.utils.trace import FlightTracer

    fr = FlightRecorder()
    t0 = time.perf_counter()
    for _ in range(n):
        fr.record("queue", "evac.bench.submit", slices=4)
    record_us = (time.perf_counter() - t0) / n * 1e6
    tr = FlightTracer(FlightRecorder())
    t0 = time.perf_counter()
    for _ in range(n):
        with tr.span("replay.sample", batch=512):
            pass
    span_us = (time.perf_counter() - t0) / n * 1e6
    return {"events": n, "us_per_record": record_us,
            "us_per_flight_span": span_us}


def _bundles(directory: str) -> list:
    """The forensics bundles (finished or being written) in a directory."""
    if not os.path.isdir(directory):
        return []
    return sorted(d for d in os.listdir(directory)
                  if _BUNDLE_RE.search(d.removesuffix(".writing")))


class _ArmedForensics:
    """The crash-forensics and fleet plane around one healthy phase: a
    forensics dir and a fleet dir of the phase's own, exported to the
    processes it spawns, the watchdog (FORENSICS_DEADLINE_S) and the
    divergence sentinel installed, the flight ring fresh. :meth:`hold`
    reads the phase's /debug/flight tail and then fails the phase on any
    stall, trip or bundle (the spawned processes' included), a bundle
    write that failed, or a tail without the loop's own events; it
    prints the ``forensics`` line and the ``flight_overhead`` line.
    :meth:`close` disarms and restores the environment."""

    def __init__(self, phase: str, directory: str):
        from dist_dqn_tpu_torch.telemetry import fleet, flight, watchdog

        self.phase = phase
        self.dir = os.path.join(directory, "forensics")
        self.fleet_dir = os.path.join(directory, "fleet")
        os.makedirs(self.fleet_dir, exist_ok=True)
        self._env = {k: os.environ.get(k) for k in (
            watchdog.FORENSICS_ENV, watchdog.DEADLINE_ENV, fleet.FLEET_ENV)}
        os.environ[watchdog.FORENSICS_ENV] = self.dir
        os.environ[watchdog.DEADLINE_ENV] = str(FORENSICS_DEADLINE_S)
        os.environ[fleet.FLEET_ENV] = self.fleet_dir
        flight.configure(enabled=True)
        log = lambda line: print(line, flush=True)  # noqa: E731
        self.watchdog = watchdog.install_watchdog(
            forensics_dir=self.dir, deadline_s=FORENSICS_DEADLINE_S,
            log_fn=log)
        self.sentinel = watchdog.install_sentinel(forensics_dir=self.dir,
                                                  log_fn=log)

    def hold(self, tm, extra: dict = None) -> dict:
        """After the phase's run (whose fleet descriptors must be gone)
        and before ``tm.scrape()`` (which closes the phase's server)."""
        import fnmatch

        from dist_dqn_tpu_torch import telemetry

        body = json.loads(tm._get("/debug/flight"))
        names = [e["name"] for e in body["events"]]
        kinds = sorted({e["kind"] for e in body["events"]})
        missing = [w for w in FLIGHT_TAIL_WANT[self.phase]
                   if not fnmatch.filter(names, w)]
        now = telemetry.get_registry().snapshot()

        def grew(family):
            return sum(v["value"] - tm.before.get(k, {}).get("value", 0.0)
                       for k, v in now.items()
                       if k == family or k.startswith(family + "{"))

        self.watchdog.check()        # one sweep at the phase's end
        left = sorted(os.listdir(self.fleet_dir))
        # Every stage this phase's own watchdog swept (it keeps one age
        # gauge per stage it ever saw), closed ones included.
        stages = sorted(self.watchdog._age_gauges)
        res = {"forensics": self.phase,
               "stalls": grew("dqn_watchdog_stalls_total"),
               "trips": grew("dqn_divergence_trips_total"),
               "bundles_counted": grew("dqn_forensics_bundles_total"),
               "bundles": _bundles(self.dir),
               "bundle_errors": (self.watchdog.bundle_errors
                                 + self.sentinel.bundle_errors),
               "tripped": self.sentinel.tripped,
               "stale": self.watchdog.stale(),
               "stages_swept": stages,
               "flight_total": body["total"],
               "flight_tail": len(names), "flight_kinds": kinds,
               "flight_names": sorted(set(names))[:40],
               "flight_missing": missing, "fleet_left": left,
               **(extra or {})}
        print(json.dumps(res), flush=True)
        print(json.dumps({"flight_overhead": self.phase,
                          **time_flight_overhead()}), flush=True)
        if (res["stalls"] or res["trips"] or res["bundles_counted"]
                or res["bundles"] or res["bundle_errors"] or res["tripped"]
                or res["stale"] or left):
            _fail(f"{self.phase}: the healthy armed run tripped the "
                  f"forensics plane: {res}")
        if missing or "watchdog" in kinds or "divergence" in kinds:
            _fail(f"{self.phase}: /debug/flight tail without the loop's "
                  f"own events {missing} or with a trip: {kinds}")
        return res

    def close(self) -> None:
        from dist_dqn_tpu_torch.telemetry import watchdog

        watchdog.uninstall_watchdog()
        for k, v in self._env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _count_trace_kernels(trace_dir: str) -> dict:
    """The CUDA kernel events of a torch.profiler trace directory, and how
    many are the sampler kernel's."""
    with open(os.path.join(trace_dir, "trace.json")) as f:
        kernels = [e["name"] for e in json.load(f).get("traceEvents", [])
                   if e.get("cat") == "kernel"]
    return {"kernels": len(kernels),
            "sample_kernels": sum("sample_kernel" in k for k in kernels)}


def _fleet_check(fleet_dir: str, service) -> dict:
    """While the service trains: an in-process FleetAggregator over the
    phase's fleet dir finds the service (role learner, loop apex) live and
    healthy, labels every merged sample line of it with ``process`` and
    ``role``, and a ``/fleet/profile?seconds=1`` capture through the
    aggregator's HTTP face holds the sampler kernel (retried, up to
    CAPTURE_TRIES, while a window holds none)."""
    from dist_dqn_tpu_torch.telemetry import fleet

    name = f"learner-{os.getpid()}"
    agg = fleet.FleetAggregator(fleet_dir, scrape_timeout_s=10.0)
    agg.sweep_once()
    member = agg.status()["members"].get(name, {})
    samples = [ln for ln in agg.render_metrics().splitlines()
               if ln and not ln.startswith("#")
               and not ln.startswith("dqn_fleet_")]
    unlabeled = [ln for ln in samples
                 if f'process="{name}"' not in ln
                 or 'role="learner"' not in ln]
    res = {"member": {k: member.get(k) for k in (
               "state", "healthy", "labels", "role")},
           "members": sorted(agg.status()["members"]),
           "merged_samples": len(samples), "unlabeled": unlabeled[:5]}
    pane = fleet.FleetServer(agg)
    try:
        for tries in range(1, CAPTURE_TRIES + 1):
            if service._t_end is not None:
                break
            steps = service.grad_steps
            t0 = time.perf_counter()
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{pane.port}/fleet/profile?seconds=1",
                    timeout=120) as r:
                body = json.loads(r.read())
            entry = body["members"].get(name, {})
            got = (_count_trace_kernels(entry["trace_dir"])
                   if "trace_dir" in entry
                   else {"kernels": 0, "sample_kernels": 0})
            res["profile"] = {**got, "entry": entry, "tries": tries,
                              "wall_s": time.perf_counter() - t0,
                              "grad_steps_during": service.grad_steps
                              - steps}
            if got["sample_kernels"]:
                break
    finally:
        pane.close()
    return res


def check_watchdog_device_wait(directory: str) -> dict:
    """A stall inside a device wait: a stage with a DEVICE_WAIT_DEADLINE_S
    deadline beats, queues a ``torch.cuda._sleep`` spin of about
    DEVICE_WAIT_SPIN_S and waits in ``torch.cuda.synchronize()``. A
    poller thread holds that the watchdog's bundle lands while the wait is
    pending, that its ``stacks.txt`` names the waiting thread inside
    ``synchronize``, and that ``/healthz`` answers 503; after the wait the
    stage beats and ``/healthz`` returns to 200. No sampler launch."""
    import threading

    import torch

    from dist_dqn_tpu_torch import telemetry
    from dist_dqn_tpu_torch.telemetry import watchdog

    t_phase = time.perf_counter()
    bundles = os.path.join(directory, "forensics")
    # The spin's rate on this card: one short spin timed by events.
    torch.cuda._sleep(1_000)
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    probe = 50_000_000
    start.record()
    torch.cuda._sleep(probe)
    end.record()
    torch.cuda.synchronize()
    cycles = int(probe * DEVICE_WAIT_SPIN_S * 1e3 / start.elapsed_time(end))
    wd = watchdog.install_watchdog(
        forensics_dir=bundles, deadline_s=DEVICE_WAIT_DEADLINE_S,
        poll_s=0.1, log_fn=lambda line: print(line, flush=True))
    server = telemetry.start_server(0)
    url = f"http://127.0.0.1:{server.port}/healthz"
    seen = {}
    waiting = threading.Event()
    returned = threading.Event()

    def healthz():
        try:
            with urllib.request.urlopen(url, timeout=5) as r:
                return r.status
        except urllib.error.HTTPError as e:
            return e.code

    def poll():
        waiting.wait(30)
        while not returned.is_set():
            done = [b for b in _bundles(bundles)
                    if not b.endswith(".writing")]
            if done:
                seen["bundle_s"] = time.perf_counter() - seen["t_wait"]
                seen["pending_at_bundle"] = not returned.is_set()
                with open(os.path.join(bundles, done[0],
                                       "stacks.txt")) as f:
                    text = f.read()
                main = text.split("--- thread 'MainThread'", 1)[-1] \
                    .split("--- thread", 1)[0]
                seen["stacks_name_waiter"] = (
                    "--- thread 'MainThread'" in text
                    and "synchronize" in main)
                seen["healthz_during"] = healthz()
                seen["pending_at_healthz"] = not returned.is_set()
                return
            time.sleep(0.02)

    poller = threading.Thread(target=poll, daemon=True,
                              name="device-wait-poller")
    poller.start()
    hb = telemetry.heartbeat("device_wait.main")
    try:
        hb.beat()
        torch.cuda._sleep(cycles)
        seen["t_wait"] = time.perf_counter()
        waiting.set()
        torch.cuda.synchronize()
        seen["wait_s"] = time.perf_counter() - seen["t_wait"]
        returned.set()
        hb.beat()
        poller.join(timeout=10)
        deadline = time.perf_counter() + 5
        while healthz() != 200 and time.perf_counter() < deadline:
            time.sleep(0.05)
        seen["healthz_after"] = healthz()
        seen["recovered_s"] = time.perf_counter() - seen["t_wait"] \
            - seen["wait_s"]
    finally:
        returned.set()
        hb.close()
        server.close()
        seen.pop("t_wait", None)
        res = {"watchdog_device_wait": seen, "cycles": cycles,
               "bundles": _bundles(bundles),
               "bundle_errors": list(wd.bundle_errors),
               "phase_s": time.perf_counter() - t_phase}
        watchdog.uninstall_watchdog()
    print(json.dumps(res), flush=True)
    if not (seen.get("pending_at_bundle") and seen.get("stacks_name_waiter")
            and seen.get("healthz_during") == 503
            and seen.get("pending_at_healthz")
            and seen.get("healthz_after") == 200
            and len(res["bundles"]) == 1 and not res["bundle_errors"]
            and seen.get("wait_s", 0) > 2 * DEVICE_WAIT_DEADLINE_S):
        _fail(f"watchdog_device_wait: {res}")
    if res["phase_s"] > DEVICE_WAIT_MAX_S:
        _fail(f"watchdog_device_wait took {res['phase_s']:.1f} s, want <= "
              f"{DEVICE_WAIT_MAX_S}")
    return res


#: The service thread's parts as its spans name them (apex_service_pong's
#: path: zero-copy actors, actor priorities, staged batches).
SERVICE_SPAN_PARTS = {
    "drain": ("ingest.shm_record", "ingest.tcp_record"),
    "act": ("act.batched", "priority.actor_insert"),
    "bootstrap": ("priority.bootstrap.dispatch", "priority.bootstrap.insert"),
    "train": ("replay.sample", "h2d.stage", "train_step.dispatch",
              "replay.update_priorities"),
}
SERVICE_SPANS = {"act.batched", "priority.actor_insert", "replay.sample",
                 "h2d.stage", "train_step.dispatch",
                 "replay.update_priorities", "ingest.shm_record",
                 "replay_size", "env_steps"}


def _hold_service_chip_time(out: dict, trace_path: str, capture) -> dict:
    """apex_service_pong's chip-time plane and spans: the trace loads with
    the service's span names, the summary's ``programs`` (a census on
    the train step) and ``chip_time``, the /debug/profile capture's
    kernels (the sampler's printed), µs per span, and the thread's
    seconds by part from the spans beside the loop's own ``loop_s``."""
    with open(trace_path) as f:
        events = json.load(f)
    names = {e["name"] for e in events}
    sums = {}
    for e in events:
        if e.get("ph") == "X":
            sums[e["name"]] = sums.get(e["name"], 0.0) + e["dur"] / 1e6
    split = {part: sum(sums.get(n, 0.0) for n in spans)
             for part, spans in SERVICE_SPAN_PARTS.items()}
    run_s = out["run_s"]
    res = {"trace_events": len(events), "span_s": sums,
           "split_s": split,
           "split_share": {k: v / run_s for k, v in split.items()},
           "loop_s": out["loop_s"], "run_s": run_s,
           "programs": out["programs"], "chip_time": out["chip_time"],
           "capture": capture, "span_overhead": time_span_overhead()}
    print(json.dumps({"service_spans": "apex_service_pong", **res}),
          flush=True)
    if not SERVICE_SPANS <= names:
        _fail(f"apex_service_pong: trace lacks {SERVICE_SPANS - names}")
    train = (out["programs"] or {}).get("apex.train_step", {})
    if out["chip_time"] is None or not train.get("flops"):
        _fail(f"apex_service_pong: chip_time {out['chip_time']}, train "
              f"program {train}")
    # The capture on the server's thread holds the sampler kernel that
    # the service thread launched in its window.
    if capture is None or not capture["sample_kernels"]:
        _fail(f"apex_service_pong: /debug/profile capture {capture} holds "
              "no sampler kernel")
    return res


def _service_row(name: str, service, out: dict, launches: int,
                 **extra) -> dict:
    """The ``main_path`` line of one Ape-X service run: its rates, counts,
    loss counts, peak device memory and host RSS."""
    import torch

    t_fill = (out["run_s"] - out["train_s"]
              if out["train_s"] is not None else out["run_s"])
    return {"main_path": name, "device": torch.cuda.get_device_name(0),
            "env_steps": out["env_steps"], "grad_steps": out["grad_steps"],
            "sampler_launches": launches,
            "run_s": out["run_s"], "train_s": out["train_s"],
            "env_steps_per_sec": out["env_steps"] / out["run_s"],
            "fill_s": t_fill,
            "grad_steps_per_sec_training":
                (out["grad_steps"] / out["train_s"]
                 if out["train_s"] else None),
            **{k: out[k] for k in (
                "ingest_passes", "ingest_device_calls_per_pass",
                "device_calls", "ring_dropped", "ingest_torn_reads",
                "actor_restarts", "bad_records", "ingest_decode_errors",
                "hello_rejects", "tcp_corrupt_frames", "tcp_shed_records",
                "tcp_backpressure", "assembler", "transport",
                "actor_priorities", "replay_size", "records_by_actor",
                "ingest_bytes", "episodes_completed",
                "episode_return_recent", "loss")},
            "plane_shape": (
                list(service.replay.device_sampler.plane.shape)
                if getattr(service.replay, "device_sampler", None)
                is not None else None),
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            **_host_rss_gb(), **extra}


def _run_service(sampler, cfg, rt, service_hook=None, **service_kw):
    """Build the port's Ape-X service on the card and run it with the
    kernel's launch counter zeroed just before; returns (service, summary,
    launches). ``service_hook(service)`` runs between the two."""
    import torch

    from dist_dqn_tpu_torch.actors.service import ApexLearnerService

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    service = ApexLearnerService(cfg, rt, log_fn=lambda line: print(
        line, flush=True), device=DEVICE, **service_kw)
    if service_hook is not None:
        service_hook(service)
    sampler.kernel_stratified_sample.launches = 0
    out = service.run()
    return service, out, sampler.kernel_stratified_sample.launches


def _service_clean(name: str, out: dict) -> None:
    if out["ring_dropped"] or out["ingest_torn_reads"] \
            or out["bad_records"] or out["ingest_decode_errors"] \
            or out["actor_restarts"] or out["hello_rejects"] \
            or out["tcp_corrupt_frames"] or out["tcp_shed_records"]:
        _fail(f"{name}: dropped {out['ring_dropped']}, torn "
              f"{out['ingest_torn_reads']}, bad {out['bad_records']}, "
              f"undecodable {out['ingest_decode_errors']} records, "
              f"{out['actor_restarts']} actor restarts, "
              f"{out['hello_rejects']} rejected hellos, "
              f"{out['tcp_corrupt_frames']} corrupt and "
              f"{out['tcp_shed_records']} shed TCP frames")
    if not math.isfinite(out["loss"]):
        _fail(f"{name}: non-finite loss {out['loss']}")


def check_apex_service_r2d2_pong(sampler) -> int:
    """APEX_R2D2_PATH: R2D2 on the split at full width. Every insert must
    carry finite act-time sequence priorities, one per sequence; the plane
    (2,048 cells) draws through ``stratified_sample_rows``, so the kernel
    must not launch while each grad step draws once. Returns the
    launches (0)."""
    import numpy as np

    from dist_dqn_tpu_torch.actors.service import ApexRuntimeConfig
    from dist_dqn_tpu_torch.config import CONFIGS, apply_overrides

    preset, overrides, total = APEX_R2D2_PATH
    actors, lanes = APEX_R2D2_ACTORS
    cfg = apply_overrides(CONFIGS[preset], overrides)
    rt = ApexRuntimeConfig(host_env="pong", num_actors=actors,
                           envs_per_actor=lanes, total_env_steps=total,
                           device_sampling=True)
    inserts = []

    def hook(service):
        add = service.replay.add

        def recorded(items, priorities=None, shard=None):
            inserts.append((items["obs"].shape[:2],
                            None if priorities is None
                            else np.asarray(priorities)))
            add(items, priorities=priorities, shard=shard)
        service.replay.add = recorded

    service, out, launches = _run_service(sampler, cfg, rt, hook)
    seq_len = service.seq_len
    rows = sum(shape[0] for shape, _ in inserts)
    row = _service_row(
        "apex_service_r2d2_pong", service, out, launches,
        actors=actors, envs_per_actor=lanes, seq_len=seq_len,
        capacity_sequences=cfg.replay.capacity,
        sequences_inserted=rows,
        uses_kernel=service.replay.device_sampler.use_kernel,
        priorities_min=min((float(p.min()) for _, p in inserts
                            if p is not None), default=None),
        priorities_max=max((float(p.max()) for _, p in inserts
                            if p is not None), default=None))
    print(json.dumps(row), flush=True)
    del service
    _service_clean("apex_service_r2d2_pong", out)
    if out["grad_steps"] < APEX_R2D2_MIN_GRAD_STEPS:
        _fail(f"apex_service_r2d2_pong: {out['grad_steps']} grad steps, "
              f"want >= {APEX_R2D2_MIN_GRAD_STEPS}")
    if not inserts or min(rows, cfg.replay.capacity) != out["replay_size"] \
            or any(p is None or p.shape != (shape[0],)
                   or not np.isfinite(p).all() or shape[1] != seq_len
                   for shape, p in inserts):
        _fail(f"apex_service_r2d2_pong: {len(inserts)} inserts of "
              f"{rows} sequences, not each with finite act-time "
              f"priorities at length {seq_len}")
    if out["ingest_device_calls_per_pass"] != 1.0:
        _fail(f"apex_service_r2d2_pong: "
              f"{out['ingest_device_calls_per_pass']} act dispatches per "
              "ingest pass, want 1.0")
    if row["uses_kernel"] or launches != 0 \
            or out["device_calls"].get("replay_sample") != out["grad_steps"]:
        _fail(f"apex_service_r2d2_pong: {launches} kernel launches and "
              f"{out['device_calls'].get('replay_sample')} plane draws for "
              f"{out['grad_steps']} grad steps (want 0 and one each: the "
              "plane is under the kernel's crossover)")
    return launches


def check_apex_service_remote_bootstrap(sampler) -> int:
    """APEX_REMOTE_PATH: local and remote (TCP) actors feeding the
    learner-side bootstrap. Holds one sampler launch per grad step, the
    C++ assembler, bootstraps riding the fused act dispatches (a
    standalone one only at the final forced flush), one act dispatch per
    ingest pass, records from every remote id. Returns the launches."""
    from dist_dqn_tpu_torch.actors.service import ApexRuntimeConfig
    from dist_dqn_tpu_torch.config import CONFIGS, apply_overrides

    preset, overrides, total = APEX_REMOTE_PATH
    local, remote, lanes = APEX_REMOTE_ACTORS
    cfg = apply_overrides(CONFIGS[preset], overrides)
    rt = ApexRuntimeConfig(host_env="pong", num_actors=local,
                           num_remote_actors=remote, envs_per_actor=lanes,
                           total_env_steps=total, device_sampling=True,
                           actor_priorities=False,
                           spawn_remote_actors=True)
    service, out, launches = _run_service(sampler, cfg, rt)
    calls = out["device_calls"]
    act_calls = calls.get("act", 0) + calls.get("fused_act_bootstrap", 0)
    remote_ids = [str(i) for i in range(local, local + remote)]
    row = _service_row(
        "apex_service_remote_bootstrap", service, out, launches,
        local_actors=local, remote_actors=remote, envs_per_actor=lanes,
        act_dispatches_per_pass=act_calls / max(out["ingest_passes"], 1),
        tcp_address=list(service.tcp_address))
    print(json.dumps(row), flush=True)
    del service
    _service_clean("apex_service_remote_bootstrap", out)
    if out["grad_steps"] < APEX_REMOTE_MIN_GRAD_STEPS:
        _fail(f"apex_service_remote_bootstrap: {out['grad_steps']} grad "
              f"steps, want >= {APEX_REMOTE_MIN_GRAD_STEPS}")
    if launches != out["grad_steps"]:
        _fail(f"apex_service_remote_bootstrap: sampler kernel launched "
              f"{launches} times for {out['grad_steps']} grad steps")
    if out["assembler"] != "native":
        _fail(f"apex_service_remote_bootstrap: the {out['assembler']} "
              "assembler ran, want the native one")
    if calls.get("fused_act_bootstrap", 0) == 0 \
            or calls.get("bootstrap", 0) > 1:
        _fail(f"apex_service_remote_bootstrap: device calls {calls}: the "
              "bootstraps must ride the fused act dispatches")
    if act_calls != out["ingest_passes"]:
        _fail(f"apex_service_remote_bootstrap: {act_calls} act dispatches "
              f"in {out['ingest_passes']} ingest passes, want one each")
    if any(out["records_by_actor"].get(i, 0) == 0 for i in remote_ids):
        _fail(f"apex_service_remote_bootstrap: records by actor "
              f"{out['records_by_actor']}, want every remote id "
              f"{remote_ids}")
    return launches


def check_apex_service_snapshot_synthstack(sampler, directory: str) -> int:
    """APEX_SNAPSHOT_PATH: run 1 saves the learner and the replay shard;
    run 2 restores both. Holds the restored item count, the restored
    plane's mass bit for bit against the snapshot, run 2 training before
    it inserted ``min_fill`` items of its own, one sampler launch per
    grad step in both runs. Returns the launches of both."""
    import dataclasses

    import numpy as np

    from dist_dqn_tpu_torch.actors.service import ApexRuntimeConfig
    from dist_dqn_tpu_torch.config import CONFIGS, apply_overrides
    from dist_dqn_tpu_torch.envs.gym_adapter import is_pixel_env

    preset, overrides, first_total, second_total = APEX_SNAPSHOT_PATH
    actors, lanes = APEX_SNAPSHOT_ACTORS
    cfg = apply_overrides(CONFIGS[preset], overrides)
    assert not is_pixel_env("synthstack")
    # The MLP torso, as the train CLI swaps it in for a non-pixel host env.
    cfg = dataclasses.replace(cfg, network=dataclasses.replace(
        cfg.network, torso="mlp", compute_dtype="float32"))
    ckpt_dir = os.path.join(directory, "checkpoint")
    os.makedirs(ckpt_dir, exist_ok=True)
    rt = ApexRuntimeConfig(host_env="synthstack", num_actors=actors,
                           envs_per_actor=lanes, total_env_steps=first_total,
                           device_sampling=True, checkpoint_dir=ckpt_dir,
                           checkpoint_replay=True,
                           save_every_steps=first_total)
    service, first, launches1 = _run_service(sampler, cfg, rt)
    row1 = _service_row("apex_service_snapshot_synthstack_run1", service,
                        first, launches1)
    print(json.dumps(row1), flush=True)
    del service
    _service_clean("apex_service_snapshot_synthstack run 1", first)
    snapshot = os.path.join(ckpt_dir, "replay_shard.npz")
    with np.load(snapshot) as f:
        saved_mass = f["mass"].copy()
        saved_added = int(f["meta"][2])
    restored = {}

    def hook(service):
        sampler_ = service.replay.device_sampler
        sampler_._flush_writes()
        plane = sampler_.plane.reshape(-1)[:cfg.replay.capacity]
        restored["mass_equal"] = bool(np.array_equal(
            plane.cpu().numpy(), saved_mass.astype(np.float32)))
        restored["items"] = len(service.replay)
        train = service._train_to_target

        def first_train(*args, **kwargs):
            restored.setdefault("added_at_first_train",
                                service.replay.added)
            return train(*args, **kwargs)
        service._train_to_target = first_train

    service, second, launches2 = _run_service(
        sampler, cfg, dataclasses.replace(rt, total_env_steps=second_total),
        hook)
    new_at_first = restored.get("added_at_first_train", 0) - saved_added
    row2 = _service_row("apex_service_snapshot_synthstack", service, second,
                        launches2, run1=row1, snapshot_mb=os.path.getsize(
                            snapshot) / 2**20,
                        replay_snapshot=second["replay_snapshot"],
                        restored_plane_mass_equal=restored["mass_equal"],
                        inserted_before_first_train=new_at_first)
    print(json.dumps(row2), flush=True)
    del service
    _service_clean("apex_service_snapshot_synthstack run 2", second)
    snap = second["replay_snapshot"] or {}
    if snap.get("replay_snapshot_restored_items") != first["replay_size"] \
            or restored["items"] != first["replay_size"]:
        _fail(f"apex_service_snapshot_synthstack: restored {snap}, want "
              f"run 1's {first['replay_size']} items")
    if not restored["mass_equal"]:
        _fail("apex_service_snapshot_synthstack: the restored plane's mass "
              "differs from the snapshot's")
    if "added_at_first_train" not in restored \
            or new_at_first >= cfg.replay.min_fill:
        _fail(f"apex_service_snapshot_synthstack: run 2 inserted "
              f"{new_at_first} items before it trained (min_fill "
              f"{cfg.replay.min_fill}): it refilled instead of resuming "
              "warm")
    for n, (out, launches) in enumerate(((first, launches1),
                                         (second, launches2)), 1):
        if out["grad_steps"] == 0 or launches != out["grad_steps"]:
            _fail(f"apex_service_snapshot_synthstack: run {n} launched the "
                  f"sampler kernel {launches} times for "
                  f"{out['grad_steps']} grad steps")
    return launches1 + launches2


def _feeder_records(out: dict) -> dict:
    """Records and rates of a feeder run: records ingested, records and
    env steps per second of the whole run, records and host seconds per
    ingest pass, and the service thread's seconds by part of its loop:
    ``ingest_s_per_pass`` (ring drain, act and bootstrap with their
    inserts) over every pass, ``train_s_per_training_pass`` and
    ``train_s_per_grad_step`` (sample, gather, dispatch and the priority
    write-back) over the passes that trained."""
    records = sum(out["records_by_actor"].values())
    passes = max(out["ingest_passes"], 1)
    loop_s = out["loop_s"]
    ingest_s = loop_s["drain"] + loop_s["act"] + loop_s["bootstrap"]
    return {"records": records, "records_per_sec": records / out["run_s"],
            "env_steps_per_sec": out["env_steps"] / out["run_s"],
            "records_per_pass": records / passes,
            "seconds_per_pass": out["run_s"] / passes,
            "loop_s": loop_s, "train_passes": out["train_passes"],
            "ingest_s_per_pass": ingest_s / passes,
            "train_s_per_training_pass":
                loop_s["train"] / max(out["train_passes"], 1),
            "train_s_per_grad_step":
                loop_s["train"] / max(out["grad_steps"], 1),
            "train_share_of_loop": loop_s["train"] / max(
                sum(loop_s.values()), 1e-9)}


def check_apex_service_feeder_pixel(sampler, directory: str) -> int:
    """APEX_FEEDER_PATH with ``feeder:pixel`` on the zero-copy slot rings,
    APEX_FEEDER_SHM_BATCH records per slot publish, actor priorities from
    the pool's q planes and the plane [1954, 512] drawn through the
    sampler kernel. Holds at least APEX_FEEDER_PIXEL_MIN_GRAD_STEPS grad
    steps,
    one sampler launch per grad step, one act dispatch per ingest pass, no
    torn, bad or undecodable record and no restart, a finite loss; prints
    the record and env-step rates, grad steps/s in training, host RSS,
    peak device memory and the device's busy share over the first train
    event (torch.profiler); saves the learner at the end into
    ``directory/checkpoint``. Returns the launches."""
    from dist_dqn_tpu_torch.actors.service import ApexRuntimeConfig
    from dist_dqn_tpu_torch.config import CONFIGS, apply_overrides

    preset, overrides = APEX_FEEDER_PATH
    feeders, lanes = APEX_FEEDER_ACTORS
    cfg = apply_overrides(CONFIGS[preset], overrides)
    rt = ApexRuntimeConfig(host_env="feeder:pixel", num_actors=feeders,
                           envs_per_actor=lanes,
                           total_env_steps=APEX_FEEDER_PIXEL_TOTAL,
                           device_sampling=True, transport="zerocopy",
                           shm_batch=APEX_FEEDER_SHM_BATCH,
                           checkpoint_dir=os.path.join(directory,
                                                       "checkpoint"),
                           save_every_steps=APEX_FEEDER_PIXEL_TOTAL,
                           profile_dir=os.path.join(directory, "profile"))
    slots = {}
    service, out, launches = _run_service(
        sampler, cfg, rt, lambda svc: slots.update(
            bytes=svc._zc_rings[0].slot_size))
    name = "apex_service_feeder_pixel"
    profile = service.profile_row or {}
    row = _service_row(name, service, out, launches, feeders=feeders,
                       envs_per_actor=lanes, shm_batch=out["shm_batch"],
                       slot_bytes=slots["bytes"], **_feeder_records(out),
                       traced_train_event={k: profile.get(k) for k in (
                           "profile_wall_s", "device_busy_s",
                           "device_busy_share", "device_events")})
    print(json.dumps(row), flush=True)
    del service
    _service_clean(name, out)
    if out["grad_steps"] < APEX_FEEDER_PIXEL_MIN_GRAD_STEPS:
        _fail(f"{name}: {out['grad_steps']} grad steps, want >= "
              f"{APEX_FEEDER_PIXEL_MIN_GRAD_STEPS}")
    if launches != out["grad_steps"]:
        _fail(f"{name}: sampler kernel launched {launches} times for "
              f"{out['grad_steps']} grad steps")
    if row["plane_shape"] != [1954, 512]:
        _fail(f"{name}: plane {row['plane_shape']}, want [1954, 512]")
    if out["ingest_device_calls_per_pass"] != 1.0 \
            or not out["actor_priorities"]:
        _fail(f"{name}: {out['ingest_device_calls_per_pass']} act "
              "dispatches per ingest pass (want 1.0), actor priorities "
              f"{out['actor_priorities']}")
    return launches


def check_apex_service_feeder_legacy_tree(sampler) -> int:
    """APEX_FEEDER_PATH with ``feeder:pixel`` on the legacy wire (one
    record per publish into the shared request ring), the learner-side
    bootstrap over the C++ assembler, and draws from the host sum-tree,
    which must be the native one. Holds no kernel launch and one tree draw
    per grad step, the native assembler, the record checks of the pixel
    phase and at least APEX_FEEDER_LEGACY_MIN_GRAD_STEPS grad steps.
    Ring-full retries (``ring_dropped``: pushes the full request ring
    refused, and the feeder retried) are printed, not held. Returns the
    launches (0)."""
    from dist_dqn_tpu_torch.actors.service import ApexRuntimeConfig
    from dist_dqn_tpu_torch.config import CONFIGS, apply_overrides

    preset, overrides = APEX_FEEDER_PATH
    fill, total = APEX_FEEDER_LEGACY
    feeders, lanes = APEX_FEEDER_ACTORS
    cfg = apply_overrides(CONFIGS[preset],
                          [*overrides, f"replay.min_fill={fill}"])
    rt = ApexRuntimeConfig(host_env="feeder:pixel", num_actors=feeders,
                           envs_per_actor=lanes, total_env_steps=total,
                           transport="legacy", shm_batch=1)
    service, out, launches = _run_service(sampler, cfg, rt)
    name = "apex_service_feeder_legacy_tree"
    backend = type(service.replay.tree).__name__
    draws = service.replay.sampled // service.train_batch
    row = _service_row(name, service, out, launches, feeders=feeders,
                       envs_per_actor=lanes, tree_backend=backend,
                       tree_draws=draws,
                       ring_full_retries=out["ring_dropped"],
                       **_feeder_records(out))
    print(json.dumps(row), flush=True)
    del service
    # The request ring's refused pushes are the feeders' backpressure here,
    # retried and not lost: every other loss count is held at zero.
    _service_clean(name, {**out, "ring_dropped": 0})
    if backend != "NativeSumTree":
        _fail(f"{name}: the store draws from {backend}, want NativeSumTree")
    if out["grad_steps"] < APEX_FEEDER_LEGACY_MIN_GRAD_STEPS:
        _fail(f"{name}: {out['grad_steps']} grad steps, want >= "
              f"{APEX_FEEDER_LEGACY_MIN_GRAD_STEPS}")
    if launches != 0 or draws != out["grad_steps"]:
        _fail(f"{name}: {launches} kernel launches and {draws} tree draws "
              f"for {out['grad_steps']} grad steps (want 0 and one each)")
    if out["assembler"] != "native" or out["actor_priorities"]:
        _fail(f"{name}: the {out['assembler']} assembler with actor "
              f"priorities {out['actor_priorities']}, want the native one "
              "and the learner-side bootstrap")
    return launches


def check_evaluate_fake_ale(sampler, feeder_dir: str, directory: str) -> int:
    """The feeder phase's learner checkpoint (6 actions, as ale:Pong has)
    played with ``DQN_FAKE_ALE=1`` on the fake ALE's Pong: by the evaluate
    CLI (``--host-env ale:Pong``), which must return a finite return in
    [-21, 21], then by ``atari57 --mode eval --games Pong`` over a root
    holding it as ``Pong/``, which prints the HNS rollup from the shipped
    table. Greedy play draws from no replay, so the sampler kernel's
    count, zeroed just before the two calls, must read 0 after them;
    returns it."""
    import contextlib
    import io

    from dist_dqn_tpu_torch import atari57, evaluate

    preset, overrides = APEX_FEEDER_PATH
    ckpt = os.path.join(feeder_dir, "checkpoint")
    sets = [a for o in overrides for a in ("--set", o)]
    common = ["--config", preset, "--episodes", str(FAKE_ALE_EPISODES),
              "--device", DEVICE, *sets]
    root = os.path.join(directory, "atari57_root")
    os.makedirs(root, exist_ok=True)
    os.symlink(ckpt, os.path.join(root, "Pong"))
    before = os.environ.get("DQN_FAKE_ALE")
    os.environ["DQN_FAKE_ALE"] = "1"
    sampler.kernel_stratified_sample.launches = 0
    try:
        out = {}
        for tool, argv in (
                ("evaluate", ["--checkpoint-dir", ckpt, "--host-env",
                              "ale:Pong", *common]),
                ("atari57", ["--mode", "eval", "--games", "Pong",
                             "--checkpoint-root", root, *common])):
            text = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(text):
                (evaluate if tool == "evaluate" else atari57).main(argv)
            out[tool] = json.loads(text.getvalue().strip().splitlines()[-1])
            out[f"{tool}_s"] = time.perf_counter() - t0
    finally:
        if before is None:
            os.environ.pop("DQN_FAKE_ALE", None)
        else:
            os.environ["DQN_FAKE_ALE"] = before
    launches = sampler.kernel_stratified_sample.launches
    out["sampler_launches"] = launches
    print(json.dumps({"evaluate_fake_ale": out}), flush=True)
    if launches != 0:
        _fail(f"evaluate_fake_ale: the sampler kernel launched {launches} "
              "times in greedy play, want 0")
    ret = out["evaluate"].get("eval_return")
    if out["evaluate"].get("host_env") != "ale:Pong" or ret is None \
            or not math.isfinite(ret) or not -21.0 <= ret <= 21.0:
        _fail(f"evaluate_fake_ale: evaluate --host-env ale:Pong returned "
              f"{out['evaluate']}")
    hns = out["atari57"].get("hns", {})
    if out["atari57"].get("games_evaluated") != 1 \
            or "Pong" not in hns.get("per_game", {}) \
            or not math.isfinite(hns.get("median_hns", math.nan)):
        _fail(f"evaluate_fake_ale: atari57 --mode eval rolled up "
              f"{out['atari57']}")
    return launches


def check_host_replay_uniform_pair(sampler, profile_dir: str) -> int:
    """HOST_REPLAY_PAIR twice, uniform: pipelined and prefetched, then the
    serial ``--no-pipeline --no-prefetch`` reference. Their final params
    must be equal on the card (the JAX package's own pin); any stream or
    buffer fence that let a batch or a slice be read early breaks it. The
    pipelined leg traces its first training chunk (``profile_dir``) for
    the device's busy share. Returns the sampler launches (none:
    uniform)."""
    import torch

    from dist_dqn_tpu_torch.config import CONFIGS, apply_overrides

    preset, overrides, total, chunk_iters = HOST_REPLAY_PAIR
    cfg = apply_overrides(CONFIGS[preset], overrides)
    sampler.kernel_stratified_sample.launches = 0
    runs, logged = {}, []
    for name, options in (("pipelined", dict(profile_dir=profile_dir)),
                          ("serial", dict(pipeline=False, prefetch=False))):
        torch.cuda.empty_cache()
        out, wall = _drive_host_replay(cfg, total, chunk_iters,
                                       logged=logged, prioritized=False,
                                       **options)
        runs[name] = (out, wall)
    profile = [r for r in logged if "profile_trace" in r]
    (a, wall_a), (b, wall_b) = runs["pipelined"], runs["serial"]
    params_a = list(a["learner"].net.parameters())
    params_b = list(b["learner"].net.parameters())
    equal = all(torch.equal(x, y) for x, y in zip(params_a, params_b))
    launches = sampler.kernel_stratified_sample.launches
    row = {"main_path": "host_replay_uniform_pair",
           "wall_s": [wall_a, wall_b], "grad_steps": [a["grad_steps"],
                                                     b["grad_steps"]],
           "param_checksum": [a["param_checksum"], b["param_checksum"]],
           "params_equal": equal,
           "final_loss": [a["history"][-1].get("loss"),
                          b["history"][-1].get("loss")],
           "evac_fence_wait_s_total": [a["evac_fence_wait_s_total"],
                                       b["evac_fence_wait_s_total"]],
           "stale_batches": a["stale_batches"], "sampler_launches": launches,
           # The traced chunk (chunk 1, the first that trains) of the
           # pipelined leg.
           "profiled_chunk": {k: profile[0].get(k) for k in (
               "profile_wall_s", "device_busy_s", "device_busy_share",
               "device_events")} if profile else None,
           "profiled_chunk_row": a["history"][1]}
    print(json.dumps(row), flush=True)
    if not equal or a["grad_steps"] != b["grad_steps"] \
            or not a["grad_steps"]:
        _fail("host_replay_uniform_pair: the pipelined and serial runs end "
              f"with different params (or no grad steps): {row}")
    if launches:
        _fail(f"host_replay_uniform_pair: {launches} sampler launches on "
              "uniform runs")
    return launches


def _serving_ref(act, net, obs, bucket: int):
    """The act step at epsilon 0 on ``obs`` (numpy rows) zero-padded to
    ``bucket`` rows, as the batcher packs it; the first ``len(obs)``
    actions (numpy int32)."""
    import numpy as np
    import torch

    padded = np.zeros((bucket,) + obs.shape[1:], obs.dtype)
    padded[:len(obs)] = obs
    gen = torch.Generator(device=DEVICE)
    acts = act(net, torch.from_numpy(padded).to(DEVICE), gen,
               torch.zeros(bucket, device=DEVICE))
    return acts.cpu().numpy().astype(np.int32)[:len(obs)]


def _closed_loop(address: str, obs, clients: int, seconds: float,
                 registry) -> dict:
    """``clients`` threads, each on its own connection, sending ``obs``
    back to back for ``seconds``: requests/s, rows/s, the mean fan-in
    (requests per dispatch, from the registry's counters) and client-side
    latency percentiles (ms)."""
    import threading

    import numpy as np

    from dist_dqn_tpu_torch.serving import ServingClient
    from dist_dqn_tpu_torch.telemetry import collectors as tmc

    def count(name):
        return sum(i.value for i in registry.collect().get(name, []))

    lat, errors = [], []
    lock = threading.Lock()
    stop = threading.Event()
    barrier = threading.Barrier(clients + 1, timeout=60)

    def run():
        cl = ServingClient(address)
        mine = []
        try:
            barrier.wait()
            while not stop.is_set():
                t0 = time.perf_counter()
                cl.act(obs, greedy=True)
                mine.append(time.perf_counter() - t0)
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(f"{type(e).__name__}: {e}")
        finally:
            cl.close()
            with lock:
                lat.extend(mine)

    threads = [threading.Thread(target=run, name=f"serving-load-{i}",
                                daemon=False)
               for i in range(clients)]
    for t in threads:
        t.start()
    req0 = count(tmc.SERVING_REQUESTS)
    disp0 = count(tmc.SERVING_DISPATCHES)
    barrier.wait()
    t0 = time.perf_counter()
    time.sleep(seconds)
    stop.set()
    for t in threads:
        t.join(timeout=60)
    wall = time.perf_counter() - t0
    dispatches = count(tmc.SERVING_DISPATCHES) - disp0
    ms = np.asarray(lat) * 1e3
    return {"clients": clients, "requests": len(lat), "wall_s": wall,
            "requests_per_s": len(lat) / wall,
            "rows_per_s": len(lat) * len(obs) / wall,
            "mean_fanin_requests": (count(tmc.SERVING_REQUESTS) - req0)
            / max(dispatches, 1),
            "p50_ms": float(np.percentile(ms, 50)) if len(ms) else None,
            "p99_ms": float(np.percentile(ms, 99)) if len(ms) else None,
            "errors": errors[:3]}


def check_serving_apex(sampler, directory: str) -> int:
    """The serving tier (dist_dqn_tpu_torch/serving/) over an apex learner
    checkpoint at full width (Nature CNN, dueling, bf16, pixel_pong's 6
    actions, uint8 obs [84, 84, 4], max_rows 256). Holds: greedy served
    actions bit-equal to ``make_actor_step`` on the restored net at
    epsilon 0 on the same padded bucket (fan-in 1, fan-in 3 in one
    dispatch, a full bucket); rows whose action differs between bucket 4
    and bucket 256 have a top-2 gap within the bf16 torso's error; a hot
    reload under load serves one version per dispatch, never goes back,
    and serves the step-200 net's actions after the swap; 429 with
    Retry-After and no 5xx under overload; the CLI announces, answers,
    serves /healthz and /metrics and drains to rc 0 on SIGTERM. Prints
    the timings; no sampler launch (returns the count). Runs armed
    (:class:`_ArmedForensics`): the batcher's ``serving.batcher`` stage
    is swept with no stall, trip or bundle, and the CLI, given
    ``--forensics-dir`` and ``--fleet-dir``, is a ``serving`` member of
    the fleet while it serves and leaves none behind."""
    t_phase = time.perf_counter()
    armed = _ArmedForensics("serving_apex", directory)
    try:
        return _serving_apex(sampler, directory, armed, t_phase)
    finally:
        armed.close()


def _serving_apex(sampler, directory: str, armed, t_phase: float) -> int:
    """The body of :func:`check_serving_apex`, armed."""
    import dataclasses
    import http.client
    import itertools
    import signal
    import threading

    import numpy as np
    import torch

    from dist_dqn_tpu_torch.actors.act_dispatch import bucket_rows
    from dist_dqn_tpu_torch.actors.transport import encode_arrays
    from dist_dqn_tpu_torch.agents.dqn import make_actor_step, make_learner
    from dist_dqn_tpu_torch.config import CONFIGS
    from dist_dqn_tpu_torch.envs import make_env
    from dist_dqn_tpu_torch.evaluate import _restore_latest
    from dist_dqn_tpu_torch.models import build_network
    from dist_dqn_tpu_torch.serving import ServingClient, build_server
    from dist_dqn_tpu_torch.telemetry import get_registry
    from dist_dqn_tpu_torch.utils.checkpoint import TrainCheckpointer

    cfg = CONFIGS["apex"]
    env = make_env(cfg.env_name, device=DEVICE)
    shape, n_act = tuple(env.observation_shape), env.num_actions
    del env
    nets = [build_network(cfg.network, n_act, shape, device=DEVICE, seed=s)
            for s in SERVING_SEEDS]
    ckpt = TrainCheckpointer(directory)
    ckpt.save(100, make_learner(cfg.learner, nets[0])[0](nets[0]))
    _, net = _restore_latest(directory, build_network(
        cfg.network, n_act, shape, device=DEVICE, seed=99))
    act = make_actor_step(n_act)
    rng = np.random.default_rng(cfg.seed)
    obs = rng.integers(0, 256, (SERVING_MAX_ROWS,) + shape, dtype=np.uint8)
    registry = get_registry()
    quiet = lambda *_: None  # noqa: E731
    sampler.kernel_stratified_sample.launches = 0
    out = {"max_rows": SERVING_MAX_ROWS, "buckets": []}
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()

    # -- the greedy pin and the hot reload, on one server ----------------
    server = build_server(cfg, {"default": directory}, device=DEVICE,
                          max_rows=SERVING_MAX_ROWS,
                          max_wait_ms=SERVING_PIN_WAIT_MS,
                          poll_interval_s=0.1, log_fn=quiet)
    try:
        out["warmup_s_by_bucket"] = dict(server.batcher.warmup_s)
        out["buckets"] = sorted(server.batcher.warmup_s)
        cl = ServingClient(server.address)
        try:
            r1 = cl.act(obs[:5], greedy=True)
            rfull = cl.act(obs, greedy=True)
        finally:
            cl.close()
        pin = {"fanin1": bool(np.array_equal(
                   r1.actions, _serving_ref(act, net, obs[:5], 8))),
               "full": bool(np.array_equal(
                   rfull.actions,
                   _serving_ref(act, net, obs, SERVING_MAX_ROWS)))}
        clients = [ServingClient(server.address) for _ in range(3)]
        barrier = threading.Barrier(3, timeout=60)
        res = [None] * 3

        def one(i):
            barrier.wait()
            res[i] = clients[i].act(obs[i:i + 1], greedy=True)

        threads = [threading.Thread(target=one, args=(i,),
                                    name=f"serving-lockstep-{i}",
                                    daemon=False)
                   for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        for c in clients:
            c.close()
        served = [int(r.actions[0]) for r in res]
        refs = []
        for order in itertools.permutations(range(3)):
            a = _serving_ref(act, net, obs[list(order)], 4)
            refs.append([int(a[order.index(i)]) for i in range(3)])
        pin["fanin3"] = served in refs
        pin["fanin3_requests"] = max(r.fanin_requests for r in res)
        out["greedy_pin"] = pin
        if not (pin["fanin1"] and pin["full"] and pin["fanin3"]
                and pin["fanin3_requests"] == 3
                and r1.version == rfull.version == 1):
            _fail(f"serving_apex: served greedy actions differ from the "
                  f"act step on the same bucket: {pin}")

        # Across buckets: each row in buckets of 4 against the same row in
        # the bucket of 256, beside a float32 copy of the net.
        ref32 = build_network(dataclasses.replace(
            cfg.network, compute_dtype="float32"), n_act, shape,
            device=DEVICE)
        ref32.load_state_dict(net.state_dict())
        obs_t = torch.from_numpy(obs).to(DEVICE)
        with torch.no_grad():
            q256 = net.q_values(obs_t).float()
            q4 = torch.cat([net.q_values(obs_t[i:i + 4]).float()
                            for i in range(0, SERVING_MAX_ROWS, 4)])
            q32 = ref32.q_values(obs_t).float()
        differ = (q4.argmax(-1) != q256.argmax(-1)).cpu().numpy()
        top2 = torch.topk(q256, 2, dim=-1).values
        gap = (top2[:, 0] - top2[:, 1]).cpu().numpy()
        # check_outputs' rule for the bf16 torso: 0.05 of the Q scale per
        # forward, so two buckets' forwards may differ by twice that.
        scale = float(q32.abs().max().clamp(min=1e-3))
        bound = 2 * 0.05 * scale
        out["across_buckets"] = {
            "rows": SERVING_MAX_ROWS, "buckets": [4, SERVING_MAX_ROWS],
            "rows_action_differs": int(differ.sum()),
            "max_abs_dq": float((q4 - q256).abs().max()),
            "min_top2_gap_of_differing": (float(gap[differ].min())
                                          if differ.any() else None),
            "bf16_vs_f32_max_abs": float(max((q4 - q32).abs().max(),
                                             (q256 - q32).abs().max())),
            "gap_bound": bound, "bound_rule": "2 x 0.05 x max|Q_f32|"}
        if differ.any() and float(gap[differ].max()) > bound:
            _fail(f"serving_apex: a row's action differs across buckets "
                  f"with a top-2 gap past the bf16 bound: "
                  f"{out['across_buckets']}")

        # Hot reload under load: the same 3 rows from every client, where
        # the step-100 and step-200 nets disagree.
        n_clients, load_s, save_at = SERVING_RELOAD
        a1 = _serving_ref(act, nets[0], obs, SERVING_MAX_ROWS)
        a2 = _serving_ref(act, nets[1], obs, SERVING_MAX_ROWS)
        rows = np.nonzero(a1 != a2)[0][:3]
        if len(rows) < 3:
            _fail("serving_apex: the two nets agree on almost every row")
        probe = obs[rows]
        batcher = server.batcher
        real = batcher._dispatch_inner
        dispatches = []

        def spy(batch):
            real(batch)
            if all(p.result is not None for p in batch):
                dispatches.append(
                    ({p.result.version for p in batch}, len(batch),
                     np.concatenate([p.result.actions for p in batch])))

        batcher._dispatch_inner = spy
        seen, errors = {}, []
        stop = threading.Event()

        def hammer(i):
            c = ServingClient(server.address)
            try:
                while not stop.is_set():
                    r = c.act(probe, greedy=True)
                    seen.setdefault(i, []).append(
                        (r.version, r.step, time.perf_counter()))
            except Exception as e:  # noqa: BLE001 — reported below
                errors.append(f"{type(e).__name__}: {e}")
            finally:
                c.close()

        threads = [threading.Thread(target=hammer, args=(i,),
                                    name=f"serving-hammer-{i}",
                                    daemon=False)
                   for i in range(n_clients)]
        for t in threads:
            t.start()
        time.sleep(save_at)
        t_save = time.perf_counter()
        ckpt.save(200, make_learner(cfg.learner, nets[1])[0](nets[1]))
        t_saved = time.perf_counter()
        save_s = t_saved - t_save
        time.sleep(max(load_s - save_at - save_s, 0.5))
        stop.set()
        for t in threads:
            t.join(timeout=60)
        batcher._dispatch_inner = real
        versions = [v for rs in seen.values() for v, _, _ in rs]
        refs = {}
        wrong = 0
        for vs, k, acts in dispatches:
            if len(vs) != 1:
                continue
            (v,) = vs
            if (v, k) not in refs:
                refs[(v, k)] = _serving_ref(
                    act, nets[v - 1], np.concatenate([probe] * k),
                    bucket_rows(3 * k))
            wrong += int(not np.array_equal(acts, refs[(v, k)]))
        reload = {
            "requests": len(versions), "dispatches": len(dispatches),
            "mixed_dispatches": sum(len(vs) != 1 for vs, _, _ in dispatches),
            "versions": sorted(set(versions)),
            "went_back": sum(any(b[0] < a[0] for a, b in zip(rs, rs[1:]))
                             for rs in seen.values()),
            "dispatches_off_their_net": wrong,
            "v2_dispatches": sum(vs == {2} for vs, _, _ in dispatches),
            "mean_fanin_requests": (sum(k for _, k, _ in dispatches)
                                    / max(len(dispatches), 1)),
            "save_s": save_s,
            # From the save's return to the first response from step 200.
            "swap_s": min((t for rs in seen.values() for v, _, t in rs
                           if v == 2), default=math.inf) - t_saved,
            "errors": errors[:3]}
        out["hot_reload"] = reload
        if (errors or reload["mixed_dispatches"] or reload["went_back"]
                or wrong or reload["versions"] != [1, 2]
                or not reload["v2_dispatches"]
                or any(s != {1: 100, 2: 200}[v]
                       for rs in seen.values() for v, s, _ in rs)):
            _fail(f"serving_apex: hot reload under load: {reload}")
    finally:
        server.close()

    # -- the act step's device time per bucket -----------------------------
    gen = torch.Generator(device=DEVICE).manual_seed(cfg.seed)
    act_ms = {}
    for n in out["buckets"]:
        o = torch.zeros((n,) + shape, dtype=torch.uint8, device=DEVICE)
        e = torch.zeros(n, device=DEVICE)
        act_ms[n] = _eager_ms(lambda: act(net, o, gen, e),
                              SERVING_ACT_ITERS)
    out["act_ms_by_bucket"] = act_ms

    # -- shedding ----------------------------------------------------------
    limit, n_shed = SERVING_SHED
    server = build_server(cfg, {"default": directory}, device=DEVICE,
                          max_rows=SERVING_MAX_ROWS, max_wait_ms=400.0,
                          queue_limit=limit, poll_interval_s=3600.0,
                          log_fn=quiet)
    statuses, retry_after = [], []
    body = encode_arrays({"obs": obs[:1]}, meta={"greedy": True})
    barrier = threading.Barrier(n_shed, timeout=60)

    def shed_one():
        conn = http.client.HTTPConnection(server.host, server.port,
                                          timeout=60)
        try:
            barrier.wait()
            conn.request("POST", "/v1/act", body=body)
            resp = conn.getresponse()
            resp.read()
            statuses.append(resp.status)
            if resp.status == 429:
                retry_after.append(resp.getheader("Retry-After"))
        finally:
            conn.close()

    try:
        threads = [threading.Thread(target=shed_one,
                                    name=f"serving-shed-{k}", daemon=False)
                   for k in range(n_shed)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        server.close()
    out["shedding"] = {"queue_limit": limit, "clients": n_shed,
                       "ok": statuses.count(200), "shed": statuses.count(429),
                       "5xx": sum(s >= 500 for s in statuses),
                       "retry_after": sorted(set(retry_after))}
    if (len(statuses) != n_shed or not retry_after
            or not all(h and int(h) >= 1 for h in retry_after)
            or any(s not in (200, 429) for s in statuses)):
        _fail(f"serving_apex: shedding: {out['shedding']} ({statuses})")

    # -- timings at max_wait 2 ms: a lone request, then closed loops --------
    # The scrape's window: the lone requests and both closed loops.
    tm = _PhaseTelemetry("serving_apex", cfg)
    served = 0
    clients, seconds = SERVING_CLOSED_LOOP
    for batching in (True, False):
        server = build_server(cfg, {"default": directory}, device=DEVICE,
                              max_rows=SERVING_MAX_ROWS,
                              max_wait_ms=SERVING_WAIT_MS,
                              batching=batching, poll_interval_s=3600.0,
                              log_fn=quiet)
        try:
            if batching:
                cl = ServingClient(server.address)
                try:
                    lone = []
                    for _ in range(SERVING_LONE_REQUESTS):
                        t0 = time.perf_counter()
                        cl.act(obs[:1], greedy=True)
                        lone.append((time.perf_counter() - t0) * 1e3)
                finally:
                    cl.close()
                out["lone_request_ms"] = {
                    "requests": SERVING_LONE_REQUESTS,
                    "max_wait_ms": SERVING_WAIT_MS,
                    "p50": float(np.percentile(lone, 50)),
                    "p99": float(np.percentile(lone, 99))}
                served += SERVING_LONE_REQUESTS
            arm = _closed_loop(server.address, obs[:1], clients, seconds,
                               registry)
            served += arm["requests"]
            if batching:
                # /debug/profile on the telemetry server's thread while the
                # dispatch thread serves one more, untimed, closed loop.
                with ThreadPoolExecutor(1) as pool:
                    capture = pool.submit(_capture_profile, tm,
                                          SERVING_CAPTURE_DELAY_S)
                    served += _closed_loop(server.address, obs[:1], clients,
                                           SERVING_CAPTURE_LOOP_S,
                                           registry)["requests"]
                    out["profile_capture"] = capture.result(timeout=60)
        finally:
            server.close()
        out["closed_loop_batching" if batching
            else "closed_loop_no_batching"] = arm
        if arm["errors"] or not arm["requests"]:
            _fail(f"serving_apex: closed loop (batching={batching}): {arm}")
    key = "dqn_serving_requests_total{policy=default}"
    forensics = armed.hold(tm)
    if "serving.batcher" not in forensics["stages_swept"]:
        _fail(f"serving_apex: the batcher's heartbeat was never swept: "
              f"{forensics['stages_swept']}")
    scrape = tm.scrape()
    scrape.hold({key: (scrape.grew(key), served),
                 "dqn_program_dispatches_total{loop=serving,"
                 "program=serving.act}": (
                     scrape.grew("dqn_program_dispatches_total{loop=serving,"
                                 "program=serving.act}"),
                     scrape.grew("dqn_serving_dispatches_total"))})
    if not out["profile_capture"]["kernels"]:
        _fail(f"serving_apex: /debug/profile captured no CUDA kernel: "
              f"{out['profile_capture']}")
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    out["peak_device_gb"] = peak / 1e9
    # The servers' own share: the peak over what the phase's nets held.
    out["serving_peak_over_nets_gb"] = (peak - mem0) / 1e9

    # -- the CLI -------------------------------------------------------------
    t_cli = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "dist_dqn_tpu_torch.serving", "--config",
         "apex", "--checkpoint-dir", directory, "--port", "0",
         "--telemetry-port", "0", "--forensics-dir", armed.dir,
         "--fleet-dir", armed.fleet_dir],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    cli, lines = {}, []
    try:
        deadline = time.time() + 180
        while time.time() < deadline and "port" not in cli:
            line = proc.stdout.readline()
            if not line:
                break
            lines.append(line.rstrip())
            try:
                row = json.loads(line)
            except ValueError:
                continue
            if "serving_warmup_buckets" in row:
                cli["warmup"] = row
            if "telemetry_port" in row:
                cli["telemetry_port"] = row["telemetry_port"]
            if "serving_port" in row:
                cli["port"] = row["serving_port"]
                cli["announced_s"] = time.perf_counter() - t_cli
                cli["announced_step"] = row["policies"]["default"]["step"]
        if "port" not in cli:
            _fail(f"serving_apex: the CLI never announced its port: "
                  f"{lines[-20:]}")
        desc_path = os.path.join(armed.fleet_dir,
                                 f"serving-{proc.pid}.json")
        with open(desc_path) as f:
            desc = json.load(f)
        cli["fleet_descriptor"] = {k: desc[k] for k in ("role", "port")}
        c = ServingClient(f"127.0.0.1:{cli['port']}")
        try:
            r = c.act(obs[:2], greedy=True)
            cli["answered"] = r.actions.shape == (2,)
            cli["healthz"] = c.healthz()[0]
            status, text = c._get("/metrics")
        finally:
            c.close()
        # The CLI's own telemetry endpoint serves the same registry.
        with urllib.request.urlopen(
                f"http://127.0.0.1:{cli.get('telemetry_port')}/metrics",
                timeout=30) as r:
            cli["telemetry_endpoint_requests"] = [
                ln for ln in r.read().decode().splitlines()
                if ln.startswith("dqn_serving_requests_total")]
        samples = [ln for ln in text.decode().splitlines()
                   if ln and not ln.startswith("#")]
        for ln in samples:
            float(ln.rsplit(" ", 1)[1])       # every sample parses
        cli["metrics_status"] = status
        cli["metrics_samples"] = len(samples)
        cli["metrics_requests"] = [ln for ln in samples if ln.startswith(
            "dqn_serving_requests_total")]
    finally:
        proc.send_signal(signal.SIGTERM)
        try:
            rest, _ = proc.communicate(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            rest, _ = proc.communicate()
    cli["rc"] = proc.returncode
    tail = [json.loads(ln) for ln in rest.splitlines() if ln.startswith("{")]
    cli["drained"] = bool(tail) and tail[-1].get("serving_drained") is True
    cli["s"] = time.perf_counter() - t_cli
    cli["fleet_left"] = sorted(os.listdir(armed.fleet_dir))
    cli["bundles"] = _bundles(armed.dir)
    out["cli"] = cli
    if (cli["rc"] != 0 or not cli["drained"] or not cli["answered"]
            or cli["healthz"] != 200 or cli["metrics_status"] != 200
            or not cli["metrics_requests"]
            or cli["telemetry_endpoint_requests"]
            != ['dqn_serving_requests_total{policy="default"} 1']
            or cli["fleet_descriptor"] != {
                "role": "serving", "port": cli["telemetry_port"]}
            or cli["fleet_left"] or cli["bundles"]):
        _fail(f"serving_apex: the CLI: {cli} {rest[-2000:]}")

    launches = sampler.kernel_stratified_sample.launches
    out["sampler_launches"] = launches
    out["phase_s"] = time.perf_counter() - t_phase
    print(json.dumps({"serving_apex": out}), flush=True)
    if launches:
        _fail(f"serving_apex: {launches} sampler launches, want 0")
    return launches


class _Tee:
    """A stdout that keeps what it is given and passes it on."""

    def __init__(self, out):
        self.out, self.lines = out, []
        self._part = ""

    def write(self, text):
        self.out.write(text)
        self._part += text
        *done, self._part = self._part.split("\n")
        self.lines.extend(done)
        return len(text)

    def flush(self):
        self.out.flush()


def check_mesh_apex_nccl(sampler, directory: str) -> int:
    """MESH_NCCL_PATH through the CLI's ``main`` in this process
    (``--mesh-devices 0``), with a learner checkpoint at its end: the group
    must be NCCL of world size 1 on the card, every row rank 0's (one per
    chunk), one sampler launch per grad step, and the saved learner
    finite. Returns the launches."""
    import contextlib

    import torch

    from dist_dqn_tpu_torch import parallel
    from dist_dqn_tpu_torch.config import CONFIGS, apply_overrides
    from dist_dqn_tpu_torch.envs import make_env
    from dist_dqn_tpu_torch.models import build_network
    from dist_dqn_tpu_torch.train import main as train_main
    from dist_dqn_tpu_torch.utils.checkpoint import TrainCheckpointer

    name = "mesh_apex_nccl"
    preset, overrides, total, chunk_iters = MESH_NCCL_PATH
    cfg = apply_overrides(CONFIGS[preset], overrides)
    argv = ["--config", preset, "--mesh-devices", "0", "--total-env-steps",
            str(total), "--chunk-iters", str(chunk_iters),
            "--checkpoint-dir", directory,
            *(a for o in overrides for a in ("--set", o))]
    meshes = []
    real_make_mesh = parallel.make_mesh

    def make_mesh(*args, **kwargs):
        mesh = real_make_mesh(*args, **kwargs)
        meshes.append({"backend": mesh.backend, "size": mesh.size,
                       "rank": mesh.rank, "device": str(mesh.device)})
        return mesh

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    tee = _Tee(sys.stdout)
    parallel.make_mesh = make_mesh
    sampler.kernel_stratified_sample.launches = 0
    try:
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(tee):
            train_main(argv)
        wall = time.perf_counter() - t0
    finally:
        parallel.make_mesh = real_make_mesh
    launches = sampler.kernel_stratified_sample.launches
    rows = [json.loads(line) for line in tee.lines
            if line.startswith("{") and "env_frames" in line]
    grad_steps = int(sum(r["grad_steps_in_chunk"] for r in rows))
    env = make_env(cfg.env_name, device=DEVICE)
    net = build_network(cfg.network, env.num_actions, env.observation_shape,
                        device=DEVICE)
    restored = TrainCheckpointer(directory).restore_params(net)
    finite = restored is not None and all(
        bool(torch.isfinite(p).all()) for p in net.parameters())
    frames_per_chunk = chunk_iters * cfg.actor.num_envs
    chunks = -(-total // frames_per_chunk)
    row = {"main_path": name, "device": torch.cuda.get_device_name(0),
           "meshes": meshes, "wall_s": wall,
           "env_frames": [r["env_frames"] for r in rows],
           "grad_steps": grad_steps, "sampler_launches": launches,
           "grad_steps_per_sec_chunks": [r["grad_steps_per_sec"]
                                         for r in rows[1:]],
           "env_steps_per_sec_chunks": [r["env_steps_per_sec"]
                                        for r in rows[1:]],
           "losses": [r["loss"] for r in rows if r["grad_steps_in_chunk"]],
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "saved_learner_finite": finite,
           "saved_at_frames": restored[0] if restored else None}
    print(json.dumps(row), flush=True)
    if meshes != [{"backend": "nccl", "size": 1, "rank": 0,
                   "device": "cuda:0"}]:
        _fail(f"{name}: the mesh was {meshes}, not NCCL of one rank")
    if [r["env_frames"] for r in rows] != [
            frames_per_chunk * (i + 1) for i in range(chunks)]:
        _fail(f"{name}: rows {row['env_frames']} (want {chunks} chunks of "
              f"{frames_per_chunk} frames, rank 0's only)")
    if grad_steps <= 0 or launches != grad_steps:
        _fail(f"{name}: {launches} sampler launches for {grad_steps} grad "
              "steps")
    if not finite or not all(math.isfinite(x) for x in row["losses"]):
        _fail(f"{name}: non-finite loss or saved learner")
    return launches


def _mesh_rank(rank: int, address: str, jobs, out_dir: str) -> None:
    """One rank of the two-rank phases: join a gloo group on the card (both
    ranks on cuda:0), run each job and write its report."""
    import datetime

    import torch
    import torch.distributed as dist

    from dist_dqn_tpu_torch.parallel import distributed, make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(DEVICE, 0)
    torch.cuda.set_device(dev)
    # gloo, not NCCL: NCCL refuses two ranks on one card, and gloo carries
    # the two collectives the port uses (all_reduce, broadcast) on it.
    dist.init_process_group("gloo", init_method=f"tcp://{address}",
                            world_size=MESH_RANKS, rank=rank,
                            timeout=datetime.timedelta(seconds=300))
    try:
        mesh = make_mesh(device=dev)
        report = {}
        ref = None
        for job in jobs:
            if job == "mesh_host_replay_2rank":
                report[job] = _mesh_host_replay(mesh)
            elif job == "mesh_resume_r2d2_2rank":
                report[job] = _mesh_resume_r2d2(
                    mesh, ref, os.path.join(out_dir, "resume_r2d2"))
                ref = None
            else:
                keep = (job == "mesh_r2d2_2rank"
                        and "mesh_resume_r2d2_2rank" in jobs)
                report[job], ref = _mesh_train(mesh, job, keep)
            torch.cuda.empty_cache()
            if job == "mesh_apex_2rank":
                report["mesh_apex_sharded_step"] = _mesh_sharded_step(mesh)
        with open(os.path.join(out_dir, f"{rank}.json"), "w") as fh:
            json.dump(report, fh)
    finally:
        distributed.shutdown()


def _mesh_train(mesh, job: str, keep: bool = False):
    """MESH_2RANK_PATHS[job] through the mesh trainer on this rank, its
    sampler counter zeroed just before: rows, launches, peak memory,
    whether its learner equals rank 0's bit for bit, and the all-reduce's
    time at the gradient's size. Returns (report, the final carry's
    leaves when ``keep``, else None)."""
    import torch

    from dist_dqn_tpu_torch.config import CONFIGS, apply_overrides
    from dist_dqn_tpu_torch.envs import make_env
    from dist_dqn_tpu_torch.models import build_network
    from dist_dqn_tpu_torch.ops import sampler
    from dist_dqn_tpu_torch.parallel import (make_mesh_fused_train,
                                             make_mesh_r2d2_train)
    from dist_dqn_tpu_torch.parallel.learner import global_metrics

    preset, overrides, total, chunk_iters = MESH_2RANK_PATHS[job]
    cfg = apply_overrides(CONFIGS[preset], overrides)
    torch.cuda.reset_peak_memory_stats()
    env = make_env(cfg.env_name, device=mesh.device)
    net = build_network(cfg.network, env.num_actions, env.observation_shape,
                        device=mesh.device, seed=cfg.seed)
    make = (make_mesh_r2d2_train if cfg.network.lstm_size
            else make_mesh_fused_train)
    init, run = make(cfg, env, net, mesh)
    carry = init(cfg.seed)
    sampler.kernel_stratified_sample.launches = 0
    rows = []
    frames = 0
    torch.cuda.synchronize()
    t_run = time.perf_counter()
    while frames < total:
        t0 = time.perf_counter()
        carry, metrics = run(carry, chunk_iters)
        row = global_metrics({k: metrics[k] for k in (
            "episode_return", "episodes", "loss")})
        row.update(env_frames=metrics["env_frames"],
                   grad_steps_in_chunk=metrics["grad_steps_in_chunk"],
                   seconds=time.perf_counter() - t0)
        rows.append(row)
        frames = row["env_frames"]
    run_s = time.perf_counter() - t_run
    launches = sampler.kernel_stratified_sample.launches
    learner = carry.learner
    flat = torch.cat([p.detach().reshape(-1) for p in (
        *learner.net.parameters(), *learner.target_net.parameters())])
    rank0 = flat.clone()
    mesh.broadcast_([rank0])
    buf = torch.zeros(sum(p.numel() for p in learner.net.parameters()) + 3,
                      device=mesh.device)
    for _ in range(3):
        mesh.pmean([buf])
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(MESH_ALLREDUCE_ITERS):
        mesh.pmean([buf])
    end.record()
    end.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / MESH_ALLREDUCE_ITERS
    grad_steps = int(sum(r["grad_steps_in_chunk"] for r in rows))
    training = [r for r in rows if r["grad_steps_in_chunk"]]
    out = {
        "rank": mesh.rank, "backend": mesh.backend, "size": mesh.size,
        "lanes": cfg.actor.num_envs // mesh.size, "rows": rows,
        "grad_steps": grad_steps, "sampler_launches": launches,
        "steps": learner.steps, "run_s": run_s,
        "grad_steps_per_sec_training_chunks": [
            r["grad_steps_in_chunk"] / r["seconds"] for r in training],
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "learner_equals_rank0": bool(torch.equal(flat, rank0)),
        "params_finite": bool(torch.isfinite(flat).all()),
        "allreduce_floats": buf.numel(),
        "allreduce_ms": start.elapsed_time(end) / MESH_ALLREDUCE_ITERS,
        "allreduce_host_ms": host_ms,
        "iterations": carry.iteration}
    kept = _carry_leaves(carry) if keep else None
    del carry, learner, flat, rank0, buf
    return out, kept


def _carry_leaves(carry) -> list:
    """Every leaf of a carry's state tree, in walk order, tensors cloned on
    their device."""
    import torch

    from dist_dqn_tpu_torch.utils.checkpoint import state_tree, tree_leaves

    return [t.clone() if isinstance(t, torch.Tensor) else t
            for t in tree_leaves(state_tree(carry))]


def _mesh_resume_r2d2(mesh, ref, directory: str) -> dict:
    """mesh_r2d2_2rank through ``train()`` with ``checkpoint_replay``:
    killed right after its save at MESH_RESUME_AT frames, then
    relaunched to the path's end (its sampler counter zeroed just before
    the relaunch). Every leaf of this rank's resumed carry (learner,
    optimizer, ring, priorities, env state, LSTM carry, generators) must
    equal ``ref``, the uninterrupted mesh_r2d2_2rank carry."""
    import torch

    from dist_dqn_tpu_torch.config import CONFIGS, apply_overrides
    from dist_dqn_tpu_torch.ops import sampler
    from dist_dqn_tpu_torch.train import train

    # The tests' kill switch for a mesh run (it imports only the port).
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "tests"))
    from torch_mesh_workers import KillAfterSaves, Killed

    preset, overrides, total, chunk_iters = MESH_2RANK_PATHS[
        "mesh_r2d2_2rank"]
    cfg = apply_overrides(CONFIGS[preset], overrides)
    kw = dict(total_env_steps=total, chunk_iters=chunk_iters,
              checkpoint_dir=directory, checkpoint_replay=True,
              save_every_frames=MESH_RESUME_SAVE_EVERY)
    logged = []
    t0 = time.perf_counter()
    killed = False
    try:
        train(cfg, mesh=KillAfterSaves(mesh, 2), log_fn=logged.append,
              **kw)
    except Killed:
        killed = True
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    sampler.kernel_stratified_sample.launches = 0
    carry, history = train(cfg, mesh=mesh, log_fn=logged.append, **kw)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = sampler.kernel_stratified_sample.launches
    got = _carry_leaves(carry)
    differ = [i for i, (a, b) in enumerate(zip(ref, got))
              if not (torch.equal(a, b) if isinstance(a, torch.Tensor)
                      else a == b)]
    rows = [json.loads(x) for x in logged if x.startswith("{")]
    return {"rank": mesh.rank, "killed": killed,
            "killed_run_s": t1 - t0, "resumed_run_s": t2 - t1,
            "logged": rows, "leaves": len(got),
            "leaves_equal": len(got) == len(ref) and not differ,
            "differing_leaves": differ[:8],
            "resumed_frames": [r["env_frames"] for r in history],
            "grad_steps": int(sum(r["grad_steps_in_chunk"]
                                  for r in history)),
            "sampler_launches": launches,
            "shard_files": sorted(os.listdir(os.path.join(
                directory, f"rank{mesh.rank}")))
            if mesh.rank else None}


def _mesh_host_replay(mesh) -> dict:
    """MESH_HOST_REPLAY_PATH through ``run_host_replay`` as this rank of
    the mesh (pipelined, prefetched, PER on this rank's device plane), its
    sampler counter zeroed just before: launches, grad steps, the rows'
    global columns, per-shard bytes, whether its learner equals rank 0's,
    rates, evacuation columns, host RSS before and after the run (and the
    process's peak) and peak device memory."""
    import torch

    from dist_dqn_tpu_torch.config import CONFIGS, apply_overrides
    from dist_dqn_tpu_torch.host_replay_loop import run_host_replay
    from dist_dqn_tpu_torch.ops import sampler

    preset, overrides, total, chunk_iters = MESH_HOST_REPLAY_PATH
    cfg = apply_overrides(CONFIGS[preset], overrides)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    rss_before = _host_rss_gb()["host_rss_gb"]
    sampler.kernel_stratified_sample.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = run_host_replay(cfg, total_env_steps=total,
                          chunk_iters=chunk_iters,
                          log_fn=lambda line: print(line, flush=True),
                          mesh=mesh, mesh_devices=mesh.size,
                          prioritized=True, device_sampling=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = sampler.kernel_stratified_sample.launches
    learner = out.pop("learner")
    flat = torch.cat([p.detach().reshape(-1) for p in (
        *learner.net.parameters(), *learner.target_net.parameters())])
    rank0 = flat.clone()
    mesh.broadcast_([rank0])
    history = out["history"]
    losses = [r["loss"] for r in history if "loss" in r]
    report = {
        "rank": mesh.rank, "backend": mesh.backend, "size": mesh.size,
        "lanes": out["collect_lane_block"], "wall_s": wall,
        "env_steps": out["env_steps"], "chunks": len(history),
        "chunk_iters": chunk_iters, "grad_steps": out["grad_steps"],
        "stale_batches": out["stale_batches"], "sampler_launches": launches,
        "plane_shape": [-(-(cfg.replay.capacity // cfg.actor.num_envs
                            * out["collect_lane_block"]) // 512), 512],
        "rows_per_rank": out["train_batch"] // mesh.size,
        "global_rows": [{k: r[k] for k in MESH_GLOBAL_ROW_KEYS if k in r}
                        for r in history],
        "d2h_bytes_by_shard": out["d2h_bytes_by_shard"],
        "ring_bytes_by_shard": out["ring_bytes_by_shard"],
        "d2h_bytes_total": out["d2h_bytes_total"],
        "losses": losses,
        "learner_equals_rank0": bool(torch.equal(flat, rank0)),
        "params_finite": bool(torch.isfinite(flat).all()),
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "host_rss_before_gb": rss_before, **_host_rss_gb(),
        "ring_gb": out["ring_gb"],
        "env_steps_per_sec_chunks": [r["env_steps_per_sec"]
                                     for r in history[1:]],
        "grad_steps_per_sec_training": [
            (r["grad_steps"] - p["grad_steps"]) / r["chunk_train_s"]
            for p, r in zip(history, history[1:]) if "loss" in r],
        **{k: [r[k] for r in history] for k in (
            "evac_s", "evac_fence_wait_s", "evac_overlap_frac",
            "chip_busy_s", "prefetch_wait_s", "sample_s")},
        "evac_fence_wait_s_total": out["evac_fence_wait_s_total"],
        "chip_time": out["chip_time"],
        "summary_grad_steps_per_sec": out["grad_steps_per_sec"],
        "summary_env_steps_per_sec": out["env_steps_per_sec"]}
    del learner, flat, rank0
    return report


def _mesh_sharded_step(mesh) -> dict:
    """One apex learner step on 512 rows whole, and the same step as 2 x
    256 through the group, from the same weights and batch (drawn from a
    seed, equal on both ranks). The gradient each optimizer is handed (on
    the sharded side, the all-reduced mean) is held against the whole
    batch's by the relative norm of their difference; so are two controls
    that must fail the bound: this rank's own 256-row gradient (a step
    without the all-reduce, or on half the batch) and the all-reduced sum
    without the divide. Also |dloss|, |dparam|, |dpriority| and whether
    every number is finite."""
    import torch

    from dist_dqn_tpu_torch.agents.dqn import ClipAdam, make_learner
    from dist_dqn_tpu_torch.config import CONFIGS
    from dist_dqn_tpu_torch.models import build_network
    from dist_dqn_tpu_torch.parallel.learner import (make_sharded_train_step,
                                                     train_step_specs)
    from dist_dqn_tpu_torch.types import Transition

    class GradRecorder(ClipAdam):
        """The optimizer, keeping the flat gradient its step is handed."""
        grad = None

        def step(self, params, grads, state):
            self.grad = torch.cat([g.detach().float().reshape(-1)
                                   for g in grads])
            return super().step(params, grads, state)

    cfg = CONFIGS["apex"]
    dev = mesh.device
    rows = cfg.learner.batch_size
    shape = (84, 84, 4)
    gen = torch.Generator(device=dev).manual_seed(5)

    def frames():
        return torch.randint(0, 256, (rows, *shape), generator=gen,
                             device=dev, dtype=torch.uint8)

    batch = Transition(
        obs=frames(),
        action=torch.randint(0, 6, (rows,), generator=gen, device=dev),
        reward=torch.rand(rows, generator=gen, device=dev) * 2 - 1,
        discount=(torch.rand(rows, generator=gen, device=dev) < 0.9).float()
        * cfg.learner.gamma ** cfg.learner.n_step,
        next_obs=frames())
    weights = torch.rand(rows, generator=gen, device=dev) * 0.8 + 0.2

    def learner(axis=None):
        net = build_network(cfg.network, 6, shape, device=dev, seed=11)
        tx = GradRecorder(cfg.learner)
        init, step = make_learner(cfg.learner, net, tx=tx, axis=axis)
        return tx, init(net), step

    tx_whole, state, step = learner()
    whole, m_whole = step(state, batch, weights)
    tx_part, state, step = learner(mesh)
    # devtime: a test fixture, held against the whole-batch step.
    sharded = make_sharded_train_step(step, mesh, *train_step_specs())
    part, m_part = sharded(state, batch, weights)
    tx_local, state, step = learner()
    block = mesh.rows(rows // mesh.size)
    step(state, Transition(*(f[block] for f in batch)), weights[block])
    g = tx_whole.grad

    def rel_err(x):
        return float((x - g).norm() / g.norm())

    # bf16 keeps 8 significant bits: four roundings of 2^-8 (one in the
    # forward and one in the backward on each side).
    bound = 4 * 2.0 ** -8
    loss = float(m_whole["loss"])
    finite = all(bool(torch.isfinite(t).all()) for t in (
        g, tx_part.grad, m_whole["loss"], m_part["loss"],
        *part.net.parameters()))
    return {"rows": rows, "rows_per_rank": rows // mesh.size,
            "grad_rel_err": rel_err(tx_part.grad),
            "grad_bound": bound,
            "bound_rule": "|g_sharded - g_whole| / |g_whole| and |dloss| / "
                          "|loss| <= 4 x 2^-8 (bf16 roundings)",
            "control_local_rel_err": rel_err(tx_local.grad),
            "control_sum_rel_err": rel_err(tx_part.grad * mesh.size),
            "max_abs_dgrad": float((tx_part.grad - g).abs().max()),
            "grad_norm_whole": float(g.norm()),
            "loss_whole": loss, "loss_sharded": float(m_part["loss"]),
            "max_abs_dloss": abs(float(m_part["loss"]) - loss),
            "loss_bound": bound * abs(loss),
            "max_abs_dparam": max(float((a - b).detach().abs().max())
                                  for a, b in zip(whole.net.parameters(),
                                                  part.net.parameters())),
            "max_abs_dpriority": float((m_whole["priorities"]
                                        - m_part["priorities"]).abs().max()),
            "finite": finite}


def check_mesh_2rank(phases) -> dict:
    """The two-rank phases in ``phases``, in one spawned group of two ranks
    on this card; each rank's report printed and held. Returns the sampler
    launches of each phase (summed over the ranks)."""
    import torch

    from dist_dqn_tpu_torch.parallel import distributed

    jobs = [p for p in MESH_2RANK_PHASES if p in phases
            or (p == "mesh_r2d2_2rank" and "mesh_resume_r2d2_2rank" in phases)]
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mesh_") as out:
        distributed.spawn(_mesh_rank, (
            f"127.0.0.1:{distributed.free_port()}", jobs, out), MESH_RANKS,
            deadline_s=MESH_DEADLINE_S)
        ranks = []
        for r in range(MESH_RANKS):
            with open(os.path.join(out, f"{r}.json")) as fh:
                ranks.append(json.load(fh))
    wall = time.perf_counter() - t0
    launches = {}
    for job in jobs:
        reports = [rk[job] for rk in ranks]
        if job == "mesh_host_replay_2rank":
            launches[job] = _hold_mesh_host_replay(reports, wall)
            continue
        if job == "mesh_resume_r2d2_2rank":
            launches[job] = _hold_mesh_resume(reports, wall)
            continue
        chunk_iters = MESH_2RANK_PATHS[job][3]
        print(json.dumps({"main_path": job,
                          "device": torch.cuda.get_device_name(0),
                          "spawn_wall_s": wall, "ranks": reports}),
              flush=True)
        launches[job] = sum(r["sampler_launches"] for r in reports)
        for r in reports:
            lanes_total = r["lanes"] * r["size"]
            if r["backend"] != "gloo" or r["size"] != MESH_RANKS:
                _fail(f"{job}: rank {r['rank']} in a {r['backend']} group "
                      f"of {r['size']}")
            if not r["learner_equals_rank0"] or not r["params_finite"]:
                _fail(f"{job}: rank {r['rank']}'s learner differs from "
                      "rank 0's or is not finite")
            frames = [x["env_frames"] for x in r["rows"]]
            if frames != [chunk_iters * lanes_total * (i + 1)
                          for i in range(len(frames))] or \
                    frames[-1] != r["iterations"] * lanes_total:
                _fail(f"{job}: env_frames {frames} are not iterations x "
                      f"{lanes_total}")
            if r["grad_steps"] <= 0 or r["sampler_launches"] != \
                    r["grad_steps"] or r["steps"] != r["grad_steps"]:
                _fail(f"{job}: rank {r['rank']} launched the sampler "
                      f"{r['sampler_launches']} times for {r['grad_steps']} "
                      "grad steps")
            if not all(math.isfinite(x["loss"]) for x in r["rows"]):
                _fail(f"{job}: non-finite loss on rank {r['rank']}")
        same = [[{k: v for k, v in x.items() if k != "seconds"}
                 for x in r["rows"]] for r in reports]
        if same[0] != same[1]:
            _fail(f"{job}: the ranks report different global metrics")
        if job == "mesh_apex_2rank":
            steps = [rk["mesh_apex_sharded_step"] for rk in ranks]
            print(json.dumps({"mesh_apex_sharded_step": steps}), flush=True)
            for st in steps:
                # Written so that a NaN fails.
                if not (st["finite"] and st["grad_rel_err"] <= st[
                        "grad_bound"] and st["max_abs_dloss"] <= st[
                        "loss_bound"]):
                    _fail(f"mesh_apex_sharded_step: the sharded gradient is "
                          f"off the whole batch's by {st['grad_rel_err']} "
                          f"(bound {st['grad_bound']}), |dloss| "
                          f"{st['max_abs_dloss']} (bound {st['loss_bound']}),"
                          f" or a value is not finite")
                if not (st["control_local_rel_err"] > st["grad_bound"] and
                        st["control_sum_rel_err"] > st["grad_bound"]):
                    _fail(f"mesh_apex_sharded_step: a control passes the "
                          f"gradient bound {st['grad_bound']}: {st}")
    return launches


def _hold_mesh_host_replay(reports, wall: float) -> int:
    """mesh_host_replay_2rank's holds: on each rank one sampler launch per
    grad step (plus the stale batches' draws), a learner bit-equal to rank
    0's, env_frames = iterations x 16, the per-shard bytes summing to the
    total and equal to the bytes each ring appended, finite losses; the
    same global row columns on both ranks. Returns the launches."""
    import torch

    job = "mesh_host_replay_2rank"
    print(json.dumps({"main_path": job,
                      "device": torch.cuda.get_device_name(0),
                      "spawn_wall_s": wall, "ranks": reports}), flush=True)
    launches = sum(r["sampler_launches"] for r in reports)
    for r in reports:
        lanes_total = r["lanes"] * r["size"]
        frames = [x["env_frames"] for x in r["global_rows"]]
        if r["backend"] != "gloo" or r["size"] != MESH_RANKS:
            _fail(f"{job}: rank {r['rank']} in a {r['backend']} group of "
                  f"{r['size']}")
        if not r["learner_equals_rank0"] or not r["params_finite"]:
            _fail(f"{job}: rank {r['rank']}'s learner differs from rank "
                  "0's or is not finite")
        if frames != [r["chunk_iters"] * lanes_total * (i + 1)
                      for i in range(r["chunks"])] or \
                r["env_steps"] != r["chunks"] * r["chunk_iters"] \
                * lanes_total:
            _fail(f"{job}: env_frames {frames} are not iterations x "
                  f"{lanes_total}")
        if r["grad_steps"] < MESH_HOST_REPLAY_MIN_GRAD_STEPS or \
                r["sampler_launches"] < r["grad_steps"]:
            _fail(f"{job}: rank {r['rank']} took {r['grad_steps']} grad "
                  f"steps with {r['sampler_launches']} sampler launches")
        if sum(r["d2h_bytes_by_shard"]) != r["d2h_bytes_total"] or \
                r["d2h_bytes_by_shard"] != r["ring_bytes_by_shard"]:
            _fail(f"{job}: per-shard bytes {r['d2h_bytes_by_shard']} "
                  f"(rings {r['ring_bytes_by_shard']}) against the total "
                  f"{r['d2h_bytes_total']}")
        if not r["losses"] or not all(math.isfinite(x)
                                      for x in r["losses"]):
            _fail(f"{job}: non-finite loss on rank {r['rank']}")
    r0 = reports[0]
    if launches != MESH_RANKS * r0["grad_steps"] + r0["stale_batches"]:
        _fail(f"{job}: {launches} sampler launches on the ranks for "
              f"{r0['grad_steps']} grad steps each and "
              f"{r0['stale_batches']} stale batches")
    if reports[0]["global_rows"] != reports[1]["global_rows"]:
        _fail(f"{job}: the ranks report different global rows")
    return launches


def _hold_mesh_resume(reports, wall: float) -> int:
    """mesh_resume_r2d2_2rank's holds: both ranks killed after the save,
    the relaunch resumed at it on rank 0 (logged there alone), every leaf
    of each rank's carry equal to the uninterrupted run's, one sampler
    launch per grad step of the resumed leg, rank 1's shard files."""
    import torch

    job = "mesh_resume_r2d2_2rank"
    print(json.dumps({"main_path": job,
                      "device": torch.cuda.get_device_name(0),
                      "spawn_wall_s": wall, "ranks": reports}), flush=True)
    total = MESH_2RANK_PATHS["mesh_r2d2_2rank"][2]
    resumed = [x for x in reports[0]["logged"] if "resumed_at_frames" in x]
    if resumed != [{"resumed_at_frames": MESH_RESUME_AT,
                    "with_replay": True}] or reports[1]["logged"]:
        _fail(f"{job}: rank 0 logged {resumed}, rank 1 "
              f"{reports[1]['logged'][:3]}")
    for r in reports:
        if not r["killed"] or not r["leaves_equal"]:
            _fail(f"{job}: rank {r['rank']} killed={r['killed']}, carry "
                  f"leaves differing from the uninterrupted run: "
                  f"{r['differing_leaves']}")
        if r["resumed_frames"] != [total] or r["grad_steps"] <= 0 or \
                r["sampler_launches"] != r["grad_steps"]:
            _fail(f"{job}: rank {r['rank']} resumed to "
                  f"{r['resumed_frames']} with {r['grad_steps']} grad steps "
                  f"and {r['sampler_launches']} sampler launches")
    if reports[1]["shard_files"] != sorted(
            f"{f}.pt" for f in (400, MESH_RESUME_AT, total)):
        _fail(f"{job}: rank 1's carry shards {reports[1]['shard_files']}")
    return sum(r["sampler_launches"] for r in reports)


def check_sharded_store_device(sampler) -> int:
    """SHARDED_STORE on the card: ``ShardedPrioritizedReplay(2, 1M,
    sampler="device")`` filled with integer priorities, then draws of S =
    512 with the kernel launch counter zeroed just before. Each draw must
    launch the kernel once per shard that takes rows (each plane is
    [977, 512]) and pick exactly the cells the plain version picks at the
    same uniforms (max abs err 0 over the slot ids), and the items
    must be those slots'. Then 1,000 fresh inserts overwrite shard 0's
    oldest slots and a write-back of the last draw's rows lands under the
    generation guard: overwritten slots keep their insert's mass, live
    ones take the written one (the last draw's rows and 500 overwritten
    slots). Returns the launches."""
    import copy

    import numpy as np
    import torch

    from dist_dqn_tpu_torch.replay.host import stratified_mass
    from dist_dqn_tpu_torch.replay.sharded import (ShardedPrioritizedReplay,
                                                   _map_mass_to_shards)

    shards, capacity, S, draws = SHARDED_STORE
    t0 = time.perf_counter()
    store = ShardedPrioritizedReplay(shards, capacity, alpha=1.0,
                                     priority_eps=0.0, seed=3,
                                     sampler="device")
    cap = store.shard_capacity
    rng = np.random.default_rng(0)
    for s in range(shards):
        for lo in range(0, cap, 100_000):
            ids = np.arange(s * cap + lo, s * cap + lo + 100_000)
            store.add({"id": ids.astype(np.int64)},
                      priorities=rng.integers(1, 9, ids.shape[0])
                      .astype(np.float64), shard=s)
    store.sample(S, beta=0.4)          # lands the fill's writes
    torch.cuda.synchronize()
    t_fill = time.perf_counter() - t0
    planes = [x.device_sampler for x in store.shards]
    sampler.kernel_stratified_sample.launches = 0
    dispatched = store.device_sample_dispatches
    expected = 0
    err = 0
    draw_s = []
    for _ in range(draws):
        before = copy.deepcopy(store._rng)
        totals = np.array([p.total for p in planes], np.float64)
        t1 = time.perf_counter()
        items, idx, w = store.sample(S, beta=0.4)
        draw_s.append(time.perf_counter() - t1)
        mass = stratified_mass(before, S, float(totals.sum()))
        shard_of, local = _map_mass_to_shards(mass, totals)
        for s, plane in enumerate(planes):
            rows = shard_of == s
            if not rows.any():
                continue
            expected += 1
            u = torch.as_tensor(np.asarray(local[rows] / totals[s],
                                           np.float32),
                                device=plane.plane.device)
            t, b, m, _ = sampler.plain_stratified_sample(plane.plane, u)
            ref = (t.long() * plane.lanes + b.long()).cpu().numpy()
            err = max(err, int(np.abs(idx[rows] - s * cap - ref).max()))
        if not np.array_equal(items["id"], idx):
            _fail("sharded_store_device: the gathered items are not the "
                  "drawn slots'")
    launches = sampler.kernel_stratified_sample.launches
    dispatches = store.device_sample_dispatches - dispatched
    # The generation guard: overwrite shard 0's oldest slots, then write
    # back the last draw's rows and half the overwritten slots, with the
    # generations read before the overwrite.
    back = np.concatenate([idx, np.arange(SHARDED_STORE_OVERWRITE // 2)])
    gens = store.generation(back)
    fresh = rng.integers(1, 9, SHARDED_STORE_OVERWRITE).astype(np.float64)
    store.add({"id": np.full(SHARDED_STORE_OVERWRITE, -1, np.int64)},
              priorities=fresh, shard=0)
    written = rng.integers(1, 9, back.shape[0]).astype(np.float64)
    store.update_priorities(back, written, expected_gen=gens)
    want = {}
    for slot, p in zip(back, written):
        s, local_slot = divmod(int(slot), cap)
        live = not (s == 0 and local_slot < SHARDED_STORE_OVERWRITE)
        want[(s, local_slot)] = p if live else fresh[local_slot]
    for p in planes:
        p._flush_writes()
    got = {k: float(planes[k[0]].plane.reshape(-1)[k[1]]) for k in want}
    guard_ok = all(got[k] == float(v) for k, v in want.items())
    row = {"main_path": "sharded_store_device",
           "device": torch.cuda.get_device_name(0), "shards": shards,
           "capacity": capacity, "plane_shape": list(planes[0].plane.shape),
           "rows_per_draw": S, "draws": draws, "sampler_launches": launches,
           "expected_launches": expected, "dispatches": dispatches,
           "max_abs_err": err, "fill_s": t_fill,
           "draw_ms": [x * 1e3 for x in draw_s],
           "guard_rows": len(want),
           "guard_overwritten": sum(1 for s, l in want
                                    if s == 0 and
                                    l < SHARDED_STORE_OVERWRITE),
           "guard_ok": guard_ok,
           "weights_max": float(w.max())}
    print(json.dumps(row), flush=True)
    if launches != expected or dispatches != expected or err != 0:
        _fail(f"sharded_store_device: {launches} kernel launches and "
              f"{dispatches} dispatches for {expected} shard draws, max "
              f"abs err {err} against the plain version")
    if not guard_ok:
        _fail("sharded_store_device: a write-back landed on an overwritten "
              "slot, or a live one kept its old mass")
    return launches


# --------------------------------------------------------------------------
# The Ape-X service's distributed paths (ROADMAP.md A6c).
# --------------------------------------------------------------------------

def _hold_service(name: str, out: dict, launches: int, min_grad_steps: int
                  ) -> None:
    _service_clean(name, out)
    if out["grad_steps"] < min_grad_steps:
        _fail(f"{name}: {out['grad_steps']} grad steps, want >= "
              f"{min_grad_steps}")
    if out["ingest_device_calls_per_pass"] != 1.0:
        _fail(f"{name}: {out['ingest_device_calls_per_pass']} act "
              "dispatches per ingest pass, want 1.0")


def _apex_dist_rt(**kw):
    from dist_dqn_tpu_torch.actors.service import ApexRuntimeConfig

    actors, lanes = APEX_DIST_ACTORS
    return ApexRuntimeConfig(host_env="pong", num_actors=actors,
                             envs_per_actor=lanes,
                             total_env_steps=APEX_DIST_PATH[2], **kw)


def check_apex_service_shards_pong(sampler) -> int:
    """APEX_DIST_PATH with ``ingest_shards=2`` and ``device_sampling``: two
    item shards of 500,000 transitions, each drawing on its own plane
    ``[977, 512]`` through the kernel. Holds: both shards got records and
    inserts, the inserts by shard sum to the store's, the kernel's
    launches equal the store's plane dispatches and the service's
    ``replay_sample`` calls, the dispatches are a multiple of the two
    shards (each draw takes rows from both), and each shard plane's draw
    at explicit uniforms picks exactly the plain version's cells (max abs
    err 0). Returns the launches."""
    import numpy as np
    import torch

    from dist_dqn_tpu_torch.config import CONFIGS, apply_overrides

    name = "apex_service_shards_pong"
    preset, overrides, _ = APEX_DIST_PATH
    cfg = apply_overrides(CONFIGS[preset], overrides)
    t0 = time.perf_counter()
    service, out, launches = _run_service(
        sampler, cfg, _apex_dist_rt(device_sampling=True,
                                    ingest_shards=APEX_SHARDS))
    store = service.replay
    dispatches = store.device_sample_dispatches
    planes = [s.device_sampler for s in store.shards]
    # Each shard plane's draw at explicit uniforms, kernel against the plain
    # version (these launches come after the count was read).
    rng = np.random.default_rng(1)
    err = 0
    for p in planes:
        S = cfg.learner.batch_size // APEX_SHARDS
        u = torch.as_tensor(np.sort(rng.random(S)).astype(np.float32),
                            device=p.plane.device)
        t_k, b_k, m_k, _ = sampler.kernel_stratified_sample(p.plane, u)
        t_p, b_p, m_p, _ = sampler.plain_stratified_sample(p.plane, u)
        got = t_k.long() * p.lanes + b_k.long()
        want = t_p.long() * p.lanes + b_p.long()
        err = max(err, int((got - want).abs().max()),
                  float((m_k - m_p).abs().max()))
    added = {int(k): v for k, v in out["replay_added_by_shard"].items()}
    row = _service_row(name, service, out, launches,
                       shards=APEX_SHARDS,
                       plane_shapes=[list(p.plane.shape) for p in planes],
                       records_by_shard=out["records_by_shard"],
                       replay_added_by_shard=added,
                       store_added=store.added,
                       plane_dispatches=dispatches,
                       replay_sample_calls=out["device_calls"].get(
                           "replay_sample", 0),
                       max_abs_err=err,
                       phase_s=time.perf_counter() - t0)
    del service, store, planes
    print(json.dumps(row), flush=True)
    _hold_service(name, out, launches, APEX_DIST_MIN_GRAD_STEPS)
    if sorted(added) != list(range(APEX_SHARDS)) or min(added.values()) <= 0 \
            or len(out["records_by_shard"]) != APEX_SHARDS:
        _fail(f"{name}: records {out['records_by_shard']}, inserts {added}: "
              "a shard got nothing")
    if sum(added.values()) != row["store_added"]:
        _fail(f"{name}: inserts by shard {added} do not sum to the store's "
              f"{row['store_added']}")
    if launches != dispatches or dispatches != row["replay_sample_calls"] \
            or dispatches % APEX_SHARDS or launches < out["grad_steps"]:
        _fail(f"{name}: {launches} kernel launches, {dispatches} plane "
              f"dispatches, {row['replay_sample_calls']} replay_sample "
              f"calls for {out['grad_steps']} grad steps")
    if err != 0:
        _fail(f"{name}: a shard plane's kernel draw is off the plain "
              f"version's by {err}")
    return launches


def check_apex_service_shard_sampling_pong(sampler) -> int:
    """APEX_DIST_PATH with ``ingest_shards=2`` and ``shard_sampling``: the
    host trees, drawn and gathered by one worker thread per shard. Holds:
    at least one pre-packed batch per grad step (up to ``pipeline_depth``
    more drawn ahead), both shards fed, no kernel launch. Returns the
    launches (0)."""
    from dist_dqn_tpu_torch.config import CONFIGS, apply_overrides

    name = "apex_service_shard_sampling_pong"
    preset, overrides, _ = APEX_DIST_PATH
    cfg = apply_overrides(CONFIGS[preset], overrides)
    t0 = time.perf_counter()
    service, out, launches = _run_service(
        sampler, cfg, _apex_dist_rt(ingest_shards=APEX_SHARDS,
                                    shard_sampling=True))
    row = _service_row(name, service, out, launches,
                       shard_sampling=out["shard_sampling"],
                       shard_sample_batches=out["shard_sample_batches"],
                       records_by_shard=out["records_by_shard"],
                       replay_added_by_shard=out["replay_added_by_shard"],
                       loop_s=out["loop_s"],
                       phase_s=time.perf_counter() - t0)
    del service
    print(json.dumps(row), flush=True)
    _hold_service(name, out, launches, APEX_DIST_MIN_GRAD_STEPS)
    if not out["shard_sampling"] \
            or out["shard_sample_batches"] < out["grad_steps"] \
            or len(out["replay_added_by_shard"]) != APEX_SHARDS:
        _fail(f"{name}: {out['shard_sample_batches']} pre-packed batches "
              f"for {out['grad_steps']} grad steps, inserts "
              f"{out['replay_added_by_shard']}")
    if launches:
        _fail(f"{name}: {launches} kernel launches on the host trees")
    return launches


def _learner_ranks_grad_check(service) -> dict:
    """One train event of the service's learner ranks (2 x 256 rows) on a
    seeded batch of 512, before its run, against one learner on the whole
    batch from the same weights: the gradient the optimizer is handed (the
    all-reduced mean on the ranks) within 4 x 2^-8 of the whole batch's by
    relative norm, two controls failing that bound (rank 0's own 256-row
    gradient, the all-reduced sum without the divide), and the priorities
    in global row order (within the bound; with the rank blocks swapped,
    off it)."""
    import copy

    import torch

    from dist_dqn_tpu_torch.agents.dqn import ClipAdam, make_learner
    from dist_dqn_tpu_torch.types import Transition

    cfg = service.cfg
    dev = service.device
    rows = cfg.learner.batch_size
    half = rows // 2
    gen = torch.Generator(device=dev).manual_seed(5)
    shape = (84, 84, 4)             # pixel pong's stacked frames

    def frames():
        return torch.randint(0, 256, (rows, *shape), generator=gen,
                             device=dev, dtype=torch.uint8)

    batch = Transition(
        obs=frames(),
        action=torch.randint(0, service.num_actions, (rows,), generator=gen,
                             device=dev),
        reward=torch.rand(rows, generator=gen, device=dev) * 2 - 1,
        discount=(torch.rand(rows, generator=gen, device=dev) < 0.9).float()
        * cfg.learner.gamma ** cfg.learner.n_step,
        next_obs=frames())
    weights = torch.rand(rows, generator=gen, device=dev) * 0.8 + 0.2
    weights_before = copy.deepcopy(service.state.net.state_dict())
    grads = []
    real_step = ClipAdam.step

    def recording_step(self, params, g, state):
        grads.append(torch.cat([x.detach().float().reshape(-1) for x in g]))
        return real_step(self, params, g, state)

    ClipAdam.step = recording_step
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        service.state, m = service._learners.train(
            service.state, (Transition(*(x[None] for x in batch)),
                            weights[None]), scan=True)
        prios = m["priorities"].reshape(-1).float()
        torch.cuda.synchronize()
        event_ms = (time.perf_counter() - t0) * 1e3

        def solo(block):
            net = copy.deepcopy(service.net)
            net.load_state_dict(weights_before)
            init, step = make_learner(cfg.learner, net)
            state = init(net, torch.Generator(device=dev).manual_seed(0))
            _, mm = step(state, Transition(*(x[block] for x in batch)),
                         weights[block])
            return mm

        m_whole = solo(slice(0, rows))
        solo(slice(0, half))
    finally:
        ClipAdam.step = real_step
    g_part, g_whole, g_local = grads

    def rel(x, ref):
        return float((x - ref).norm() / ref.norm())

    p_whole = m_whole["priorities"].float()
    swapped = torch.cat([prios[half:], prios[:half]])
    bound = 4 * 2.0 ** -8
    return {"rows": rows, "rows_per_rank": half,
            "event_ms_host": event_ms,
            "grad_rel_err": rel(g_part, g_whole), "grad_bound": bound,
            "control_local_rel_err": rel(g_local, g_whole),
            "control_sum_rel_err": rel(g_part * 2, g_whole),
            "priority_rel_err": rel(prios, p_whole),
            "control_swapped_priority_rel_err": rel(swapped, p_whole),
            "finite": bool(torch.isfinite(g_part).all()
                           and torch.isfinite(prios).all())}


def check_apex_service_learners_2rank(sampler) -> int:
    """APEX_DIST_PATH with ``learner_devices=2`` as two ``gloo`` ranks on
    this card (``learner_backend="gloo"``): the service leads one learner
    rank; every train event broadcasts the 512-row batch and each rank
    trains on 256 rows. Before the run, one event on a seeded batch is held
    against the whole batch's step (:func:`_learner_ranks_grad_check`).
    Holds: bit-equal replicas at the end, one sampler launch per grad step
    on the 1M plane ``[1954, 512]``, the gradient and priority bounds and
    both controls failing. Returns the launches."""
    from dist_dqn_tpu_torch.config import CONFIGS, apply_overrides

    name = "apex_service_learners_2rank"
    preset, overrides, _ = APEX_DIST_PATH
    cfg = apply_overrides(CONFIGS[preset], overrides)
    check = {}
    t0 = time.perf_counter()
    service, out, launches = _run_service(
        sampler, cfg, _apex_dist_rt(device_sampling=True, learner_devices=2),
        service_hook=lambda s: check.update(_learner_ranks_grad_check(s)),
        learner_backend="gloo")
    row = _service_row(name, service, out, launches,
                       learner_devices=out["learner_devices"],
                       learner_replicas_equal=out["learner_replicas_equal"],
                       grad_check=check, phase_s=time.perf_counter() - t0)
    del service
    print(json.dumps(row), flush=True)
    _hold_service(name, out, launches, APEX_DIST_MIN_GRAD_STEPS)
    if out["learner_devices"] != 2 or out["learner_replicas_equal"] is not True:
        _fail(f"{name}: {out['learner_devices']} learner ranks, replicas "
              f"equal: {out['learner_replicas_equal']}")
    if launches != out["grad_steps"]:
        _fail(f"{name}: {launches} sampler launches for {out['grad_steps']} "
              "grad steps")
    bound = check["grad_bound"]
    # Written so that a NaN fails.
    if not (check["finite"] and check["grad_rel_err"] <= bound
            and check["priority_rel_err"] <= bound):
        _fail(f"{name}: the ranks' gradient or priorities are off the whole "
              f"batch's: {check}")
    if not (check["control_local_rel_err"] > bound
            and check["control_sum_rel_err"] > bound
            and check["control_swapped_priority_rel_err"] > bound):
        _fail(f"{name}: a control passes the bound {bound}: {check}")
    return launches


def _allreduce_ms(mesh, numel: int) -> dict:
    """Device and host ms of one gradient-sized all-reduce over the group
    (every rank calls it)."""
    import torch

    buf = torch.zeros(numel, device=mesh.device)
    for _ in range(3):
        mesh.pmean([buf])
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(MESH_ALLREDUCE_ITERS):
        mesh.pmean([buf])
    end.record()
    end.synchronize()
    return {"allreduce_floats": numel,
            "allreduce_ms": start.elapsed_time(end) / MESH_ALLREDUCE_ITERS,
            "allreduce_host_ms": (time.perf_counter() - t0) * 1e3
            / MESH_ALLREDUCE_ITERS}


def _multihost_rank(rank: int, address: str, out_dir: str) -> None:
    """One of the two service processes of apex_service_multihost_2proc:
    join a gloo group on this card, run the service (which finds the group
    and trains collectively), time a gradient-sized all-reduce, write the
    report."""
    import datetime

    import torch
    import torch.distributed as dist

    from dist_dqn_tpu_torch.actors.service import (ApexLearnerService,
                                                   ApexRuntimeConfig)
    from dist_dqn_tpu_torch.config import CONFIGS, apply_overrides
    from dist_dqn_tpu_torch.ops import sampler
    from dist_dqn_tpu_torch.parallel import distributed

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(DEVICE, 0)
    torch.cuda.set_device(dev)
    dist.init_process_group("gloo", init_method=f"tcp://{address}",
                            world_size=MESH_RANKS, rank=rank,
                            timeout=datetime.timedelta(seconds=300))
    try:
        preset, overrides, total = MULTIHOST_PATH
        actors, lanes = MULTIHOST_ACTORS
        every, episodes = MULTIHOST_EVAL
        cfg = apply_overrides(CONFIGS[preset], overrides)
        rt = ApexRuntimeConfig(host_env="pong", num_actors=actors,
                               envs_per_actor=lanes, total_env_steps=total,
                               device_sampling=True, eval_every_steps=every,
                               eval_episodes=episodes)
        lines = []

        def log(line):
            lines.append(line)
            print(f"[process {rank}] {line}", flush=True)

        torch.cuda.reset_peak_memory_stats()
        service = ApexLearnerService(cfg, rt, log_fn=log, device=dev)
        sampler.kernel_stratified_sample.launches = 0
        out = service.run()
        launches = sampler.kernel_stratified_sample.launches
        rows = [json.loads(x) for x in lines if x.startswith("{")]
        report = {
            "rank": rank, "backend": service._mh.mesh.backend,
            "size": service._mh.mesh.size,
            "sampler_launches": launches,
            "plane_draws": service.replay.device_sampler.draw_dispatches,
            "plane_shape": list(service.replay.device_sampler.plane.shape),
            "local_batch": service._local_batch,
            "rate_rows": sum("env_steps_per_sec_per_chip" in r
                             for r in rows),
            "eval_returns": [r["eval_return"] for r in rows
                             if "eval_return" in r],
            "eval_episodes_truncated": [r["eval_episodes_truncated"]
                                        for r in rows
                                        if "eval_episodes_truncated" in r],
            "grad_steps_per_sec_training": (out["grad_steps"]
                                            / out["train_s"]
                                            if out["train_s"] else None),
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            **_host_rss_gb(),
            **{k: out[k] for k in (
                "env_steps", "grad_steps", "global_env_steps",
                "learner_replicas_equal", "run_s", "train_s", "loss",
                "device_calls", "ingest_device_calls_per_pass",
                "ring_dropped", "ingest_torn_reads", "bad_records",
                "ingest_decode_errors", "actor_restarts", "hello_rejects",
                "tcp_corrupt_frames", "tcp_shed_records", "replay_size")},
            **_allreduce_ms(service._mh.mesh, sum(
                p.numel() for p in service.state.net.parameters()) + 3)}
        del service
        with open(os.path.join(out_dir, f"{rank}.json"), "w") as fh:
            json.dump(report, fh)
    finally:
        distributed.shutdown()


def check_apex_service_multihost_2proc(sampler) -> int:
    """MULTIHOST_PATH: two service processes in one ``gloo`` group on this
    card (NCCL refuses two ranks on one card, so the group is built here,
    as the two-rank mesh phases build theirs), each with its own 4 x 8
    actors and 1M store whose plane ``[1954, 512]`` draws its 256 rows
    through the kernel; they agree on the counters and train in lockstep.
    Rank 0 evaluates in a thread. Holds: equal grad steps, the global
    cursor at the total, no rate rows on process 1, ``eval_return`` on
    process 0 only, bit-equal learners, each process's launches equal to
    its plane draws and grad steps. Then the CLI's ``--coordinator`` path
    at world size 1 over NCCL (:func:`_coordinator_nccl`). Returns the
    launches of both processes and of the CLI run."""
    import torch

    from dist_dqn_tpu_torch.parallel import distributed

    name = "apex_service_multihost_2proc"
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mh_") as out:
        distributed.spawn(_multihost_rank, (
            f"127.0.0.1:{distributed.free_port()}", out), MESH_RANKS,
            deadline_s=MESH_DEADLINE_S)
        reports = []
        for r in range(MESH_RANKS):
            with open(os.path.join(out, f"{r}.json")) as fh:
                reports.append(json.load(fh))
    wall = time.perf_counter() - t0
    cli = _coordinator_nccl(sampler)
    print(json.dumps({"main_path": name,
                      "device": torch.cuda.get_device_name(0),
                      "spawn_wall_s": wall, "processes": reports,
                      "coordinator_nccl": cli}), flush=True)
    total = MULTIHOST_PATH[2]
    grads = {r["grad_steps"] for r in reports}
    if len(grads) != 1 or min(grads) < MULTIHOST_MIN_GRAD_STEPS:
        _fail(f"{name}: grad steps {[r['grad_steps'] for r in reports]}, "
              f"want equal and >= {MULTIHOST_MIN_GRAD_STEPS}")
    for r in reports:
        _service_clean(f"{name} process {r['rank']}", r)
        if r["backend"] != "gloo" or r["size"] != MESH_RANKS \
                or r["global_env_steps"] < total \
                or r["global_env_steps"] != reports[0]["global_env_steps"]:
            _fail(f"{name}: process {r['rank']} in a {r['backend']} group "
                  f"of {r['size']}, global env steps "
                  f"{r['global_env_steps']} (want >= {total}, equal)")
        if r["learner_replicas_equal"] is not True:
            _fail(f"{name}: process {r['rank']}'s learner differs from "
                  "rank 0's")
        if r["sampler_launches"] != r["plane_draws"] \
                or r["sampler_launches"] != r["grad_steps"]:
            _fail(f"{name}: process {r['rank']} launched the kernel "
                  f"{r['sampler_launches']} times for {r['plane_draws']} "
                  f"plane draws and {r['grad_steps']} grad steps")
    if reports[1]["rate_rows"] or reports[1]["eval_returns"] \
            or not reports[0]["eval_returns"]:
        _fail(f"{name}: process 1 printed {reports[1]['rate_rows']} rows "
              f"and evals {reports[1]['eval_returns']}; process 0 evals "
              f"{reports[0]['eval_returns']}")
    if not all(math.isfinite(x) for r in reports for x in r["eval_returns"]):
        _fail(f"{name}: a non-finite eval return")
    return sum(r["sampler_launches"] for r in reports) + cli["launches"]


def _coordinator_nccl(sampler) -> dict:
    """``python -m dist_dqn_tpu_torch.train --runtime apex --coordinator
    127.0.0.1:P --num-processes 1 --process-id 0`` (its ``main``, in this
    process) at COORDINATOR_PATH: the group must be NCCL of world size 1
    (one process is one host, so the service trains alone), the run must
    train with one kernel launch per grad step and leave the group."""
    import contextlib

    import torch
    import torch.distributed as dist

    from dist_dqn_tpu_torch.parallel import distributed
    from dist_dqn_tpu_torch.train import main as train_main

    preset, overrides, total = COORDINATOR_PATH
    actors, lanes = MULTIHOST_ACTORS
    argv = ["--config", preset, "--runtime", "apex", "--host-env", "pong",
            "--device-sampling", "--num-actors", str(actors),
            "--envs-per-actor", str(lanes), "--total-env-steps", str(total),
            "--coordinator", f"127.0.0.1:{distributed.free_port()}",
            "--num-processes", "1", "--process-id", "0",
            *(a for o in overrides for a in ("--set", o))]
    groups = []
    real = distributed.initialize

    def initialize(*args, **kwargs):
        dev = real(*args, **kwargs)
        groups.append({"backend": dist.get_backend(),
                       "size": dist.get_world_size(), "device": str(dev)})
        return dev

    tee = _Tee(sys.stdout)
    distributed.initialize = initialize
    sampler.kernel_stratified_sample.launches = 0
    try:
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(tee):
            train_main(argv)
        wall = time.perf_counter() - t0
    finally:
        distributed.initialize = real
    launches = sampler.kernel_stratified_sample.launches
    summary = json.loads([x for x in tee.lines
                          if x.startswith('{"env_steps"')][-1])
    out = {"groups": groups, "left_group": not dist.is_initialized(),
           "wall_s": wall, "launches": launches,
           **{k: summary[k] for k in ("env_steps", "grad_steps", "loss",
                                      "global_env_steps")}}
    if groups != [{"backend": "nccl", "size": 1, "device": "cuda:0"}] \
            or not out["left_group"]:
        _fail(f"apex_service_multihost_2proc: the CLI's group was {groups}, "
              f"left: {out['left_group']}")
    if summary["grad_steps"] <= 0 or launches != summary["grad_steps"] \
            or not math.isfinite(summary["loss"]):
        _fail(f"apex_service_multihost_2proc: the CLI run took "
              f"{summary['grad_steps']} grad steps with {launches} launches, "
              f"loss {summary['loss']}")
    return out


# The chaos phase: the chaos plane (chaos/), the sizing gate
# (utils/sizing.py) and the device cleanup (utils/device_cleanup.py) on
# the card. The host plane of apex's 1M slots, [1954, 512], S = 512 per
# draw: an injected exception at the first draw, a 0.05 s stall at the
# third, CHAOS_DRAWS draws after the exception.
CHAOS_PLANE = (1_000_000, 512, 512)
CHAOS_DRAWS = 20
# The host-replay runs under the seeded chaos smoke's plan (evac.drain and
# prefetch.sample stalls, a commit-without-stamp save, a torn LATEST):
# apex_dedup's widths (Nature CNN, bf16, batch 512, 16 lanes, a dedup
# ring), uniform, in HOST_REPLAY_PAIR's chunks of 25 iterations (400
# frames), filled at 800, 3,200 frames (200 grad steps), with the ring cut
# to 16,384 slots so each sidecar (the ring window, 0.12 GB) stays small;
# a save every other chunk, as that smoke saves (four saves: the
# crash, a stamp, the torn stamp, the stamp that recovers it). The
# evacuation stall is devtime's chaos case's 0.8 s at the second drain,
# which the ledger must file under evac_fence (at least 0.4 s of it): a
# save in the same body would quiesce the evacuation first and take the
# wait itself.
CHAOS_HOST_REPLAY = ("apex", ["replay.frame_dedup=true",
                              "replay.min_fill=800",
                              "replay.capacity=16384",
                              "eval_every_steps=0"], 3_200, 25)
CHAOS_SAVE_EVERY = 800
CHAOS_EVAC_STALL_S = 0.8
CHAOS_EVAC_FENCE_MIN_S = 0.4
# Device cleanup: a CartPole train CLI on the card SIGTERM'd once it has
# logged its first chunk; it must exit within CLEANUP_EXIT_MAX_S, leave
# nvidia-smi's compute apps within CLEANUP_GONE_MAX_S of its exit, and the
# card's free memory come back to within CLEANUP_FREE_SLACK of before.
CLEANUP_EXIT_MAX_S = 30.0
CLEANUP_GONE_MAX_S = 10.0
CLEANUP_FREE_SLACK = 512 << 20
# Unarmed chaos.fire() calls timed on the host.
FIRE_CALLS = 1_000_000


def _chaos_plane_draws(sampler) -> dict:
    """The replay.device_sample seam on the sampler kernel's dispatch at
    the host plane: the injected exception raises before any launch with
    the plane's pending writes intact; the next draw launches, recovers
    the trip, and it and every later draw (one of them stalled) pick the
    plain version's cells at the same uniforms."""
    import numpy as np
    import torch

    from dist_dqn_tpu_torch import chaos
    from dist_dqn_tpu_torch.replay.host import DevicePrioritySampler
    from dist_dqn_tpu_torch.telemetry.registry import Registry

    capacity, lanes, S = CHAOS_PLANE
    rng = np.random.default_rng(19)
    plane = DevicePrioritySampler(capacity, lanes=lanes, device=DEVICE)
    shape = tuple(plane.plane.shape)
    if not plane.use_kernel or shape != (1954, 512):
        _fail(f"chaos: the host plane is {shape}, kernel {plane.use_kernel}")
    plane.set(np.arange(capacity), rng.random(capacity) + 0.01)
    plane.sample_at(np.full(S, 0.5, np.float32), capacity)      # flushed
    rows = rng.choice(capacity, 4096, replace=False)
    plane.set(rows, rng.random(4096) * 4.0)                     # pending
    pending = [a.copy() for a in plane._pending_idx]
    torch.cuda.synchronize()
    before = plane.plane.clone()

    def uniforms():
        return ((np.arange(S) + rng.random(S)) / S).astype(np.float32)

    plan = chaos.FaultPlan(seed=19, events=(
        chaos.FaultEvent("replay.device_sample", "exception", at_hit=1),
        chaos.FaultEvent("replay.device_sample", "stall", at_hit=3,
                         args={"delay_s": 0.05})))
    reg = Registry()
    sampler.kernel_stratified_sample.launches = 0
    agree, max_err, open_after_first = True, 0.0, None
    with chaos.installed(plan, registry=reg) as inj:
        try:
            plane.dispatch_at(uniforms())
            raised = False
        except chaos.ChaosInjectedError:
            raised = True
        torch.cuda.synchronize()
        launched_on_raise = sampler.kernel_stratified_sample.launches
        intact = ([a.tolist() for a in plane._pending_idx]
                  == [a.tolist() for a in pending]
                  and torch.equal(plane.plane, before))
        for i in range(CHAOS_DRAWS):
            u = uniforms()
            idx, mass = plane.sample_at(u, capacity)
            if i == 0:
                open_after_first = inj.open_trips()
            t, b, m, _ = sampler.plain_stratified_sample(
                plane.plane, torch.from_numpy(u).to(plane.plane.device))
            idx_p = (t.long() * lanes + b.long()).cpu().numpy()
            agree &= bool(np.array_equal(idx, idx_p))
            max_err = max(max_err, float(np.abs(
                mass - m.cpu().numpy().astype(np.float64)).max()))
        injected = [(e["seam"], e["fault"], e["hit"]) for e in inj.injected]
        open_trips = inj.open_trips()
    launches = sampler.kernel_stratified_sample.launches
    out = {"plane": list(shape), "S": S, "raised_before_launch": raised
           and launched_on_raise == 0, "pending_writes_intact": intact,
           "draws": CHAOS_DRAWS + 1, "launches": launches,
           "agree_with_plain": agree, "max_abs_err": max_err,
           "open_trips_after_next_draw": open_after_first,
           "injected": injected, "open_trips": open_trips,
           "recovery_s": _recovery_seconds(reg)}
    print(json.dumps({"chaos_plane_draws": out}), flush=True)
    if not (out["raised_before_launch"] and intact and agree
            and max_err == 0.0 and launches == CHAOS_DRAWS
            and open_after_first == [] and open_trips == []
            and injected == [("replay.device_sample", "exception", 1),
                             ("replay.device_sample", "stall", 3)]):
        _fail(f"chaos: the device draw seam misbehaved: {out}")
    return out


def _recovery_seconds(reg) -> dict:
    """Mean seconds from injection to recovery per seam, from an
    injector's registry."""
    return {h.labels["seam"]: h.sum / h.count
            for h in reg.collect().get("dqn_recovery_seconds", [])
            if h.count}


def _chaos_host_replay(directory: str) -> dict:
    """An unarmed uniform host-replay run, then the same run twice under
    the smoke's plan with checkpoints: the same (seam, fault, hit) list
    both times, the unarmed run's params, no open trip, and the
    evacuation stall in the ledger's evac_fence."""
    import torch

    from dist_dqn_tpu_torch import chaos
    from dist_dqn_tpu_torch.config import CONFIGS, apply_overrides
    from dist_dqn_tpu_torch.telemetry.registry import Registry

    preset, overrides, total, chunk_iters = CHAOS_HOST_REPLAY
    cfg = apply_overrides(CONFIGS[preset], overrides)
    plan = chaos.FaultPlan(seed=8, events=(
        chaos.FaultEvent("evac.drain", "stall", at_hit=2,
                         args={"delay_s": CHAOS_EVAC_STALL_S}),
        chaos.FaultEvent("prefetch.sample", "stall", at_hit=3,
                         args={"delay_s": 0.05}),
        chaos.FaultEvent("checkpoint.save", "crash_before_stamp",
                         at_hit=1),
        chaos.FaultEvent("latest.write", "torn", at_hit=2)))
    want = sorted((e.seam, e.fault, e.at_hit) for e in plan.events)
    torch.cuda.empty_cache()
    ref, ref_wall = _drive_host_replay(cfg, total, chunk_iters,
                                       prioritized=False)
    runs = []
    for tag in ("a", "b"):
        reg = Registry()
        with chaos.installed(plan, registry=reg) as inj:
            out, wall = _drive_host_replay(
                cfg, total, chunk_iters, prioritized=False,
                checkpoint_dir=os.path.join(directory, tag),
                save_every_frames=CHAOS_SAVE_EVERY)
            injected = sorted((e["seam"], e["fault"], e["hit"])
                              for e in inj.injected)
            open_trips = inj.open_trips()
        runs.append({"wall_s": wall, "grad_steps": out["grad_steps"],
                     "param_checksum": out["param_checksum"],
                     "injected": injected, "open_trips": open_trips,
                     "evac_fence_s": out["chip_time"]["evac_fence"],
                     "stale_batches": out["stale_batches"],
                     "recovery_s": _recovery_seconds(reg)})
    row = {"reference_wall_s": ref_wall,
           "reference_checksum": ref["param_checksum"],
           "reference_evac_fence_s": ref["chip_time"]["evac_fence"],
           "runs": runs}
    print(json.dumps({"chaos_host_replay": row}), flush=True)
    ok = all(r["injected"] == [tuple(x) for x in want]
             and r["open_trips"] == []
             and r["param_checksum"] == ref["param_checksum"]
             and r["grad_steps"] == ref["grad_steps"] > 0
             and r["evac_fence_s"] >= CHAOS_EVAC_FENCE_MIN_S
             and r["stale_batches"] == 0 for r in runs)
    if not ok:
        _fail(f"chaos: the armed host-replay runs broke an invariant "
              f"(want {want}): {row}")
    return row


def _compute_apps() -> dict:
    """pid -> used memory text of nvidia-smi's compute apps."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid,used_memory",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    apps = {}
    for line in smi.stdout.strip().splitlines():
        pid, _, mem = line.partition(",")
        if pid.strip().isdigit():
            apps[int(pid)] = mem.strip()
    return apps


def _chaos_device_cleanup() -> dict:
    """SIGTERM a train CLI holding the card mid-chunk: it must exit (the
    cleanup's 128 + SIGTERM) within CLEANUP_EXIT_MAX_S, leave nvidia-smi's
    compute apps (by pid, or by the list's length where the list does not
    show this process namespace's pids), and give back the memory it
    held."""
    import signal

    import torch

    torch.cuda.synchronize()
    free_before, _ = torch.cuda.mem_get_info()
    apps_before = _compute_apps()
    proc = subprocess.Popen(
        [sys.executable, "-m", "dist_dqn_tpu_torch.train", "--config",
         "cartpole", "--total-env-steps", "100000000", "--chunk-iters",
         "500", "--eval-every-steps", "0"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    try:
        t0 = time.perf_counter()
        lines = []
        while True:
            line = proc.stdout.readline()
            if not line:
                _fail(f"chaos: the train CLI ended before a row: {lines}")
            lines.append(line.rstrip())
            if '"env_frames"' in line:
                break
            if time.perf_counter() - t0 > 300:
                _fail("chaos: no train row within 300 s")
        apps_during = _compute_apps()
        free_during, _ = torch.cuda.mem_get_info()
        seen = proc.pid in apps_during
        listed = seen or len(apps_during) > len(apps_before)
        t_term = time.perf_counter()
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=CLEANUP_EXIT_MAX_S + 30)
        exit_s = time.perf_counter() - t_term
        rest = proc.stdout.read()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    gone_s = None
    while time.perf_counter() - t_term < exit_s + CLEANUP_GONE_MAX_S:
        apps = _compute_apps()
        if proc.pid not in apps and len(apps) <= len(apps_before):
            gone_s = time.perf_counter() - t_term
            break
        time.sleep(0.1)
    free_after, _ = torch.cuda.mem_get_info()
    probe = torch.empty(int(free_before * 0.5), dtype=torch.uint8,
                        device=DEVICE)
    del probe
    torch.cuda.empty_cache()
    out = {"rc": rc, "exit_s": exit_s, "exit_max_s": CLEANUP_EXIT_MAX_S,
           "pid_seen_while_running": seen, "listed_while_running": listed,
           "apps_before": len(apps_before), "apps_during": len(apps_during),
           "gone_s": gone_s, "free_gb_before": free_before / 1e9,
           "free_gb_during": free_during / 1e9,
           "free_gb_after": free_after / 1e9,
           "first_row": lines[-1][:200], "tail": rest[-300:]}
    print(json.dumps({"chaos_device_cleanup": out}), flush=True)
    if rc != 128 + signal.SIGTERM or exit_s > CLEANUP_EXIT_MAX_S \
            or gone_s is None or free_during >= free_before \
            or free_after < free_before - CLEANUP_FREE_SLACK:
        _fail(f"chaos: the SIGTERM'd train CLI did not leave the card: "
              f"{out}")
    return out


def _chaos_sizing(walls: dict) -> dict:
    """The sizing gate's prediction for each fused main path this call
    ran, beside the wall it took: the gate must be conservative."""
    from dist_dqn_tpu_torch.config import CONFIGS, apply_overrides
    from dist_dqn_tpu_torch.envs import make_env
    from dist_dqn_tpu_torch.utils import sizing

    rows = {}
    for name, wall in walls.items():
        preset, overrides, total, chunk_iters = MAIN_PATHS[name]
        cfg = apply_overrides(CONFIGS[preset], overrides)
        env = make_env(cfg.env_name, device="cpu")
        verdict = sizing.gate_fused(
            budget_s=float("inf"),
            **sizing.fused_gate_args(cfg, env, total, chunk_iters))
        rows[name] = {"sizing_predicted_s": verdict.predicted_s,
                      "wall_s": wall, "ok": verdict.ok}
    print(json.dumps({"chaos_sizing": rows,
                      "device_memory_gb": sizing.device_memory_bytes() / 1e9}),
          flush=True)
    low = {n: r for n, r in rows.items()
           if not r["ok"] or r["sizing_predicted_s"] < r["wall_s"]}
    if low:
        _fail(f"chaos: the sizing gate predicted below a measured wall "
              f"(or refused a path the card ran): {low}")
    return rows


def check_chaos(sampler, directory: str, walls: dict) -> int:
    """The chaos phase (about a minute): the device draw seam at the host
    plane, the smoke plan's host-replay runs, the device cleanup of a
    SIGTERM'd train CLI, and the sizing gate against the main paths'
    walls. Returns the sampler launches of its draws."""
    from dist_dqn_tpu_torch import chaos

    t0 = time.perf_counter()
    for _ in range(FIRE_CALLS):
        chaos.fire("replay.device_sample")
    fire_us = (time.perf_counter() - t0) / FIRE_CALLS * 1e6
    print(json.dumps({"chaos_fire_unarmed_us": fire_us,
                      "calls": FIRE_CALLS}), flush=True)
    draws = _chaos_plane_draws(sampler)
    _chaos_host_replay(directory)
    _chaos_device_cleanup()
    _chaos_sizing(walls)
    return draws["launches"]


BAR_PHASES = ("cartpole", "catch", "rainbow_cartpole", "qrdqn_cartpole",
              "iqn_cartpole", "mdqn_cartpole")
HOST_REPLAY_PHASES = ("host_replay_apex_dedup", "host_replay_uniform_pair")
APEX_SERVICE_PHASES = ("apex_service_pong", "apex_service_r2d2_pong",
                       "apex_service_remote_bootstrap",
                       "apex_service_snapshot_synthstack",
                       "apex_service_feeder_pixel",
                       "apex_service_feeder_legacy_tree", "evaluate_fake_ale")
MESH_PHASES = ("mesh_apex_nccl", *MESH_2RANK_PHASES)
APEX_DIST_PHASES = {
    "apex_service_shards_pong": check_apex_service_shards_pong,
    "apex_service_shard_sampling_pong":
        check_apex_service_shard_sampling_pong,
    "apex_service_learners_2rank": check_apex_service_learners_2rank,
    "apex_service_multihost_2proc": check_apex_service_multihost_2proc,
}
PHASES = ("dqnlint", "sampler", "dedup_gather", "helpers", *MAIN_PATHS,
          *(f for follows in FOLLOW_UPS.values() for f in follows),
          "population_learner_lockstep", "chaos", *HOST_REPLAY_PHASES,
          *APEX_SERVICE_PHASES, "serving_apex", "watchdog_device_wait",
          *MESH_PHASES,
          "sharded_store_device", *APEX_DIST_PHASES, *BAR_PHASES)


def start_bars(phases):
    """Start the selected learning bars (BAR_PHASES order) in a side
    process of this script, which runs them one after the other while
    this process runs the phases after the fused paths: the bars are
    host-bound on one thread each and took 498 s of a slow host's 1,424
    (PERF.md §4); a bar's frames to its bar do not depend on its wall. The
    side process's lines pass through, and it is killed if this process
    exits first. Returns the handle :func:`finish_bars` takes, or None."""
    import atexit
    import threading

    names = [n for n in BAR_PHASES if n in phases]
    if not names:
        return None
    got = {}
    side = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--bar-worker",
         ",".join(names)], stdout=subprocess.PIPE, text=True,
        cwd=os.path.dirname(os.path.abspath(__file__)))

    def relay():
        # To the process's own stdout: a phase that captures sys.stdout
        # (the mesh and evaluate CLIs' rows) must not read the bars'.
        for line in side.stdout:
            sys.__stdout__.write(line)
            sys.__stdout__.flush()
            if line.startswith('{"bar_worker"'):
                got.update(json.loads(line)["bar_worker"])

    def kill():
        if side.poll() is None:
            side.kill()
            side.wait()

    atexit.register(kill)
    reader = threading.Thread(target=relay, daemon=True,
                              name="bar-worker-relay")
    reader.start()
    print(json.dumps({"bars_started": names}), flush=True)
    return side, reader, got, names, time.perf_counter(), kill


def finish_bars(handle) -> dict:
    """Wait for the bars' side process: it must exit 0 having reached
    every bar. Returns their sampler launches by bar."""
    if handle is None:
        return {}
    side, reader, got, names, t0, kill = handle
    try:
        rc = side.wait()
        reader.join(timeout=30)
    finally:
        kill()
    print(json.dumps({"bars_done": names, "rc": rc,
                      "wall_s": time.perf_counter() - t0}), flush=True)
    if rc != 0 or set(got) != set(names):
        _fail(f"learning bars: their process ended with {rc}, reporting "
              f"{got} of {names}")
    return got


def run_main_paths(phases, sampler, launches: dict, tmp: str,
                   walls: dict) -> None:
    """Drive each selected main path (and each one a selected follow-up
    phase reuses), then its follow-ups; records the sampler launches of
    each in ``launches`` and its train() wall in ``walls``."""
    import torch

    from dist_dqn_tpu_torch.config import CONFIGS, apply_overrides

    for name, (preset, overrides, total_env_steps, chunk_iters) in \
            MAIN_PATHS.items():
        follows = [f for f in FOLLOW_UPS.get(name, ()) if f in phases]
        if name not in phases and not follows:
            continue
        cfg = apply_overrides(CONFIGS[preset], overrides)
        checkpoint = {}
        directory = os.path.join(tmp, name)
        if "checkpoint_apex" in follows:
            checkpoint = dict(checkpoint_dir=directory,
                              save_every_frames=APEX_SAVE_EVERY)
        elif "evaluate_iqn_risk" in follows:
            checkpoint = dict(checkpoint_dir=directory)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        logged = []
        tm = None
        if name == "apex":
            tm = _PhaseTelemetry(name, cfg)
            checkpoint["telemetry_port"] = 0
        sampler.kernel_stratified_sample.launches = 0
        with _FlushWatch() as flushes, _LedgerWalls() as ledger:
            carry, history, wall = drive_main_path(
                cfg, total_env_steps, chunk_iters, logged=logged,
                **checkpoint)
        launches[name] = sampler.kernel_stratified_sample.launches
        walls[name] = wall
        checkpoint.pop("telemetry_port", None)
        outputs = check_outputs(name, cfg, carry, history, launches[name])
        if tm is not None:
            scrape = _hold_fused_scrape(tm, logged, carry, history,
                                        launches[name])
            outputs["chip_time"] = _hold_fused_chip_time(
                scrape, cfg, history, chunk_iters, ledger.walls)
        if cfg.replay.prioritized and cfg.replay.updates_per_chunk > 1:
            # One last-wins flush per train event, each landing new values.
            outputs["priority_flushes"] = len(flushes.changed)
            outputs["every_flush_changed_the_plane"] = flushes.all_changed()
            if (len(flushes.changed) * cfg.replay.updates_per_chunk
                    != outputs["grad_steps"]
                    or not outputs["every_flush_changed_the_plane"]):
                _fail(f"{name}: {len(flushes.changed)} priority flushes for "
                      f"{outputs['grad_steps']} grad steps, or a flush "
                      "left the plane as it was")
        if name in END_EVAL_PATHS:
            ret, outputs["eval_s"] = evaluate_at_end(cfg, carry.learner.net)
            outputs["eval_return_at_end"] = ret
            if not math.isfinite(ret):
                _fail(f"{name}: non-finite evaluation return {ret}")
        row = _main_path_row(name, history, wall, launches[name], outputs)
        if "checkpoint_dir" in checkpoint:
            row.update(_checkpoint_rows(logged))
        if any(f.startswith("population") for f in follows):
            # The population path's yardstick.
            row.update(_profile_training(cfg, carry))
        print(json.dumps(row), flush=True)
        if name == "apex_dedup" and row["peak_mem_gb"] > APEX_DEDUP_MAX_GB:
            _fail(f"{name}: peak device memory {row['peak_mem_gb']} GB > "
                  f"{APEX_DEDUP_MAX_GB} GB")
        reference = carry if "resume_r2d2" in follows else None
        first_leg = {"frames": history[-1]["env_frames"],
                     "steps": carry.learner.steps}
        if name == "apex":
            _chunk_attribution(cfg, carry)
        del carry, history
        if "checkpoint_apex" in follows:
            launches["checkpoint_apex"] = check_checkpoint_apex(
                cfg, chunk_iters, directory, first_leg, sampler)
        elif "resume_r2d2" in follows:
            launches["resume_r2d2"] = check_resume_r2d2(
                cfg, chunk_iters, total_env_steps, directory, reference,
                sampler)
            del reference
        elif "evaluate_iqn_risk" in follows:
            check_evaluate_iqn_risk(cfg, directory)
        if any(f.startswith("population") for f in follows):
            directory = os.path.join(tmp, "population_apex_dedup")
            launches["population_apex_dedup"] = check_population_apex_dedup(
                cfg, directory, row, sampler)
            if "population_checkpoint" in follows:
                launches["population_checkpoint"] = \
                    check_population_checkpoint(cfg, directory, sampler)
        _clock(name)


def _profile_training(cfg, carry) -> dict:
    """PROFILED_ITERS more training iterations of a finished path's carry
    (the loop the path ran, rebuilt around its net), under torch.profiler:
    device events (kernels, copies, memsets) per iteration and the
    device's busy share. The iterations advance the carry."""
    from dist_dqn_tpu_torch import population as pop
    from dist_dqn_tpu_torch.envs import make_env
    from dist_dqn_tpu_torch.train_loop import make_fused_train

    env = make_env(cfg.env_name, device=DEVICE)
    make = (pop.make_population_train if cfg.population.size > 1
            else make_fused_train)
    _, run_chunk = make(cfg, env, carry.learner.net, device=DEVICE)
    held = {"carry": carry}

    def one_iteration():
        held["carry"], _ = run_chunk(held["carry"], 1)

    prof = _profile_device(one_iteration, PROFILED_ITERS)
    return {"profiled_iterations": PROFILED_ITERS,
            "profiled_wall_s": prof["wall_s"],
            "device_busy_share": prof["busy_s"] / prof["wall_s"],
            "device_events_per_iteration": prof["events"] / PROFILED_ITERS}


def population_config(base, size: int = POPULATION_SIZE,
                      spec: str = POPULATION_SPEC):
    """apex_dedup's config as a population of ``size`` (``--population``,
    ``--population-spec``), with no evaluation inside the run."""
    import dataclasses

    from dist_dqn_tpu_torch.config import PopulationConfig
    return dataclasses.replace(base, eval_every_steps=0,
                               population=PopulationConfig(size=size,
                                                           spec_json=spec))


def check_population_apex_dedup(base, directory: str, solo: dict,
                                sampler) -> int:
    """The population main path: four apex_dedup members through train()
    (learner-kind saves into ``directory``), PROFILED_ITERS more training
    iterations traced, then one evaluation of every member. Fails on a non-finite member
    loss or return, sampler launches other than the grad steps per member,
    a peak over POPULATION_MAX_GB, or device kernels per iteration at or
    above POPULATION_MAX_LAUNCH_RATIO times the solo path's (``solo``,
    apex_dedup's row of this call). Returns the sampler launches."""
    import torch

    from dist_dqn_tpu_torch import population as pop
    from dist_dqn_tpu_torch.envs import make_env

    name = "population_apex_dedup"
    cfg = population_config(base)
    M = cfg.population.size
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    logged = []
    sampler.kernel_stratified_sample.launches = 0
    carry, history, wall = drive_main_path(
        cfg, POPULATION_FRAMES, POPULATION_CHUNK, logged=logged,
        checkpoint_dir=directory)
    launches = sampler.kernel_stratified_sample.launches
    peak = torch.cuda.max_memory_allocated() / 1e9
    profile = _profile_training(cfg, carry)
    returns, eval_s = evaluate_at_end(cfg, carry.learner.net)
    env = make_env(cfg.env_name, device=DEVICE)
    grad_steps = int(sum(r["grad_steps_in_chunk"] for r in history))
    losses = [r["loss_members"] for r in history if r["grad_steps_in_chunk"]]
    pr = carry.replay.priorities
    net = carry.learner.net
    member0 = _solo_net(cfg, env)
    member0.load_state_dict(pop.extract_member(net.state_dict(), 0))
    obs = carry.obs[0, :8]
    with torch.no_grad():
        q = member0.q_values(obs)
    steady = history[1:]
    row = {
        "main_path": name, "device": torch.cuda.get_device_name(0),
        "population": M, "wall_s": wall,
        "env_frames_per_member": history[-1]["env_frames"],
        "grad_steps_per_member": grad_steps,
        "sampler_launches": launches,
        "peak_mem_gb": peak, "peak_mem_limit_gb": POPULATION_MAX_GB,
        "loss_members_last": losses[-1] if losses else None,
        "eval_return_members": returns, "eval_s": eval_s,
        "env_steps_per_sec_chunks": [r["env_steps_per_sec"] for r in steady],
        "grad_steps_per_sec_chunks": [r["grad_steps_per_sec"]
                                      for r in steady],
        "grad_steps_per_sec_member_chunks": [
            r["grad_steps_per_sec_member"] for r in steady],
        "env_steps_per_sec_last": history[-1]["env_steps_per_sec"],
        "env_steps_per_sec_member_last":
            history[-1]["env_steps_per_sec"] / M,
        "grad_steps_per_sec_last": history[-1]["grad_steps_per_sec"],
        "grad_steps_per_sec_member_last":
            history[-1]["grad_steps_per_sec_member"],
        **profile,
        **_checkpoint_rows(logged),
        "solo_apex_dedup": {k: solo[k] for k in (
            "env_steps_per_sec_last", "grad_steps_per_sec_last",
            "env_steps_per_sec_chunks", "grad_steps_per_sec_chunks",
            "device_events_per_iteration", "device_busy_share",
            "profiled_wall_s", "peak_mem_gb", "wall_s")},
    }
    row["device_events_per_iteration_vs_solo"] = (
        row["device_events_per_iteration"]
        / solo["device_events_per_iteration"])
    print(json.dumps(row), flush=True)
    if (not losses or not all(math.isfinite(x) for m in losses for x in m)
            or not all(math.isfinite(x) for x in returns)
            or len(returns) != M):
        _fail(f"{name}: non-finite member losses or returns: {losses[-1:]} "
              f"{returns}")
    if not bool(torch.isfinite(pr).all()) or bool((pr < 0).any()):
        _fail(f"{name}: non-finite or negative priorities")
    if any(p.dtype != torch.float32 for p in net.parameters()):
        _fail(f"{name}: the learner's master params are not all float32")
    if tuple(q.shape) != (obs.shape[0], env.num_actions) or \
            not bool(torch.isfinite(q).all()):
        _fail(f"{name}: member 0's Q-values of shape {tuple(q.shape)} or "
              "non-finite")
    if grad_steps != POPULATION_GRAD_STEPS or launches != grad_steps:
        _fail(f"{name}: {launches} sampler launches for {grad_steps} grad "
              f"steps per member (want {POPULATION_GRAD_STEPS} of each)")
    if peak > POPULATION_MAX_GB:
        _fail(f"{name}: peak device memory {peak} GB > {POPULATION_MAX_GB}")
    if row["device_events_per_iteration_vs_solo"] >= \
            POPULATION_MAX_LAUNCH_RATIO:
        _fail(f"{name}: {row['device_events_per_iteration']} device kernels "
              f"per iteration, {row['device_events_per_iteration_vs_solo']}x "
              "the solo path's")
    return launches


def _solo_net(cfg, env):
    from dist_dqn_tpu_torch.models import build_network
    return build_network(cfg.network, env.num_actions, env.observation_shape,
                         device=DEVICE)


def check_population_checkpoint(base, directory: str, sampler) -> int:
    """The population path's directory: its POPULATION marker reads 4,
    ``evaluate_checkpoint(member=2)`` plays a finite return, a relaunch at
    M = 4 resumes (and, finished, trains nothing) and a relaunch at M = 3
    is refused with the width's text. Returns the sampler launches."""
    import torch

    from dist_dqn_tpu_torch import population as pop
    from dist_dqn_tpu_torch.evaluate import evaluate_checkpoint
    from dist_dqn_tpu_torch.utils.checkpoint import read_population_size

    name = "population_checkpoint"
    cfg = population_config(base)
    torch.cuda.empty_cache()
    marker = read_population_size(directory)
    t0 = time.perf_counter()
    member = evaluate_checkpoint(
        pop.member_config(cfg, pop.resolve_spec(cfg), 2), directory,
        episodes=cfg.eval_episodes, device=DEVICE, member=2)
    evaluate_s = time.perf_counter() - t0
    logged = []
    sampler.kernel_stratified_sample.launches = 0
    carry, history, relaunch_s = drive_main_path(
        cfg, POPULATION_FRAMES, POPULATION_CHUNK, logged=logged,
        checkpoint_dir=directory)
    launches = sampler.kernel_stratified_sample.launches
    del carry
    torch.cuda.empty_cache()
    resumed = [r for r in logged if "resumed_at_frames" in r]
    want = [{"resumed_at_frames": POPULATION_FRAMES, "with_replay": False,
             "population": POPULATION_SIZE}]
    refusal = None
    try:
        drive_main_path(population_config(base, size=3, spec=""),
                        POPULATION_FRAMES, POPULATION_CHUNK,
                        checkpoint_dir=directory)
    except ValueError as e:
        refusal = str(e)
    want_refusal = (
        f"checkpoint directory {directory!r} holds a population-"
        f"{POPULATION_SIZE} stacked tree but this run trains --population 3"
        " — the member axis is part of the checkpoint structure. Resume "
        "with the same --population, use a fresh --checkpoint-dir, or "
        "extract single members with restore_params(member=k) / "
        "evaluate.py --member.")
    report = {"population_checkpoint": {
        "marker": marker, "evaluate_member": member["member"],
        "evaluate_return": member["eval_return"],
        "evaluate_frames": member["frames"], "evaluate_s": evaluate_s,
        "resumed": resumed, "relaunch_rows": len(history),
        "relaunch_s": relaunch_s, **_checkpoint_rows(logged),
        "refused_m3": refusal}}
    print(json.dumps(report), flush=True)
    if marker != POPULATION_SIZE or member["member"] != 2 or \
            not math.isfinite(member["eval_return"]):
        _fail(f"{name}: marker {marker}, member evaluation {member}")
    if resumed != want or history or launches:
        _fail(f"{name}: relaunch at M={POPULATION_SIZE} logged {resumed} "
              f"(want {want}) and trained {len(history)} chunks")
    if refusal != want_refusal:
        _fail(f"{name}: the M=3 relaunch was refused with {refusal!r}")
    return launches


def check_population_learner_lockstep(sampler) -> int:
    """Member independence on the card. The cartpole learner at its preset
    width, two members (per-member lr): the stacked learner and two solo
    learners on the same batches for LOCKSTEP_STEPS grad steps, params
    within rtol 1e-5, atol 1e-6 (fatal). Then a LOCKSTEP_FRAMES-frame M = 2
    fused run beside the two solo runs of the same seeds, one iteration at
    a time: the first iteration at which a member's actions or replay draws
    differ from its solo twin's is reported (or "none"), not held to a
    bar. The cartpole preset draws uniformly, so the phase must launch
    the sampler kernel no time; returns its launches."""
    import dataclasses

    import torch

    from dist_dqn_tpu_torch import population as pop
    from dist_dqn_tpu_torch.agents import dqn
    from dist_dqn_tpu_torch.config import CONFIGS, PopulationConfig
    from dist_dqn_tpu_torch.envs import make_env
    from dist_dqn_tpu_torch.models import build_network, stack_networks
    from dist_dqn_tpu_torch.replay import device as ring
    from dist_dqn_tpu_torch.train_loop import make_fused_train
    from dist_dqn_tpu_torch.types import Transition

    name = "population_learner_lockstep"
    spec = json.dumps({"epsilon": [0.05, 0.2], "lr": [1e-3, 5e-4],
                       "gamma": [0.99, 0.97]})
    cfg = dataclasses.replace(CONFIGS["cartpole"], eval_every_steps=0,
                              population=PopulationConfig(2, spec))
    resolved = pop.resolve_spec(cfg)
    members = [pop.member_config(cfg, resolved, k) for k in range(2)]
    seeds = pop.member_seeds(cfg.seed, 2)
    env = make_env(cfg.env_name, device=DEVICE)
    nets = [build_network(cfg.network, env.num_actions,
                          env.observation_shape, device=DEVICE, seed=s)
            for s in seeds]
    stacked = stack_networks(nets)
    init, step = dqn.make_learner(
        cfg.learner, stacked, dqn.make_population_optimizer(cfg.learner, 2))
    state = dqn.set_member_lr(init(stacked, [torch.Generator(DEVICE)
                                             for _ in range(2)]),
                              pop.member_hp(cfg, resolved).lr)
    solos = []
    for k in range(2):
        s_init, s_step = dqn.make_learner(members[k].learner, nets[k])
        solos.append((s_init(nets[k]), s_step))
    gen = torch.Generator(DEVICE).manual_seed(0)
    S = cfg.learner.batch_size

    def draw(*shape, dtype=torch.float32):
        return torch.rand(shape, generator=gen, device=DEVICE, dtype=dtype)

    sampler.kernel_stratified_sample.launches = 0
    t0 = time.perf_counter()
    for _ in range(LOCKSTEP_STEPS):
        batch = Transition(
            obs=draw(2, S, 4) * 2 - 1,
            action=torch.randint(0, env.num_actions, (2, S), generator=gen,
                                 device=DEVICE),
            reward=draw(2, S), discount=(draw(2, S) < 0.9).float() * 0.97,
            next_obs=draw(2, S, 4) * 2 - 1)
        weights = draw(2, S) * 0.8 + 0.2
        step(state, batch, weights)
        for k, (s_state, s_step) in enumerate(solos):
            s_step(s_state, Transition(*(x[k] for x in batch)), weights[k])
    torch.cuda.synchronize()
    lockstep_s = time.perf_counter() - t0
    worst, ok = 0.0, True
    for k, (s_state, _) in enumerate(solos):
        for (pname, p), (_, q) in zip(state.net.named_parameters(),
                                      s_state.net.named_parameters()):
            err = float((p[k] - q).detach().abs().max())
            worst = max(worst, err)
            ok = ok and bool(torch.allclose(p[k], q, rtol=1e-5, atol=1e-6))

    # The fused loop, one iteration at a time.
    spy = []
    real_gather = ring.gather_transitions

    def gather(state_, t_idx, b_idx, *args, **kwargs):
        spy.append((t_idx, b_idx))
        return real_gather(state_, t_idx, b_idx, *args, **kwargs)

    ring.gather_transitions = gather
    try:
        t0 = time.perf_counter()
        pop_net = stack_networks([build_network(
            cfg.network, env.num_actions, env.observation_shape,
            device=DEVICE, seed=s) for s in seeds])
        # devtime: test fixtures: the lockstep check compares these
        # programs' outputs, outside any loop's program table.
        p_init, p_run = pop.make_population_train(cfg, env, pop_net,
                                                  device=DEVICE)
        # devtime: the solo twins of the same fixture.
        runs = [make_fused_train(members[k], env, build_network(
            cfg.network, env.num_actions, env.observation_shape,
            device=DEVICE, seed=seeds[k]), device=DEVICE) for k in range(2)]
        p_carry = p_init(seeds)
        carries = [runs[k][0](seeds[k]) for k in range(2)]
        first = [None, None]
        iters = LOCKSTEP_FRAMES // cfg.actor.num_envs
        for it in range(iters):
            spy.clear()
            p_carry, _ = p_run(p_carry, 1)
            pop_draws = list(spy)
            slot = (p_carry.replay.pos - 1) % p_carry.replay.action.shape[1]
            for k in range(2):
                spy.clear()
                carries[k], _ = runs[k][1](carries[k], 1)
                same = torch.equal(p_carry.replay.action[k, slot],
                                   carries[k].replay.action[slot])
                same = same and len(spy) == len(pop_draws) and all(
                    torch.equal(tp[k], ts) and torch.equal(bp[k], bs)
                    for (tp, bp), (ts, bs) in zip(pop_draws, spy))
                if first[k] is None and not same:
                    first[k] = it
        fused_s = time.perf_counter() - t0
        grad_steps = p_carry.learner.steps
    finally:
        ring.gather_transitions = real_gather
    launches = sampler.kernel_stratified_sample.launches
    report = {name: {
        "learner_steps": LOCKSTEP_STEPS, "params_max_abs_err": worst,
        "within_rtol_1e-5_atol_1e-6": ok, "learner_s": lockstep_s,
        "fused_iterations": iters, "fused_grad_steps": grad_steps,
        "first_divergent_iteration": [f if f is not None else "none"
                                      for f in first],
        "fused_s": fused_s, "sampler_launches": launches}}
    print(json.dumps(report), flush=True)
    if not ok:
        _fail(f"{name}: the stacked learner's params left the solo "
              f"learners' by {worst} (rtol 1e-5, atol 1e-6)")
    if launches:
        _fail(f"{name}: the uniform cartpole runs launched the sampler "
              f"kernel {launches} times")
    return launches


def main(argv=None) -> int:
    import argparse

    import torch
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--only", default=",".join(PHASES),
                        help="comma-separated phases to run, of "
                             f"{', '.join(PHASES)}; a partial run prints "
                             "no result line (default: all)")
    # start_bars' side process: these learning bars only, then their
    # launches on one line.
    parser.add_argument("--bar-worker", default=None,
                        help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    phases = [p for p in args.only.split(",") if p]
    unknown = sorted(set(phases) - set(PHASES))
    if unknown:
        parser.error(f"unknown phases {unknown}")
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    if "dqnlint" in phases and not args.bar_worker:
        check_dqnlint()
        _clock("dqnlint")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from dist_dqn_tpu_torch.ops import sampler

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t_build = time.perf_counter()
    build_fns = {"stratified_sample": sampler.build_library}
    with ThreadPoolExecutor(len(build_fns)) as pool:
        futures = {n: pool.submit(b) for n, b in build_fns.items()}
        built = {n: str(f.result()) for n, f in futures.items()}
    print(json.dumps({"built": built,
                      "build_s": time.perf_counter() - t_build}), flush=True)
    if args.bar_worker:
        worker = {}
        for name in args.bar_worker.split(","):
            worker[name] = run_learning_bar(name, sampler)
            print(json.dumps({"bar_done": name, "elapsed_s":
                              time.perf_counter() - t_start}), flush=True)
        print(json.dumps({"bar_worker": worker}), flush=True)
        return 0

    sampler_report = (check_sampler(sampler, TIMING_ITERS)
                      if "sampler" in phases else None)
    _clock("sampler")
    if "dedup_gather" in phases:
        check_dedup_gather()
        _clock("dedup_gather")
    if "helpers" in phases:
        check_helpers()
        _clock("helpers")

    launches = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        # /debug/profile captures land in the forensics dir: the script's.
        os.environ["DQN_FORENSICS_DIR"] = os.path.join(tmp, "forensics")
        walls = {}
        run_main_paths(phases, sampler, launches, tmp, walls)
        if "population_learner_lockstep" in phases:
            launches["population_learner_lockstep"] = \
                check_population_learner_lockstep(sampler)
            _clock("population_learner_lockstep")
        if "chaos" in phases:
            launches["chaos"] = check_chaos(
                sampler, os.path.join(tmp, "chaos"), walls)
            _clock("chaos")
        # The bars run beside the rest from here: the sampler's timing and
        # the fused paths' chip-time and kernel counts are taken alone.
        bars = start_bars(phases)
        if "host_replay_apex_dedup" in phases:
            launches["host_replay_apex_dedup"] = \
                check_host_replay_apex_dedup(
                    sampler, os.path.join(tmp, "host_replay_apex_dedup"))
            _clock("host_replay_apex_dedup")
        if "host_replay_uniform_pair" in phases:
            launches["host_replay_uniform_pair"] = \
                check_host_replay_uniform_pair(
                    sampler, os.path.join(tmp, "host_replay_profile"))
            _clock("host_replay_uniform_pair")
        if "apex_service_pong" in phases:
            launches["apex_service_pong"] = check_apex_service_pong(
                sampler, os.path.join(tmp, "apex_service_pong"))
            _clock("apex_service_pong")
        if "apex_service_r2d2_pong" in phases:
            launches["apex_service_r2d2_pong"] = \
                check_apex_service_r2d2_pong(sampler)
            _clock("apex_service_r2d2_pong")
        if "apex_service_remote_bootstrap" in phases:
            launches["apex_service_remote_bootstrap"] = \
                check_apex_service_remote_bootstrap(sampler)
            _clock("apex_service_remote_bootstrap")
        if "apex_service_snapshot_synthstack" in phases:
            launches["apex_service_snapshot_synthstack"] = \
                check_apex_service_snapshot_synthstack(
                    sampler, os.path.join(tmp, "apex_service_snapshot"))
            _clock("apex_service_snapshot_synthstack")
        # evaluate_fake_ale plays the pixel feeder phase's checkpoint, so
        # selecting it runs that phase too.
        feeder_dir = os.path.join(tmp, "apex_service_feeder_pixel")
        if {"apex_service_feeder_pixel", "evaluate_fake_ale"} & set(phases):
            launches["apex_service_feeder_pixel"] = \
                check_apex_service_feeder_pixel(sampler, feeder_dir)
            _clock("apex_service_feeder_pixel")
        if "apex_service_feeder_legacy_tree" in phases:
            launches["apex_service_feeder_legacy_tree"] = \
                check_apex_service_feeder_legacy_tree(sampler)
            _clock("apex_service_feeder_legacy_tree")
        if "evaluate_fake_ale" in phases:
            launches["evaluate_fake_ale"] = check_evaluate_fake_ale(
                sampler, feeder_dir, os.path.join(tmp, "evaluate_fake_ale"))
            _clock("evaluate_fake_ale")
        if "serving_apex" in phases:
            launches["serving_apex"] = check_serving_apex(
                sampler, os.path.join(tmp, "serving_apex"))
            _clock("serving_apex")
        if "watchdog_device_wait" in phases:
            check_watchdog_device_wait(
                os.path.join(tmp, "watchdog_device_wait"))
            _clock("watchdog_device_wait")
        if "mesh_apex_nccl" in phases:
            launches["mesh_apex_nccl"] = check_mesh_apex_nccl(
                sampler, os.path.join(tmp, "mesh_apex_nccl"))
            _clock("mesh_apex_nccl")
        if set(MESH_2RANK_PHASES) & set(phases):
            launches.update(check_mesh_2rank(phases))
            _clock("mesh_2rank")
    if "sharded_store_device" in phases:
        launches["sharded_store_device"] = check_sharded_store_device(sampler)
        _clock("sharded_store_device")
    for name, check in APEX_DIST_PHASES.items():
        if name in phases:
            launches[name] = check(sampler)
            _clock(name)

    launches.update(finish_bars(bars))

    print(json.dumps({"phases": phases,
                      "wall_s": time.perf_counter() - t_start}), flush=True)
    if sampler_report is None:
        return 0
    apex = sampler_report["apex"]
    kernels = [{
        "name": "stratified_sample",
        "route": "cuda",
        "source": "dist_dqn_tpu_torch/csrc/stratified_sample.cu",
        "replaces": "dist_dqn_tpu/ops/pallas_sampler.py:70",
        "launches": sum(launches.values()),
        "launches_by_path": launches,
        "max_abs_err": sampler_report["max_abs_err"],
        "ms": apex["ms"],
        "plain_ms": apex["plain_ms"],
        "bound_ms": apex["bound_ms"],
        "bound_by": apex["bound_by"],
        "library_ms": apex["library_ms"],
        "eager_ms": apex["eager_ms"],
        "device_launches_per_call": apex["device_launches_per_call"],
        # The same numbers at R2D2's sequence plane, the PixelCatch bar's
        # plane and the population's [M, T, B] planes (one member-axis
        # launch, beside one 2-D launch per member).
        **{f"{case}_shape": {k: sampler_report[case][k] for k in (
            "T", "B", "S", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "eager_ms", "device_launches_per_call")}
           for case in ("r2d2", "catch")},
        "host_plane_shape": {k: sampler_report["host_plane"][k] for k in (
            "T", "B", "S", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "eager_ms", "device_launches_per_call",
            "rows_twin_ms", "rows_twin_eager_ms", "rows_twin_repeats")},
        "mesh_rank_shape": {k: sampler_report["mesh_rank"][k] for k in (
            "T", "B", "S", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "eager_ms", "device_launches_per_call")},
        # A rank's plane of the host-replay mesh and a shard plane of the
        # two-shard store.
        "mesh_host_plane_shape": {
            k: sampler_report["mesh_host_plane"][k] for k in (
                "T", "B", "S", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "eager_ms", "device_launches_per_call",
                "rows_twin_ms", "rows_twin_eager_ms", "rows_twin_repeats")},
        "population_shape": {k: sampler_report["population"][k] for k in (
            "M", "T", "B", "S", "ms", "one_launch_per_member_ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms", "eager_ms",
            "one_launch_per_member_eager_ms", "device_launches_per_call")},
        # The wide-row path at ragged widths, and where it takes over.
        **{f"{case}_shape": {k: sampler_report[case][k] for k in (
            "T", "B", "S", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "device_launches_per_call")}
           for case in ("wide_500", "wide_520", "wide_510")},
        "wide_min_lanes": sampler.SAMPLER_WIDE_MIN_LANES,
        "width_sweep": sampler_report["width_sweep"],
        "pass": True,
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip()
          else f"nvidia-smi: {smi.stderr.strip()}", flush=True)
    if set(phases) != set(PHASES):
        return 0
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
