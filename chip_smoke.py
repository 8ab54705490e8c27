#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/H100 port (dist_dqn_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA card and nvcc; exits nonzero, printing no result, without
them or outside a checkout of the repository. Phases, each fatal:

1. Build every kernel of the port from ``dist_dqn_tpu_torch/csrc/`` (one
   nvcc per source, all started together).
2. Hold each kernel against its plain PyTorch version on the card, at the
   shapes the main paths give it (the sampler: the apex PER plane, a ragged
   mostly-zero plane, R2D2's sequence plane with mass in every 40th row,
   the PixelCatch bar's small plane, the host-replay device plane
   ``[1954, 512]`` of apex's 1M slots with its last 448 cells empty (and
   the card time of ``stratified_sample_rows``, the plane's draw below
   the kernel's crossover, and whether it repeats), and the population's
   four apex planes ``[4, 62500, 16]`` in one member-axis launch, which
   must equal four 2-D launches bit for bit), and time both beside one
   PyTorch library call computing the same function and the card's bound.
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
     spec of four epsilons, learning rates and gammas, 28,000 frames per
     member (752 grad steps each, one sampler launch per grad step for
     all four), peak memory at most four times apex_dedup's bar, and
     fewer than twice apex_dedup's device kernels per training iteration
     (each path's carry runs 10 more training iterations under
     torch.profiler after its run); then one evaluation of every member.
5. The learning bars (``dist_dqn_tpu_torch/learning_bars.py``): CartPole
   to a greedy eval return of 475 within 360,000 frames, PixelCatch
   (PER through the sampler kernel, dedup ring) from a random start to an
   episode return of +0.5 within 96,000 frames, the rainbow preset on
   CartPole to 475 within 300,000, and qrdqn, iqn and mdqn on the scaled
   CartPole to 150 within 160,000; each stops at its bar.
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
     replay.frame_dedup=true --per --device-sampling``, 56,000 frames in
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
   kernel, S = 512; training from 20,000 transitions to 32,000 env steps.
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
     sequences for about 150 grad steps. Holds a finite loss, grad steps,
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
     24,000 env steps. Holds one sampler launch per grad step, the native
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
12. population_learner_lockstep: the cartpole learner at its preset width
   as a population of two (own learning rates) and as two solo learners,
   on the same batches for 100 grad steps: params within rtol 1e-5, atol
   1e-6. Then a 4,000-frame two-member fused run beside the two solo runs
   of the same seeds, one iteration at a time; the first iteration at
   which a member's actions or replay draws differ from its solo twin's
   is reported, not held to a bar.

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
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

# The card's published peaks (H100 SXM data sheet): HBM bandwidth and the
# float32 rate outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
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
# draw). Chunks of 125 iterations are 2,000 frames; chunks 24-27 follow the
# 50,000-frame fill, 125 grad steps each.
HOST_REPLAY_PATH = ("apex", ["replay.frame_dedup=true",
                             "eval_every_steps=0"], 56_000, 125)
HOST_REPLAY_MIN_GRAD_STEPS = 300
# The Ape-X service path (--runtime apex --config apex --host-env pong
# --device-sampling): apex's full width (Nature CNN, bf16, batch 512, n-step
# 3, a 1M-transition host PER shard whose device plane is [1954, 512], S =
# 512 per draw), 8 actor processes of 8 numpy PixelPong envs each. Training
# starts at 20,000 transitions (the preset's 50,000: a depth cut) and the
# run ends at 32,000 env steps; at one grad step per 64 inserts the learner
# owes about 310 grad steps at the fill and about 500 at the end.
APEX_SERVICE_PATH = ("apex", ["replay.min_fill=20000", "eval_every_steps=0"],
                     32_000)
APEX_SERVICE_ACTORS = (8, 8)
APEX_SERVICE_MIN_GRAD_STEPS = 300
# The rest of the service (PERF.md §4 lists the cuts). R2D2 at full width
# with 8 actors of 8 envs (the preset's layout is 256 x 16) and a shard of
# 2,048 sequences (the preset's 100,000 would need 353 GB of host memory):
# the fill of 128 sequences lands at about 10,600 env steps (two windows
# per lane), and the learner owes one grad step per sequence, at most 4
# per pass of 64 env steps: about 150 grad steps by 13,500 env steps (124
# by 13,000 in PR 10's first full call).
APEX_R2D2_PATH = ("r2d2", ["replay.capacity=2048"], 13_500)
APEX_R2D2_ACTORS = (8, 8)
APEX_R2D2_MIN_GRAD_STEPS = 100
# Remote actors and the learner-side bootstrap: apex's full width, 4 local
# and 4 remote actors of 8 envs, training from 16,000 transitions (the
# preset's 50,000: a depth cut) to 24,000 env steps, about 375 grad steps.
APEX_REMOTE_PATH = ("apex", ["replay.min_fill=16000"], 24_000)
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
# as a solo apex_dedup run of its own epsilon, lr and gamma. 28,000 frames
# per member: the fill at 22,000, then 376 train events of two grad steps.
POPULATION_SIZE = 4
POPULATION_SPEC = json.dumps({"epsilon": [0.01, 0.05, 0.1, 0.02],
                              "lr": [1e-4, 5e-5, 2e-4, 1e-4],
                              "gamma": [0.99, 0.99, 0.98, 0.995]})
POPULATION_FRAMES = 28_000
POPULATION_CHUNK = 125
POPULATION_GRAD_STEPS = 752
POPULATION_MAX_GB = POPULATION_SIZE * APEX_DEDUP_MAX_GB
# After apex_dedup's and the population's runs, PROFILED_ITERS more
# training iterations of each are traced with torch.profiler (no trace is
# written: exporting a whole chunk's took about 100 s in PR 7's first
# call). The population must launch fewer than
# POPULATION_MAX_LAUNCH_RATIO times the solo path's device kernels per
# iteration (a loop over members would launch 4x).
PROFILED_ITERS = 10
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


def _fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


_T0 = time.perf_counter()


def _clock(phase: str) -> None:
    """One line at the end of each phase: the script's seconds so far."""
    print(json.dumps({"phase_done": phase,
                      "elapsed_s": time.perf_counter() - _T0}), flush=True)


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
# every sequence_stride=40 writes, so only every 40th row has mass; and the
# PixelCatch learning bar's 16,384-transition plane of 32 lanes.
SAMPLER_CASES = {"apex": (62500, 16, 512, 0.3, 1),
                 "ragged": (700, 8, 128, 0.9, 1),
                 "r2d2": (6250, 16, 64, 0.0, 40),
                 "catch": (512, 32, 32, 0.0, 1),
                 "host_plane": (1954, 512, 512, 0.3, 1)}
TIMED_CASES = ("apex", "r2d2", "catch", "host_plane")
# The host-replay device plane of apex's 1M slots: [ceil(1e6 / 512), 512]
# cells, of which the last 448 (past slot 999,999) are never written.
HOST_PLANE_LIVE_CELLS = 1_000_000


def _time_sampler(sampler, w, u, iters: int) -> dict:
    """Kernel, plain version and library call at one shape: device and
    eager times, the card's bound, graph-replay equality and device
    kernels per call. Fails if graph replays differ from an eager call.
    With a member axis (w [M, T, B], u [M, S]) the library call is the
    stacked cumsum with searchsorted, and ``one_launch_per_member_ms``
    times M 2-D launches, one per plane."""
    import torch

    M, T, B = w.shape if w.dim() == 3 else (1, *w.shape)
    S = u.shape[-1]

    def kernel():
        return sampler.kernel_stratified_sample(w, u)

    launches_per_call = _device_launches_per_call(kernel)
    replay_ok = _graph_replay_matches(kernel)
    if not replay_ok:
        _fail(f"sampler kernel outputs differ between eager calls and CUDA "
              f"graph replays (M={M}, T={T})")
    flat = w.reshape(M, -1)
    u2 = u.reshape(M, S)

    def library():
        cdf = torch.cumsum(flat, dim=1)
        return torch.searchsorted(cdf, u2 * cdf[:, -1:])

    fns = {"": kernel,
           "plain_": lambda: sampler.plain_stratified_sample(w, u),
           "library_": library}
    if w.dim() == 3:
        fns["one_launch_per_member_"] = lambda: [
            sampler.kernel_stratified_sample(w[m], u[m]) for m in range(M)]
    device = {f"{k}ms": _device_ms(fn) for k, fn in fns.items()}
    eager = {f"{k}eager_ms": _eager_ms(fn, iters) for k, fn in fns.items()}
    # Least work: read the planes and u once, write the three [S] outputs
    # and the total of each member once; add every cell once, scan the T
    # row sums, and per sample search log2(T) rows and walk B lanes.
    bytes_moved = M * (T * B * 4 + S * 4 + S * 12 + 4)
    ops = M * (T * B + T + S * (math.ceil(math.log2(T)) + B))
    bound_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    bound_ops = ops / F32_OPS_PER_S * 1e3
    return {**device, "bound_ms": max(bound_bytes, bound_ops),
            "bound_by": "bytes" if bound_bytes >= bound_ops
            else "operations", **eager, "graph_replay_equal": replay_ok,
            "device_launches_per_call": launches_per_call}


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
        if name == "host_plane":
            w_np.reshape(-1)[HOST_PLANE_LIVE_CELLS:] = 0.0
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
            if name == "host_plane":
                timing.update(_time_rows_twin(sampler, w, u, iters))
            print(json.dumps({"sampler_timing": name, "T": T, "B": B,
                              "S": S, **timing}), flush=True)
            report[name] = {"T": T, "B": B, "S": S, **timing}
    report["population"] = check_sampler_members(sampler, rng, iters)
    report["max_abs_err"] = max(report["max_abs_err"],
                                report["population"]["max_abs_err"])
    return report


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


def check_host_replay_apex_dedup(sampler) -> int:
    """HOST_REPLAY_PATH through the host-replay runtime (pipelined and
    prefetched, PER on the device plane): one sampler launch per grad
    step at the plane [1954, 512], a finite loss. Prints the rows' rates,
    the evacuation columns, host RSS and the card's peak memory; returns
    the launches."""
    import torch

    from dist_dqn_tpu_torch.config import CONFIGS, apply_overrides

    preset, overrides, total, chunk_iters = HOST_REPLAY_PATH
    cfg = apply_overrides(CONFIGS[preset], overrides)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    sampler.kernel_stratified_sample.launches = 0
    out, wall = _drive_host_replay(cfg, total, chunk_iters,
                                   prioritized=True, device_sampling=True)
    launches = sampler.kernel_stratified_sample.launches
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
           "chip_time": out["chip_time"],
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


def check_apex_service_pong(sampler, directory: str) -> int:
    """APEX_SERVICE_PATH through the port's Ape-X service: actor processes
    over shared memory, one batched act per ingest pass, actor-shipped
    priorities, PER through the device plane. Holds: at least
    APEX_SERVICE_MIN_GRAD_STEPS grad steps, one sampler launch per grad
    step, one act dispatch per ingest pass, no dropped, torn or bad
    records and no actor restarts, a finite loss; traces the first train event (torch.profiler) for the
    device's busy share; then the learner checkpoint it saved at the end
    is restored and played by the port's evaluate CLI. Returns the
    launches."""
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
    rt = ApexRuntimeConfig(host_env="pong", num_actors=actors,
                           envs_per_actor=lanes, total_env_steps=total,
                           device_sampling=True, checkpoint_dir=ckpt_dir,
                           save_every_steps=total,
                           profile_dir=os.path.join(directory, "profile"))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    service = ApexLearnerService(cfg, rt, log_fn=lambda line: print(
        line, flush=True), device=DEVICE)
    sampler.kernel_stratified_sample.launches = 0
    out = service.run()
    launches = sampler.kernel_stratified_sample.launches
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
                if service.replay.device_sampler is not None else None),
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            **_host_rss_gb(), **extra}


def _run_service(sampler, cfg, rt, service_hook=None):
    """Build the port's Ape-X service on the card and run it with the
    kernel's launch counter zeroed just before; returns (service, summary,
    launches). ``service_hook(service)`` runs between the two."""
    import torch

    from dist_dqn_tpu_torch.actors.service import ApexLearnerService

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    service = ApexLearnerService(cfg, rt, log_fn=lambda line: print(
        line, flush=True), device=DEVICE)
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


BAR_PHASES = ("cartpole", "catch", "rainbow_cartpole", "qrdqn_cartpole",
              "iqn_cartpole", "mdqn_cartpole")
HOST_REPLAY_PHASES = ("host_replay_apex_dedup", "host_replay_uniform_pair")
APEX_SERVICE_PHASES = ("apex_service_pong", "apex_service_r2d2_pong",
                       "apex_service_remote_bootstrap",
                       "apex_service_snapshot_synthstack",
                       "apex_service_feeder_pixel",
                       "apex_service_feeder_legacy_tree", "evaluate_fake_ale")
PHASES = ("sampler", "dedup_gather", *MAIN_PATHS,
          *(f for follows in FOLLOW_UPS.values() for f in follows),
          "population_learner_lockstep", *HOST_REPLAY_PHASES,
          *APEX_SERVICE_PHASES, *BAR_PHASES)


def run_main_paths(phases, sampler, launches: dict, tmp: str) -> None:
    """Drive each selected main path (and each one a selected follow-up
    phase reuses), then its follow-ups; records the sampler launches of
    each in ``launches``."""
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
        sampler.kernel_stratified_sample.launches = 0
        with _FlushWatch() as flushes:
            carry, history, wall = drive_main_path(
                cfg, total_env_steps, chunk_iters, logged=logged,
                **checkpoint)
        launches[name] = sampler.kernel_stratified_sample.launches
        outputs = check_outputs(name, cfg, carry, history, launches[name])
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
        p_init, p_run = pop.make_population_train(cfg, env, pop_net,
                                                  device=DEVICE)
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
    args = parser.parse_args(argv)
    phases = [p for p in args.only.split(",") if p]
    unknown = sorted(set(phases) - set(PHASES))
    if unknown:
        parser.error(f"unknown phases {unknown}")
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from dist_dqn_tpu_torch.ops import sampler

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t_start = time.perf_counter()
    build_fns = {"stratified_sample": sampler.build_library}
    with ThreadPoolExecutor(len(build_fns)) as pool:
        futures = {n: pool.submit(b) for n, b in build_fns.items()}
        built = {n: str(f.result()) for n, f in futures.items()}
    print(json.dumps({"built": built,
                      "build_s": time.perf_counter() - t_start}), flush=True)

    sampler_report = (check_sampler(sampler, TIMING_ITERS)
                      if "sampler" in phases else None)
    _clock("sampler")
    if "dedup_gather" in phases:
        check_dedup_gather()
        _clock("dedup_gather")

    launches = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        run_main_paths(phases, sampler, launches, tmp)
        if "population_learner_lockstep" in phases:
            launches["population_learner_lockstep"] = \
                check_population_learner_lockstep(sampler)
            _clock("population_learner_lockstep")
        if "host_replay_apex_dedup" in phases:
            launches["host_replay_apex_dedup"] = \
                check_host_replay_apex_dedup(sampler)
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

    for name in BAR_PHASES:
        if name in phases:
            launches[name] = run_learning_bar(name, sampler)
            _clock(name)

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
        "population_shape": {k: sampler_report["population"][k] for k in (
            "M", "T", "B", "S", "ms", "one_launch_per_member_ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms", "eager_ms",
            "one_launch_per_member_eager_ms", "device_launches_per_call")},
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
