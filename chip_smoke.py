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
   and the PixelCatch bar's small plane), and time both beside one PyTorch
   library call computing the same function and the card's bound. Times
   are device times (CUDA events around replays of a CUDA graph of 20
   calls); the ``*eager_ms`` keys time the same calls launched from
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
   at full width past ``min_fill`` for a few hundred grad steps and an
   eval, with the kernel launch counters zeroed just before and read just
   after each:
   * apex: 1M-transition PER ring, batch 512, Nature CNN, bf16;
   * r2d2 with ``replay.pallas_sampler=True``: the recurrent Nature-CNN +
     LSTM-512 net (bf16), 6,250 x 16 sequence ring, 64 sequences of 125
     steps per grad step, one sampler launch per grad step;
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
     envs, about 110 grad steps past the fill at 20,000 frames.
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
import time
from concurrent.futures import ThreadPoolExecutor

# The card's published peaks (H100 SXM data sheet): HBM bandwidth and the
# float32 rate outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# Main paths: name -> (preset, --set overrides, total env frames,
# iterations per chunk). apex fills its ring at 50,000 frames (min_fill);
# 6,000 more are 376 grad steps at 16 frames per step. r2d2 fills
# at 2,500 frames (157 iterations of 16 envs); 4,800 frames are 300
# iterations, 144 of them with a grad step. atari_breakout fills at 20,000
# frames (iteration 312 of 64 envs) and trains every 4th iteration, two
# grad steps at a time: 204 events, 408 grad steps in 72,000 frames.
# apex_dedup trains from iteration 3,124 to 3,624, 501 events of two grad
# steps. Both eval once, after their first chunk. rainbow, qrdqn, iqn and
# mdqn fill at 20,000 frames (iteration 312 of 64 envs) and train every
# 4th iteration: 110 grad steps in 48,000 frames; they eval after their
# first chunk and their last.
MAIN_PATHS = {
    "apex": ("apex", [], 56_000, 250),
    "r2d2": ("r2d2", ["replay.pallas_sampler=true"], 4_800, 100),
    "atari_breakout": ("atari", ["env_name=pixel_breakout",
                                 "replay.frame_dedup=true",
                                 "network.actor_dtype=bfloat16",
                                 "replay.updates_per_chunk=2",
                                 "eval_every_steps=72000"], 72_000, 125),
    "apex_dedup": ("apex", ["replay.frame_dedup=true",
                            "replay.updates_per_chunk=2",
                            "eval_every_steps=58000"], 58_000, 125),
    **{preset: (preset, ["eval_every_steps=40000"], 48_000, 125)
       for preset in ("rainbow", "qrdqn", "iqn", "mdqn")},
}
APEX_DEDUP_MAX_GB = 12.0
TIMING_ITERS = 200


def _fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


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
    import torch
    from torch.autograd import DeviceType
    fn()
    torch.cuda.synchronize()
    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    return len(events) / calls


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
                 "catch": (512, 32, 32, 0.0, 1)}
TIMED_CASES = ("apex", "r2d2", "catch")


def _time_sampler(sampler, w, u, iters: int) -> dict:
    """Kernel, plain version and library call at one shape: device and
    eager times, the card's bound, graph-replay equality and device
    kernels per call. Fails if graph replays differ from an eager call."""
    import torch

    T, B = w.shape
    S = u.shape[0]

    def kernel():
        return sampler.kernel_stratified_sample(w, u)

    replay_ok = _graph_replay_matches(kernel)
    launches_per_call = _device_launches_per_call(kernel)
    if not replay_ok:
        _fail(f"sampler kernel outputs differ between eager calls and CUDA "
              f"graph replays (T={T})")
    flat = w.reshape(-1)

    def library():
        cdf = torch.cumsum(flat, dim=0)
        return torch.searchsorted(cdf, u * cdf[-1])

    fns = {"": kernel,
           "plain_": lambda: sampler.plain_stratified_sample(w, u),
           "library_": library}
    device = {f"{k}ms": _device_ms(fn) for k, fn in fns.items()}
    eager = {f"{k}eager_ms": _eager_ms(fn, iters) for k, fn in fns.items()}
    # Least work: read the plane and u once, write the three [S] outputs
    # and the total once; add every cell once, scan the T row sums, and per
    # sample search log2(T) rows and walk B lanes.
    bytes_moved = T * B * 4 + S * 4 + S * 12 + 4
    ops = T * B + T + S * (math.ceil(math.log2(T)) + B)
    bound_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    bound_ops = ops / F32_OPS_PER_S * 1e3
    return {**device, "bound_ms": max(bound_bytes, bound_ops),
            "bound_by": "bytes" if bound_bytes >= bound_ops
            else "operations", **eager, "graph_replay_equal": replay_ok,
            "device_launches_per_call": launches_per_call}


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
            print(json.dumps({"sampler_timing": name, "T": T, "B": B,
                              "S": S, **timing}), flush=True)
            report[name] = {"T": T, "B": B, "S": S, **timing}
    return report


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
                    stop_fn=None):
    """One config through the port's train() on the card."""
    import torch

    from dist_dqn_tpu_torch.train import train

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    carry, history = train(cfg, total_env_steps=total_env_steps,
                           chunk_iters=chunk_iters,
                           log_fn=lambda line: print(line, flush=True),
                           device="cuda", stop_fn=stop_fn)
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


BAR_PHASES = ("cartpole", "catch", "rainbow_cartpole", "qrdqn_cartpole",
              "iqn_cartpole", "mdqn_cartpole")
PHASES = ("sampler", "dedup_gather", *MAIN_PATHS, *BAR_PHASES)


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
    from dist_dqn_tpu_torch.config import CONFIGS, apply_overrides
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
    if "dedup_gather" in phases:
        check_dedup_gather()

    launches = {}
    for name, (preset, overrides, total_env_steps, chunk_iters) in \
            MAIN_PATHS.items():
        if name not in phases:
            continue
        cfg = apply_overrides(CONFIGS[preset], overrides)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        sampler.kernel_stratified_sample.launches = 0
        with _FlushWatch() as flushes:
            carry, history, wall = drive_main_path(cfg, total_env_steps,
                                                   chunk_iters)
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
        row = _main_path_row(name, history, wall, launches[name], outputs)
        print(json.dumps(row), flush=True)
        if name == "apex_dedup" and row["peak_mem_gb"] > APEX_DEDUP_MAX_GB:
            _fail(f"{name}: peak device memory {row['peak_mem_gb']} GB > "
                  f"{APEX_DEDUP_MAX_GB} GB")
        del carry, history

    for name in BAR_PHASES:
        if name in phases:
            launches[name] = run_learning_bar(name, sampler)

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
        # The same numbers at R2D2's sequence plane and the PixelCatch
        # bar's plane.
        **{f"{case}_shape": {k: sampler_report[case][k] for k in (
            "T", "B", "S", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "eager_ms", "device_launches_per_call")}
           for case in ("r2d2", "catch")},
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
