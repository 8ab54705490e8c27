#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/H100 port (dist_dqn_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA card and nvcc; exits nonzero, printing no result, without
them or outside a checkout of the repository. Phases, each fatal:

1. Build every kernel of the port from ``dist_dqn_tpu_torch/csrc/`` (one
   nvcc per source, all started together).
2. Hold each kernel against its plain PyTorch version on the card, at the
   shapes the main path gives it, and time both beside one PyTorch
   library call computing the same function and the card's bound. Times
   are device times (CUDA events around replays of a CUDA graph of 20
   calls); the ``*eager_ms`` keys time the same calls launched from
   Python one by one, which is what the main path pays.
3. Drive the main path: ``dist_dqn_tpu_torch.train.train`` on the apex
   preset at full width (1M-transition PER ring, batch 512, Nature CNN,
   bf16) past ``min_fill`` for a few hundred grad steps and an eval, with
   the kernel launch counters zeroed just before and read just after.
4. Check the outputs: finite loss and priorities, Q-values of the expected
   shape that agree with a float32 reference forward of the same weights.

Then it prints the ``kernels`` JSON line, the card's name and power limit,
and as the last line ``{"ok": true, "device": {...}}``.

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
# Main path: apex fills its ring at 50,000 frames (min_fill); 14,000 more
# are about 875 grad steps at 16 frames per step.
MAIN_PATH_ENV_STEPS = 64_000
CHUNK_ITERS = 500
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


def _mass(rng, T, B, zero_frac):
    import numpy as np
    w = rng.uniform(0.1, 2.0, (T, B)).astype(np.float32)
    w[rng.uniform(size=(T, B)) < zero_frac] = 0.0
    return w


def check_sampler(sampler, iters: int) -> dict:
    """Kernel vs plain version at the apex shape (T=62500, B=16, S=512, 30%
    zero mass) and a ragged 90%-zero case (T=700, B=8, S=128). Bars: >= 98%
    (t, b) agreement, mass_sel == w[t, b] to rtol 1e-6, no zero-mass pick,
    t < T, total to rtol 1e-5. Times the apex case."""
    import numpy as np
    import torch

    rng = np.random.default_rng(0)
    dev = torch.device("cuda")
    report = {}
    max_err = 0.0
    for name, (T, B, S, zero) in (("apex", (62500, 16, 512, 0.3)),
                                  ("ragged", (700, 8, 128, 0.9))):
        w_np = _mass(rng, T, B, zero)
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
        max_err = max(max_err, err)
        report[name] = {"T": T, "B": B, "S": S, "agreement": agree,
                        "max_abs_err": err, "checks": checks}
        print(json.dumps({"sampler_check": name, **report[name]}),
              flush=True)
        if not all(checks.values()):
            _fail(f"sampler kernel disagrees with its plain version "
                  f"({name}): {checks}")
        if name == "apex":
            apex = (w, u, T, B, S)

    w, u, T, B, S = apex
    flat = w.reshape(-1)

    def library():
        cdf = torch.cumsum(flat, dim=0)
        return torch.searchsorted(cdf, u * cdf[-1])

    fns = {"": lambda: sampler.kernel_stratified_sample(w, u),
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
    timing = {**device, "bound_ms": max(bound_bytes, bound_ops),
              "bound_by": "bytes" if bound_bytes >= bound_ops
              else "operations"}
    print(json.dumps({"sampler_timing": "apex", "T": T, "B": B, "S": S,
                      **timing, **eager}), flush=True)
    return {"max_abs_err": max_err, **timing}


def drive_main_path(total_env_steps: int, chunk_iters: int):
    """The apex preset through the port's train() on the card."""
    import torch

    from dist_dqn_tpu_torch.config import CONFIGS
    from dist_dqn_tpu_torch.train import train

    cfg = CONFIGS["apex"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    carry, history = train(cfg, total_env_steps=total_env_steps,
                           chunk_iters=chunk_iters,
                           log_fn=lambda line: print(line, flush=True),
                           device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return cfg, carry, history, wall


def check_outputs(cfg, carry, history, launches: int) -> dict:
    """Grad steps taken through the kernel, finite loss and priorities,
    and Q-values of the trained net that agree with a float32 reference
    forward of the same weights on a small input."""
    import dataclasses

    import torch

    from dist_dqn_tpu_torch.models import build_network

    grad_steps = int(sum(r["grad_steps_in_chunk"] for r in history))
    losses = [r["loss"] for r in history if r["grad_steps_in_chunk"]]
    if grad_steps <= 0:
        _fail("the main path took no grad steps")
    if not all(math.isfinite(x) for x in losses):
        _fail(f"non-finite loss: {losses}")
    if launches < grad_steps:
        _fail(f"sampler kernel launched {launches} times for {grad_steps} "
              "grad steps")
    if not any("eval_return" in r for r in history):
        _fail("no eval ran")
    pr = carry.replay.priorities
    if not bool(torch.isfinite(pr).all()) or bool((pr < 0).any()):
        _fail("non-finite or negative priorities")
    net = carry.learner.net
    obs = carry.obs[:8]
    ref = build_network(dataclasses.replace(cfg.network,
                                            compute_dtype="float32"),
                        net.num_actions, tuple(obs.shape[1:]),
                        device=obs.device)
    ref.load_state_dict(net.state_dict())
    with torch.no_grad():
        q = net(obs)
        q32 = ref(obs)
    if tuple(q.shape) != (8, 6) or not bool(torch.isfinite(q).all()):
        _fail(f"Q-values of shape {tuple(q.shape)} or non-finite")
    # bf16 keeps 8 significant bits through five layers.
    scale = float(q32.abs().max().clamp(min=1e-3))
    q_err = float((q - q32).abs().max())
    if q_err > 0.05 * scale:
        _fail(f"bf16 Q-values off the f32 reference by {q_err} "
              f"(scale {scale})")
    return {"grad_steps": grad_steps, "final_loss": losses[-1],
            "q_bf16_vs_f32_max_abs": q_err, "q_scale": scale}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from dist_dqn_tpu_torch.ops import sampler

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    build_fns = {"stratified_sample": sampler.build_library}
    with ThreadPoolExecutor(len(build_fns)) as pool:
        futures = {n: pool.submit(b) for n, b in build_fns.items()}
        built = {n: str(f.result()) for n, f in futures.items()}
    print(json.dumps({"built": built,
                      "build_s": time.perf_counter() - t0}), flush=True)

    sampler_report = check_sampler(sampler, TIMING_ITERS)

    sampler.kernel_stratified_sample.launches = 0
    cfg, carry, history, wall = drive_main_path(MAIN_PATH_ENV_STEPS,
                                                CHUNK_ITERS)
    launches = sampler.kernel_stratified_sample.launches
    outputs = check_outputs(cfg, carry, history, launches)
    steady = history[1:]
    print(json.dumps({
        "main_path": "apex", "device": torch.cuda.get_device_name(0),
        "wall_s": wall, "env_frames": history[-1]["env_frames"],
        "env_steps_per_sec_last": history[-1]["env_steps_per_sec"],
        "grad_steps_per_sec_last": history[-1]["grad_steps_per_sec"],
        "env_steps_per_sec_chunks": [r["env_steps_per_sec"] for r in steady],
        "grad_steps_per_sec_chunks": [r["grad_steps_per_sec"]
                                      for r in steady],
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "sampler_launches": launches, **outputs}), flush=True)

    kernels = [{
        "name": "stratified_sample",
        "route": "cuda",
        "source": "dist_dqn_tpu_torch/csrc/stratified_sample.cu",
        "replaces": "dist_dqn_tpu/ops/pallas_sampler.py:70",
        "launches": launches,
        "max_abs_err": sampler_report["max_abs_err"],
        "ms": sampler_report["ms"],
        "plain_ms": sampler_report["plain_ms"],
        "bound_ms": sampler_report["bound_ms"],
        "bound_by": sampler_report["bound_by"],
        "library_ms": sampler_report["library_ms"],
        "pass": True,
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip()
          else f"nvidia-smi: {smi.stderr.strip()}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
