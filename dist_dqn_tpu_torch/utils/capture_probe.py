"""Does a ``/debug/profile`` capture keep the card's kernels while another
thread launches them?

    python -m dist_dqn_tpu_torch.utils.capture_probe [--captures 20]
        [--seconds 0.5] [--variants ungated,gated]

For each variant, in a fresh process: one thread serves a small
Q-network continuously (an 8-row forward, its argmax read back, as the
serving batcher's dispatch does) while another thread, which launches
nothing itself, takes ``--captures`` captures of ``--seconds`` through
``telemetry/devtime.py capture_profile``. ``gated``: the serving thread
launches inside ``devtime.device_work()``, as the port's loops do, so
the profiler starts between its steps (``LaunchGate``); ``ungated``: it
launches outside, as a thread that skipped the gate would. Prints one
JSON line per capture with the kernel and runtime-API events its trace
holds and the server iterations in its window, then one line per
variant: how many captures held no kernel or under half the kernels per
iteration of one traced on the serving thread itself. Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import threading
import time

VARIANTS = ("ungated", "gated")


def _events(trace_dir: str) -> tuple:
    with open(os.path.join(trace_dir, "trace.json")) as f:
        events = json.load(f).get("traceEvents", [])
    return (sum(e.get("cat") == "kernel" for e in events),
            sum(e.get("cat") == "cuda_runtime" for e in events))


def _child(variant: str, captures: int, seconds: float) -> None:
    import contextlib

    import torch

    from dist_dqn_tpu_torch.telemetry import devtime

    block = (devtime.device_work if variant == "gated"
             else contextlib.nullcontext)
    net = torch.nn.Sequential(torch.nn.Linear(512, 512), torch.nn.ReLU(),
                              torch.nn.Linear(512, 18)).cuda()
    obs = torch.randn(8, 512, device="cuda")
    base = tempfile.mkdtemp(prefix="capture-probe-")
    with torch.no_grad(), torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as own:
        for _ in range(10):
            net(obs).argmax(-1).cpu()
    own.export_chrome_trace(os.path.join(base, "trace.json"))
    per_iter = _events(base)[0] / 10
    iters, stop = [0], threading.Event()

    def serve():
        with torch.no_grad():
            while not stop.is_set():
                with block():
                    net(obs).argmax(-1).cpu()
                iters[0] += 1

    server = threading.Thread(target=serve, name="capture-probe-serve",
                              daemon=True)
    server.start()
    time.sleep(0.3)
    rows = []
    for i in range(captures):
        got, n0, t0 = {}, iters[0], time.perf_counter()
        th = threading.Thread(target=lambda: got.update(
            devtime.capture_profile(seconds, base_dir=base)),
            name=f"capture-probe-{i}", daemon=True)
        th.start()
        th.join()
        kernels, runtime = _events(got["trace_dir"])
        row = {"variant": variant, "capture": i, "iterations": iters[0] - n0,
               "kernels": kernels, "runtime_events": runtime,
               "wall_s": time.perf_counter() - t0}
        row["kernels_per_iteration"] = kernels / max(row["iterations"], 1)
        rows.append(row)
        print(json.dumps(row), flush=True)
    stop.set()
    server.join()
    print(json.dumps({
        "variant": variant, "captures": len(rows),
        "kernels_per_iteration_same_thread": per_iter,
        "no_kernel": sum(r["kernels"] == 0 for r in rows),
        "under_half": sum(r["kernels_per_iteration"] < per_iter / 2
                          for r in rows),
        "device": torch.cuda.get_device_name(0)}), flush=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--captures", type=int, default=20)
    p.add_argument("--seconds", type=float, default=0.5)
    p.add_argument("--variants", default=",".join(VARIANTS))
    p.add_argument("--child", choices=VARIANTS, help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("capture_probe: needs a CUDA card", file=sys.stderr)
        return 1
    if args.child:
        _child(args.child, args.captures, args.seconds)
        return 0
    rc = 0
    for variant in args.variants.split(","):
        # A fresh process each: a capture that lost its kernels can leave
        # later captures of the same process without them.
        rc |= subprocess.call(
            [sys.executable, "-m", __spec__.name, "--child", variant,
             "--captures", str(args.captures), "--seconds",
             str(args.seconds)])
    return rc


if __name__ == "__main__":
    sys.exit(main())
