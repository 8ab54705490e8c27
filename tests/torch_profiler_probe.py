"""How many device events torch.profiler records around the sampler kernel,
each process fresh, and the card test that counts them run in a loop.

    python tests/torch_profiler_probe.py --processes 16
    python tests/torch_profiler_probe.py --setups cold,test \
        --processes 12 --sessions 25
    python tests/torch_profiler_probe.py --pytest-loop 50

The first forms start ``--processes`` fresh processes for each setup and,
in each, draw ``--calls`` times from the apex plane ``[62500, 16]`` under
``--sessions`` profiler sessions in a row. Setups: ``cold`` opens the
counted sessions straight after one eager call, as
``tests/test_torch_kernels_cuda.py::test_sampler_draw_is_one_device_kernel``
did before it waited; ``warm`` opens and closes one profiler session
around an eager call first; ``gap`` waits 50 ms after each counted session
opens and before it closes; ``test`` calls that test function itself once
per session. For every session it prints the kernel events torch.profiler
reports, the raw device and launch records of its Kineto result, which
launches (by correlation id) have no kernel record, and the kernels'
device start times against the first launch's host time. The last form
runs that test ``N`` times, each in a fresh pytest process, and counts the
passes. All need a CUDA card; the last line is one JSON object.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
SETUPS = ("cold", "warm", "gap", "test")
TEST_ID = ("tests/test_torch_kernels_cuda.py::"
           "test_sampler_draw_is_one_device_kernel")


def _session(fn, calls: int, gap_s: float = 0.0) -> dict:
    """One profiler session of ``calls`` calls (``gap_s`` idle seconds
    after it opens and before it closes): the kernel events torch.profiler
    reports and the raw records behind them."""
    import time

    import torch
    from torch.autograd import DeviceType

    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA]) as prof:
        time.sleep(gap_s)
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        time.sleep(gap_s)
    names = [e.name for e in prof.events()
             if e.device_type == DeviceType.CUDA]
    raw = prof.profiler.kineto_results.events()
    device = [e for e in raw if e.device_type() == DeviceType.CUDA]
    launches = [e for e in raw if e.device_type() == DeviceType.CPU
                and "LaunchKernel" in e.name()]
    seen = {e.correlation_id() for e in device}
    missing = [i for i, e in enumerate(launches)
               if e.correlation_id() not in seen]
    t0 = min((e.start_ns() for e in launches), default=0)
    return {"events": len(names), "kernels": sum("sample_kernel" in n
                                                 for n in names),
            "raw_device": len(device), "raw_launches": len(launches),
            "missing_launch_index": missing,
            "device_start_us": [round((e.start_ns() - t0) / 1e3, 1)
                                for e in device]}


def _child(setup: str, calls: int, sessions: int) -> dict:
    import numpy as np
    import torch

    from dist_dqn_tpu_torch.ops import sampler as tps

    rng = np.random.default_rng(8)
    w_np = rng.uniform(0.1, 2.0, (62500, 16)).astype(np.float32)
    w_np[rng.uniform(size=w_np.shape) < 0.3] = 0.0
    u_np = ((np.arange(512) + rng.uniform(size=512)) / 512).astype(
        np.float32)
    w = torch.from_numpy(w_np).cuda()
    u = torch.from_numpy(u_np).cuda()

    def fn():
        tps.kernel_stratified_sample(w, u)

    fn()
    torch.cuda.synchronize()
    if setup == "test":
        return {"setup": setup,
                "sessions": [_test_session() for _ in range(sessions)]}
    if setup == "warm":
        _session(fn, 1)
    gap_s = 0.05 if setup == "gap" else 0.0
    return {"setup": setup,
            "sessions": [_session(fn, calls, gap_s)
                         for _ in range(sessions)]}


def _test_session() -> dict:
    """One call of the card test; ``kernels`` is 10 when it passed."""
    import importlib.util

    import torch

    spec = importlib.util.spec_from_file_location(
        "kernels_cuda", REPO / TEST_ID.split("::")[0])
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    try:
        module.test_sampler_draw_is_one_device_kernel(torch.device("cuda"))
    except AssertionError as e:
        return {"kernels": -1, "error": str(e)[:500]}
    return {"kernels": 10}


def _run_child(setup: str, calls: int, sessions: int) -> dict:
    proc = subprocess.run(
        [sys.executable, str(Path(__file__).resolve()), "--child", setup,
         "--calls", str(calls), "--sessions", str(sessions)], cwd=REPO,
        capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"probe child failed ({proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _pytest_loop(n: int) -> dict:
    """Run the card test ``n`` times, each in a fresh pytest process."""
    passed, failures = 0, []
    for i in range(n):
        proc = subprocess.run(
            [sys.executable, "-m", "pytest", "--noconftest", "-p",
             "no:cacheprovider", "-q", "-m", "cuda", TEST_ID], cwd=REPO,
            capture_output=True, text=True, timeout=300)
        if proc.returncode == 0 and "1 passed" in proc.stdout:
            passed += 1
        else:
            failures.append({"run": i, "rc": proc.returncode,
                             "tail": proc.stdout[-1500:]})
    return {"test": TEST_ID, "runs": n, "passed": passed,
            "failures": failures[:5]}


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--processes", type=int, default=16,
                        help="fresh processes per setup")
    parser.add_argument("--setups", default=",".join(SETUPS),
                        help=f"comma-separated, of {', '.join(SETUPS)}")
    parser.add_argument("--calls", type=int, default=10)
    parser.add_argument("--sessions", type=int, default=3,
                        help="counted sessions per process")
    parser.add_argument("--pytest-loop", type=int, default=0, metavar="N",
                        help="run the card test N times instead")
    parser.add_argument("--child", choices=SETUPS, default=None,
                        help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("torch_profiler_probe needs a CUDA card")
    if args.child:
        print(json.dumps(_child(args.child, args.calls, args.sessions)))
        return
    if args.pytest_loop:
        print(json.dumps(_pytest_loop(args.pytest_loop)))
        return
    out = {"device": torch.cuda.get_device_name(0), "calls": args.calls}
    for setup in args.setups.split(","):
        runs = [_run_child(setup, args.calls, args.sessions)
                for _ in range(args.processes)]
        for r in runs:
            print(json.dumps(r), flush=True)
        short = [[s["kernels"] != args.calls for s in r["sessions"]]
                 for r in runs]
        sessions = args.processes * args.sessions
        out[setup] = {
            "processes": len(runs),
            "sessions": sessions,
            "short_sessions": sum(map(sum, short)),
            "short_sessions_by_index": [sum(s[k] for s in short)
                                        for k in range(args.sessions)]}
    print(json.dumps(out))


if __name__ == "__main__":
    main()
