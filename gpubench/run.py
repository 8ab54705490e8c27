"""Run one cell of the port's benchmark once and print its result line.

    python3 gpubench/run.py --workload apex.pop8 --seed 1234 \
        --seconds 10 --trace 0

From the root of a checkout: set-up (weights made on the card from the
seed, rings filled to capacity, the first grad steps captured for the
check, one chunk warmed up), then chunks of the population program for
``--seconds`` seconds, then the check against the plain reference. The
last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number compared with its limit);
the last lines of standard error repeat the checks. A run that raises
prints a line with ``correct`` false and exits 1. ``--trace 0`` reports the cell's
end-to-end metrics, ``--trace 1`` its per-layer metrics, read from a
torch.profiler capture of ``trace_chunks`` chunks after the window.

Exits non-zero without a result when there is no card, too few cards,
no program to run, or when JAX or the JAX package was loaded.
"""
import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# Module names (the part before the first dot, whole) that no process of
# the benchmark may load.
BANNED = ("jax", "jaxlib", "flax", "dist_dqn_tpu")


def banned_modules():
    """The banned top-level names among the loaded modules."""
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(BANNED))


def _cache_dirs() -> None:
    """Build and kernel caches at fixed paths inside the checkout, so the
    first run of a cell there builds and later runs find it built. The
    sampler kernel's library goes to build/dist_dqn_tpu_torch/, a path the
    program fixes inside the checkout."""
    cache = ROOT / ".cache"
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(cache / sub)


def _power_limit_w():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=20)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.TimeoutExpired):
        return None


def _judge(readings: dict, limits: dict) -> dict:
    """The numbers compared, each beside its limit: those the cell's
    limits file gives a limit (a number without one is named there with
    the reason it is not compared)."""
    return {name: {"value": value, "limit": limits[name]["limit"]}
            for name, value in readings.items()
            if limits.get(name, {}).get("limit") is not None}


def _device(on_card: bool, peak: int) -> dict:
    import torch

    return {"platform": "gpu" if on_card else "cpu",
            "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
            "count": 1, "memory_peak_bytes": int(peak),
            "power_limit_w": _power_limit_w() if on_card else None}


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", overrides=None,
             traffic_overrides=None) -> dict:
    """One run of cell ``name``: its result object. ``overrides`` (dotted
    config fields) and ``traffic_overrides`` shrink a cell for the CPU
    tests."""
    import torch

    from gpubench.harness import cell as cells
    from gpubench.harness.population import Population
    from gpubench.reference import judge

    c = cells.cell(name)
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    t = [time.perf_counter()]
    pop = Population(c, seed, device, overrides, traffic_overrides)
    t.append(time.perf_counter())
    for stage in (pop.fill, pop.check_steps, pop.warm_up):
        stage()
        t.append(time.perf_counter())
    t_window = t[-1]
    parts = zip(("build", "fill", "check_steps", "warm_up"), t, t[1:])
    print(f"gpubench: set-up (s): import {t[0] - _T0:.3f}, " + ", ".join(
        f"{name} {b - a:.3f}" for name, a, b in parts), file=sys.stderr)
    window = pop.window(seconds)
    if on_card:
        torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    traced = None
    if trace:
        from gpubench.harness.trace import profile
        chunks = pop.traffic["trace_chunks"]
        traced = profile(lambda: [pop._chunk(pop.traffic["chunk_iters"])
                                  for _ in range(chunks)])
        traced_iters = chunks * pop.traffic["chunk_iters"]
    found = banned_modules()
    if found:
        raise SystemExit(f"loaded modules of JAX or the JAX package: {found}")
    capture = pop.capture
    cfg, M, B = pop.cfg, pop.members, pop.lanes
    T = capture["steps"][0]["plane_pre"].shape[1]
    dev = _device(on_card, peak)
    ctx = {"window": window, "network": capture["network"],
           "num_actions": pop.num_actions, "members": M, "lanes": B,
           "batch": cfg.learner.batch_size,
           "double_dqn": cfg.learner.double_dqn,
           "plane": (M, T, B, cfg.learner.batch_size),
           "device_name": dev["kind"]}
    pop.free()
    del pop
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    readings = judge.readings(capture, device=device)
    checks = _judge(readings, c["limits"])
    correct = (window["failed"] == 0 and window["error"] is None
               and bool(checks)
               and all(math.isfinite(ch["value"]) and ch["value"] <= ch["limit"]
                       for ch in checks.values()))
    result = {"correct": correct, "attempted": window["grad_steps"],
              "failed": window["failed"]}
    if trace:
        ctx.update(trace=traced, traced_iterations=traced_iters)
        metrics = {}
        for m in c["per_layer"]:
            value = cells.reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        dev.update(busy_s=traced.busy_s(), window_s=traced.wall_s)
        result.update(metrics=metrics, device=dev,
                      breakdown=traced.breakdown())
    else:
        values = {"env_steps_per_s": window["env_steps"] / window["wall_s"],
                  "peak_mem_gb": peak / 1e9,
                  "setup_s": t_window - _T0}
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in c["end_to_end"]}
        result.update(metrics=metrics, device=dev)
    if window["error"]:
        print(f"gpubench: a window chunk raised {window['error']}",
              file=sys.stderr)
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    _cache_dirs()
    sys.path.insert(0, str(ROOT))
    import torch

    from gpubench.harness import cell as cells
    if importlib.util.find_spec("dist_dqn_tpu_torch") is None:
        print("gpubench: no program to run (dist_dqn_tpu_torch is not in "
              "this checkout)", file=sys.stderr)
        return 2
    chips = cells.cell(args.workload)["entry"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"gpubench: the cell needs {chips} CUDA card(s); "
              f"cuda available {torch.cuda.is_available()}, "
              f"{torch.cuda.device_count()} card(s)", file=sys.stderr)
        return 2
    code = 0
    try:
        result = run_cell(args.workload, args.seed, args.seconds,
                          bool(args.trace))
    except Exception:           # noqa: BLE001 - every exit prints a line
        traceback.print_exc()
        code = 1
        result = {"correct": False, "attempted": 0, "failed": 0,
                  "metrics": {}, "device": {"platform": "gpu", "count": 1},
                  "checks": {}}
        try:
            result["device"] = _device(True,
                                       torch.cuda.max_memory_allocated())
        except Exception:       # noqa: BLE001 - the card itself failed
            pass
    found = banned_modules()
    if found:
        print(f"gpubench: loaded modules of JAX or the JAX package: {found}",
              file=sys.stderr)
        return 3
    for name, ch in result["checks"].items():
        print(f"check {name} {ch['value']!r} limit {ch['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return code


if __name__ == "__main__":
    sys.exit(main())
