"""The readings the limits are set from, many seeds in one process.

    python3 gpubench/readings.py --workload apex.pop8 \
        --seeds 11,12,13 --control-seeds 11,12,13

For each seed: the cell's set-up at its own size (weights, fill, the
checked grad steps) and the check's numbers for the program; for the
control seeds also the numbers of the reference put in the program's
place in bfloat16 (a witness), in float8 (the control), with half the
batch left out, with its priorities doubled, and with every action
altered, and with member 0 given another member's learning rate or
discount (``gpubench/reference/judge.py`` ``control_readings``). One JSON
line per seed, then the summary: per number the largest program reading
and the smallest reading of each control and fault. The benchmark's own
runs never run this.
"""
import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--control-seeds", default="")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from gpubench.harness import cell as cells
    from gpubench.harness.population import Population
    from gpubench.reference import judge

    if args.device == "cuda" and not torch.cuda.is_available():
        print("gpubench: no CUDA card", file=sys.stderr)
        return 2
    c = cells.cell(args.workload)
    seeds = [int(s) for s in args.seeds.split(",")]
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    program, other = {}, {}
    for seed in seeds:
        t0 = time.perf_counter()
        pop = Population(c, seed, args.device)
        pop.fill()
        pop.check_steps()
        capture = pop.capture
        pop.free()
        del pop
        gc.collect()
        if args.device == "cuda":
            torch.cuda.empty_cache()
        setup = time.perf_counter() - t0
        detail = {}
        row = {"seed": seed, "setup_s": setup,
               "program": judge.readings(capture, device=args.device,
                                         detail=detail),
               "detail": detail}
        if seed in controls:
            row["witness_detail"] = {}
            row["in_place"] = judge.control_readings(
                capture, device=args.device, detail=row["witness_detail"])
        row["check_s"] = time.perf_counter() - t0 - setup
        print(json.dumps(row), flush=True)
        for k, v in row["program"].items():
            program[k] = max(program.get(k, 0.0), v)
        for kind, numbers in row.get("in_place", {}).items():
            for k, v in numbers.items():
                key = f"{kind}.{k}"
                other[key] = min(other.get(key, float("inf")), v)
    print(json.dumps({"workload": args.workload, "seeds": len(seeds),
                      "program_max": program, "in_place_min": other}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
