"""Device time of a torch.profiler Chrome trace, grouped by launch grid.

    python -m dist_dqn_tpu_torch.utils.trace_grids TRACE [--top N]
        [--grid X,Y,Z ...]

``TRACE`` is the ``trace.json`` (or ``trace.json.gz``) that ``train
--profile-dir`` writes. The ops table (``ops.txt``) sums kernels by name,
and one elementwise kernel name serves tensors of every size; the launch
grid tells them apart, so an op over one tensor shape (the C51
projection's ``[B, M, M]`` weight, the quantile loss's ``[B, N, M]``
tensors) can be found by the grids its kernels launch with. Prints the
total device time, the ``N`` grids with the most device time, and with
``--grid`` the sum over the given grids.
"""
from __future__ import annotations

import argparse
import collections
import gzip
import json
from typing import Dict, Iterable, List, Tuple

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def load_device_events(path: str) -> List[dict]:
    """The trace's device events: kernels, copies and memsets."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        trace = json.load(f)
    return [e for e in trace["traceEvents"]
            if e.get("cat") in DEVICE_CATEGORIES]


def by_grid(events: Iterable[dict]) -> Dict[Tuple, Tuple[int, float]]:
    """grid (tuple, or None for copies and memsets) -> (launches, µs)."""
    out = collections.defaultdict(lambda: [0, 0.0])
    for e in events:
        grid = e.get("args", {}).get("grid")
        key = tuple(grid) if grid is not None else None
        out[key][0] += 1
        out[key][1] += e["dur"]
    return {k: (n, us) for k, (n, us) in out.items()}


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("trace")
    parser.add_argument("--top", type=int, default=10)
    parser.add_argument("--grid", action="append", default=[],
                        help="X,Y,Z: add this grid's kernels to the sum")
    args = parser.parse_args(argv)
    events = load_device_events(args.trace)
    total = sum(e["dur"] for e in events)
    grids = by_grid(events)
    print(json.dumps({"device_events": len(events), "device_us": total}))
    for grid, (n, us) in sorted(grids.items(), key=lambda kv: -kv[1][1])[
            :args.top]:
        print(json.dumps({"grid": grid, "launches": n, "device_us": us,
                          "share": us / total}))
    if args.grid:
        chosen = [tuple(int(x) for x in g.split(",")) for g in args.grid]
        n = sum(grids.get(g, (0, 0.0))[0] for g in chosen)
        us = sum(grids.get(g, (0, 0.0))[1] for g in chosen)
        print(json.dumps({"grids": chosen, "launches": n, "device_us": us,
                          "share": us / total}))


if __name__ == "__main__":
    main()
