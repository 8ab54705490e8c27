"""Device time by program span, from a profiler trace (``Trace``: device
events and host events, each a name, a start and an end in us).

The program names its layers with spans that the profiler records as
host ops (``dist_dqn_tpu_torch/utils/trace.py`` ``span``). A device event
belongs to the host call that launched it: on the program's one stream
the k-th device event, in start order, was enqueued by the k-th launch
call (``LAUNCH_CALLS``), in start order, on whichever thread made it. A
device event belongs to a span when its launch call starts inside one of
that span's intervals. Where the two counts differ the pairing is
unknown and every answer is None: nothing is guessed.

cuDNN runs a grouped convolution's groups on streams of its own, forked
from and joined to the program's stream inside the one call: their
events leave start order only among events of the same call, so of the
same span, and each span's set of events is the one the profiler's
correlation ids give. A span's device time is the union of its events'
intervals, the time the card was busy with the span's work: summed
durations would count the concurrent streams' overlap too.
"""
from __future__ import annotations

import bisect
from typing import Iterable, List, Optional, Tuple

from gpubench.arith.busy import busy_seconds

#: The runtime and driver calls that enqueue one device event each, as
#: the card's trace names them.
LAUNCH_CALLS = frozenset({
    "cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
    "cuLaunchKernelEx", "cudaMemcpyAsync", "cudaMemsetAsync"})

_cache: list = [None, None]       # the last trace paired, its pairs


def launch_pairs(trace
                 ) -> Optional[List[Tuple[float, Tuple[float, float]]]]:
    """(launch call's start, (device event's start, end)) in us for every
    device event of ``trace``, or None where the launch calls and the
    device events differ in number."""
    if _cache[0] is trace:
        return _cache[1]
    calls = sorted(s for name, s, _ in trace.host if name in LAUNCH_CALLS)
    device = sorted((s, e) for _, s, e in trace.device)
    pairs = None
    if calls and len(calls) == len(device):
        pairs = list(zip(calls, device))
    _cache[:] = [trace, pairs]
    return pairs


def _merged(intervals: Iterable[Tuple[float, float]]):
    out: List[List[float]] = []
    for start, end in sorted(intervals):
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], end)
        else:
            out.append([start, end])
    return out


def device_seconds(trace, spans: Iterable[str]) -> Optional[float]:
    """Seconds in which a device event launched inside the intervals of
    the named ``spans`` ran (the union of the events' intervals); None
    where no such span is in the trace or the launches cannot be
    paired."""
    names = set(spans)
    intervals = _merged((s, e) for name, s, e in trace.host
                        if name in names)
    if not intervals:
        return None
    pairs = launch_pairs(trace)
    if pairs is None:
        return None
    starts = [s for s, _ in intervals]
    mine = []
    for call, event in pairs:
        i = bisect.bisect_right(starts, call) - 1
        if i >= 0 and call <= intervals[i][1]:
            mine.append(event)
    return busy_seconds(mine)


def per_iteration_ms(ctx: dict, spans: Iterable[str]) -> Optional[float]:
    """A reader's value: the device ms of ``spans`` per traced fused
    iteration."""
    iters = ctx["traced_iterations"]
    seconds = device_seconds(ctx["trace"], spans)
    if seconds is None or not iters:
        return None
    return 1e3 * seconds / iters
