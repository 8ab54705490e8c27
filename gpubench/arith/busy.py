"""The device's busy time from a profiler trace: the union of the
intervals of its events (kernels, copies, memsets).

A frozen copy of the port's ``train.py`` ``_busy_seconds``, over plain
(start, end) pairs in microseconds.
"""
from __future__ import annotations

from typing import Iterable, List, Tuple


def busy_seconds(spans: Iterable[Tuple[float, float]]) -> float:
    """Seconds in which at least one of ``spans`` (start, end in us) was
    running; 0.0 for none."""
    busy_us, reach = 0.0, float("-inf")
    for start, end in sorted(spans):      # by start: count only new time
        busy_us += max(0.0, end - max(start, reach))
        reach = max(reach, end)
    return busy_us / 1e6


def idle_gaps(spans: Iterable[Tuple[float, float]]
              ) -> List[Tuple[float, float]]:
    """The gaps (start, end in us) between the union of ``spans``, in
    time order."""
    gaps, reach = [], None
    for start, end in sorted(spans):
        if reach is not None and start > reach:
            gaps.append((reach, start))
        reach = end if reach is None else max(reach, end)
    return gaps
