"""A torch.profiler capture of a stretch of chunks, reduced to plain
events: the device's (kernels, copies, memsets) and the host's ops."""
from __future__ import annotations

import time
from typing import Callable, List, NamedTuple, Tuple

import torch

from gpubench.arith.busy import busy_seconds, idle_gaps

Event = Tuple[str, float, float]          # name, start us, end us
# A kernel's name in the breakdown is cut to this many characters (a
# template instantiation's can run to thousands).
NAME_CHARS = 160


class Trace(NamedTuple):
    device: List[Event]
    host: List[Event]
    wall_s: float

    def busy_s(self) -> float:
        return busy_seconds((s, e) for _, s, e in self.device)

    def breakdown(self, top: int = 10) -> dict:
        """The device ops that took most time (summed by name), and the
        longest idle gaps, each named by the innermost host op running
        across its middle."""
        by_name = {}
        for name, s, e in self.device:
            by_name[name] = by_name.get(name, 0.0) + (e - s) / 1e6
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(idle_gaps((s, e) for _, s, e in self.device),
                      key=lambda g: g[0] - g[1])[:top]
        named = []
        for start, end in gaps:
            mid = (start + end) / 2
            around = [(e - s, n) for n, s, e in self.host if s <= mid <= e]
            named.append([min(around)[1] if around else "host",
                          (end - start) / 1e6])
        return {"device_ops": [[n[:NAME_CHARS], v] for n, v in ops],
                "idle_gaps": [[n[:NAME_CHARS], v] for n, v in named]}


def profile(fn: Callable[[], None]) -> Trace:
    """Run ``fn`` under torch.profiler (host and device) and reduce the
    trace."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as torch_profile

    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    device, host = [], []
    for e in prof.events():
        item = (e.name, e.time_range.start, e.time_range.end)
        (device if e.device_type == DeviceType.CUDA else host).append(item)
    return Trace(device, host, wall)
