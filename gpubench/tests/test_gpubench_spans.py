"""Device time by program span (gpubench/arith/spans.py) and its five
readers, on synthetic traces: launches paired with device events in
start order whatever thread launched them, nested spans counted for the
spans named only, concurrent streams' events counted once, and nothing
read where the counts differ or the program has no spans."""
from _small import ROOT  # noqa: F401

import pytest

from gpubench.arith import spans
from gpubench.harness import cell as cells
from gpubench.harness.trace import Trace

READERS = {"acting_ms": ("fused.act", "fused.env", "fused.episode_stats"),
           "replay_ms": ("fused.ring_add", "replay.draw", "replay.gather",
                         "replay.writeback"),
           "learner_fwd_ms": ("learner.forward",),
           "learner_bwd_ms": ("learner.backward",),
           "learner_opt_ms": ("learner.optimizer",)}


def _iteration(t0: float):
    """One fused iteration's host and device events from ``t0`` us: every
    reader's spans, each launching one kernel of a known length, the
    backward's from autograd's thread (an op of its own, inside the
    caller's wait in ``learner.backward``)."""
    host, device = [], []
    t = t0

    def span(name: str, length: float, op=None):
        nonlocal t
        host.append((name, t, t + 5 + length))
        if op:
            host.append((op, t + 0.5, t + 4))
        host.append(("cudaLaunchKernel", t + 1, t + 3))
        device.append((name + ".kernel", t + 5, t + 5 + length))
        t += 5 + length

    span("fused.act", 10)
    span("fused.env", 2)
    span("fused.ring_add", 1)
    train = t
    span("replay.draw", 3)
    span("replay.gather", 4)
    span("learner.forward", 30, op="aten::conv2d")
    span("learner.backward", 20, op="autograd::engine::evaluate_function")
    span("learner.optimizer", 6)
    span("replay.writeback", 2)
    host.append(("fused.train", train, t))
    span("fused.episode_stats", 1)
    return host, device, t


def _trace(iterations: int = 3) -> Trace:
    host, device, t = [("fused.chunk", 0.0, 0.0)], [], 0.0
    for _ in range(iterations):
        h, d, t = _iteration(t)
        host += h
        device += d
    host[0] = ("fused.chunk", 0.0, t + 10)
    # The chunk's exit: one launch outside every reader's span.
    host.append(("cudaMemsetAsync", t + 1, t + 2))
    device.append(("Memset (Device)", t + 4, t + 5))
    return Trace(device, host, (t + 10) / 1e6)


# Kernel us of one iteration per reader.
WANT_US = {"acting_ms": 10 + 2 + 1, "replay_ms": 1 + 3 + 4 + 2,
           "learner_fwd_ms": 30, "learner_bwd_ms": 20, "learner_opt_ms": 6}


@pytest.mark.parametrize("metric", sorted(READERS))
def test_readers_give_device_ms_per_iteration(metric):
    ctx = {"trace": _trace(3), "traced_iterations": 3}
    assert cells.reader(metric)(ctx) == pytest.approx(WANT_US[metric] / 1e3)


def test_the_readers_cover_the_busy_time_but_the_chunks_exit():
    trace = _trace(4)
    ctx = {"trace": trace, "traced_iterations": 4}
    total_s = sum(cells.reader(m)(ctx) for m in READERS) * 4 / 1e3
    assert total_s == pytest.approx(trace.busy_s() - 1e-6)


def test_pairing_is_in_start_order_across_threads():
    """Launch calls pair with device events by rank in start order, not
    by the thread or op around them: here the backward's launch, made on
    autograd's thread, starts inside ``learner.backward``."""
    host = [("learner.backward", 10.0, 50.0),
            ("autograd::engine::evaluate_function", 12.0, 40.0),
            ("cudaLaunchKernel", 15.0, 16.0),
            ("learner.forward", 0.0, 9.0),
            ("cudaLaunchKernelExC", 2.0, 3.0)]
    device = [("wgrad", 30.0, 37.0), ("fprop", 5.0, 25.0)]
    trace = Trace(device, host, 1e-4)
    assert spans.launch_pairs(trace) == [(2.0, (5.0, 25.0)),
                                         (15.0, (30.0, 37.0))]
    assert spans.device_seconds(trace, ["learner.forward"]) == 20e-6
    assert spans.device_seconds(trace, ["learner.backward"]) == 7e-6


def test_nested_spans_count_for_the_spans_named_only():
    """A launch in ``replay.gather`` inside ``fused.train`` counts for
    either name asked, and for no sibling."""
    host = [("fused.train", 0.0, 100.0), ("replay.gather", 10.0, 20.0),
            ("cudaLaunchKernel", 12.0, 13.0),
            ("learner.forward", 30.0, 40.0),
            ("cudaLaunchKernel", 32.0, 33.0),
            ("cudaLaunchKernel", 90.0, 91.0)]
    device = [("gather", 14.0, 18.0), ("fwd", 34.0, 44.0),
              ("sum", 92.0, 93.0)]
    trace = Trace(device, host, 1e-4)
    assert spans.device_seconds(trace, ["replay.gather"]) == 4e-6
    assert spans.device_seconds(trace, ["learner.forward"]) == 10e-6
    assert spans.device_seconds(trace, ["fused.train"]) == 15e-6
    assert spans.device_seconds(trace, ["replay.draw"]) is None


def test_concurrent_streams_count_once():
    """Two events of one call on two streams (cuDNN's grouped
    convolution) overlap: the span's time is their union."""
    host = [("learner.forward", 0.0, 10.0),
            ("cudaLaunchKernel", 1.0, 2.0), ("cudaLaunchKernel", 3.0, 4.0)]
    device = [("group0", 5.0, 25.0), ("group1", 6.0, 20.0)]
    trace = Trace(device, host, 1e-4)
    assert spans.device_seconds(trace, ["learner.forward"]) == 20e-6


def test_a_count_mismatch_reads_nothing():
    trace = _trace(2)
    short = Trace(trace.device[:-1], trace.host, trace.wall_s)
    assert spans.launch_pairs(short) is None
    ctx = {"trace": short, "traced_iterations": 2}
    assert all(cells.reader(m)(ctx) is None for m in READERS)


def test_a_device_event_named_like_a_span_is_a_mismatch():
    """A span mirrored onto the device track (a user annotation) is a
    CUDA-typed event no launch call enqueued: the counts differ, and
    nothing is read."""
    trace = _trace(2)
    mirrored = Trace(trace.device + [("learner.forward", 40.0, 80.0)],
                     trace.host, trace.wall_s)
    ctx = {"trace": mirrored, "traced_iterations": 2}
    assert all(cells.reader(m)(ctx) is None for m in READERS)


def test_a_program_without_spans_reads_nothing():
    """The parent's program has no spans: every reader is silent, and
    none raises."""
    trace = _trace(2)
    bare = Trace(trace.device, [e for e in trace.host
                                if e[0] in spans.LAUNCH_CALLS], trace.wall_s)
    ctx = {"trace": bare, "traced_iterations": 2}
    assert all(cells.reader(m)(ctx) is None for m in READERS)
    empty = {"trace": Trace([], [], 0.0), "traced_iterations": 0}
    assert all(cells.reader(m)(empty) is None for m in READERS)


def test_readers_read_the_spans_they_name():
    import importlib.util

    for metric, names in READERS.items():
        path = ROOT / "gpubench" / "metrics" / f"{metric}.py"
        spec = importlib.util.spec_from_file_location("m_" + metric, path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        assert module.SPANS == names
