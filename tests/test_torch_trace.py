"""Host-loop tracing of the port (dist_dqn_tpu_torch/utils/trace.py)
against the JAX package's (tests/test_trace.py): span, instant and counter
recording in the Chrome trace-event format, the streamed flush, the inert
twin, the registry mirror, and the service's spans, whose names equal the
JAX service's on the same tiny run. ``--trace-path`` writes the apex
runtime's trace and is ignored by the fused runtime, as in the JAX CLI."""
import json
import os
import subprocess
import sys
import threading

import pytest

from dist_dqn_tpu.telemetry import registry as jregistry
from dist_dqn_tpu.utils import trace as jtrace
from dist_dqn_tpu_torch.telemetry import registry as tregistry
from dist_dqn_tpu_torch.utils.trace import (SPAN_BUCKETS, NullTracer,
                                            SpanTracer, make_tracer)
from torch_parity import cli_rows

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_span_tracer_records_chrome_events(tmp_path):
    path = str(tmp_path / "trace.json")
    tr = SpanTracer(path, process_name="test-proc")
    with tr.span("outer", batch=4):
        with tr.span("inner"):
            pass
    tr.instant("marker", reason="x")
    tr.counter("replay_size", 123.0)
    tr.close()

    events = json.load(open(path))
    by_name = {e["name"]: e for e in events}
    assert by_name["process_name"]["args"]["name"] == "test-proc"
    outer, inner = by_name["outer"], by_name["inner"]
    assert outer["ph"] == inner["ph"] == "X"
    assert outer["args"]["batch"] == 4
    # Nesting: inner lies within outer on the same thread track.
    assert outer["ts"] <= inner["ts"]
    assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"] + 1e-3
    assert outer["tid"] == inner["tid"] == threading.get_ident()
    assert by_name["marker"]["ph"] == "i"
    assert by_name["replay_size"]["ph"] == "C"
    assert by_name["replay_size"]["args"]["value"] == 123.0


def test_span_tracer_is_exception_safe(tmp_path):
    tr = SpanTracer(str(tmp_path / "t.json"))
    try:
        with tr.span("failing"):
            raise RuntimeError("boom")
    except RuntimeError:
        pass
    tr.close()
    events = json.load(open(tr.path))
    assert any(e["name"] == "failing" and "dur" in e for e in events)


def test_flush_is_incremental_and_memory_bounded(tmp_path):
    """Each flush appends only NEW events; the buffer is cleared, and an
    unterminated (crashed-run) file still exposes every flushed event."""
    tr = SpanTracer(str(tmp_path / "t.json"))
    with tr.span("a"):
        pass
    tr.flush()
    assert tr._events == []
    size1 = len(open(tr.path).read())
    tr.flush()  # nothing new: no growth
    assert len(open(tr.path).read()) == size1
    with tr.span("b"):
        pass
    tr.flush()
    events = json.loads(open(tr.path).read() + "]")
    assert {"a", "b"} <= {e["name"] for e in events}
    tr.close()
    events = json.load(open(tr.path))
    assert {"a", "b"} <= {e["name"] for e in events}
    tr.close()  # idempotent


def test_make_tracer_disabled_is_noop():
    tr = make_tracer(None)
    assert isinstance(tr, NullTracer) and not tr.enabled
    with tr.span("x"):
        tr.counter("y", 1.0)
    tr.close()  # no file side effects


def test_same_events_and_registry_mirror_as_jax(tmp_path):
    """The same calls on both packages' tracers write the same events but
    for the clock (names, phases, args, the process name) and mirror into
    the same registry series: a span histogram per span name with JAX's
    buckets, a gauge per counter track."""
    assert SPAN_BUCKETS == jtrace.SPAN_BUCKETS
    regs = {"j": jregistry.Registry(), "t": tregistry.Registry()}
    out = {}
    for key, cls in (("j", jtrace.SpanTracer), ("t", SpanTracer)):
        tr = cls(str(tmp_path / f"{key}.json"), process_name="apex-learner",
                 registry=regs[key])
        with tr.span("replay.sample", batch=16):
            pass
        tr.instant("ingest_stalled", silent_s=1.5)
        tr.counter("env_steps", 800)
        tr.close()
        out[key] = [{k: v for k, v in e.items()
                     if k not in ("ts", "dur", "pid", "tid")}
                    for e in json.load(open(tmp_path / f"{key}.json"))]
    assert out["t"] == out["j"]
    jsnap, tsnap = regs["j"].snapshot(), regs["t"].snapshot()
    assert set(tsnap) == set(jsnap) == {
        "dqn_host_span_seconds{span=replay.sample}",
        "dqn_trace_counter{counter=env_steps}"}
    assert tsnap["dqn_trace_counter{counter=env_steps}"]["value"] == 800
    assert tsnap["dqn_host_span_seconds{span=replay.sample}"]["count"] == 1


def _service_trace_names(pkg: str, path) -> list:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "tests",
                                      "torch_telemetry_workers.py"), pkg,
         str(path)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])["trace_names"]


def test_apex_service_writes_trace(tmp_path):
    """The twin of tests/test_trace.py's service case: one actor, 800
    CartPole steps with ``trace_path``, in each package's service; the
    port's trace loads as JSON and names the same spans and counter
    tracks as the JAX service's."""
    want = _service_trace_names("jax", tmp_path / "j.json")
    got = _service_trace_names("torch", tmp_path / "t.json")
    assert got == want
    assert {"ingest.shm_record", "replay.sample", "train_step.dispatch",
            "replay.update_priorities", "act.batched",
            "priority.actor_insert", "replay_size",
            "env_steps"} <= set(got)


_CLI_TINY = ["--device", "cpu", "--eval-every-steps", "0",
             "--set", "network.mlp_features=(16,)",
             "--set", "replay.min_fill=64", "--set", "learner.batch_size=16"]


@pytest.mark.parametrize("runtime", ["fused", "apex"])
def test_train_cli_trace_path(runtime, tmp_path, capfd):
    """``--trace-path`` writes the apex runtime's host-loop trace; the
    fused runtime runs as it would without it and writes nothing, as the
    JAX CLI does (it hands the path to the apex service alone)."""
    from dist_dqn_tpu_torch.train import main

    path = tmp_path / "trace.json"
    argv = ["--config", "cartpole", "--runtime", runtime, *_CLI_TINY,
            "--trace-path", str(path)]
    if runtime == "fused":
        main([*argv, "--total-env-steps", "800", "--chunk-iters", "50",
              "--set", "actor.num_envs=8"])
        rows = cli_rows(capfd.readouterr().out)
        assert rows[-1]["env_frames"] == 800
        assert not path.exists()
        return
    main([*argv, "--host-env", "CartPole-v1", "--num-actors", "1",
          "--envs-per-actor", "4", "--total-env-steps", "400"])
    summary = json.loads(capfd.readouterr().out.strip().splitlines()[-1])
    assert summary["env_steps"] >= 400
    assert summary["programs"]["apex.act"]["dispatches"] > 0
    names = {e["name"] for e in json.load(open(path))}
    assert {"process_name", "act.batched", "ingest.shm_record"} <= names
