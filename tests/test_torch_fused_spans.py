"""The fused loop's profiler spans (dist_dqn_tpu_torch/utils/trace.py
``span``): every layer boundary of ``run_chunk`` (train_loop.py), the
replay's draw, gather and write-back and the learner's forward, backward,
all-reduce and optimizer appear in a torch.profiler capture as ops, with
their counts per chunk, iteration, train event or grad step, each inside
its parent; nothing is recorded, and no number moves, without a profiler;
the service tracers' spans reach the same capture; ``--profile-dir`` rows
carry the per-span ``layers``; and the fused loop's utilization ledger
files the chunks a profiler measured, and those only."""
import json
from types import SimpleNamespace

import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from dist_dqn_tpu_torch import config as tconfig
from dist_dqn_tpu_torch import population as pop
from dist_dqn_tpu_torch.envs import make_env
from dist_dqn_tpu_torch.models import build_network, stack_networks
from dist_dqn_tpu_torch.parallel import distributed
from dist_dqn_tpu_torch.parallel.mesh import make_mesh
from dist_dqn_tpu_torch.telemetry import registry as tregistry
from dist_dqn_tpu_torch.train_loop import make_fused_train
from dist_dqn_tpu_torch.utils import trace
from dist_dqn_tpu_torch.utils.trace import (FUSED_SPANS, FlightTracer,
                                            NullTracer, SpanTracer)
from torch_parity import cli_rows

# A population of two on PixelCatch with frame-dedup storage and PER
# through the sampler kernel's plain version: a chunk of 16 iterations
# fills the ring to min_fill, and every second iteration then trains.
_CATCH = ["env_name=pixel_catch", "network.torso=small",
          "network.hidden=16", "network.compute_dtype=float32",
          "replay.capacity=512", "replay.min_fill=64",
          "learner.batch_size=8", "actor.num_envs=4", "train_every=2",
          "replay.frame_dedup=true", "population.size=2",
          'population.spec_json={"lr": [0.0001, 0.0002]}']
OPTIONS = {
    "per": ["replay.prioritized=true", "replay.pallas_sampler=true"],
    "per_ratio2": ["replay.prioritized=true", "replay.pallas_sampler=true",
                   "replay.updates_per_chunk=2"],
    "uniform": [],
}
SEEDS = [3, 4]
FILL_ITERS, ITERS = 16, 6

# span -> the span it lies in (fused.chunk has none).
PARENT = {"fused.act": "fused.chunk", "fused.env": "fused.chunk",
          "fused.ring_add": "fused.chunk", "fused.train": "fused.chunk",
          "fused.episode_stats": "fused.chunk",
          "replay.draw": "fused.train", "replay.gather": "fused.train",
          "replay.writeback": "fused.train",
          "learner.forward": "fused.train", "learner.backward": "fused.train",
          "learner.allreduce": "fused.train",
          "learner.optimizer": "fused.train"}


def _population(option):
    cfg = tconfig.apply_overrides(tconfig.CONFIGS["atari"],
                                  _CATCH + OPTIONS[option])
    env = make_env(cfg.env_name, device="cpu")
    nets = [build_network(cfg.network, env.num_actions,
                          env.observation_shape, device="cpu", seed=s)
            for s in SEEDS]
    init, run = pop.make_population_train(cfg, env, stack_networks(nets),
                                          device="cpu")
    carry, metrics = run(init(SEEDS), FILL_ITERS)
    assert metrics["grad_steps_in_chunk"] == 0
    return cfg, carry, run


def _spans(prof):
    """{span name: [event, ...]} of a capture, in start order."""
    out = {}
    for e in prof.events():
        if e.name in FUSED_SPANS:
            out.setdefault(e.name, []).append(e)
    for events in out.values():
        events.sort(key=lambda e: e.time_range.start)
    return out


@pytest.fixture(scope="module", params=list(OPTIONS))
def captured(request):
    """One profiled chunk of ``ITERS`` iterations after the fill: the
    option, its config, the capture's spans and the chunk's metrics."""
    cfg, carry, run = _population(request.param)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        carry, metrics = run(carry, ITERS)
    return request.param, cfg, _spans(prof), metrics


def _expected_counts(cfg, grad_steps: int) -> dict:
    ratio = cfg.replay.updates_per_chunk
    events = grad_steps // ratio
    counts = {"fused.chunk": 1, "fused.act": ITERS, "fused.env": ITERS,
              "fused.ring_add": ITERS, "fused.episode_stats": ITERS,
              "fused.train": events, "replay.draw": grad_steps,
              "replay.gather": grad_steps, "learner.forward": grad_steps,
              "learner.backward": grad_steps,
              "learner.optimizer": grad_steps}
    if cfg.replay.prioritized:
        # After every grad step, or once per event under a ratio above 1.
        counts["replay.writeback"] = events if ratio > 1 else grad_steps
    return counts


def test_each_span_appears_with_its_count(captured):
    option, cfg, spans, metrics = captured
    grad_steps = metrics["grad_steps_in_chunk"]
    assert grad_steps == ITERS // 2 * cfg.replay.updates_per_chunk
    got = {name: len(events) for name, events in spans.items()}
    assert got == _expected_counts(cfg, grad_steps), option


def test_each_span_lies_inside_its_parent(captured):
    _, _, spans, _ = captured
    for name, events in spans.items():
        if name == "fused.chunk":
            continue
        parents = spans[PARENT[name]]
        for e in events:
            assert any(p.time_range.start <= e.time_range.start
                       and e.time_range.end <= p.time_range.end
                       for p in parents), (name, e.time_range)


def test_spans_are_host_ops_not_user_annotations(captured):
    _, _, spans, _ = captured
    for events in spans.values():
        for e in events:
            assert not e.is_user_annotation
            assert e.device_type == DeviceType.CPU


def test_no_span_is_recorded_without_a_profiler(monkeypatch):
    """Without a profiler ``span`` hands back the shared no-op and never
    opens the profiler's range; under one it opens one per call."""
    assert trace.span("fused.act") is trace._NO_SPAN
    recording, op_range = trace._profiler
    opened = []

    def spy(name):
        opened.append(name)
        return op_range(name)

    monkeypatch.setattr(trace, "_profiler", (recording, spy))
    _, carry, run = _population("per")
    run(carry, 2)
    assert opened == []
    with profile(activities=[ProfilerActivity.CPU]):
        run(carry, 2)
    assert opened.count("fused.chunk") == 1
    assert opened.count("learner.forward") == 1


def test_profiler_changes_no_bit_of_the_chunk():
    """The same chunk, with and without a profiler: equal losses,
    priority planes, running maxes and parameters, bit for bit."""
    out = []
    for traced in (False, True):
        _, carry, run = _population("per")
        if traced:
            with profile(activities=[ProfilerActivity.CPU]):
                carry, metrics = run(carry, ITERS)
        else:
            carry, metrics = run(carry, ITERS)
        out.append((metrics["loss"], carry.replay.priorities,
                    carry.replay.max_priority,
                    [p.detach() for p in carry.learner.net.parameters()]))
    (loss_a, plane_a, max_a, params_a), (loss_b, plane_b, max_b,
                                         params_b) = out
    assert torch.equal(loss_a, loss_b)
    assert torch.equal(plane_a, plane_b)
    assert torch.equal(max_a, max_b)
    assert all(torch.equal(a, b) for a, b in zip(params_a, params_b))


@pytest.fixture
def solo_mesh():
    """A gloo group of one rank in this process."""
    distributed.initialize(f"127.0.0.1:{distributed.free_port()}", 1, 0,
                           device="cpu", timeout_s=60.0)
    try:
        yield make_mesh()
    finally:
        distributed.shutdown()


def test_solo_mesh_step_opens_the_allreduce_span(solo_mesh):
    """A solo learner on a mesh (train_step): the same spans, and the
    gradient all-reduce in ``learner.allreduce`` once per grad step,
    between the backward and the optimizer."""
    cfg = tconfig.apply_overrides(tconfig.CONFIGS["cartpole"], [
        "network.mlp_features=(16,)", "replay.capacity=1024",
        "replay.min_fill=64", "learner.batch_size=16", "actor.num_envs=8",
        "replay.prioritized=true", "replay.pallas_sampler=true"])
    env = make_env(cfg.env_name, device="cpu")
    net = build_network(cfg.network, env.num_actions, env.observation_shape,
                        device="cpu", seed=cfg.seed)
    init, run = make_fused_train(cfg, env, net, device="cpu",
                                 axis=solo_mesh, num_shards=1)
    carry, _ = run(init(cfg.seed), 8)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        carry, metrics = run(carry, 4)
    spans = _spans(prof)
    steps = metrics["grad_steps_in_chunk"]
    assert steps == 4
    counts = {name: len(events) for name, events in spans.items()}
    assert counts == {**{n: 4 for n in FUSED_SPANS}, "fused.chunk": 1}
    for back, reduce, opt in zip(spans["learner.backward"],
                                 spans["learner.allreduce"],
                                 spans["learner.optimizer"]):
        assert (back.time_range.end <= reduce.time_range.start
                <= reduce.time_range.end <= opt.time_range.start)


@pytest.mark.parametrize("tracer", ["span", "flight", "null"])
def test_service_tracer_spans_reach_the_profiler(tracer, tmp_path):
    """Every tracer's ``span`` opens the same profiler span, so a
    ``--profile-dir`` or ``/debug/profile`` capture of the service names
    its spans, as ops."""
    make = {"span": lambda: SpanTracer(str(tmp_path / "t.json"),
                                       registry=tregistry.Registry()),
            "flight": lambda: FlightTracer(),
            "null": lambda: NullTracer()}[tracer]
    tr = make()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tr.span("replay.sample", batch=16):
            torch.ones(4).sum()
    tr.close()
    found = [e for e in prof.events() if e.name == "replay.sample"]
    assert len(found) == 1 and not found[0].is_user_annotation


def test_profile_row_carries_the_layers_on_cpu(capsys, tmp_path):
    """``--profile-dir``'s row names every span of the traced chunk with
    its host self ms; device ms are the card's alone."""
    from dist_dqn_tpu_torch.train import main

    main(["--config", "cartpole", "--device", "cpu",
          "--total-env-steps", "240", "--chunk-iters", "20",
          "--eval-every-steps", "0", "--profile-dir", str(tmp_path),
          "--set", "network.mlp_features=(16,)",
          "--set", "replay.min_fill=32", "--set", "replay.prioritized=true",
          "--set", "replay.pallas_sampler=true",
          "--set", "learner.batch_size=16", "--set", "actor.num_envs=4"])
    row = [r for r in cli_rows(capsys.readouterr().out)
           if "profile_trace" in r][0]
    want = set(FUSED_SPANS) - {"learner.allreduce"}
    assert set(row["layers"]) == want
    for layer in row["layers"].values():
        assert set(layer) == {"host_self_ms"}
        assert layer["host_self_ms"] >= 0
    assert "device_busy_s" not in row
    names = {e["name"] for e in json.loads(
        (tmp_path / "trace.json").read_text())["traceEvents"]}
    assert want <= names


def _event(name, start, end, device_us=0.0, kind=DeviceType.CPU):
    return SimpleNamespace(name=name, device_type=kind,
                           time_range=SimpleNamespace(start=start, end=end),
                           self_device_time_total=device_us)


def test_layers_take_kernel_time_by_start_across_threads():
    """On the card a span's device ms is the kernel time of every op that
    starts inside its intervals, whichever thread ran it: a backward op
    of autograd's thread counts for ``learner.backward``, and a parent
    span holds its children's time."""
    from dist_dqn_tpu_torch.train import _layers

    events = [
        _event("fused.train", 0, 100),
        _event("learner.forward", 10, 40),
        _event("aten::conv2d", 12, 30, device_us=500.0),
        _event("learner.backward", 50, 90),
        # Autograd's device thread, while the caller waits in the span.
        _event("autograd::engine::evaluate_function", 55, 80,
               device_us=700.0),
        _event("aten::add", 95, 96, device_us=20.0),
        _event("aten::zeros", 120, 121, device_us=9.0),
        _event("kernel", 56, 70, kind=DeviceType.CUDA),
    ]
    averages = [SimpleNamespace(key=name, self_cpu_time_total=1000.0)
                for name in ("fused.train", "learner.forward",
                             "learner.backward", "aten::add")]
    prof = SimpleNamespace(events=lambda: events)
    layers = _layers(prof, averages, on_card=True)
    assert layers == {
        "fused.train": {"host_self_ms": 1.0, "device_ms": 1.22},
        "learner.forward": {"host_self_ms": 1.0, "device_ms": 0.5},
        "learner.backward": {"host_self_ms": 1.0, "device_ms": 0.7}}
    assert _layers(prof, averages, on_card=False)["learner.backward"] == {
        "host_self_ms": 1.0}


@pytest.mark.parametrize("busy", [None, 0.25], ids=["unmeasured",
                                                     "profiled"])
def test_fused_ledger_files_measured_chunks_only(busy, monkeypatch):
    """A chunk files its profiler-measured busy seconds and its idle rest
    in the ledger; an unmeasured chunk files nothing there (its wall is
    the host's, not the card's). Either way the chunk program counts its
    dispatch and dispatch-to-fence seconds."""
    from dist_dqn_tpu_torch.telemetry import devtime
    from dist_dqn_tpu_torch.train import _FusedTelemetry

    reg = tregistry.Registry()
    monkeypatch.setattr(tregistry, "_default_registry", reg)
    monkeypatch.setattr(devtime, "_program_registry",
                        devtime.ProgramRegistry(reg))
    tm = _FusedTelemetry(tconfig.CONFIGS["cartpole"])
    tm.observe_device(1.0, torch.device("cpu"), busy)
    snap = tm.ledger.snapshot()
    if busy is None:
        assert snap["chunks"] == 0 and snap["busy"] == 0 == snap["other"]
    else:
        assert snap["chunks"] == 1
        assert snap["busy"] == busy and snap["other"] == 1.0 - busy
    assert tm.program.dispatches == 1 and tm.program.device_seconds == 1.0
