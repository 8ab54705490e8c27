"""The chip-time plane of the port (dist_dqn_tpu_torch/telemetry/devtime.py)
against the JAX package's (tests/test_devtime.py): the program table's
get-or-create identity, one-shot cost and snapshots, the registry-derived
learner MFU (absent without a known card peak), the utilization ledger's
conservation and clamping (its snapshots equal JAX's for the same inputs),
the device-memory sweep, on-demand profiles and the one-chunk profiler,
the host-replay runtime's summary census beside JAX's, and JAX's chaos
case: an injected evacuation stall lands in the ledger's ``evac_fence``."""
import json
import os
import time

import numpy as np
import pytest
import torch

from dist_dqn_tpu import config as jconfig
from dist_dqn_tpu.telemetry import devtime as jdevtime
from dist_dqn_tpu.telemetry.registry import Registry as JRegistry
from dist_dqn_tpu_torch import config as tconfig
from dist_dqn_tpu_torch.telemetry import collectors as tmc
from dist_dqn_tpu_torch.telemetry import devtime
from dist_dqn_tpu_torch.telemetry.exposition import render_prometheus
from dist_dqn_tpu_torch.telemetry.registry import Registry

H100 = "NVIDIA H100 80GB HBM3"


@pytest.fixture(autouse=True)
def _fresh_program_registry():
    """Tests below mutate the process-global registry (the loops use
    it); leave a clean one behind either way."""
    yield
    devtime.reset_program_registry()


@pytest.fixture
def h100(monkeypatch):
    """A CUDA device whose name is the H100's (the CPU has no peak)."""
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: H100)
    return torch.device("cuda", 0)


def _cost(flops=None, nbytes=None):
    return {"flops": flops, "bytes": nbytes}


def test_register_is_get_or_create_and_snapshots():
    reg = devtime.ProgramRegistry(metrics=Registry())
    rec = reg.register("p", loop="l", cost=_cost(100.0, 50.0), role="train")
    assert reg.register("p", loop="l") is rec
    assert reg.get("p", "l") is rec
    assert reg.get("p", "other") is None
    rec.count_dispatch(3)
    rec.add_device_seconds(0.5)
    snap = reg.snapshot("l")["p"]
    assert snap["flops"] == 100.0 and snap["bytes"] == 50.0
    assert snap["dispatches"] == 3.0
    assert snap["device_seconds"] == pytest.approx(0.5)
    assert snap["arith_intensity"] == pytest.approx(2.0)
    assert reg.snapshot("other") == {}
    # add_device_seconds ignores non-positive samples.
    rec.add_device_seconds(-1.0)
    assert rec.device_seconds == pytest.approx(0.5)


def test_attach_cost_is_one_shot_and_failures_degrade():
    reg = devtime.ProgramRegistry(metrics=Registry())
    rec = reg.register("p", loop="l")
    assert not rec.cost_attached

    def boom():
        raise RuntimeError("no census on this device")

    rec.attach_cost(boom)
    # A failed harvest still closes the one shot.
    assert rec.cost_attached and rec.flops is None and rec.bytes is None
    rec.attach_cost(_cost(1.0))
    assert rec.flops is None
    # Zero-arg callables returning a cost are unwrapped; the first
    # harvest wins and later attaches are ignored; a non-positive value
    # is unknown.
    rec2 = reg.register("q", loop="l", cost=lambda: _cost(7.0, 2.0))
    assert rec2.flops == 7.0
    rec2.attach_cost(_cost(999.0))
    assert rec2.flops == 7.0
    assert reg.register("z", loop="l", cost=_cost(0.0, 5.0)).flops is None


def test_learner_mfu_registry_derived_and_absent_on_cpu(h100):
    metrics = Registry()
    reg = devtime.reset_program_registry(metrics)
    rec = reg.register("train", loop="l", cost=_cost(1e12), role="train")
    other = reg.register("act", loop="l", cost=_cost(1e30), role="act")
    other.count_dispatch(5)
    other.add_device_seconds(3.0)

    # No device time on any role="train" record yet: underivable, and the
    # gauge stays ABSENT.
    assert devtime.set_learner_mfu("l", device=h100, reg=metrics) is None
    assert tmc.LEARNER_MFU not in render_prometheus(metrics)

    rec.count_dispatch(10)
    rec.add_device_seconds(1.0)
    # Only the role="train" census counts: 1e12 FLOPs x 10 execs over 1 s
    # against the H100's dense bf16 peak.
    want = (1e12 * 10) / 1.0 / 989.4e12
    assert reg.learner_mfu("l", device=h100) == pytest.approx(want)
    assert devtime.set_learner_mfu("l", device=h100, reg=metrics) \
        == pytest.approx(want)
    assert tmc.LEARNER_MFU in render_prometheus(metrics)
    # The CPU (no card peak) -> None; so is a process with no CUDA context.
    assert reg.learner_mfu("l", device=torch.device("cpu")) is None
    assert reg.learner_mfu("l") is None


def test_program_snapshots_equal_jax():
    """The same calls on both packages' program tables give the same
    snapshot (JAX's cost is a compiled program's census; the port's a
    cost dict) and the same registry series."""

    class _Compiled:
        def cost_analysis(self):
            return {"flops": 12.0, "bytes accessed": 48.0}

    regs = {"j": JRegistry(), "t": Registry()}
    snaps = {}
    for key, mod, cost in (("j", jdevtime, _Compiled()),
                           ("t", devtime, _cost(12.0, 48.0))):
        table = mod.ProgramRegistry(metrics=regs[key])
        rec = table.register("apex.train_scan", loop="apex", role="train",
                             execs_per_dispatch=4)
        rec.attach_cost(cost)
        act = table.register("apex.act", loop="apex", role="act")
        for _ in range(3):
            rec.count_dispatch()
            rec.add_device_seconds(0.25)
            act.count_dispatch()
        snaps[key] = table.snapshot("apex")
    assert snaps["t"] == snaps["j"]
    assert regs["t"].snapshot() == regs["j"].snapshot()


# ---------------------------------------------------------------------------
# UtilizationLedger


def test_ledger_conserves_wall_and_derives_other():
    led = devtime.UtilizationLedger("t", reg=Registry())
    out = led.observe_chunk(10.0, 4.0, sample=1.0, evac_fence=2.0)
    assert out["busy"] == 4.0
    assert out["other"] == pytest.approx(3.0)
    snap = led.snapshot()
    assert snap["chunks"] == 1.0
    total = snap["busy"] + sum(snap[c] for c in devtime.IDLE_CAUSES)
    assert total == pytest.approx(10.0)


def test_ledger_clamps_estimates():
    led = devtime.UtilizationLedger("t", reg=Registry())
    out = led.observe_chunk(1.0, 5.0, sample=3.0)
    assert out["busy"] == 1.0
    assert out["other"] == 0.0
    assert led.snapshot()["sample"] == pytest.approx(3.0)
    out = led.observe_chunk(-2.0, -1.0)
    assert out["wall"] == 0.0 and out["busy"] == 0.0


def test_ledger_snapshots_equal_jax():
    """Random chunks (busy over the wall, causes over-explaining it, the
    h2d bucket) through both packages' ledgers: equal breakdowns,
    snapshots and registry series."""
    assert devtime.IDLE_CAUSES == jdevtime.IDLE_CAUSES
    rng = np.random.default_rng(0)
    regs = {"j": JRegistry(), "t": Registry()}
    leds = {"j": jdevtime.UtilizationLedger("host_replay", regs["j"]),
            "t": devtime.UtilizationLedger("host_replay", regs["t"])}
    for _ in range(40):
        wall = float(rng.uniform(-0.1, 2.0))
        args = dict(busy_s=float(rng.uniform(-0.1, 2.5)),
                    sample=float(rng.uniform(0, 0.5)),
                    evac_fence=float(rng.uniform(-0.1, 0.5)),
                    prefetch_wait=float(rng.uniform(0, 0.5)),
                    h2d=float(rng.uniform(0, 0.2)))
        assert leds["t"].observe_chunk(wall, **args) == \
            leds["j"].observe_chunk(wall, **args)
    assert leds["t"].snapshot() == leds["j"].snapshot()
    assert regs["t"].snapshot() == regs["j"].snapshot()


# ---------------------------------------------------------------------------
# Device memory


class _Dev:
    def __init__(self, ident, stats):
        self.id = ident
        self._stats = stats

    def memory_stats(self):
        if isinstance(self._stats, Exception):
            raise self._stats
        return self._stats


def test_sweep_device_memory_none_partial_and_raising():
    metrics = Registry()
    devs = [
        _Dev(0, None),                          # reports nothing
        _Dev(1, {"bytes_in_use": 100, "bytes_limit": 400,
                 "weird": "not-a-number"}),     # partial + garbage kind
        _Dev(2, RuntimeError("no stats")),      # raises
    ]
    swept = devtime.sweep_device_memory(reg=metrics, devices=devs)
    assert set(swept) == {"1"}
    assert swept["1"]["bytes_in_use"] == 100.0
    assert swept["1"]["bytes_limit"] == 400.0
    assert "weird" not in swept["1"]
    assert swept["1"]["peak_bytes_in_use_seen"] >= 100.0
    rendered = render_prometheus(metrics)
    assert 'device="1"' in rendered
    assert 'device="0"' not in rendered and 'device="2"' not in rendered

    # The host-tracked high-water mark is monotone across sweeps.
    peak0 = swept["1"]["peak_bytes_in_use_seen"]
    swept2 = devtime.sweep_device_memory(
        reg=metrics, devices=[_Dev(1, {"bytes_in_use": 40})])
    assert swept2["1"]["peak_bytes_in_use_seen"] == peak0

    # No devices, or a process without a CUDA context (this CPU run):
    # nothing swept, no gauge.
    assert devtime.sweep_device_memory(reg=Registry(), devices=[]) == {}
    empty = Registry()
    assert devtime.sweep_device_memory(reg=empty) == {}
    assert tmc.DEVICE_MEMORY_BYTES not in render_prometheus(empty)


def test_cuda_memory_maps_the_allocator_onto_jax_kinds(monkeypatch):
    """The caching allocator's statistics under XLA's kind names, swept
    into the same series as JAX's for the same numbers."""
    stats = {"allocated_bytes.all.current": 3 << 30,
             "allocated_bytes.all.peak": 5 << 30,
             "reserved_bytes.all.current": 6 << 30}

    class _Props:
        total_memory = 80 << 30

    monkeypatch.setattr(torch.cuda, "memory_stats", lambda i: stats)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda i: _Props())
    want = {"bytes_in_use": 3 << 30, "peak_bytes_in_use": 5 << 30,
            "bytes_reserved": 6 << 30, "bytes_limit": 80 << 30}
    assert devtime._CudaMemory(0).memory_stats() == want
    regs = {"j": JRegistry(), "t": Registry()}
    got = devtime.sweep_device_memory(reg=regs["t"],
                                      devices=[devtime._CudaMemory(7)])
    jdevtime.sweep_device_memory(reg=regs["j"], devices=[_Dev(7, want)])
    assert got["7"]["peak_bytes_in_use_seen"] == 3 << 30
    assert regs["t"].snapshot() == regs["j"].snapshot()


# ---------------------------------------------------------------------------
# On-demand profiling


def test_capture_profile_writes_loadable_trace(tmp_path):
    out = devtime.capture_profile(0, base_dir=str(tmp_path))
    assert "error" not in out, out
    assert os.path.isdir(out["trace_dir"])
    assert out["files"] >= 1, "a trace window must land on disk"
    assert out["seconds"] == 0.0
    events = json.load(open(os.path.join(out["trace_dir"], "trace.json")))
    assert "traceEvents" in events
    # The HTTP handler passes the query value through as a string.
    out2 = devtime.capture_profile("0", base_dir=str(tmp_path))
    assert "error" not in out2 and out2["trace_dir"] != out["trace_dir"]
    assert devtime.capture_profile("nope")["error"].startswith("bad")


def test_capture_profile_is_serialized_and_lands_in_forensics_dir(
        tmp_path, monkeypatch):
    monkeypatch.setenv(devtime.FORENSICS_ENV, str(tmp_path))
    with devtime._profile_lock:
        assert devtime.capture_profile(0)["error"] == "busy"
    out = devtime.capture_profile(0)
    assert os.path.dirname(out["trace_dir"]) == str(tmp_path)


def test_capture_profile_records_other_threads(tmp_path):
    """A capture runs on the telemetry server's thread while the loop's
    thread computes: it records that thread's ops (profile_all_threads),
    not only its own, which torch.profiler's default config would."""
    import threading

    stop = threading.Event()
    ran = []

    def loop():
        a = torch.ones(32, 32)
        while not stop.is_set():
            torch.mm(a, a)
            ran.append(None)

    worker = threading.Thread(target=loop, daemon=True)
    worker.start()
    try:
        while not ran:
            pass
        out = devtime.capture_profile(0.3, base_dir=str(tmp_path))
    finally:
        stop.set()
        worker.join()
    assert "error" not in out, out
    with open(os.path.join(out["trace_dir"], "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    mm_threads = {e.get("tid") for e in events if e.get("name") == "aten::mm"}
    assert mm_threads, "the capture recorded none of the loop thread's ops"


def _hold_block(gate, entered, release):
    """A thread that sits inside one ``gate.work()`` block until
    ``release`` is set."""
    import threading

    def run():
        with gate.work():
            entered.set()
            release.wait(10)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    assert entered.wait(10)
    return t


def test_launch_gate_starts_between_other_threads_blocks():
    """quiet() waits for another thread's block to end, and a block
    entered while quiet() holds waits until it ends."""
    import threading

    gate = devtime.LaunchGate()
    entered, release = threading.Event(), threading.Event()
    holder = _hold_block(gate, entered, release)
    order = []

    def quiesce():
        with gate.quiet(10) as held:
            order.append(("quiet", held))
            later = threading.Thread(target=enter_later)
            later.start()
            time.sleep(0.2)
            order.append(("start done", None))
        later.join(10)

    def enter_later():
        with gate.work():
            order.append(("entered", None))

    q = threading.Thread(target=quiesce)
    q.start()
    time.sleep(0.2)
    assert order == [], "quiet() ran while another thread was in a block"
    release.set()
    q.join(10)
    holder.join(10)
    assert order == [("quiet", True), ("start done", None),
                     ("entered", None)]


def test_launch_gate_own_block_nesting_and_timeout():
    """The caller's own block does not hold quiet() up; a block held
    past the timeout yields False and leaves the gate open; a block that
    waits for another thread's block cannot deadlock."""
    import threading

    gate = devtime.LaunchGate()
    with gate.work():
        with gate.work():                 # nested: counted once
            with gate.quiet(1) as held:
                assert held
    entered, release = threading.Event(), threading.Event()
    holder = _hold_block(gate, entered, release)
    t0 = time.perf_counter()
    with gate.quiet(0.2) as held:
        assert not held
    assert time.perf_counter() - t0 >= 0.2
    with gate.work():                     # the gate stayed open
        pass
    release.set()
    holder.join(10)

    # A block waiting on another thread's block while quiet() waits.
    inner_done = threading.Event()

    def inner():
        with gate.work():
            inner_done.set()

    def outer():
        with gate.work():
            time.sleep(0.1)
            t = threading.Thread(target=inner)
            t.start()
            t.join(10)

    o = threading.Thread(target=outer)
    o.start()
    time.sleep(0.05)
    with gate.quiet(10) as held:
        assert held
    o.join(10)
    assert inner_done.is_set()


def test_launch_gate_stress_keeps_quiet_windows_empty():
    """Twelve threads entering and leaving blocks (some nested) under a
    short switch interval while another thread takes quiet windows: no
    block is open or entered during a held window, and the gate ends
    empty and open."""
    import sys
    import threading

    gate = devtime.LaunchGate()
    lock = threading.Lock()
    state = {"inside": 0, "entries": 0}
    stop = threading.Event()
    violations, windows = [], []

    def worker(nested):
        while not stop.is_set():
            with gate.work():
                with lock:
                    state["inside"] += 1
                    state["entries"] += 1
                if nested:
                    with gate.work():
                        pass
                with lock:
                    state["inside"] -= 1

    def quiesce():
        deadline = time.monotonic() + 1.5
        while time.monotonic() < deadline and len(windows) < 30:
            with gate.quiet(1.0) as held:
                if not held:
                    continue
                with lock:
                    before = dict(state)
                time.sleep(0.001)
                with lock:
                    after = dict(state)
                windows.append(1)
                if before["inside"] or after != before:
                    violations.append((before, after))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=worker, args=(i % 2,),
                                    daemon=True) for i in range(12)]
        for t in threads:
            t.start()
        q = threading.Thread(target=quiesce)
        q.start()
        q.join(20)
        stop.set()
        for t in threads:
            t.join(20)
    finally:
        sys.setswitchinterval(old)
    assert windows, "no quiet window was ever held"
    assert not violations, violations[:3]
    assert gate._active == 0 and not gate._closed


def test_capture_profile_waits_for_device_work(tmp_path, monkeypatch):
    """capture_profile starts its profiler only once the other threads'
    ``device_work`` blocks have ended; past QUIET_TIMEOUT_S it reports
    an error and leaves the block alone."""
    import threading

    entered, release = threading.Event(), threading.Event()
    holder = _hold_block(devtime._launch_gate, entered, release)
    monkeypatch.setattr(devtime, "QUIET_TIMEOUT_S", 0.2)
    out = devtime.capture_profile(0, base_dir=str(tmp_path))
    assert out["error"].startswith("start_trace failed"), out
    monkeypatch.setattr(devtime, "QUIET_TIMEOUT_S", 10.0)
    threading.Timer(0.3, release.set).start()
    t0 = time.perf_counter()
    out = devtime.capture_profile(0, base_dir=str(tmp_path))
    assert "error" not in out, out
    assert time.perf_counter() - t0 >= 0.25
    holder.join(10)


def test_one_chunk_profiler_is_one_shot(tmp_path):
    off = devtime.maybe_trace_first_chunk(None)
    assert off.start() is False and off.stop() is None
    one = devtime.maybe_trace_first_chunk(str(tmp_path))
    assert one.start() is True
    assert one.start() is False       # already open
    torch.ones(4).sum()
    assert one.stop() == str(tmp_path)
    assert one.profile is not None
    assert one.start() is False and one.stop() is None   # spent


# ---------------------------------------------------------------------------
# The host-replay runtime's census beside JAX's


_HOST_REPLAY = ["network.mlp_features=(32,)", "replay.capacity=4096",
                "replay.min_fill=64", "learner.batch_size=16",
                "actor.num_envs=8", "eval_every_steps=0"]


@pytest.mark.parametrize("kw", [dict(prioritized=True, pipeline=True),
                                dict(prioritized=False, pipeline=False,
                                     prefetch=False)],
                         ids=["per_pipelined", "uniform_serial"])
def test_host_replay_summary_census_matches_jax(kw, monkeypatch):
    """The twin of the census half of tests/test_devtime.py's host-replay
    case: the summary's ``programs`` name JAX's programs with JAX's
    dispatch counts (one train-step dispatch per grad step, one collect
    per chunk), the train program carries a census, its device seconds
    are the ledger's busy total, and ``chip_time`` has JAX's keys and
    conserves against the run wall."""
    from dist_dqn_tpu import host_replay_loop as jhrl
    from dist_dqn_tpu_torch import host_replay_loop as thrl

    monkeypatch.setattr(jdevtime, "_program_registry",
                        jdevtime.ProgramRegistry(JRegistry()))
    devtime.reset_program_registry(Registry())
    common = dict(total_env_steps=800, chunk_iters=50,
                  log_fn=lambda s: None, **kw)
    jout = jhrl.run_host_replay(
        jconfig.apply_overrides(jconfig.CONFIGS["cartpole"], _HOST_REPLAY),
        **common)
    tout = thrl.run_host_replay(
        tconfig.apply_overrides(tconfig.CONFIGS["cartpole"], _HOST_REPLAY),
        device="cpu", **common)
    jp, tp = jout["programs"], tout["programs"]
    assert set(tp) == set(jp) == {"host_replay.collect",
                                  "host_replay.train_step"}
    for name in tp:
        assert tp[name]["dispatches"] == jp[name]["dispatches"]
        assert set(tp[name]) >= set(jp[name]) - {"arith_intensity"}
    assert tp["host_replay.train_step"]["dispatches"] == tout["grad_steps"]
    assert tp["host_replay.train_step"]["flops"] > 0
    assert tp["host_replay.train_step"]["bytes"] > 0
    chip = tout["chip_time"]
    assert set(chip) == set(jout["chip_time"])
    assert chip["chunks"] == jout["chip_time"]["chunks"] == 2.0
    total = chip["busy"] + sum(chip[c] for c in devtime.IDLE_CAUSES)
    assert 0.0 < total <= tout["wall_s"] + 0.05
    assert tp["host_replay.train_step"]["device_seconds"] == \
        pytest.approx(chip["busy"])


@pytest.mark.chaos
def test_host_replay_chaos_evac_stall_lands_in_evac_fence():
    """Twin of tests/test_devtime.py:241: an injected ``evac.drain`` stall
    blocks the loop at the evac fence it already holds — the ledger must
    file that wait under ``evac_fence`` (not ``other``), the run's summary
    census must name both registered programs with dispatch counts, and
    the per-cause totals must conserve against the run wall."""
    from dist_dqn_tpu_torch import chaos
    from dist_dqn_tpu_torch import host_replay_loop as thrl

    devtime.reset_program_registry(Registry())
    plan = chaos.FaultPlan(seed=7, events=(
        chaos.FaultEvent("evac.drain", "stall", at_hit=2,
                         args={"delay_s": 0.8}),))
    cfg = tconfig.apply_overrides(tconfig.CONFIGS["cartpole"],
                                  _HOST_REPLAY + ["replay.prioritized=false"])
    with chaos.installed(plan, registry=Registry()) as inj:
        out = thrl.run_host_replay(cfg, total_env_steps=3200,
                                   chunk_iters=50, log_fn=lambda s: None,
                                   device="cpu")
    assert [e["seam"] for e in inj.injected] == ["evac.drain"]
    assert inj.open_trips() == []

    chip = out["chip_time"]
    assert chip["chunks"] == 8.0  # 3200 / (50 iters x 8 lanes)
    # The 0.8 s stall sat on the critical path at the fence; a tiny
    # CPU chunk has nowhere near that much pipeline slack to hide it.
    assert chip["evac_fence"] >= 0.4, chip
    # Conservation: the decomposition never exceeds the run wall and
    # busy never exceeds the decomposed total.
    total = chip["busy"] + sum(chip[c] for c in devtime.IDLE_CAUSES)
    assert 0.0 < total <= out["wall_s"] + 1e-6
    assert chip["busy"] <= total

    progs = out["programs"]
    assert set(progs) >= {"host_replay.collect",
                          "host_replay.train_step"}
    assert progs["host_replay.train_step"]["dispatches"] \
        == out["grad_steps"]
    # Train device-seconds were attributed at the existing fences and
    # reconcile with the ledger's busy total exactly (same samples).
    assert progs["host_replay.train_step"]["device_seconds"] \
        == pytest.approx(chip["busy"])
