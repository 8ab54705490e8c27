"""Chip-time attribution plane of the port (twin of
``dist_dqn_tpu/telemetry/devtime.py``): per-program device-time ledger,
utilization decomposition, on-demand profiling, device-memory telemetry.

``ProgramRegistry``
    Process-wide table of every device entry point (fused chunk,
    collect, train step, act dispatch, sampler draw). Each
    :class:`ProgramRecord` carries FLOPs/bytes from the census of
    ``utils/flops.py``, dispatch counts, and device-seconds sampled at
    fences the loops ALREADY hold — no new synchronization on the hot
    path. The device-seconds are an attribution: the span from dispatch
    (or the previous fence) to the fence, gaps between launches included,
    not kernel-busy time. Cost is harvested once per program, at its
    first dispatch site, by a census on deep copies of its arguments,
    never on the live state.

``UtilizationLedger``
    Decomposes each chunk's wall-time into device-busy plus the named
    host-blocked buckets ``sample | evac_fence | prefetch_wait | h2d |
    other`` and feeds the ``dqn_chip_idle_seconds_total{cause}`` /
    ``dqn_chip_busy_seconds_total`` families.

``set_learner_mfu``
    FLOPs-per-exec x executions / device-seconds of the role="train"
    programs over the card's bf16 peak.

``sweep_device_memory`` / ``capture_profile``
    The caching allocator's statistics -> ``dqn_device_memory_bytes{kind,
    device}`` gauges with a host-tracked peak, and the
    ``/debug/profile?seconds=N`` backend (a torch.profiler trace).

``device_work``
    The port's own: every thread that launches on the card does so inside
    ``device_work()``, and a profiler starts only while no other thread
    is inside one (:class:`LaunchGate`).

Everything degrades on the CPU: a census that fails leaves FLOPs
``None`` (gauges absent, never a crash), a process without a card sweeps
to nothing, and torch and ``utils/flops.py`` are imported where they are
used, so the module stays importable from the torch-free actor
processes.
"""
from __future__ import annotations

import contextlib
import os
import sys
import tempfile
import threading
import time
from typing import Any, Dict, Iterator, Optional

from dist_dqn_tpu_torch.telemetry import collectors as tmc
from dist_dqn_tpu_torch.telemetry.registry import Registry, get_registry

#: Fixed idle-cause vocabulary for dqn_chip_idle_seconds_total (the JAX
#: package's).
IDLE_CAUSES = ("sample", "evac_fence", "prefetch_wait", "h2d", "other")

#: Hard ceiling on one /debug/profile capture; windows past this are
#: better taken as several correlated short ones.
PROFILE_MAX_SECONDS = 60.0

#: How long a profiler's start waits for the launching threads to leave
#: their ``device_work`` blocks (a fused chunk is one block).
QUIET_TIMEOUT_S = 30.0

#: The forensics directory's environment variable (JAX
#: ``telemetry/watchdog.py FORENSICS_ENV``): profile captures land there.
FORENSICS_ENV = "DQN_FORENSICS_DIR"


def _positive(value) -> Optional[float]:
    if value is None or value <= 0:
        return None
    return float(value)


def _cost_from(obj: Any) -> Dict[str, Optional[float]]:
    """FLOPs/bytes for one execution from ``obj`` — a ``{"flops",
    "bytes"}`` dict (``utils/flops.py census``) or a zero-arg callable
    returning one. Any failure degrades to ``{"flops": None, "bytes":
    None}``; a non-positive value is unknown, not zero."""
    try:
        if callable(obj):
            obj = obj()
        flops = _positive(obj.get("flops"))
        nbytes = _positive(obj.get("bytes"))
    except Exception:  # noqa: BLE001 — a census never takes a loop down
        flops = nbytes = None
    return {"flops": flops, "bytes": nbytes}


class ProgramRecord:
    """One device entry point: static cost + running dispatch tallies.

    ``flops``/``bytes`` are for ONE execution of the program. A program
    that runs N sub-steps per dispatch registers with
    ``execs_per_dispatch`` = N and the cost of one sub-step.
    """

    def __init__(self, registry: "ProgramRegistry", name: str, loop: str,
                 role: Optional[str], execs_per_dispatch: float):
        self._registry = registry
        self.name = name
        self.loop = loop
        self.role = role
        self.execs_per_dispatch = float(execs_per_dispatch)
        self.flops: Optional[float] = None
        self.bytes: Optional[float] = None
        self._cost_done = False
        self._lock = threading.Lock()
        labels = {"program": name, "loop": loop}
        reg = registry.metrics
        self._g_flops = reg.gauge(
            tmc.PROGRAM_FLOPS, "FLOPs per execution (XLA cost analysis)",
            labels)
        self._g_bytes = reg.gauge(
            tmc.PROGRAM_BYTES, "bytes accessed per execution", labels)
        self._c_dispatch = reg.counter(
            tmc.PROGRAM_DISPATCHES, "host-side launches", labels)
        self._c_devsec = reg.counter(
            tmc.PROGRAM_DEVICE_SECONDS,
            "device time attributed at existing fences", labels)
        self.dispatches = 0.0
        self.device_seconds = 0.0

    def attach_cost(self, source: Any) -> "ProgramRecord":
        """Harvest FLOPs/bytes once from ``source`` (a cost dict or a
        zero-arg callable returning one). Idempotent: the first harvest
        wins; repeat calls and failures are free, so dispatch sites can
        call this unconditionally."""
        with self._lock:
            if self._cost_done:
                return self
            cost = _cost_from(source)
            # A failed harvest closes the one shot too: retrying a failing
            # census every dispatch would be hot-path work.
            self._cost_done = True
            if cost["flops"] is None and cost["bytes"] is None:
                return self
            self.flops, self.bytes = cost["flops"], cost["bytes"]
        if self.flops is not None:
            self._g_flops.set(self.flops)
        if self.bytes is not None:
            self._g_bytes.set(self.bytes)
        return self

    @property
    def cost_attached(self) -> bool:
        return self._cost_done

    def count_dispatch(self, n: float = 1.0) -> None:
        self.dispatches += n
        self._c_dispatch.inc(n)

    def add_device_seconds(self, seconds: float) -> None:
        if seconds <= 0:
            return
        self.device_seconds += seconds
        self._c_devsec.inc(seconds)

    @property
    def executions(self) -> float:
        return self.dispatches * self.execs_per_dispatch

    @property
    def arith_intensity(self) -> Optional[float]:
        if self.flops is None or not self.bytes:
            return None
        return self.flops / self.bytes

    def snapshot(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {
            "program": self.name,
            "loop": self.loop,
            "flops": self.flops,
            "bytes": self.bytes,
            "dispatches": self.dispatches,
            "execs_per_dispatch": self.execs_per_dispatch,
            "device_seconds": self.device_seconds,
        }
        ai = self.arith_intensity
        if ai is not None:
            out["arith_intensity"] = ai
        return out


class ProgramRegistry:
    """Process-wide (name, loop) -> :class:`ProgramRecord` table."""

    def __init__(self, metrics: Optional[Registry] = None):
        self.metrics = metrics if metrics is not None else get_registry()
        self._records: Dict[tuple, ProgramRecord] = {}
        self._lock = threading.RLock()

    def register(self, name: str, loop: str = "default",
                 cost: Any = None, role: Optional[str] = None,
                 execs_per_dispatch: float = 1.0) -> ProgramRecord:
        """Get-or-create the record for ``(name, loop)``. ``cost`` is
        attached immediately when given; dispatch sites that only have
        real args later call ``record.attach_cost`` themselves."""
        key = (name, loop)
        with self._lock:
            rec = self._records.get(key)
            if rec is None:
                rec = ProgramRecord(self, name, loop, role,
                                    execs_per_dispatch)
                self._records[key] = rec
            elif role is not None and rec.role is None:
                rec.role = role
        if cost is not None:
            rec.attach_cost(cost)
        return rec

    def records(self, loop: Optional[str] = None):
        with self._lock:
            recs = list(self._records.values())
        if loop is not None:
            recs = [r for r in recs if r.loop == loop]
        return recs

    def get(self, name: str, loop: str = "default"):
        with self._lock:
            return self._records.get((name, loop))

    def snapshot(self, loop: Optional[str] = None) -> Dict[str, Dict]:
        """JSON-able {program: fields} block for summaries."""
        return {r.name: r.snapshot() for r in self.records(loop)}

    def learner_mfu(self, loop: str,
                    device: Any = None) -> Optional[float]:
        """Registry-derived MFU for ``loop``: summed FLOPs x executions
        over summed device-seconds of every record tagged role="train",
        against the card's bf16 peak. None when no train program has
        both cost and device time, or the peak is unknown (CPU)."""
        from dist_dqn_tpu_torch.utils import flops as flops_util

        if device is None:
            device = _default_device()
        if device is None:
            return None
        peak = flops_util.chip_peak_flops(device)
        if not peak:
            return None
        total_flops = 0.0
        total_secs = 0.0
        for rec in self.records(loop):
            if rec.role != "train" or rec.flops is None:
                continue
            total_flops += rec.flops * rec.executions
            total_secs += rec.device_seconds
        if total_secs <= 0 or total_flops <= 0:
            return None
        return (total_flops / total_secs) / peak


_program_registry = ProgramRegistry()


def get_program_registry() -> ProgramRegistry:
    """The process-global program registry (what every loop uses)."""
    return _program_registry


def reset_program_registry(metrics: Optional[Registry] = None
                           ) -> ProgramRegistry:
    """Swap in a fresh registry (tests, or runs that want per-run
    dispatch tallies). Returns the new instance."""
    global _program_registry
    _program_registry = ProgramRegistry(metrics)
    return _program_registry


def register_program(name: str, loop: str = "default", cost: Any = None,
                     role: Optional[str] = None,
                     execs_per_dispatch: float = 1.0) -> ProgramRecord:
    """Module-level convenience for the common dispatch-site idiom."""
    return _program_registry.register(
        name, loop=loop, cost=cost, role=role,
        execs_per_dispatch=execs_per_dispatch)


def programs_snapshot(loop: Optional[str] = None) -> Dict[str, Dict]:
    return _program_registry.snapshot(loop)


def _cuda_in_use() -> bool:
    """Whether this process holds a CUDA context (never creates one)."""
    torch = sys.modules.get("torch")
    return (torch is not None and torch.cuda.is_available()
            and torch.cuda.is_initialized())


def _default_device():
    """The card this process computes on, or None (no CUDA context)."""
    if not _cuda_in_use():
        return None
    import torch
    return torch.device("cuda", torch.cuda.current_device())


def set_learner_mfu(loop: str, device: Any = None,
                    reg: Optional[Registry] = None) -> Optional[float]:
    """Publish the registry-derived ``dqn_learner_mfu{loop=...}`` gauge.
    No-op (gauge absent) when the MFU is underivable — unknown card
    peak, no census, no device time yet."""
    value = _program_registry.learner_mfu(loop, device=device)
    if value is None:
        return None
    if reg is None:
        reg = get_registry()
    reg.gauge(tmc.LEARNER_MFU, "model FLOPs utilization vs chip peak "
              "(registry-derived)", {"loop": loop}).set(value)
    return value


class UtilizationLedger:
    """Per-chunk wall-time decomposition for one loop.

    ``observe_chunk(wall_s, busy_s, sample=..., evac_fence=...,
    prefetch_wait=..., h2d=...)`` files the measured device-busy time
    under ``dqn_chip_busy_seconds_total{loop}`` and the host-blocked
    remainder under ``dqn_chip_idle_seconds_total{loop, cause}``;
    whatever wall-time the named causes don't explain lands in
    ``other`` (clamped at zero — the buckets are estimates sampled at
    existing fences, never allowed to go negative). All five cause
    series are registered up front so the family is scrapeable at 0
    before the first chunk and dashboards never see a hole.
    """

    def __init__(self, loop: str, reg: Optional[Registry] = None):
        if reg is None:
            reg = get_registry()
        self.loop = loop
        self._busy = reg.counter(
            tmc.CHIP_BUSY_SECONDS,
            "chunk wall-time the device was measured busy",
            {"loop": loop})
        self._idle = {
            cause: reg.counter(
                tmc.CHIP_IDLE_SECONDS,
                "chunk wall-time the device sat idle, by cause",
                {"loop": loop, "cause": cause})
            for cause in IDLE_CAUSES
        }
        self.chunks = 0
        self.totals: Dict[str, float] = {"busy": 0.0}
        self.totals.update({c: 0.0 for c in IDLE_CAUSES})

    def observe_chunk(self, wall_s: float, busy_s: float,
                      sample: float = 0.0, evac_fence: float = 0.0,
                      prefetch_wait: float = 0.0,
                      h2d: float = 0.0) -> Dict[str, float]:
        """File one chunk; returns the breakdown (incl. the derived
        ``other`` residual) for the caller's own log row."""
        wall_s = max(float(wall_s), 0.0)
        busy_s = min(max(float(busy_s), 0.0), wall_s)
        named = {"sample": max(float(sample), 0.0),
                 "evac_fence": max(float(evac_fence), 0.0),
                 "prefetch_wait": max(float(prefetch_wait), 0.0),
                 "h2d": max(float(h2d), 0.0)}
        named["other"] = max(wall_s - busy_s - sum(named.values()), 0.0)
        self._busy.inc(busy_s)
        self.totals["busy"] += busy_s
        for cause, secs in named.items():
            if secs > 0:
                self._idle[cause].inc(secs)
            self.totals[cause] += secs
        self.chunks += 1
        out = {"wall": wall_s, "busy": busy_s}
        out.update(named)
        return out

    def snapshot(self) -> Dict[str, float]:
        return {"chunks": float(self.chunks), **self.totals}


# ---------------------------------------------------------------------------
# Device memory telemetry


class _CudaMemory:
    """One card's memory statistics under the vocabulary of kinds XLA's GPU
    client reports (JAX ``Device.memory_stats()``), from the caching
    allocator (``torch.cuda.memory_stats``) and the card's total:

      * ``bytes_in_use``      <- ``allocated_bytes.all.current``
      * ``peak_bytes_in_use`` <- ``allocated_bytes.all.peak``
      * ``bytes_reserved``    <- ``reserved_bytes.all.current``
      * ``bytes_limit``       <- the card's total memory (the total of
        ``torch.cuda.mem_get_info``, read from the cached device
        properties, so the sweep reads host-side figures only)

    The sweep adds the host-tracked ``peak_bytes_in_use_seen``."""

    def __init__(self, index: int):
        self.id = index

    def memory_stats(self) -> Dict[str, float]:
        import torch

        stats = torch.cuda.memory_stats(self.id)
        return {
            "bytes_in_use": stats.get("allocated_bytes.all.current", 0),
            "peak_bytes_in_use": stats.get("allocated_bytes.all.peak", 0),
            "bytes_reserved": stats.get("reserved_bytes.all.current", 0),
            "bytes_limit": torch.cuda.get_device_properties(
                self.id).total_memory,
        }


_mem_lock = threading.Lock()
_mem_peaks: Dict[str, float] = {}


def sweep_device_memory(reg: Optional[Registry] = None,
                        devices: Any = None) -> Dict[str, Dict[str, float]]:
    """Sweep ``memory_stats()`` of ``devices`` (default: the card this
    process computes on, :class:`_CudaMemory`) into
    ``dqn_device_memory_bytes{kind, device}`` gauges.

    A process without a CUDA context (the CPU) sweeps nothing, and
    devices that report nothing or partial dicts sweep to exactly the
    keys they report — gauges degrade to absent, never crash.
    ``bytes_in_use`` additionally feeds a host-tracked high-water mark
    published as ``kind="peak_bytes_in_use_seen"``. Returns
    {device_label: {kind: bytes}} of what was actually swept (empty dict
    when nothing reported).
    """
    if reg is None:
        reg = get_registry()
    if devices is None:
        dev = _default_device()
        if dev is None:
            return {}
        devices = [_CudaMemory(dev.index)]
    swept: Dict[str, Dict[str, float]] = {}
    for i, dev in enumerate(devices):
        try:
            stats = dev.memory_stats()
        except Exception:  # noqa: BLE001 — a sweep never crashes a loop
            stats = None
        if not stats:
            continue
        label = str(getattr(dev, "id", i))
        kinds: Dict[str, float] = {}
        for kind, value in stats.items():
            try:
                value = float(value)
            except (TypeError, ValueError):
                continue
            kinds[kind] = value
            reg.gauge(tmc.DEVICE_MEMORY_BYTES,
                      "Device.memory_stats() sweep",
                      {"kind": str(kind), "device": label}).set(value)
        in_use = kinds.get("bytes_in_use")
        if in_use is not None:
            with _mem_lock:
                peak = max(_mem_peaks.get(label, 0.0), in_use)
                _mem_peaks[label] = peak
            kinds["peak_bytes_in_use_seen"] = peak
            reg.gauge(tmc.DEVICE_MEMORY_BYTES,
                      "host-tracked high-water mark of bytes_in_use",
                      {"kind": "peak_bytes_in_use_seen",
                       "device": label}).set(peak)
        if kinds:
            swept[label] = kinds
    return swept


# ---------------------------------------------------------------------------
# On-demand profiling (/debug/profile backend)


_profile_lock = threading.Lock()


def _profile_base_dir() -> str:
    """Where captures land: the armed watchdog's or sentinel's forensics
    directory, else $DQN_FORENSICS_DIR, else a tempdir: the order the
    crash path uses, so traces sit next to the forensics bundles."""
    from dist_dqn_tpu_torch.telemetry import watchdog as wd

    armed = wd.armed_forensics_dir()
    if armed:
        return str(armed)
    env = os.environ.get(FORENSICS_ENV)
    if env:
        return env
    return tempfile.mkdtemp(prefix="dqn-profile-")


def _profiler(all_threads: bool = False):
    """A torch.profiler over the host and, in a process that
    holds a CUDA context, the card. ``all_threads`` (a capture started
    on the telemetry server's thread) records every thread's ops, as
    JAX's process-wide trace does; a torch without the option gets the
    default, thread-local config."""
    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if _cuda_in_use():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    config = None
    if all_threads:
        try:
            config = torch._C._profiler._ExperimentalConfig(
                profile_all_threads=True)
        except (AttributeError, TypeError):
            config = None
    return torch.profiler.profile(activities=activities,
                                  experimental_config=config)


class LaunchGate:
    """Keeps the card's launches out of a profiler's start.

    A kernel that one thread launches while another starts torch.profiler
    can cost the capture every kernel record (the runtime-API records
    stay), and later captures of the process often go on without them
    (ROADMAP.md C9; ``utils/capture_probe.py`` counts it on a card).
    So each thread that launches does so inside :meth:`work`, and
    :meth:`quiet` holds a start until no other thread is inside one, then
    keeps new ones waiting until the start has returned. ``quiet`` closes
    the gate only at a moment when no other thread is inside :meth:`work`,
    so an entry never waits while another thread holds a block: a block
    that waits on another thread's block cannot deadlock. The thread
    calling ``quiet`` may be inside its own block (the one-chunk profiler
    starts in its loop). Costs one lock round trip per block."""

    def __init__(self):
        self._cond = threading.Condition()
        self._active = 0          # threads inside work()
        self._closed = False      # a start is running; entries wait
        self._waiter_own = None   # the waiting quiet()'s own block (0/1)
        self._local = threading.local()
        self._quiet_lock = threading.Lock()   # one quiet() at a time

    @contextlib.contextmanager
    def work(self) -> Iterator[None]:
        local = self._local
        depth = getattr(local, "depth", 0)
        if depth:                 # nested: the thread is counted
            local.depth = depth + 1
            try:
                yield
            finally:
                local.depth = depth
            return
        with self._cond:
            while self._closed:
                self._cond.wait()
            self._active += 1
        local.depth = 1
        try:
            yield
        finally:
            local.depth = 0
            with self._cond:
                self._active -= 1
                if self._active == self._waiter_own:
                    self._closed = True
                    self._cond.notify_all()

    @contextlib.contextmanager
    def quiet(self, timeout: float) -> Iterator[bool]:
        """Yields True while no other thread is inside :meth:`work` and
        none may enter; False if they did not all leave within
        ``timeout`` seconds (the gate then stays open)."""
        own = 1 if getattr(self._local, "depth", 0) else 0
        if not self._quiet_lock.acquire(timeout=timeout):
            yield False
            return
        try:
            with self._cond:
                if self._active == own:
                    self._closed = True
                else:
                    self._waiter_own = own
                    self._cond.wait_for(lambda: self._closed, timeout)
                    self._waiter_own = None
                ok = self._closed
            try:
                yield ok
            finally:
                if ok:
                    with self._cond:
                        self._closed = False
                        self._cond.notify_all()
        finally:
            self._quiet_lock.release()


_launch_gate = LaunchGate()


def device_work():
    """The block a thread launches on the card in (:class:`LaunchGate`):
    a loop's step from its first launch to its fence."""
    return _launch_gate.work()


def _start_quiet(prof) -> bool:
    """``prof.start()`` with the launching threads held off and the card
    drained (each device this process allocated on); whether they were
    held (False: they kept a block past QUIET_TIMEOUT_S, and the profiler
    was not started)."""
    with _launch_gate.quiet(QUIET_TIMEOUT_S) as held:
        if not held:
            return False
        if _cuda_in_use():
            import torch

            for i in range(torch.cuda.device_count()):
                if torch.cuda.memory_reserved(i):
                    torch.cuda.synchronize(i)
        prof.start()
    return True


def capture_profile(seconds: float,
                    base_dir: Optional[str] = None) -> Dict[str, Any]:
    """Capture a torch.profiler trace for ``seconds`` (clamped to
    [0, PROFILE_MAX_SECONDS]) into ``trace.json`` of a fresh
    subdirectory of the forensics dir. Serialized process-wide: a second
    caller while a capture is running gets ``{"error": "busy"}`` instead
    of corrupting the active trace. ``seconds=0`` opens and immediately
    closes the window — cheap smoke-path for tests and endpoint probes.
    """
    try:
        seconds = max(0.0, min(float(seconds), PROFILE_MAX_SECONDS))
    except (TypeError, ValueError):
        return {"error": f"bad seconds value: {seconds!r}"}
    if not _profile_lock.acquire(blocking=False):
        return {"error": "busy", "detail": "a capture is already running"}
    try:
        try:
            prof = _profiler(all_threads=True)
        except Exception as e:  # noqa: BLE001 — torch-free process
            return {"error": f"torch unavailable: {e}"}
        base = base_dir or _profile_base_dir()
        trace_dir = os.path.join(
            base, f"profile-{os.getpid()}-{int(time.time() * 1000)}")
        os.makedirs(trace_dir, exist_ok=True)
        t0 = time.perf_counter()
        try:
            if not _start_quiet(prof):
                return {"error": "start_trace failed: the launching "
                                 f"threads kept the card past "
                                 f"{QUIET_TIMEOUT_S:g} s",
                        "trace_dir": trace_dir}
        except Exception as e:  # noqa: BLE001 — another profiler is open
            return {"error": f"start_trace failed: {e}",
                    "trace_dir": trace_dir}
        try:
            if seconds > 0:
                time.sleep(seconds)
        finally:
            try:
                prof.stop()
                prof.export_chrome_trace(os.path.join(trace_dir,
                                                      "trace.json"))
            except Exception as e:  # noqa: BLE001 — reported, not raised
                return {"error": f"stop_trace failed: {e}",
                        "trace_dir": trace_dir}
        n_files = sum(len(fns) for _, _, fns in os.walk(trace_dir))
        return {"trace_dir": trace_dir,
                "seconds": seconds,
                "capture_wall_s": time.perf_counter() - t0,
                "files": n_files}
    finally:
        _profile_lock.release()


def maybe_trace_first_chunk(profile_dir: Optional[str]):
    """The --profile-dir contract, shared by all three runtimes: a
    (start, stop) pair that traces exactly one chunk with torch.profiler
    and is a no-op when ``profile_dir`` is unset. ``stop()`` returns the
    directory once, after the one traced window, and leaves the stopped
    profiler on ``.profile`` for the caller's trace and op table."""

    class _OneShot:
        def __init__(self, target: Optional[str]):
            self._target = target
            self._armed = bool(target)
            self._active = False
            self.profile = None

        def start(self) -> bool:
            """Open the one window; whether this call opened it."""
            if not self._armed or self._active:
                return False
            self.profile = _profiler()
            if not _start_quiet(self.profile):
                # The other launching threads did not pause: trace the
                # chunk all the same.
                self.profile.start()
            self._active = True
            return True

        def stop(self) -> Optional[str]:
            if not self._active:
                return None
            self.profile.stop()
            self._active = False
            self._armed = False  # one shot
            return self._target

    return _OneShot(profile_dir)
