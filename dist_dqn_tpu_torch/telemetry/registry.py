"""Central metrics registry of the port (twin of
``dist_dqn_tpu/telemetry/registry.py``): counter / gauge / histogram
primitives.

Every layer that records metrics records through ONE registry, so rates,
spans and gauges share a naming scheme and a flush lifecycle. Design
constraints, in order:

  * hot-path-safe: an ``inc``/``set``/``observe`` is a few attribute ops
    under a per-instrument lock (~100ns in CPython). Instruments are
    created once and cached by their owners; creation (the only dict
    mutation) takes the registry lock, updates never do. Locks are
    REENTRANT: an exit flush running on the main thread may interrupt a
    frame already inside an instrument's critical section, and a plain
    Lock would deadlock it against the interrupted holder.
  * dependency-free: stdlib only, no torch, so processes that never touch
    the card (clients, load generators) can import it.
  * Null-object disabled path: ``NullRegistry`` hands out no-op
    instruments with the identical surface, so call sites never branch.

Naming scheme: ``dqn_<subsystem>_<what>[_total|_seconds]``. Counters are
monotonic and end in ``_total``; histograms observe seconds and end in
``_seconds``; gauges are bare. The text is the JAX package's, so a scrape
of either package reads the same series.
"""
from __future__ import annotations

import bisect
import threading
from typing import Dict, Iterable, Optional, Sequence, Tuple

#: Default histogram buckets, tuned for host-loop latencies: 100µs device
#: dispatches up to minute-scale compile/checkpoint stalls.
DEFAULT_BUCKETS: Tuple[float, ...] = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0)


def _label_key(labels: Optional[Dict[str, str]]) -> Tuple:
    return tuple(sorted((labels or {}).items()))


class Counter:
    """Monotonically increasing count (Prometheus ``counter``)."""

    kind = "counter"

    def __init__(self, name: str, help: str = "",
                 labels: Optional[Dict[str, str]] = None):
        self.name = name
        self.help = help
        self.labels = dict(labels or {})
        self._lock = threading.RLock()
        self._value = 0.0

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name} cannot decrease "
                             f"(inc({n}))")
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        return self._value

    def sample(self) -> Dict:
        return {"value": self._value}


class Gauge:
    """Point-in-time value that can move both ways."""

    kind = "gauge"

    def __init__(self, name: str, help: str = "",
                 labels: Optional[Dict[str, str]] = None):
        self.name = name
        self.help = help
        self.labels = dict(labels or {})
        self._lock = threading.RLock()
        self._value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n

    def dec(self, n: float = 1.0) -> None:
        self.inc(-n)

    @property
    def value(self) -> float:
        return self._value

    def sample(self) -> Dict:
        return {"value": self._value}


class Histogram:
    """Cumulative-bucket histogram (Prometheus ``histogram`` semantics).

    ``buckets`` are ascending upper bounds; the implicit ``+Inf`` bucket
    always exists. ``observe`` is one bisect + three adds.
    """

    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 labels: Optional[Dict[str, str]] = None,
                 buckets: Optional[Sequence[float]] = None):
        self.name = name
        self.help = help
        self.labels = dict(labels or {})
        bounds = tuple(buckets if buckets is not None else DEFAULT_BUCKETS)
        if list(bounds) != sorted(bounds) or len(set(bounds)) != len(bounds):
            raise ValueError(f"histogram {name} buckets must be strictly "
                             f"ascending: {bounds}")
        self.bounds = bounds
        self._lock = threading.RLock()
        # _counts[i] = observations <= bounds[i] would be cumulative; we
        # store PER-BUCKET counts and cumulate at render time so observe
        # touches exactly one cell.
        self._counts = [0] * (len(bounds) + 1)  # last cell = +Inf overflow
        self._sum = 0.0
        self._count = 0

    def observe(self, v: float) -> None:
        v = float(v)
        i = bisect.bisect_left(self.bounds, v)
        with self._lock:
            self._counts[i] += 1
            self._sum += v
            self._count += 1

    def observe_many(self, values: Iterable[float]) -> None:
        """Batch observe: one lock hold for a whole sample batch (the
        replay lineage path observes batch_size values per draw)."""
        vals = [float(v) for v in values]
        idxs = [bisect.bisect_left(self.bounds, v) for v in vals]
        with self._lock:
            for i in idxs:
                self._counts[i] += 1
            self._sum += sum(vals)
            self._count += len(vals)

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    def cumulative_buckets(self) -> Iterable[Tuple[float, int]]:
        """[(upper_bound, cumulative_count), ...] ending at (+Inf, count)."""
        with self._lock:
            counts = list(self._counts)
            total = self._count
        acc = 0
        out = []
        for b, c in zip(self.bounds, counts):
            acc += c
            out.append((b, acc))
        out.append((float("inf"), total))
        return out

    def sample(self) -> Dict:
        return {"count": self._count, "sum": self._sum,
                "buckets": {str(b): c for b, c in
                            self.cumulative_buckets()}}


class _NullInstrument:
    """No-op twin carrying every instrument's surface (never branches)."""

    kind = "null"
    name = ""
    help = ""
    labels: Dict[str, str] = {}
    bounds: Tuple[float, ...] = ()
    value = 0.0
    count = 0
    sum = 0.0

    def inc(self, n: float = 1.0) -> None:
        pass

    def dec(self, n: float = 1.0) -> None:
        pass

    def set(self, v: float) -> None:
        pass

    def observe(self, v: float) -> None:
        pass

    def observe_many(self, values) -> None:
        pass

    def cumulative_buckets(self):
        return [(float("inf"), 0)]

    def sample(self) -> Dict:
        return {}


NULL_INSTRUMENT = _NullInstrument()


class Registry:
    """Process-wide instrument registry with get-or-create semantics.

    The same (name, labels) pair always returns the same instrument, so
    independent components (several replay shards, say) aggregate into
    one counter instead of clobbering registrations; asking for an
    existing name with a different TYPE is a bug and raises.
    """

    enabled = True

    def __init__(self):
        self._lock = threading.RLock()
        self._instruments: Dict[Tuple[str, Tuple], object] = {}

    def _get_or_create(self, cls, name: str, help: str,
                       labels: Optional[Dict[str, str]], **kwargs):
        key = (name, _label_key(labels))
        with self._lock:
            inst = self._instruments.get(key)
            if inst is None:
                inst = cls(name, help=help, labels=labels, **kwargs)
                self._instruments[key] = inst
            elif not isinstance(inst, cls):
                raise ValueError(
                    f"metric {name!r} already registered as {inst.kind}, "
                    f"not {cls.kind}")
            return inst

    def counter(self, name: str, help: str = "",
                labels: Optional[Dict[str, str]] = None) -> Counter:
        return self._get_or_create(Counter, name, help, labels)

    def gauge(self, name: str, help: str = "",
              labels: Optional[Dict[str, str]] = None) -> Gauge:
        return self._get_or_create(Gauge, name, help, labels)

    def histogram(self, name: str, help: str = "",
                  labels: Optional[Dict[str, str]] = None,
                  buckets: Optional[Sequence[float]] = None) -> Histogram:
        return self._get_or_create(Histogram, name, help, labels,
                                   buckets=buckets)

    def collect(self):
        """Instruments grouped by family name, registration-ordered."""
        with self._lock:
            instruments = list(self._instruments.values())
        families: Dict[str, list] = {}
        for inst in instruments:
            families.setdefault(inst.name, []).append(inst)
        return families

    def snapshot(self) -> Dict:
        """JSON-able snapshot: {name{labels}: sample dict}."""
        out: Dict[str, Dict] = {}
        for name, insts in self.collect().items():
            for inst in insts:
                key = name
                if inst.labels:
                    lbl = ",".join(f"{k}={v}" for k, v
                                   in sorted(inst.labels.items()))
                    key = f"{name}{{{lbl}}}"
                out[key] = {"type": inst.kind, **inst.sample()}
        return out


class NullRegistry:
    """Disabled path: identical surface, zero work, no instruments."""

    enabled = False

    def counter(self, name: str, help: str = "", labels=None):
        return NULL_INSTRUMENT

    def gauge(self, name: str, help: str = "", labels=None):
        return NULL_INSTRUMENT

    def histogram(self, name: str, help: str = "", labels=None,
                  buckets=None):
        return NULL_INSTRUMENT

    def collect(self):
        return {}

    def snapshot(self) -> Dict:
        return {}


_default_registry = Registry()


def get_registry() -> Registry:
    """The process-global default registry (what every collector uses
    unless handed an explicit one)."""
    return _default_registry
