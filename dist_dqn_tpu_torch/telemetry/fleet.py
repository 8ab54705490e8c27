"""Fleet observability plane of the port (twin of
``dist_dqn_tpu/telemetry/fleet.py``): endpoint registry + metrics
federation.

A distributed run is a PROCESS FLEET (learner, remote actors, serving
replicas, evaluation runs), each serving its own ``/metrics``
(telemetry/server.py). This module gives the run ONE pane:

  * **Run-scoped endpoint registry.** Every process that starts a
    telemetry server calls ``register_endpoint(role, port)`` right after
    bind. When ``DQN_FLEET_DIR`` (or an explicit ``fleet_dir``) names a
    directory, the call atomically writes ``<fleet_dir>/<role>-<pid>.json``
    (tmp + ``os.replace``) describing the endpoint: role, labels,
    host:port, manifest hash, start time. The descriptor is removed
    through the shared exit lifecycle (telemetry/lifecycle.py: atexit AND
    SIGTERM), and by the server's ``close()`` where the entry point
    registered through ``serve_if_asked``, so a gracefully stopped member
    leaves no litter. Unset env: a no-op, zero cost.
  * **Federation.** ``FleetAggregator`` sweeps the registry, scrapes every
    member, and serves ONE merged Prometheus exposition with
    ``process="<role>-<pid>"``/``role`` labels injected into every sample
    line (``_bucket`` lines included). A member that stops answering
    degrades to LABELED staleness (``dqn_fleet_member_up`` 0,
    ``dqn_fleet_member_staleness_seconds`` climbing, last-good families
    still served): a dead endpoint never fails the fleet scrape.
  * **Health rollup.** ``/fleet/status`` is the JSON rollup: per member
    live/stale/dead (scrape liveness x descriptor-pid liveness), each
    member's ``/healthz`` verdict (watchdog stalls, divergence latches,
    SLO breaches: the 503 detail JSON rides along verbatim),
    learner-reported ``dqn_ingest_degraded``, and the fleet's own
    actor-quorum degradation. ``/fleet/forensics`` pulls ``/debug/flight``
    + ``/debug/stacks`` from every live member into one correlated bundle:
    the first step of the hang runbook (README.md).
    ``/fleet/profile?seconds=N`` fans ``/debug/profile`` out to every live
    member in parallel for one correlated cross-fleet torch.profiler
    window; dead members are labeled, never fatal.

Descriptor hygiene: a registration REFUSES (raises
``FleetRegistrationError``) when a live descriptor already claims the
same role+pid with a different endpoint: two processes must never alias
one series. Descriptors whose pid is dead are removed by the AGGREGATOR
only, never by a live peer registering alongside them: the aggregator is
the one place that can tell "crashed" from "slow to start", and a crashed
member stays visible as ``dead`` in the rollup until its grace lapses.

Stdlib only (urllib + http.server + json): actor and feeder processes
load no torch.

CLI::

    python -m dist_dqn_tpu_torch.telemetry.fleet --fleet-dir RUN/fleet --port 0

prints one ``{"fleet_port": N}`` line and serves until SIGTERM.
"""
from __future__ import annotations

import argparse
import json
import os
import socket
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlsplit
from typing import Dict, List, Optional

from dist_dqn_tpu_torch.telemetry import lifecycle
from dist_dqn_tpu_torch.telemetry.devtime import QUIET_TIMEOUT_S
from dist_dqn_tpu_torch.telemetry import manifest as manifest_mod
from dist_dqn_tpu_torch.telemetry.exposition import CONTENT_TYPE, _escape_label
from dist_dqn_tpu_torch.telemetry.registry import Registry

#: Environment knob: the run's fleet registry directory. Exported by the
#: learner CLIs (--fleet-dir) so spawned actors/feeders inherit it.
FLEET_ENV = "DQN_FLEET_DIR"

#: Bump when the descriptor key set changes shape.
DESCRIPTOR_SCHEMA_VERSION = 1

#: Fields that constitute a member's IDENTITY: a same-role+pid
#: descriptor differing in any of these is a collision, not a refresh.
_IDENTITY_KEYS = ("host", "port", "start_time")


class FleetRegistrationError(ValueError):
    """Two live members claimed the same role+pid descriptor slot."""


def _pid_alive(pid: int) -> bool:
    """Best-effort liveness for a LOCAL pid (EPERM counts as alive)."""
    try:
        os.kill(int(pid), 0)
    except ProcessLookupError:
        return False
    except (PermissionError, OSError, ValueError):
        pass
    return True


def resolve_fleet_dir(explicit: Optional[str] = None) -> Optional[str]:
    """The registry directory: explicit arg wins, else ``DQN_FLEET_DIR``,
    else None (fleet plane disabled)."""
    return explicit if explicit else (os.environ.get(FLEET_ENV) or None)


class EndpointRegistration:
    """Handle for one written descriptor: ``close()`` removes it (also
    wired into the exit lifecycle, so SIGTERM'd members deregister)."""

    def __init__(self, path: str):
        self.path = path
        self._closed = False
        lifecycle.on_exit(self.close)

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        lifecycle.off_exit(self.close)
        try:
            os.unlink(self.path)
        except OSError:
            pass


def register_endpoint(role: str, port: int, host: str = "127.0.0.1",
                      labels: Optional[Dict[str, str]] = None,
                      fleet_dir: Optional[str] = None
                      ) -> Optional[EndpointRegistration]:
    """Announce this process's telemetry endpoint to the run's fleet.

    Call AFTER the server bound (the descriptor must carry the real
    port — with ``--telemetry-port 0`` the ephemeral one). No-op
    returning None when no fleet dir is configured. Raises
    ``FleetRegistrationError`` on a live same-role+pid collision.
    """
    d = resolve_fleet_dir(fleet_dir)
    if not d:
        return None
    os.makedirs(d, exist_ok=True)
    pid = os.getpid()
    path = os.path.join(d, f"{role}-{pid}.json")
    man = manifest_mod.get_run_manifest() or {}
    desc = {
        "schema_version": DESCRIPTOR_SCHEMA_VERSION,
        "role": role,
        "pid": pid,
        "host": host,
        "port": int(port),
        "hostname": socket.gethostname(),
        "labels": dict(labels or {}),
        "start_time": time.time(),
        "manifest_hash": man.get("config_hash"),
    }
    if os.path.exists(path):
        try:
            with open(path) as f:
                prev = json.load(f)
        except (OSError, ValueError):
            prev = None  # torn/garbage descriptor: overwrite
        if prev and _pid_alive(prev.get("pid", -1)) \
                and int(prev.get("pid", -1)) == pid \
                and any(prev.get(k) != desc[k] for k in ("host", "port")):
            # Same role+pid, different endpoint identity, and the
            # claimant is alive — refusing beats silently aliasing two
            # processes into one fleet series. (A DEAD claimant is pid
            # recycling; its descriptor is stale litter the aggregator
            # will GC, and this process legitimately owns the slot.)
            raise FleetRegistrationError(
                f"fleet descriptor {path} already claimed by a live "
                f"member at {prev.get('host')}:{prev.get('port')} "
                f"(ours: {host}:{port})")
    tmp = path + f".tmp.{pid}"
    with open(tmp, "w") as f:
        json.dump(desc, f, sort_keys=True)
        f.write("\n")
    os.replace(tmp, path)  # atomic: sweepers never see a torn descriptor
    return EndpointRegistration(path)


# ---------------------------------------------------------------------------
# Federation: exposition merge


def _inject_labels(series: str, extra: Dict[str, str]) -> str:
    """Inject labels into one exposition series token (``name`` or
    ``name{...}`` — bucket lines are just series tokens too)."""
    if not extra:
        return series
    pairs = ",".join(f'{k}="{_escape_label(v)}"'
                     for k, v in sorted(extra.items()))
    if series.endswith("}"):
        sep = "" if series.endswith("{") else ","
        return series[:-1] + sep + pairs + "}"
    return series + "{" + pairs + "}"


def merge_expositions(pages: List[Dict]) -> str:
    """Merge N scraped exposition texts into one, injecting each page's
    ``labels`` into every sample line. ``pages`` items: {"text": str,
    "labels": {..}}. HELP/TYPE are emitted once per family (first
    page's wording wins); families keep first-seen order."""
    families: Dict[str, Dict] = {}
    order: List[str] = []
    for page in pages:
        extra = page.get("labels") or {}
        for line in page["text"].splitlines():
            line = line.strip()
            if not line:
                continue
            if line.startswith("#"):
                parts = line.split(None, 3)
                if len(parts) < 3 or parts[1] not in ("HELP", "TYPE"):
                    continue
                name = parts[2]
                fam = families.get(name)
                if fam is None:
                    fam = families[name] = {"help": None, "type": None,
                                            "lines": []}
                    order.append(name)
                key = parts[1].lower()
                if fam[key] is None:
                    fam[key] = parts[3] if len(parts) > 3 else ""
                continue
            # Sample line: series token then value (labels may hold
            # spaces inside quotes, so split at the closing brace, not
            # the first whitespace).
            if "}" in line:
                cut = line.rindex("}") + 1
            else:
                cut = line.find(" ")
                if cut < 0:
                    continue
            series, value = line[:cut], line[cut:].strip()
            bare = series.split("{", 1)[0]
            # _bucket/_sum/_count samples belong to their histogram
            # family's HELP/TYPE block.
            name = bare
            for suffix in ("_bucket", "_sum", "_count"):
                if bare.endswith(suffix) and bare[:-len(suffix)] in families:
                    name = bare[:-len(suffix)]
                    break
            fam = families.get(name)
            if fam is None:
                fam = families[name] = {"help": None, "type": None,
                                        "lines": []}
                order.append(name)
            fam["lines"].append(f"{_inject_labels(series, extra)} {value}")
    out: List[str] = []
    for name in order:
        fam = families[name]
        if fam["help"]:
            out.append(f"# HELP {name} {fam['help']}")
        if fam["type"]:
            out.append(f"# TYPE {name} {fam['type']}")
        out.extend(fam["lines"])
    return "\n".join(out) + "\n"


# ---------------------------------------------------------------------------
# The aggregator


#: Sweeps a dead member's descriptor survives before the aggregator
#: GC's the file (the member stays in the in-memory rollup regardless).
DEAD_GC_SWEEPS = 3


class _Member:
    """Aggregator-side record of one registered endpoint."""

    def __init__(self, desc: Dict, path: str):
        self.desc = desc
        self.path = path
        self.name = f"{desc.get('role', 'unknown')}-{desc.get('pid', 0)}"
        self.state = "stale"  # until the first successful scrape
        self.healthy: Optional[bool] = None
        self.health_detail = None
        self.last_text: Optional[str] = None
        self.last_scrape: Optional[float] = None
        self.dead_sweeps = 0

    @property
    def base_url(self) -> str:
        return f"http://{self.desc['host']}:{self.desc['port']}"

    def inject(self) -> Dict[str, str]:
        extra = dict(self.desc.get("labels") or {})
        extra["process"] = self.name
        extra["role"] = str(self.desc.get("role", "unknown"))
        return extra


class FleetAggregator:
    """Sweep the registry dir, scrape every member, serve the one pane.

    ``sweep_once()`` is synchronous (tests call it directly); ``start()``
    runs it on a daemon thread every ``sweep_interval_s``. All HTTP
    out-calls carry ``scrape_timeout_s`` so one wedged member delays,
    never wedges, the sweep.
    """

    def __init__(self, fleet_dir: str, sweep_interval_s: float = 2.0,
                 scrape_timeout_s: float = 2.0):
        self.fleet_dir = fleet_dir
        self.sweep_interval_s = float(sweep_interval_s)
        self.scrape_timeout_s = float(scrape_timeout_s)
        self.members: Dict[str, _Member] = {}
        self._lock = threading.RLock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._hostname = socket.gethostname()
        # The aggregator's OWN families live in a private registry so
        # embedding it in a learner process cannot collide with the
        # process-global instruments it is federating.
        self.registry = Registry()
        reg = self.registry
        self._g_members = {
            s: reg.gauge("dqn_fleet_members", "registered members by "
                         "state", {"state": s})
            for s in ("live", "stale", "dead")}
        self._c_sweeps = reg.counter("dqn_fleet_sweeps_total",
                                     "registry sweeps completed")
        self._c_scrape_errs = reg.counter(
            "dqn_fleet_scrape_errors_total",
            "member scrapes that failed (per attempt)")
        self._h_sweep = reg.histogram("dqn_fleet_sweep_seconds",
                                      "one full sweep's wall time")
        self._g_degraded = reg.gauge(
            "dqn_fleet_ingest_degraded",
            "1 while at least half the actor-role members are dead "
            "(the fleet-level twin of the learner's "
            "dqn_ingest_degraded supervision gauge)")

    # -- scraping -----------------------------------------------------

    def _http_get(self, url: str) -> Optional[bytes]:
        try:
            with urllib.request.urlopen(
                    url, timeout=self.scrape_timeout_s) as resp:
                return resp.read()
        except Exception:  # noqa: BLE001 — any failure = scrape miss
            return None

    def _healthz(self, member: _Member) -> None:
        """Fetch /healthz; 503 bodies carry the watchdog's detail JSON
        (stale stages, divergence latches, SLO probes) verbatim."""
        try:
            with urllib.request.urlopen(
                    member.base_url + "/healthz",
                    timeout=self.scrape_timeout_s) as resp:
                member.healthy = resp.status == 200
                member.health_detail = None
        except urllib.error.HTTPError as e:
            member.healthy = False
            try:
                member.health_detail = json.loads(e.read().decode())
            except Exception:  # noqa: BLE001
                member.health_detail = {"status": "unhealthy"}
        except Exception:  # noqa: BLE001 — connection-level failure
            member.healthy = None
            member.health_detail = None

    def sweep_once(self) -> None:
        t0 = time.perf_counter()
        try:
            entries = sorted(os.listdir(self.fleet_dir))
        except OSError:
            entries = []
        with self._lock:
            for fname in entries:
                if not fname.endswith(".json") or ".tmp." in fname:
                    continue
                path = os.path.join(self.fleet_dir, fname)
                try:
                    with open(path) as f:
                        desc = json.load(f)
                except (OSError, ValueError):
                    continue  # torn mid-replace or already GC'd
                name = f"{desc.get('role', 'unknown')}-{desc.get('pid', 0)}"
                known = self.members.get(name)
                if known is None or known.desc.get("start_time") \
                        != desc.get("start_time"):
                    self.members[name] = _Member(desc, path)
            members = list(self.members.values())
        for m in members:
            body = self._http_get(m.base_url + "/metrics")
            now = time.time()
            if body is not None:
                with self._lock:
                    m.state = "live"
                    m.last_text = body.decode("utf-8", "replace")
                    m.last_scrape = now
                    m.dead_sweeps = 0
                self._healthz(m)
                continue
            self._c_scrape_errs.inc()
            # Scrape missed: pid liveness (local members only) decides
            # stale-but-breathing vs dead. Remote-host members cannot
            # be probed, so they degrade to stale and stay there.
            pid = m.desc.get("pid", -1)
            local = m.desc.get("hostname") == self._hostname
            dead = local and not _pid_alive(pid)
            with self._lock:
                m.state = "dead" if dead else "stale"
                m.healthy = None
                if dead:
                    m.dead_sweeps += 1
                    # Aggregator-only GC (never a live peer): after the
                    # grace window the descriptor file goes; the member
                    # stays in the rollup as dead.
                    if m.dead_sweeps >= DEAD_GC_SWEEPS \
                            and os.path.exists(m.path):
                        try:
                            os.unlink(m.path)
                        except OSError:
                            pass
        with self._lock:
            counts = {"live": 0, "stale": 0, "dead": 0}
            actors_total = actors_dead = 0
            for m in self.members.values():
                counts[m.state] += 1
                if m.desc.get("role") == "actor":
                    actors_total += 1
                    actors_dead += m.state == "dead"
            for s, g in self._g_members.items():
                g.set(counts[s])
            degraded = bool(actors_total
                            and actors_dead * 2 >= actors_total)
            self._g_degraded.set(float(degraded))
        self._c_sweeps.inc()
        self._h_sweep.observe(time.perf_counter() - t0)

    # -- the pane -----------------------------------------------------

    def render_metrics(self) -> str:
        """ONE merged exposition: every member's last-good families
        under ``process``/``role`` labels, plus per-member liveness and
        the aggregator's own dqn_fleet_* families."""
        from dist_dqn_tpu_torch.telemetry.exposition import \
            render_prometheus

        now = time.time()
        pages: List[Dict] = []
        liveness = Registry()
        with self._lock:
            members = list(self.members.values())
        for m in members:
            lbl = {"process": m.name, "role": str(m.desc.get("role"))}
            liveness.gauge("dqn_fleet_member_up",
                           "1 = member answered the last sweep's scrape",
                           lbl).set(float(m.state == "live"))
            staleness = (now - m.last_scrape) if m.last_scrape else -1.0
            liveness.gauge("dqn_fleet_member_staleness_seconds",
                           "seconds since this member's last good "
                           "scrape (-1 = never scraped)",
                           lbl).set(staleness)
            if m.last_text is not None:
                pages.append({"text": m.last_text, "labels": m.inject()})
        pages.append({"text": render_prometheus(liveness), "labels": {}})
        pages.append({"text": render_prometheus(self.registry),
                      "labels": {}})
        return merge_expositions(pages)

    def _member_scrape_value(self, m: _Member, family: str
                             ) -> Optional[float]:
        """A single un-labeled gauge/counter value out of a member's
        last-good scrape text (rollup convenience, not a parser)."""
        if not m.last_text:
            return None
        for line in m.last_text.splitlines():
            if line.startswith(family) and not line.startswith("#"):
                series = line.split(" ")[0]
                if series == family:
                    try:
                        return float(line.rsplit(" ", 1)[1])
                    except ValueError:
                        return None
        return None

    def status(self) -> Dict:
        """The ``/fleet/status`` JSON rollup."""
        now = time.time()
        with self._lock:
            members = list(self.members.values())
        out_members: Dict[str, Dict] = {}
        counts = {"live": 0, "stale": 0, "dead": 0}
        alerts: List[str] = []
        ingest_degraded = False
        for m in members:
            counts[m.state] += 1
            staleness = (now - m.last_scrape) if m.last_scrape else None
            row = {
                "role": m.desc.get("role"),
                "pid": m.desc.get("pid"),
                "host": m.desc.get("host"),
                "port": m.desc.get("port"),
                "labels": m.desc.get("labels", {}),
                "state": m.state,
                "healthy": m.healthy,
                "start_time": m.desc.get("start_time"),
                "manifest_hash": m.desc.get("manifest_hash"),
                "last_scrape_unix": m.last_scrape,
                "staleness_s": staleness,
            }
            if m.health_detail:
                row["health_detail"] = m.health_detail
                detail = json.dumps(m.health_detail, sort_keys=True)
                alerts.append(f"{m.name}: unhealthy ({detail})")
            if m.state == "dead":
                alerts.append(f"{m.name}: dead (pid gone)")
            v = self._member_scrape_value(m, "dqn_ingest_degraded")
            if v is not None and v > 0:
                ingest_degraded = True
                alerts.append(f"{m.name}: reports dqn_ingest_degraded")
            out_members[m.name] = row
        if self._g_degraded.value:
            ingest_degraded = True
            alerts.append("fleet: at least half the actor members are "
                          "dead")
        return {
            "schema_version": 1,
            "fleet_dir": self.fleet_dir,
            "sweep_interval_s": self.sweep_interval_s,
            "updated_unix": now,
            "counts": counts,
            "ingest_degraded": ingest_degraded,
            "alerts": alerts,
            "members": out_members,
        }

    def forensics(self) -> Dict:
        """The ``/fleet/forensics`` bundle: flight tail + thread stacks
        (+ manifest) from every LIVE member, correlated under one
        timestamp; stale/dead members appear by name with their state
        so the bundle never silently omits a fleet member."""
        bundle: Dict = {"generated_unix": time.time(), "members": {}}
        with self._lock:
            members = list(self.members.values())
        for m in members:
            if m.state != "live":
                bundle["members"][m.name] = {"state": m.state}
                continue
            entry: Dict = {"state": "live", "role": m.desc.get("role")}
            flight = self._http_get(m.base_url + "/debug/flight")
            if flight is not None:
                try:
                    entry["flight"] = json.loads(flight.decode())
                except ValueError:
                    entry["flight"] = None
            stacks = self._http_get(m.base_url + "/debug/stacks")
            if stacks is not None:
                entry["stacks"] = stacks.decode("utf-8", "replace")
            man = self._http_get(m.base_url + "/debug/config")
            if man is not None:
                try:
                    entry["manifest"] = json.loads(man.decode())
                except ValueError:
                    pass
            bundle["members"][m.name] = entry
        return bundle

    def profile(self, seconds: float = 1.0) -> Dict:
        """The ``/fleet/profile`` bundle: fan ``/debug/profile?seconds=N``
        out to every LIVE member IN PARALLEL, so the per-process
        torch.profiler windows overlap and the traces correlate into one
        cross-fleet view. Stale or dead members appear by name with their
        state: a capture with a dead actor still succeeds and still says
        who was missing. Each member entry is that member's own capture
        result JSON (trace_dir on its host, or its error); a live member
        whose capture did not answer in time is there with an error,
        never dropped.

        Deviation from JAX's fan-out (``seconds + scrape_timeout_s``): a
        port capture first waits at the member's ``LaunchGate`` for the
        threads that launch on the card to leave their blocks, up to
        ``devtime.QUIET_TIMEOUT_S``, so each request allows ``seconds +
        QUIET_TIMEOUT_S + scrape_timeout_s``."""
        try:
            seconds = max(0.0, float(seconds))
        except (TypeError, ValueError):
            seconds = 1.0
        bundle: Dict = {"generated_unix": time.time(),
                        "seconds": seconds, "members": {}}
        with self._lock:
            members = list(self.members.values())
        live = [m for m in members if m.state == "live"]
        for m in members:
            if m.state != "live":
                bundle["members"][m.name] = {"state": m.state}
        timeout = seconds + QUIET_TIMEOUT_S + self.scrape_timeout_s

        def _capture(member: _Member) -> None:
            url = (member.base_url
                   + f"/debug/profile?seconds={seconds:g}")
            # The member holds its trace window open for `seconds` (after
            # its launch gate went quiet) before answering: the scrape
            # timeout alone would kill every non-trivial capture.
            try:
                with urllib.request.urlopen(url, timeout=timeout) as resp:
                    body = resp.read()
            except urllib.error.HTTPError as e:  # 409 busy carries JSON
                body = e.read()
            except Exception:  # noqa: BLE001 — connection-level failure
                bundle["members"][member.name] = {
                    "state": "live", "error": "capture request failed"}
                return
            entry: Dict = {"state": "live",
                           "role": member.desc.get("role")}
            try:
                entry.update(json.loads(body.decode()))
            except ValueError:
                entry["error"] = "unparseable capture response"
            bundle["members"][member.name] = entry

        threads = [threading.Thread(target=_capture, args=(m,),
                                    name=f"fleet-profile-{m.name}",
                                    daemon=True) for m in live]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=timeout + self.scrape_timeout_s + 5.0)
        for m in live:
            bundle["members"].setdefault(
                m.name, {"state": "live", "role": m.desc.get("role"),
                         "error": "capture did not answer in time"})
        return bundle

    # -- lifecycle ----------------------------------------------------

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(target=self._loop,
                                        name="fleet-sweeper", daemon=True)
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                self.sweep_once()
            except Exception:  # noqa: BLE001 — the sweeper must survive
                pass
            self._stop.wait(self.sweep_interval_s)

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None


class FleetServer:
    """HTTP face of the aggregator: ``/metrics`` (merged exposition),
    ``/fleet/status``, ``/fleet/forensics``, ``/fleet/profile``,
    ``/healthz``. Same stdlib ThreadingHTTPServer-on-a-daemon-thread
    shape as TelemetryServer."""

    def __init__(self, aggregator: FleetAggregator, port: int = 0,
                 host: str = "127.0.0.1"):
        self.aggregator = aggregator
        agg = aggregator

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 — http.server API
                path = self.path.split("?", 1)[0]
                if path in ("/metrics", "/"):
                    body = agg.render_metrics().encode()
                    ctype = CONTENT_TYPE
                elif path == "/fleet/status":
                    body = (json.dumps(agg.status(), sort_keys=True)
                            + "\n").encode()
                    ctype = "application/json"
                elif path == "/fleet/forensics":
                    body = (json.dumps(agg.forensics(), sort_keys=True)
                            + "\n").encode()
                    ctype = "application/json"
                elif path == "/fleet/profile":
                    qs = parse_qs(urlsplit(self.path).query)
                    seconds = (qs.get("seconds") or ["1"])[0]
                    body = (json.dumps(agg.profile(seconds),
                                       sort_keys=True) + "\n").encode()
                    ctype = "application/json"
                elif path == "/healthz":
                    body, ctype = b"ok\n", "text/plain"
                else:
                    self.send_error(404)
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, fmt, *args):
                pass

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        self.host, self.port = self._httpd.server_address[:2]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="fleet-http", daemon=True)
        self._thread.start()

    def close(self) -> None:
        try:
            self._httpd.shutdown()
            self._httpd.server_close()
        except OSError:
            pass


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        description="Fleet metrics federation + health rollup of a "
                    "run's processes (dist_dqn_tpu_torch.telemetry.fleet)")
    parser.add_argument("--fleet-dir", default=None,
                        help="registry directory the run's members "
                             "write descriptors into (defaults to "
                             f"${FLEET_ENV})")
    parser.add_argument("--port", type=int, default=0,
                        help="bind port (0 = ephemeral; the bound port "
                             "is announced as a fleet_port line)")
    parser.add_argument("--host", default="127.0.0.1",
                        help="bind address (loopback by default — the "
                             "pane is unauthenticated)")
    parser.add_argument("--sweep-interval", type=float, default=2.0,
                        help="seconds between registry sweeps")
    parser.add_argument("--scrape-timeout", type=float, default=2.0,
                        help="per-member HTTP timeout")
    args = parser.parse_args(argv)
    fleet_dir = resolve_fleet_dir(args.fleet_dir)
    if not fleet_dir:
        parser.error(f"--fleet-dir or ${FLEET_ENV} required")
    os.makedirs(fleet_dir, exist_ok=True)
    agg = FleetAggregator(fleet_dir, sweep_interval_s=args.sweep_interval,
                          scrape_timeout_s=args.scrape_timeout)
    agg.sweep_once()
    agg.start()
    server = FleetServer(agg, port=args.port, host=args.host)
    print(json.dumps({"fleet_port": server.port}), flush=True)

    stop = threading.Event()
    lifecycle.on_exit(stop.set)
    try:
        while not stop.wait(0.5):
            pass
    except KeyboardInterrupt:
        pass
    finally:
        server.close()
        agg.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
