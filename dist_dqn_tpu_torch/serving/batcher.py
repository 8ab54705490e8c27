"""Dynamic micro-batcher + SLO tracker of the port's serving tier (twin of
``dist_dqn_tpu/serving/batcher.py``).

Concurrent act requests admit into ONE bounded queue; a single dispatch
thread coalesces the queue head into one act step on the card through
the shared pow2 packing (actors/act_dispatch.py — the ingest path's
bucket rule, so serving meets O(log max-fan-in) batch shapes, not one
per burst size). Two latencies bound p99:

  * at load, a batch dispatches as soon as ``max_rows`` real rows are
    queued — fan-in amortizes the dispatch constant;
  * at low load, the HEAD request's age bounds the wait: once it has
    queued ``max_wait_s`` the batch goes out with whatever coalesced,
    so an idle server answers a lone request in ~max_wait + one
    dispatch, not "whenever a batch fills".

Backpressure is explicit: past ``queue_limit`` queued requests,
admission fails with :class:`QueueFullError` carrying a drain-estimate
``retry_after_s`` (HTTP 429 + ``Retry-After``) instead of letting the
queue — and every queued request's latency — grow without bound.

Version atomicity: the dispatch thread resolves EXACTLY ONE
:class:`PolicySnapshot` per batch, so a hot-reload swap lands between
batches, never inside one — every response in a batch echoes the same
version header.

The dispatch thread is the only thread that acts on the card; HTTP
handler threads only submit and wait. With ``batching=False`` (the A/B
baseline) the same thread dispatches one request per act step, at once,
where the JAX package dispatches it from the handler thread under a
serial lock: the card still sees one serialized dispatch per request.

The dispatch thread beats the ``serving.batcher`` stall-watchdog
heartbeat (live once ``--forensics-dir`` installs a watchdog) and records
its launches under the ``serving.act`` device-time program. The
``serving.dispatch`` chaos seam fires once a batch before its snapshot and
launch: "slow_model" sleeps the dispatch thread, "exception" fails every
rider of the batch with a structured error; the next completed dispatch
marks it recovered.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from dist_dqn_tpu_torch import chaos
from dist_dqn_tpu_torch.actors.act_dispatch import (bucket_rows,
                                                    pack_act_rows,
                                                    split_rows)
from dist_dqn_tpu_torch.serving.router import Router
from dist_dqn_tpu_torch.serving.types import (ActResult, QueueFullError,
                                              ServerClosedError,
                                              ServingError)
from dist_dqn_tpu_torch.telemetry import collectors as tmc
from dist_dqn_tpu_torch.telemetry import devtime, get_registry
from dist_dqn_tpu_torch.utils import flops
from dist_dqn_tpu_torch.telemetry import watchdog as tm_watchdog

#: Heartbeat stage the dispatch thread beats.
BATCHER_STAGE = "serving.batcher"


class SloTracker:
    """Rolling-window p99 latency + queue-depth SLOs feeding /healthz.

    ``probe()`` is registered as a health probe (telemetry/watchdog.py
    ``register_health_probe``), so a breach flips EVERY /healthz surface
    of the process. Thresholds of 0 disarm a dimension. Breaches count
    once per healthy->breached transition, not per scrape.
    """

    def __init__(self, p99_latency_s: float = 0.0, queue_depth: int = 0,
                 window: int = 512, min_samples: int = 20,
                 window_s: float = 60.0):
        self.p99_latency_s = float(p99_latency_s)
        self.queue_depth = int(queue_depth)
        self.min_samples = int(min_samples)
        # Samples age out after window_s even with no new traffic: a
        # breached replica that a load balancer drained would otherwise
        # hold 503 forever (count-only windows decay only on requests).
        self.window_s = float(window_s)
        self._lat = deque(maxlen=window)   # (monotonic t, latency_s)
        self._lock = threading.Lock()
        self._depth_fn: Optional[Callable[[], int]] = None
        self._breached = set()
        reg = get_registry()
        self._tm_breaches = {
            slo: reg.counter(tmc.SERVING_SLO_BREACHES,
                             "healthy->breached SLO transitions",
                             {"slo": slo})
            for slo in ("p99_latency", "queue_depth")
        }

    def attach_queue_depth(self, fn: Callable[[], int]) -> None:
        self._depth_fn = fn

    def observe(self, latency_s: float) -> None:
        with self._lock:
            self._lat.append((time.monotonic(), latency_s))

    def p99(self) -> Optional[float]:
        cutoff = time.monotonic() - self.window_s
        with self._lock:
            lat = [l for t, l in self._lat if t >= cutoff]
        if len(lat) < self.min_samples:
            return None
        return float(np.percentile(np.asarray(lat), 99))

    def reset(self) -> None:
        with self._lock:
            self._lat.clear()
            self._breached.clear()

    def probe(self) -> Optional[Dict]:
        """None while inside SLO; a detail dict (-> 503) otherwise."""
        detail = {}
        if self.p99_latency_s > 0:
            p99 = self.p99()
            if p99 is not None and p99 > self.p99_latency_s:
                detail["p99_latency_s"] = round(p99, 6)
                detail["slo_p99_latency_s"] = self.p99_latency_s
        if self.queue_depth > 0 and self._depth_fn is not None:
            depth = self._depth_fn()
            if depth > self.queue_depth:
                detail["queue_depth"] = depth
                detail["slo_queue_depth"] = self.queue_depth
        with self._lock:
            now_breached = set()
            if "p99_latency_s" in detail:
                now_breached.add("p99_latency")
            if "queue_depth" in detail:
                now_breached.add("queue_depth")
            for slo in now_breached - self._breached:
                self._tm_breaches[slo].inc()
            self._breached = now_breached
        return detail or None


class _Pending:
    __slots__ = ("policy_id", "obs", "epsilon", "t_enqueue", "event",
                 "result", "error", "abandoned")

    def __init__(self, policy_id: str, obs: np.ndarray, epsilon: float):
        self.policy_id = policy_id
        self.obs = obs
        self.epsilon = epsilon
        self.t_enqueue = time.perf_counter()
        self.event = threading.Event()
        self.result: Optional[ActResult] = None
        self.error: Optional[BaseException] = None
        self.abandoned = False           # client timed out and left


class MicroBatcher:
    """The admission queue + dispatch thread.

    ``act_fn(net, obs, generator, epsilon) -> actions`` is the
    epsilon-greedy act step (agents/dqn.py ``make_actor_step`` — the same
    step evaluate.py and the Ape-X service act with, which is what makes
    the serving equivalence pin possible); ``epsilon`` is one value per
    row. Its draws come from ``generator``, a ``torch.Generator`` on the
    serving device, which only the dispatch thread uses once requests are
    admitted (``warmup`` runs before).

    ``batching=False`` is the A/B arm: one dispatch per request, no
    coalescing (still pow2-padded — only the fan-in differs).
    """

    def __init__(self, act_fn, router: Router, *, generator: torch.Generator,
                 max_rows: int = 256, max_wait_s: float = 0.002,
                 queue_limit: int = 256, batching: bool = True,
                 obs_spec: Optional[Tuple] = None,
                 slo: Optional[SloTracker] = None, log_fn=print):
        self.act_fn = act_fn
        self.router = router
        self.device = generator.device
        self.max_rows = bucket_rows(int(max_rows))  # cap is itself pow2
        self.max_wait_s = float(max_wait_s)
        self.queue_limit = int(queue_limit)
        self.batching = bool(batching)
        self.slo = slo
        self.log = log_fn
        self._obs_spec = obs_spec        # (row shape, numpy dtype); the
        self._generator = generator      # first request's when None
        self.warmup_s: Dict[int, float] = {}   # bucket rows -> seconds
        self._queue: deque = deque()
        self._cond = threading.Condition()
        self._stopped = False
        self._draining = False
        self._dispatching = 0   # batches currently inside _dispatch
        # Drain-rate EWMA for the shed signal's retry-after estimate.
        self._ewma_batch_s = self.max_wait_s + 0.005
        self._ewma_fanin = 1.0
        reg = get_registry()
        self._tm_requests: Dict[str, object] = {}
        self._reg = reg
        self._tm_shed = reg.counter(
            tmc.SERVING_SHED, "requests shed by the bounded queue")
        self._tm_depth = reg.gauge(
            tmc.SERVING_QUEUE_DEPTH, "act requests awaiting dispatch")
        self._tm_latency = reg.histogram(
            tmc.SERVING_LATENCY, "request admission -> response split")
        self._tm_fanin = reg.histogram(
            tmc.SERVING_BATCH_FANIN,
            "real (unpadded) rows per dispatched act program",
            buckets=tmc.FANIN_BUCKETS)
        self._tm_dispatches = reg.counter(
            tmc.SERVING_DISPATCHES, "act programs dispatched")
        # The chip-time plane (dist_dqn_tpu/serving/batcher.py:200-207):
        # the coalesced act dispatch is the serving tier's device program;
        # the ``.cpu()`` fence in ``_act`` is one the path already holds,
        # so its device seconds cost no new sync. The census (all buckets
        # share this record) is taken at the warm-up's first bucket, before
        # the port is announced, or else after the first live dispatch's
        # responses (``_census``): never inside a request's latency.
        self._prog_act = devtime.register_program(
            "serving.act", loop="serving", role="act")
        if slo is not None:
            slo.attach_queue_depth(self.queue_depth)
        self._thread = threading.Thread(
            target=self._worker, name="serving-batcher", daemon=True)
        self._thread.start()

    def _census(self, params, obs: np.ndarray, eps: np.ndarray) -> None:
        """The act program's one-shot census on copies of its arguments."""
        if self._prog_act.cost_attached:
            return
        dev = self.device
        with devtime.device_work():
            self._prog_act.attach_cost(lambda: flops.census(
                self.act_fn, params, torch.from_numpy(obs).to(dev),
                self._generator, torch.from_numpy(eps).to(dev)))

    def _act(self, params, obs: np.ndarray, eps: np.ndarray) -> np.ndarray:
        """One act step on the card; ``.cpu()`` is the fence."""
        with devtime.device_work():
            actions = self.act_fn(
                params, torch.from_numpy(obs).to(self.device),
                self._generator, torch.from_numpy(eps).to(self.device))
            return actions.cpu().numpy().astype(np.int32)

    def warmup(self) -> int:
        """Run the whole pow2 bucket ladder once (one dummy dispatch per
        bucket up to ``max_rows``) so no live request pays a batch shape's
        first-call cost on the serving path: on the card, cuDNN's and
        cuBLAS's algorithm choice per shape (the CUDA context comes with
        the first). Called at server startup, before the port is
        announced and before any request can reach the dispatch thread.
        Records each bucket's seconds in ``warmup_s``; returns the bucket
        count."""
        if self._obs_spec is None:
            return 0
        shape, dtype = self._obs_spec
        policies = self.router.policies()
        if not policies:
            return 0
        snap = self.router.store.snapshot(next(iter(policies)))
        n, buckets = 1, 0
        while n <= self.max_rows:
            obs, eps = (np.zeros((n,) + tuple(shape), dtype),
                        np.zeros((n,), np.float32))
            t0 = time.perf_counter()
            self._act(snap.params, obs, eps)
            self.warmup_s[n] = time.perf_counter() - t0
            self._census(snap.params, obs, eps)
            buckets += 1
            n *= 2
        return buckets

    # -- admission ----------------------------------------------------------
    def queue_depth(self) -> int:
        # Monitoring read for the SLO probe/metrics: the depth is stale
        # the instant it returns, and taking _cond here would make
        # every /healthz scrape contend with the dispatch hot path.
        # lock: len() on a deque is one atomic op under the GIL.
        return len(self._queue)

    def _validate_obs(self, obs) -> np.ndarray:
        obs = np.asarray(obs)
        if obs.ndim < 1 or obs.shape[0] < 1:
            raise ValueError("obs must be a [rows, ...] batch with at "
                             "least one row")
        if obs.shape[0] > self.max_rows:
            raise ValueError(
                f"request rows {obs.shape[0]} exceed max_batch_rows "
                f"{self.max_rows}; split the request")
        if self._obs_spec is None:
            self._obs_spec = (obs.shape[1:], obs.dtype)
        elif (obs.shape[1:] != tuple(self._obs_spec[0])
              or obs.dtype != self._obs_spec[1]):
            raise ValueError(
                f"obs rows {obs.shape[1:]}/{obs.dtype} do not match the "
                f"serving spec {self._obs_spec[0]}/{self._obs_spec[1]}")
        return obs

    def _request_counter(self, policy_id: str):
        c = self._tm_requests.get(policy_id)
        if c is None:
            c = self._reg.counter(
                tmc.SERVING_REQUESTS,
                "act requests served by a dispatched program",
                {"policy": policy_id})
            self._tm_requests[policy_id] = c
        return c

    def submit(self, obs, policy_id: Optional[str] = None,
               epsilon: Optional[float] = None, greedy: bool = False,
               timeout_s: float = 30.0) -> ActResult:
        """Admit one request and block until its batch answered.
        Called from HTTP handler threads (and directly by tests)."""
        obs = self._validate_obs(obs)
        # lock: advisory fast-path read — the authoritative _draining
        # check re-runs under _cond below, atomically with the enqueue.
        if self._draining:
            # Graceful drain: already-admitted requests complete; NEW
            # admissions are refused up front (503) so the in-flight
            # queue can only shrink.
            raise ServerClosedError("server draining for shutdown")
        # Route BEFORE admission: unknown policy / bad epsilon must not
        # consume a queue slot or ride a dispatched batch.
        snap, eps = self.router.resolve(policy_id, epsilon, greedy)
        pending = _Pending(snap.policy_id, obs, eps)
        with self._cond:
            if self._stopped:
                raise ServerClosedError("server shutting down")
            if self._draining:
                raise ServerClosedError("server draining for shutdown")
            if len(self._queue) >= self.queue_limit:
                self._tm_shed.inc()
                raise QueueFullError(
                    f"admission queue full ({self.queue_limit} requests "
                    "pending)", retry_after_s=self._retry_after())
            self._queue.append(pending)
            self._tm_depth.set(len(self._queue))
            self._cond.notify_all()
        if not pending.event.wait(timeout_s):
            # Withdraw a timed-out request: still queued -> remove it
            # (no wasted dispatch, frees its backpressure slot); already
            # packed into an in-flight batch -> mark it abandoned so its
            # client-gone latency is not fed to the SLO window after the
            # caller got its error.
            with self._cond:
                pending.abandoned = True
                try:
                    self._queue.remove(pending)
                except ValueError:
                    pass
                else:
                    self._tm_depth.set(len(self._queue))
            raise ServingError(
                f"request timed out after {timeout_s}s in the serving "
                "pipeline")
        if pending.error is not None:
            raise pending.error
        return pending.result

    def _retry_after(self) -> float:
        """Drain estimate for a shed request: the full queue's batches
        at the recent per-batch wall."""
        batches = max(1.0, self.queue_limit / max(self._ewma_fanin, 1.0))
        return max(0.05, batches * self._ewma_batch_s)

    # -- dispatch thread ----------------------------------------------------
    def _worker(self) -> None:
        hb = tm_watchdog.heartbeat(BATCHER_STAGE)
        try:
            while True:
                batch = self._take_batch(hb)
                if batch is None:
                    break
                if not batch:
                    # The head this cycle waited on was withdrawn by a
                    # client timeout and the next head is another
                    # policy's — nothing assembled; take again.
                    continue
                self._dispatch(batch)
                hb.beat()
        finally:
            hb.close()
            self._fail_queue(ServerClosedError("server shut down"))

    # lock: called only from _take_batch with self._cond already held —
    # a cross-function hold the lexical race analysis cannot see.
    def _head_run_rows(self) -> int:
        """Rows queued for the head request's policy (stops at the
        first other-policy request — batches never mix params)."""
        rows, policy = 0, self._queue[0].policy_id
        for p in self._queue:
            if p.policy_id != policy:
                break
            rows += p.obs.shape[0]
            if rows >= self.max_rows:
                break
        return rows

    def _take_batch(self, hb) -> Optional[List[_Pending]]:
        with self._cond:
            while True:
                while not self._queue:
                    if self._stopped:
                        return None
                    self._cond.wait(0.1)
                    hb.beat()
                head = self._queue[0]
                if not self.batching:
                    break
                deadline = head.t_enqueue + self.max_wait_s
                drained = False
                while (self._head_run_rows() < self.max_rows
                       and not self._stopped):
                    remaining = deadline - time.perf_counter()
                    if remaining <= 0:
                        break
                    self._cond.wait(min(remaining, 0.05))
                    hb.beat()
                    if not self._queue:
                        # The head was withdrawn mid-wait (client
                        # timeout) and the queue drained; restart the
                        # wait iteratively — recursing here let a
                        # withdraw-storm grow the stack without bound.
                        drained = True
                        break
                if not drained:
                    break
            batch, rows = [], 0
            while self._queue:
                nxt = self._queue[0]
                if nxt.policy_id != head.policy_id:
                    break
                r = nxt.obs.shape[0]
                if batch and (rows + r > self.max_rows or not self.batching):
                    break
                self._queue.popleft()
                batch.append(nxt)
                rows += r
                if rows >= self.max_rows:
                    break
            self._tm_depth.set(len(self._queue))
            if batch:
                # Claim under THIS lock hold: from wait_idle's view the
                # batch moves queue -> in-flight atomically.
                self._dispatching += 1
            return batch

    def _dispatch(self, batch: List[_Pending]) -> None:
        """The batch was counted in ``_dispatching`` under the SAME lock
        hold that popped it from the queue — otherwise wait_idle could
        observe the instant between the pop and the increment and report
        an idle batcher while admitted requests still await dispatch."""
        try:
            self._dispatch_inner(batch)
        finally:
            with self._cond:
                self._dispatching -= 1
                self._cond.notify_all()

    def _dispatch_inner(self, batch: List[_Pending]) -> None:
        t0 = time.perf_counter()
        try:
            # Chaos seam: slow_model exercises the SLO/backpressure
            # degradation path (p99 breach -> 503, queue growth -> 429)
            # under a genuinely slow dispatch; exception exercises the
            # fan-out of a dispatch failure to every rider as a
            # structured 500, not a connection reset.
            ev = chaos.fire("serving.dispatch")
            if ev is not None:
                if ev.fault == "exception":
                    raise chaos.ChaosInjectedError("serving.dispatch",
                                                   ev.fault)
                chaos.sleep_for(ev)
            # ONE snapshot per batch: every row acts on the same params
            # and every response echoes the same version header — the
            # hot-reload atomicity contract.
            snap = self.router.store.snapshot(batch[0].policy_id)
            obs_cat, eps, rows, total = pack_act_rows(
                [p.obs for p in batch], [p.epsilon for p in batch])
            acts_np = self._act(snap.params, obs_cat, eps)
        except BaseException as e:  # noqa: BLE001 — fanned back out
            for p in batch:
                p.error = e
                p.event.set()
            return
        # A completed dispatch proves recovery from an injected slow/
        # failed one (the chaos recovery metric's serving anchor).
        chaos.mark_recovered("serving.dispatch")
        self._tm_dispatches.inc()
        self._prog_act.count_dispatch()
        self._prog_act.add_device_seconds(time.perf_counter() - t0)
        # Counted at DISPATCH, not admission: the mean request fan-in is
        # requests_total / dispatches_total, so a request shed at
        # admission or withdrawn by a client timeout while still queued
        # must not skew the ratio — only requests that actually rode a
        # dispatched program count.
        self._request_counter(snap.policy_id).inc(len(batch))
        self._tm_fanin.observe(float(total))
        wall = time.perf_counter() - t0
        self._ewma_batch_s += 0.2 * (wall - self._ewma_batch_s)
        self._ewma_fanin += 0.2 * (len(batch) - self._ewma_fanin)
        now = time.perf_counter()
        for p, acts in zip(batch, split_rows(acts_np, rows)):
            latency = now - p.t_enqueue
            if not p.abandoned:
                self._tm_latency.observe(latency)
                if self.slo is not None:
                    self.slo.observe(latency)
            p.result = ActResult(
                actions=acts, policy_id=snap.policy_id,
                version=snap.version, step=snap.step,
                fanin_requests=len(batch), fanin_rows=total,
                latency_s=latency)
            p.event.set()
        self._census(snap.params, obs_cat, eps)

    def _fail_queue(self, err: BaseException) -> None:
        with self._cond:
            stuck = list(self._queue)
            self._queue.clear()
            self._tm_depth.set(0)
        for p in stuck:
            p.error = err
            p.event.set()

    def begin_drain(self) -> None:
        """Stop admitting; keep dispatching what is already queued.
        Step one of the SIGTERM graceful-drain contract: after this,
        ``submit`` answers ServerClosedError (503) while every request
        admitted before the drain still gets its real response."""
        with self._cond:
            self._draining = True
            self._cond.notify_all()

    def wait_idle(self, timeout_s: float) -> bool:
        """Block until the queue is empty and no dispatch is in flight
        (True), or ``timeout_s`` elapsed (False). Meaningful after
        ``begin_drain`` — an admitting batcher may never go idle."""
        deadline = time.monotonic() + max(timeout_s, 0.0)
        with self._cond:
            while self._queue or self._dispatching:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._cond.wait(min(remaining, 0.1))
            return True

    def close(self) -> None:
        with self._cond:
            self._stopped = True
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        self._fail_queue(ServerClosedError("server shut down"))
