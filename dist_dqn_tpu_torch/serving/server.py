"""The port's policy-inference HTTP server (twin of
``dist_dqn_tpu/serving/server.py``): transport + assembly of the serving
pieces.

One process owns the card and runs

  * the :class:`ModelStore` (resident checkpoints + hot-reload watcher),
  * the :class:`Router` (multi-tenant policy/epsilon resolution),
  * the :class:`MicroBatcher` (ONE dispatch thread coalescing
    concurrent requests into pow2-bucketed act steps on the card),
  * a stdlib ``ThreadingHTTPServer`` front end: handler threads are
    request-scoped and block in ``batcher.submit`` — the card only ever
    sees the batcher thread's act steps (and the watcher's restores).

Wire format: the actors/transport.py array codec (``encode_arrays`` /
``decode_arrays``, the JAX package's bytes) — bit-exact observation and
action transfer with the optional CRC the transport already has, no JSON
float round-trips on the act path. ``POST /v1/act`` takes ``{"obs":
[rows, ...]}`` with meta ``{"policy", "epsilon", "greedy"}`` and answers
``{"action": [rows]}`` with the provenance header (policy, version, step,
fan-in, latency) echoed in meta. ``/healthz`` is the telemetry core's
``healthz_body``, so a serving SLO breach (p99 latency / queue depth, via
a registered health probe) flips every probe surface of the process to
503 at once. Shed admissions answer 429 with a ``Retry-After`` drain
estimate. ``/metrics`` and ``/metrics.json`` expose the registry.
"""
from __future__ import annotations

import itertools
import json
import math
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional

import numpy as np
import torch

from dist_dqn_tpu_torch.actors.transport import decode_arrays, encode_arrays
from dist_dqn_tpu_torch.serving.batcher import MicroBatcher, SloTracker
from dist_dqn_tpu_torch.serving.model_store import ModelStore
from dist_dqn_tpu_torch.serving.router import Router
from dist_dqn_tpu_torch.serving.types import (QueueFullError, ServingError,
                                              UnknownPolicyError)
from dist_dqn_tpu_torch.telemetry import watchdog as tm_watchdog
from dist_dqn_tpu_torch.telemetry.exposition import (CONTENT_TYPE,
                                                     render_prometheus,
                                                     snapshot)
from dist_dqn_tpu_torch.telemetry.registry import get_registry
from dist_dqn_tpu_torch.telemetry.server import healthz_body
from dist_dqn_tpu_torch.utils.device import resolve_device

#: /healthz probe-name prefix the SLO tracker registers under; each
#: PolicyServer instance appends a sequence number so two servers in
#: one process (tests, embedded benches) can't clobber or unregister
#: each other's probe.
SLO_PROBE = "serving_slo"
_SLO_PROBE_SEQ = itertools.count(1)

#: Maximum accepted request body; far above any sane obs batch, far
#: below a memory-exhaustion payload (the endpoint is unauthenticated-
#: loopback by default, same posture as the transport listener).
_MAX_BODY = 256 << 20


class _HTTPServer(ThreadingHTTPServer):
    """The front end's listener, with a listen backlog for a burst of
    concurrent clients: socketserver's default of 5 reset connections
    when 32 clients connected at once, where the JAX package's server
    keeps that default."""

    request_queue_size = 128


class PolicyServer:
    """Assembled serving stack. ``policies`` maps policy id ->
    checkpoint directory; every tenant shares the one network
    architecture of ``net`` (and the one act step). ``net`` is the
    restore template on the serving device (the JAX twin's ``net`` and
    ``example_params`` in one module); ``obs_spec`` is (row shape, numpy
    dtype)."""

    def __init__(self, net, obs_spec, *,
                 policies: Dict[str, str],
                 policy_epsilon: Optional[Dict[str, float]] = None,
                 epsilon: float = 0.0,
                 host: str = "127.0.0.1", port: int = 0,
                 max_rows: int = 256, max_wait_ms: float = 2.0,
                 queue_limit: int = 256, batching: bool = True,
                 slo_p99_ms: float = 0.0, slo_queue_depth: int = 0,
                 poll_interval_s: float = 10.0, seed: int = 0,
                 compile_warmup: bool = True, log_fn=print):
        from dist_dqn_tpu_torch.agents.dqn import make_actor_step

        if not policies:
            raise ValueError("at least one --policy NAME=DIR is required")
        policy_epsilon = policy_epsilon or {}
        self.log = log_fn
        device = next(net.parameters()).device
        self.store = ModelStore(net, poll_interval_s=poll_interval_s,
                                log_fn=log_fn)
        try:
            for pid, ckpt_dir in policies.items():
                self.store.add_policy(
                    pid, ckpt_dir,
                    epsilon=policy_epsilon.get(pid, epsilon))
        except BaseException:
            # A later tenant failing must not leak the earlier tenants'
            # snapshots — the CLI's --wait-for-checkpoint loop rebuilds
            # the whole server each retry.
            self.store.close()
            raise
        self.router = Router(self.store)
        self.slo = None
        self._slo_probe = f"{SLO_PROBE}.{next(_SLO_PROBE_SEQ)}"
        self.batcher: Optional[MicroBatcher] = None
        try:
            if slo_p99_ms > 0 or slo_queue_depth > 0:
                self.slo = SloTracker(p99_latency_s=slo_p99_ms / 1000.0,
                                      queue_depth=slo_queue_depth)
                tm_watchdog.register_health_probe(self._slo_probe,
                                                  self.slo.probe)
            self.batcher = MicroBatcher(
                make_actor_step(net.num_actions), self.router,
                generator=torch.Generator(device=device).manual_seed(seed),
                max_rows=max_rows,
                max_wait_s=max_wait_ms / 1000.0, queue_limit=queue_limit,
                batching=batching, obs_spec=obs_spec, slo=self.slo,
                log_fn=log_fn)
            if compile_warmup:
                # Run the whole bucket ladder BEFORE the port exists: a
                # batch shape's first call (cuDNN/cuBLAS algorithm choice)
                # would otherwise land on the first request to reach each
                # fan-in bucket.
                t0 = time.perf_counter()
                buckets = self.batcher.warmup()
                log_fn(f'{{"serving_warmup_buckets": {buckets}, '
                       f'"serving_warmup_s": '
                       f'{time.perf_counter() - t0:.2f}}}')
            self.store.start()
            self._httpd = _HTTPServer((host, port), self._make_handler())
        except BaseException:
            # A failed tail (port already bound, warmup error) runs after
            # the process-global SLO probe is registered and the dispatch
            # thread exists; close() is never reached on a failed build,
            # so unwind here — the --wait-for-checkpoint CLI loop
            # rebuilds the whole server each retry.
            if self.slo is not None:
                tm_watchdog.unregister_health_probe(self._slo_probe)
            if self.batcher is not None:
                self.batcher.close()
            self.store.close()
            raise
        self._httpd.daemon_threads = True
        self.host, self.port = self._httpd.server_address[:2]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="serving-http", daemon=True)
        self._thread.start()

    @property
    def address(self) -> str:
        return f"{self.host}:{self.port}"

    # -- HTTP front end -----------------------------------------------------
    def _make_handler(self):
        server = self
        registry = get_registry()

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"  # keep-alive for closed loops
            # Act responses are two small writes (headers, body); with
            # Nagle on, the body can deadlock against the client's
            # delayed ACK for ~200ms (the client sets TCP_NODELAY on its
            # side too, serving/client.py).
            disable_nagle_algorithm = True

            def _reply(self, status, body, ctype,
                       headers: Optional[Dict[str, str]] = None):
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                for k, v in (headers or {}).items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(body)

            def _reply_json(self, status, payload,
                            headers: Optional[Dict[str, str]] = None):
                body = (json.dumps(payload, sort_keys=True) + "\n").encode()
                self._reply(status, body, "application/json", headers)

            def do_GET(self):  # noqa: N802 — http.server API
                path = self.path.split("?", 1)[0]
                if path == "/healthz":
                    status, body = healthz_body()
                    self._reply(status, body,
                                "text/plain" if status == 200
                                else "application/json")
                elif path == "/v1/policies":
                    self._reply_json(200, server.router.policies())
                elif path == "/metrics":
                    self._reply(200, render_prometheus(registry).encode(),
                                CONTENT_TYPE)
                elif path == "/metrics.json":
                    self._reply_json(200, snapshot(registry))
                else:
                    self.send_error(404)

            def do_POST(self):  # noqa: N802 — http.server API
                path = self.path.split("?", 1)[0]
                if path != "/v1/act":
                    self.send_error(404)
                    return
                try:
                    length = int(self.headers.get("Content-Length", 0))
                except ValueError:
                    length = 0
                if not 0 < length <= _MAX_BODY:
                    # The body was NOT read — leaving it in the stream
                    # would desync the next keep-alive request, so drop
                    # the connection after this reply.
                    self.close_connection = True
                    self._reply_json(400, {"error": "bad Content-Length"},
                                     headers={"Connection": "close"})
                    return
                try:
                    arrays, meta = decode_arrays(self.rfile.read(length))
                    obs = arrays["obs"]
                    eps = meta.get("epsilon")
                    epsilon = None if eps is None else float(eps)
                    greedy = bool(meta.get("greedy", False))
                except Exception as e:  # noqa: BLE001 — a corrupt body
                    # raises whatever the codec hit (struct.error,
                    # zlib.error, KeyError, ...); all of it is a client
                    # problem and must answer 400, not kill the
                    # keep-alive connection with a bare reset.
                    self._reply_json(
                        400, {"error": f"malformed act request: {e}"})
                    return
                try:
                    result = server.batcher.submit(
                        obs, policy_id=meta.get("policy"),
                        epsilon=epsilon, greedy=greedy)
                except UnknownPolicyError as e:
                    self._reply_json(404, {"error": str(e)})
                    return
                except QueueFullError as e:
                    # Header is RFC 9110 delay-seconds (an INTEGER —
                    # generic clients/proxies int-parse it); the JSON
                    # body keeps the precise float for our client.
                    self._reply_json(
                        429, {"error": str(e),
                              "retry_after_s": e.retry_after_s},
                        headers={"Retry-After":
                                 str(max(1, math.ceil(e.retry_after_s)))})
                    return
                except ValueError as e:
                    self._reply_json(400, {"error": str(e)})
                    return
                except ServingError as e:
                    self._reply_json(503, {"error": str(e)})
                    return
                except Exception as e:  # noqa: BLE001 — dispatch fans
                    # arbitrary failures (CUDA runtime errors included)
                    # back to every submit() in the batch; answer a
                    # structured 500 rather than resetting the
                    # keep-alive connection mid-protocol.
                    self._reply_json(
                        500, {"error": f"{type(e).__name__}: {e}"})
                    return
                body = encode_arrays(
                    {"action": result.actions},
                    meta={"policy": result.policy_id,
                          "version": result.version,
                          "step": result.step,
                          "fanin_requests": result.fanin_requests,
                          "fanin_rows": result.fanin_rows,
                          "latency_s": round(result.latency_s, 6)})
                self._reply(200, body, "application/octet-stream")

            def log_message(self, fmt, *args):
                pass  # request logging would swamp the JSON-line stream

        return Handler

    def drain(self, timeout_s: float = 5.0) -> bool:
        """Graceful drain: stop ADMITTING (new submits answer 503
        ServerClosedError), let every already-admitted request complete
        within ``timeout_s``, then tear down. Returns True when the queue
        drained fully; False when the timeout expired and the stragglers
        were failed by ``close`` — either way the server is closed on
        return."""
        self.batcher.begin_drain()
        drained = self.batcher.wait_idle(timeout_s)
        # One beat for handler threads to WRITE the final responses
        # the dispatch just completed — wait_idle proves dispatch
        # completion, not that the bytes left the socket.
        time.sleep(0.05)
        self.close()
        return drained

    def close(self) -> None:
        if self.slo is not None:
            tm_watchdog.unregister_health_probe(self._slo_probe)
        try:
            self._httpd.shutdown()
            self._httpd.server_close()
        except OSError:
            pass
        self.batcher.close()
        self.store.close()


def build_server(cfg, policies: Dict[str, str], *,
                 host_env: Optional[str] = None, device=None,
                 **kw) -> PolicyServer:
    """Build a :class:`PolicyServer` from an experiment config on
    ``device`` (default: the card, which must be present): the network
    and obs spec come from the config's env (the evaluate.py surface) or,
    with ``host_env``, from probing a host env — the shape source for
    checkpoints trained by the apex runtime (whose non-pixel envs swap in
    the MLP torso exactly like the train CLI does)."""
    import dataclasses

    from dist_dqn_tpu_torch.models import build_network

    if cfg.network.lstm_size:
        raise ValueError(
            "the serving tier is feed-forward only for now — recurrent "
            "(R2D2) policies need per-caller carry state, which the "
            "stateless act protocol does not carry yet")
    dev = resolve_device(device)
    if host_env:
        from dist_dqn_tpu_torch.envs.gym_adapter import (is_pixel_env,
                                                         make_host_env)
        if not is_pixel_env(host_env):
            cfg = dataclasses.replace(
                cfg, network=dataclasses.replace(
                    cfg.network, torso="mlp", compute_dtype="float32"))
        probe = make_host_env(host_env, 1)
        num_actions = probe.num_actions
        obs0 = probe.reset()
        obs_shape, obs_dtype = obs0.shape[1:], obs0.dtype
        del probe
    else:
        from dist_dqn_tpu_torch.envs import make_env
        env = make_env(cfg.env_name, device=dev)
        num_actions = env.num_actions
        obs_shape = tuple(env.observation_shape)
        obs_dtype = torch.empty((), dtype=env.observation_dtype).numpy().dtype
        del env
    net = build_network(cfg.network, num_actions, obs_shape, device=dev)
    return PolicyServer(net, (tuple(obs_shape), np.dtype(obs_dtype)),
                        policies=policies, **kw)
