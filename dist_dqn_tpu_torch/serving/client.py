"""Minimal blocking client of the port's serving tier (twin of
``dist_dqn_tpu/serving/client.py``) — the test/bench-side counterpart of
serving/server.py.

One persistent keep-alive HTTP connection per instance (NOT
thread-safe; the closed-loop load generator gives each client thread
its own instance, which is exactly the per-user-connection shape the
bench wants to model). It needs no device: only numpy + the transport
array codec, so load generators run from processes that never touch one.
It speaks the JAX package's wire, so either package's client talks to
either package's server.
"""
from __future__ import annotations

import http.client
import json
from typing import Optional, Tuple

import numpy as np

from dist_dqn_tpu_torch.actors.transport import decode_arrays, encode_arrays
from dist_dqn_tpu_torch.serving.types import (ActResult, QueueFullError,
                                              ServingError,
                                              UnknownPolicyError)


class ServingClient:
    def __init__(self, address: str, timeout_s: float = 30.0):
        """``address`` is ``host:port`` (PolicyServer.address)."""
        import socket

        host, port = address.rsplit(":", 1)
        self._conn = http.client.HTTPConnection(host, int(port),
                                                timeout=timeout_s)
        # Requests are two small writes (headers, body): disable Nagle
        # or the body stalls against the server's delayed ACK (the
        # server handler disables it for responses symmetrically).
        self._conn.connect()
        self._conn.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY,
                                   1)

    def act(self, obs: np.ndarray, policy: Optional[str] = None,
            epsilon: Optional[float] = None,
            greedy: bool = False) -> ActResult:
        """POST one act request; returns the ActResult (actions +
        version header). Raises the typed serving errors on 404/429/5xx
        so closed-loop callers can branch on shed-vs-fail."""
        meta = {"greedy": greedy}
        if policy is not None:
            meta["policy"] = policy
        if epsilon is not None:
            meta["epsilon"] = float(epsilon)
        body = encode_arrays({"obs": np.asarray(obs)}, meta=meta)
        self._conn.request(
            "POST", "/v1/act", body=body,
            headers={"Content-Type": "application/octet-stream"})
        resp = self._conn.getresponse()
        payload = resp.read()
        if resp.status == 200:
            arrays, rmeta = decode_arrays(payload)
            return ActResult(
                actions=arrays["action"], policy_id=rmeta["policy"],
                version=int(rmeta["version"]), step=int(rmeta["step"]),
                fanin_requests=int(rmeta["fanin_requests"]),
                fanin_rows=int(rmeta["fanin_rows"]),
                latency_s=float(rmeta["latency_s"]))
        detail = _error_detail(payload)
        if resp.status == 404:
            raise UnknownPolicyError(detail)
        if resp.status == 429:
            # The JSON body carries the precise float estimate; the
            # Retry-After header is RFC delay-seconds (integer) for
            # generic clients and proxies.
            try:
                retry = float(json.loads(payload.decode())["retry_after_s"])
            except Exception:
                retry = float(resp.getheader("Retry-After") or 0.05)
            raise QueueFullError(detail, retry_after_s=retry)
        raise ServingError(f"HTTP {resp.status}: {detail}")

    def policies(self) -> dict:
        return json.loads(self._get("/v1/policies")[1])

    def healthz(self) -> Tuple[int, bytes]:
        """(status, body) — 200 ok / 503 + breach JSON."""
        return self._get("/healthz")

    def _get(self, path: str) -> Tuple[int, bytes]:
        self._conn.request("GET", path)
        resp = self._conn.getresponse()
        return resp.status, resp.read()

    def close(self) -> None:
        self._conn.close()


def _error_detail(payload: bytes) -> str:
    try:
        return json.loads(payload.decode())["error"]
    except Exception:
        return payload.decode(errors="replace")
