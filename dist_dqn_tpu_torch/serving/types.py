"""Shared request/response/error types of the port's serving tier (twin
of ``dist_dqn_tpu/serving/types.py``).

Kept free of torch imports so clients (serving/client.py, a load
generator) can import them from processes that never touch a device.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np


class ServingError(Exception):
    """Base for every serving-surface failure."""


class UnknownPolicyError(ServingError):
    """The request named a policy id with no resident checkpoint
    (HTTP 404)."""


class QueueFullError(ServingError):
    """The bounded admission queue shed this request (HTTP 429).

    ``retry_after_s`` is the server's drain estimate — echoed as the
    ``Retry-After`` header so closed-loop clients back off instead of
    hammering a saturated batcher."""

    def __init__(self, msg: str, retry_after_s: float):
        super().__init__(msg)
        self.retry_after_s = float(retry_after_s)


class ServerClosedError(ServingError):
    """The server shut down while the request was queued/in flight."""


@dataclasses.dataclass(frozen=True)
class PolicySnapshot:
    """One resident, immutable (params, version) pair.

    The micro-batcher resolves EXACTLY ONE snapshot per dispatched
    batch, so every row of a batch — and therefore every response split
    from it — acts on the same params and echoes the same version
    header. Hot-reload builds a NEW snapshot off the serving path, in a
    module of its own, and swaps the reference atomically; a swap can
    never tear a batch, and nothing ever writes a resident snapshot's
    module.
    """

    policy_id: str
    params: Any            # nn.Module on the serving device (read-only)
    version: int           # bumps on every hot-reload swap, starts at 1
    step: int              # the checkpoint's frame cursor
    param_checksum: Optional[float]  # LATEST-pointer digest (provenance)
    epsilon: float         # tenant default exploration (0 = greedy)


@dataclasses.dataclass(frozen=True)
class ActResult:
    """One served act request: actions plus the provenance header."""

    actions: np.ndarray    # [rows] int32
    policy_id: str
    version: int
    step: int
    fanin_requests: int    # concurrent requests coalesced into the batch
    fanin_rows: int        # real (unpadded) rows of the dispatched batch
    latency_s: float       # admission -> response split
