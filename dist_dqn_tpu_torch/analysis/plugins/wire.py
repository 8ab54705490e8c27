"""Check ``wire``: the zero-copy wire format is pinned to its protocol
version.

Twin of ``dist_dqn_tpu/analysis/plugins/wire.py``, over the port's own
codec, whose history must keep JAX's digests (the two packages speak
one wire). The version handshake makes a mismatch fail at connect — but
only if every header change actually BUMPS the constant:

  * fingerprint the frame-header layout (``WIRE_HEADER_FIELDS`` —
    names + struct formats), the record-kind registry and the flag
    registry of ``dist_dqn_tpu_torch/ingest/codec.py``;
  * the digest must equal ``WIRE_HISTORY[PROTOCOL_VERSION]``;
  * history is append-only: every version maps to a distinct digest and
    the live constant leads the history.

Unlike the file-scanning checks this one inspects the LIVE modules (the
registries are Python data, not source patterns), so it always runs
against the installed package, whatever root the context points at.
"""
from __future__ import annotations

import hashlib
import json
from typing import List

from dist_dqn_tpu_torch.analysis.core import AnalysisContext, Check, Finding
from dist_dqn_tpu_torch.analysis.registry import register


def wire_digest() -> str:
    """Canonical fingerprint of everything a peer must agree on to
    parse a frame header."""
    from dist_dqn_tpu_torch.ingest import codec

    spec = {
        "struct": codec._HDR.format,
        "fields": [list(f) for f in codec.WIRE_HEADER_FIELDS],
        "kinds": dict(codec.WIRE_KINDS),
        "flags": dict(codec.WIRE_FLAGS),
    }
    return hashlib.sha256(
        json.dumps(spec, sort_keys=True).encode()).hexdigest()[:16]


def check() -> List[str]:
    from dist_dqn_tpu_torch.ingest import codec
    from dist_dqn_tpu_torch.ingest.schema import PROTOCOL_VERSION

    failures = []
    digest = wire_digest()
    if PROTOCOL_VERSION not in codec.WIRE_HISTORY:
        failures.append(
            f"PROTOCOL_VERSION {PROTOCOL_VERSION} has no WIRE_HISTORY "
            f"entry — record it as {PROTOCOL_VERSION}: \"{digest}\"")
    elif codec.WIRE_HISTORY[PROTOCOL_VERSION] != digest:
        failures.append(
            f"wire-format fingerprint {digest} does not match "
            f"WIRE_HISTORY[{PROTOCOL_VERSION}] = "
            f"{codec.WIRE_HISTORY[PROTOCOL_VERSION]!r}: the frame "
            f"header changed — bump PROTOCOL_VERSION "
            f"(dist_dqn_tpu_torch/ingest/schema.py) and append the new "
            f"(version, digest) pair to WIRE_HISTORY; peers then fail "
            f"loudly at connect instead of desyncing mid-stream")
    if codec.WIRE_HISTORY and max(codec.WIRE_HISTORY) != PROTOCOL_VERSION:
        failures.append(
            f"WIRE_HISTORY records version {max(codec.WIRE_HISTORY)} "
            f"but PROTOCOL_VERSION is {PROTOCOL_VERSION} — history is "
            f"append-only and the constant must lead it")
    digests = list(codec.WIRE_HISTORY.values())
    if len(set(digests)) != len(digests):
        failures.append(
            "WIRE_HISTORY maps two versions to the same digest — a "
            "version bump without a wire change (or a rewritten entry)")
    return failures


class WireCheck(Check):
    name = "wire"
    description = ("the ingest wire-format fingerprint matches "
                   "WIRE_HISTORY[PROTOCOL_VERSION] (header drift must "
                   "bump the version)")
    rationale_tag = None

    def run(self, ctx: AnalysisContext) -> List[Finding]:
        return [self.finding("dist_dqn_tpu_torch/ingest/codec.py", 0, msg,
                             key=f"wire:{i}")
                for i, msg in enumerate(check())]


register(WireCheck())
