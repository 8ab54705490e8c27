"""Check ``ckpt-schema``: the checkpoint-sidecar schema is pinned to
its version.

Twin of ``dist_dqn_tpu/analysis/plugins/ckpt_schema.py``, over the
port's own schema module. Host-replay's whole-state resume deserializes
an npz sidecar by FIELD NAME — a renamed/dropped/added field without a
version bump would surface at restore time (3am, on the production
fleet) as a silently-wrong or crashing resume, not in CI. The mechanics
mirror the
wire check: fingerprint the field registry of
``dist_dqn_tpu_torch/utils/ckpt_schema.py``; the digest must equal
``SIDECAR_HISTORY[SIDECAR_VERSION]``; history is append-only with the
live version leading it; and the schema's validator must accept its own
canonical minimal sidecar.
"""
from __future__ import annotations

from typing import List

from dist_dqn_tpu_torch.analysis.core import AnalysisContext, Check, Finding
from dist_dqn_tpu_torch.analysis.registry import register


def check() -> List[str]:
    from dist_dqn_tpu_torch.utils import ckpt_schema as cs

    failures = []
    digest = cs.sidecar_digest()
    if cs.SIDECAR_VERSION not in cs.SIDECAR_HISTORY:
        failures.append(
            f"SIDECAR_VERSION {cs.SIDECAR_VERSION} has no SIDECAR_HISTORY "
            f"entry — record it as {cs.SIDECAR_VERSION}: \"{digest}\"")
    elif cs.SIDECAR_HISTORY[cs.SIDECAR_VERSION] != digest:
        failures.append(
            f"sidecar-schema fingerprint {digest} does not match "
            f"SIDECAR_HISTORY[{cs.SIDECAR_VERSION}] = "
            f"{cs.SIDECAR_HISTORY[cs.SIDECAR_VERSION]!r}: the field set "
            f"changed — bump SIDECAR_VERSION "
            f"(dist_dqn_tpu_torch/utils/ckpt_schema.py) and append the new "
            f"(version, digest) pair to SIDECAR_HISTORY; resumes then "
            f"refuse a mismatched sidecar loudly at restore instead of "
            f"deserializing silence")
    if cs.SIDECAR_HISTORY and max(cs.SIDECAR_HISTORY) != cs.SIDECAR_VERSION:
        failures.append(
            f"SIDECAR_HISTORY records version {max(cs.SIDECAR_HISTORY)} "
            f"but SIDECAR_VERSION is {cs.SIDECAR_VERSION} — history is "
            "append-only and the constant must lead it")
    digests = list(cs.SIDECAR_HISTORY.values())
    if len(set(digests)) != len(digests):
        failures.append(
            "SIDECAR_HISTORY maps two versions to the same digest — a "
            "version bump without a schema change (or a rewritten entry)")
    # The validator itself must accept a canonical minimal sidecar —
    # a schema whose own patterns reject its scalar fields would pass
    # the digest check while failing every real save.
    try:
        cs.validate_sidecar(list(cs.SIDECAR_SCALAR_FIELDS))
    except ValueError as e:
        failures.append(f"validate_sidecar rejects the schema's own "
                        f"scalar field set: {e}")
    return failures


class CkptSchemaCheck(Check):
    name = "ckpt-schema"
    description = ("the checkpoint-sidecar field-set fingerprint "
                   "matches SIDECAR_HISTORY[SIDECAR_VERSION] (schema "
                   "drift must bump the version)")
    rationale_tag = None

    def run(self, ctx: AnalysisContext) -> List[Finding]:
        return [self.finding("dist_dqn_tpu_torch/utils/ckpt_schema.py", 0, msg,
                             key=f"ckpt:{i}")
                for i, msg in enumerate(check())]


register(CkptSchemaCheck())
