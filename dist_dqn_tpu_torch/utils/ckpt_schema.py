"""Versioned schema of the host-replay runtime's checkpoint sidecar (the
port's own copy of ``dist_dqn_tpu/utils/ckpt_schema.py``).

A host-replay checkpoint is a learner-and-collect-carry step
(utils/checkpoint.py) plus an npz sidecar holding everything else: the
ring window, the loop cursors, the PER sampler state and any deferred
priority write-backs. Resume correctness depends on the sidecar's field
set, so this module names every field (scalars explicitly, per-shard and
per-entry families as regex patterns), carries the ``SIDECAR_VERSION`` the
writer stamps into every sidecar, and keeps the append-only
``SIDECAR_HISTORY`` of ``version -> sha256 fingerprint``. The writer calls
:func:`validate_sidecar` on every save, so a key this module does not name
fails at save time; the resume path refuses a sidecar of another version.
The field set and its history are the JAX package's, so both packages
describe one format.

stdlib only.
"""
from __future__ import annotations

import hashlib
import json
import re
from typing import Dict, Iterable, Tuple

#: Bump on ANY change to the field set below, and append the new
#: (version, digest) pair (sidecar_digest()) to SIDECAR_HISTORY.
SIDECAR_VERSION = 4

#: Scalar fields present in every host_loop sidecar.
SIDECAR_SCALAR_FIELDS: Tuple[str, ...] = (
    "sidecar_version",   # this schema's version stamp
    "env_steps",         # frame cursor at the save boundary
    "grad_steps",        # grad-step cursor
    "sample_k",          # per-index batch-RNG stream cursor
    "train_debt_iters",  # train-event cadence remainder
    "next_chunk",        # first chunk body the resumed run executes
    "chunk_iters",       # loop shape pin (cursors are in chunk units)
    "dp",                # mesh width pin (per-shard layout is positional)
    "per",               # prioritized-sampling pin (uniform <-> PER refuse)
    "prio_writeback_batch",  # PER flush-cadence pin (a changed batch
                         # would flush restored pending rows on a
                         # different schedule — silent divergence)
    "wb_count",          # deferred priority write-back entries serialized
    "has_stats",         # episode-stat scalars of the dispatched chunk ride
    "has_pending",       # serial path: next chunk's records ride along
    "sharded_collect",   # v2: collect-carry placement pin —
                         # sharded runs keep per-shard carries in the
                         # sidecar (carry{s}_leaf{i}), single-collect
                         # runs keep the one carry in the checkpoint step;
                         # a mismatch cannot restore either way
    "per_sampler_kind",  # v3: PER backend pin — 0 = host
                         # sum-tree, 1 = device priority plane. The
                         # mass shadow restores either way, but draw
                         # timing/fp-reduction order differ, so a
                         # resume that silently swapped backends would
                         # break the bit-identical-resume contract;
                         # refuse loudly instead (reason=sampler_kind)
    "population",        # v4: member-axis width pin — the
                         # host-replay runtime has no stacked-member
                         # plane yet so its writer always stamps 1; a
                         # sidecar stamped differently (a future
                         # population-capable writer) cannot resume
                         # into this loop's solo state shapes — refuse
                         # loudly instead (reason=population)
)

#: Conditional scalars: present only when their ``has_*`` flag is set.
SIDECAR_CONDITIONAL_FIELDS: Tuple[str, ...] = (
    "stats_cr",          # completed-return accumulator (has_stats)
    "stats_cc",          # completed-count accumulator (has_stats)
)

#: Array-family patterns: one entry per shard / pending record field /
#: deferred write-back entry. ``ring_*`` carries the HostTimeRing (dp=1)
#: or ShardedHostReplay (dp>1: ring_num_shards + ring_shard{i}_{field},
#: with PER sampler state as ring_shard{i}_per_{field}) snapshot;
#: ``per_*`` the dp=1 sampler snapshot; ``wb{s}_*`` the deferred
#: priority write-backs of shard s; ``pending_*`` the serial path's
#: un-appended next-chunk records.
SIDECAR_PATTERNS: Tuple[str, ...] = (
    r"^ring_[a-z_]+$",
    r"^ring_num_shards$",
    r"^ring_shard\d+_[a-z_]+$",
    r"^ring_shard\d+_per_[a-z_]+$",
    r"^per_[a-z_]+$",
    r"^wb\d+_leaf$",
    r"^wb\d+_slot_gen$",
    r"^wb_prios$",
    r"^pending_[a-z_]+$",
    # v2: per-shard collect carries —
    # carry{s}_leaf{i} is leaf i of shard s's CollectCarry, flattened
    # against the freshly-initialized carry's treedef — and the serial
    # path's per-shard pending records (pending{s}_{field}).
    r"^carry\d+_leaf\d+$",
    r"^pending\d+_[a-z_]+$",
)


def sidecar_digest() -> str:
    """Canonical fingerprint of the field set a resume must agree on."""
    spec = {
        "scalars": list(SIDECAR_SCALAR_FIELDS),
        "conditionals": list(SIDECAR_CONDITIONAL_FIELDS),
        "patterns": list(SIDECAR_PATTERNS),
    }
    return hashlib.sha256(
        json.dumps(spec, sort_keys=True).encode()).hexdigest()[:16]


#: Append-only: every released sidecar version maps to the fingerprint
#: of its field set; entries are only ever appended.
SIDECAR_HISTORY: Dict[int, str] = {
    1: "948b5e00114da529",
    2: "0e038b7fe0331a3d",
    3: "8ef0d7a524f3d7d3",
    4: "a21f0ff7cab3aeb5",
}

_COMPILED = None


def _patterns():
    global _COMPILED
    if _COMPILED is None:
        _COMPILED = [re.compile(p) for p in SIDECAR_PATTERNS]
    return _COMPILED


def validate_sidecar(keys: Iterable[str]) -> None:
    """Raise unless ``keys`` (the dict about to be written) is exactly
    the schema: every required scalar present, every key named by the
    schema. Called by the WRITER on every save — a new code path
    emitting an unnamed key fails here, at save time, with the
    bump-the-schema instruction, instead of becoming a silently-ignored
    field at restore time."""
    keys = set(keys)
    missing = [f for f in SIDECAR_SCALAR_FIELDS if f not in keys]
    if missing:
        raise ValueError(
            f"checkpoint sidecar is missing required fields {missing} — "
            "the writer and utils/ckpt_schema.py disagree; update the "
            "schema (bump SIDECAR_VERSION + append SIDECAR_HISTORY) or "
            "fix the writer")
    known = set(SIDECAR_SCALAR_FIELDS) | set(SIDECAR_CONDITIONAL_FIELDS)
    unknown = sorted(
        k for k in keys
        if k not in known and not any(p.match(k) for p in _patterns()))
    if unknown:
        raise ValueError(
            f"checkpoint sidecar carries fields the schema does not "
            f"name: {unknown} — add them to utils/ckpt_schema.py, bump "
            "SIDECAR_VERSION and append the new digest to "
            "SIDECAR_HISTORY (sidecar_digest() gives it)")
