"""Sticky-sharded ingest routing (twin of ``dist_dqn_tpu/ingest/router.py``).

When the learner runs S replay shards, a trajectory should land directly in
the shard that will sample it. The assignment is sticky (an actor's whole
stream lands in one shard, so n-step windows never straddle shards) and
computable from the actor id alone: the learner stamps it into every reply
header and the actor echoes it on every frame. The port runs one shard, so
every actor maps to shard 0; the id still rides the frame headers and the
replay's ``added_by_shard`` accounting. The router reports the
``dqn_ingest_*`` telemetry families of the zero-copy subsystem.
"""
from __future__ import annotations

import struct
import zlib
from typing import Dict

from dist_dqn_tpu_torch.telemetry import collectors as tmc
from dist_dqn_tpu_torch.telemetry import get_registry


def shard_for(actor_id: int, num_shards: int) -> int:
    """The sticky assignment: crc32 over the little-endian actor id,
    mod the shard count. Stable across processes, hosts and runs —
    NOT Python ``hash`` (randomized per process) and NOT plain modulo
    (adjacent actor ids would stripe shards, defeating per-shard
    locality of the epsilon ladder's exploration spectrum)."""
    if num_shards <= 1:
        return 0
    return zlib.crc32(struct.pack("<I", actor_id & 0xFFFFFFFF)) \
        % num_shards


class StickyShardRouter:
    """Per-service routing table and its ingest accounting: records and
    bytes per transport, records per shard, decode rejections, each also
    a ``dqn_ingest_*`` registry series."""

    def __init__(self, num_shards: int = 1):
        if num_shards < 1:
            raise ValueError(f"num_shards must be >= 1, got {num_shards}")
        self.num_shards = num_shards
        get_registry().gauge(tmc.INGEST_SHARDS,
                             "configured replay-shard count for sticky "
                             "ingest routing").set(num_shards)
        self._c_records: Dict[str, object] = {}
        self._c_bytes: Dict[str, object] = {}
        self._c_shard: Dict[int, object] = {}
        self._c_decode_err: Dict[str, object] = {}
        self.records_by_shard: Dict[int, int] = {}
        self.bytes_by_transport: Dict[str, int] = {}
        self.decode_errors_by_reason: Dict[str, int] = {}
        self.decode_errors = 0

    def shard_for(self, actor_id: int) -> int:
        return shard_for(actor_id, self.num_shards)

    def record(self, actor_id: int, nbytes: int, transport: str) -> int:
        """Count one ingested record; returns its sticky shard id."""
        shard = self.shard_for(actor_id)
        c = self._c_records.get(transport)
        if c is None:
            reg = get_registry()
            c = reg.counter(tmc.INGEST_RECORDS,
                            "trajectory records ingested",
                            labels={"transport": transport})
            self._c_records[transport] = c
            self._c_bytes[transport] = reg.counter(
                tmc.INGEST_BYTES, "payload bytes ingested (pre-decode)",
                labels={"transport": transport})
        c.inc()
        self._c_bytes[transport].inc(nbytes)
        self.bytes_by_transport[transport] = \
            self.bytes_by_transport.get(transport, 0) + nbytes
        s = self._c_shard.get(shard)
        if s is None:
            s = get_registry().counter(
                tmc.INGEST_SHARD_RECORDS,
                "records routed to each sticky replay shard",
                labels={"shard": str(shard)})
            self._c_shard[shard] = s
        s.inc()
        self.records_by_shard[shard] = \
            self.records_by_shard.get(shard, 0) + 1
        return shard

    def decode_error(self, reason: str) -> None:
        """One zero-copy record rejected at the codec gate."""
        self.decode_errors += 1
        self.decode_errors_by_reason[reason] = \
            self.decode_errors_by_reason.get(reason, 0) + 1
        c = self._c_decode_err.get(reason)
        if c is None:
            c = get_registry().counter(
                tmc.INGEST_DECODE_ERRORS,
                "zero-copy records rejected at the codec gate",
                labels={"reason": reason})
            self._c_decode_err[reason] = c
        c.inc()
