"""Seqlock-stamped shared-memory slot ring (twin of
``dist_dqn_tpu/ingest/shm_ring.py``, the same bytes in shared memory).

A single-producer / single-consumer slot ring over
``multiprocessing.shared_memory``: a same-host actor publishes one
zero-copy record (``ingest/codec.py``) into a fixed-size slot; the learner
copies it out once (ownership transfer) and decodes views over that copy.
One ring per actor: the SPSC discipline is what makes it lock-free.

Layout::

    header (32 B): u64 nslots | u64 slot_size | u64 write_seq | u64 read_seq
    slot i (16 B + slot_size): u64 stamp | u32 length | u32 rsvd | payload

The producer writes ``2*seq + 1`` (odd: in flight) into the slot's stamp
before touching its body and ``2*seq + 2`` after, then advances
``write_seq``; the consumer re-checks the stamp after its copy. A producer
that died mid-write leaves an odd stamp: the record is dropped and counted
in ``torn_reads``, never decoded.

Batched slot publishes: a lock-step actor keeps one record in flight, but
an unthrottled feeder (``actors/feeder.py``) would pay the whole stamp,
length and sequence handshake per record. :meth:`ShmSlotRing.push_batch`
puts up to N records into one slot: one odd/even stamp cycle, one
``write_seq`` advance and one torn-read re-check for the batch. A batched
slot sets the high bit of its length word (``BATCH_FLAG``), and its payload
is ``u32 n | (u32 len_i | bytes_i) * n``; :meth:`ShmSlotRing.pop` unbatches
it into a consumer-side queue, so the drain cannot tell feeders from
actors. A batch of one takes :meth:`ShmSlotRing.push`, byte for byte the
unbatched wire, and a torn batched slot drops the whole batch.
:meth:`ShmSlotRing.push_wait` and :meth:`ShmSlotRing.push_batch_wait` are
their blocking forms: they retry a full ring until it takes the record.

Chaos seam ``shm.publish`` on both publishes: "drop" reports success and
publishes nothing, "stall" sleeps, "torn" advances ``write_seq`` with the
stamp left odd (die-mid-write); the next clean publish marks it recovered.

Stdlib + numpy only (actor processes import no torch).
"""
from __future__ import annotations

import struct
import time
from collections import deque
from multiprocessing import shared_memory
from typing import Optional, Sequence

import numpy as np

from dist_dqn_tpu_torch import chaos
from dist_dqn_tpu_torch.telemetry import get_registry
from dist_dqn_tpu_torch.telemetry.collectors import (INGEST_SHM_BATCH_FANIN,
                                                     INGEST_SHM_TORN,
                                                     SHM_FANIN_BUCKETS)

HEADER_BYTES = 32
SLOT_HEADER_BYTES = 16
# Header u64 indices.
_NSLOTS, _SLOT_SIZE, _WRITE_SEQ, _READ_SEQ = 0, 1, 2, 3
#: High bit of a slot's length word: the payload is a batch
#: (``u32 n | (u32 len_i | bytes_i) * n``), not one record.
BATCH_FLAG = 0x80000000


def batch_bytes(payload_sizes) -> int:
    """Slot bytes one batched publish of records of these sizes needs (the
    slot sizing of batching feeders)."""
    return 4 + sum(4 + int(n) for n in payload_sizes)


class ShmSlotRing:
    """SPSC byte-record ring over POSIX shared memory.

    ``create=True`` (the learner service) allocates the segment and owns
    its unlink; actors attach by name.
    """

    def __init__(self, name: str, slot_size: int = 0, nslots: int = 0,
                 create: bool = False):
        self.name = name
        if create:
            if slot_size <= 0 or nslots <= 0:
                raise ValueError("create=True requires slot_size and "
                                 "nslots")
            total = HEADER_BYTES + nslots * (SLOT_HEADER_BYTES + slot_size)
            self._shm = shared_memory.SharedMemory(name=name, create=True,
                                                   size=total)
            hdr = np.frombuffer(self._shm.buf, np.uint64, 4)
            hdr[_NSLOTS] = nslots
            hdr[_SLOT_SIZE] = slot_size
            hdr[_WRITE_SEQ] = 0
            hdr[_READ_SEQ] = 0
        else:
            self._shm = shared_memory.SharedMemory(name=name)
        self._hdr = np.frombuffer(self._shm.buf, np.uint64, 4)
        self.nslots = int(self._hdr[_NSLOTS])
        self.slot_size = int(self._hdr[_SLOT_SIZE])
        self._stride = SLOT_HEADER_BYTES + self.slot_size
        self._stamps = [
            np.frombuffer(self._shm.buf, np.uint64, 1,
                          HEADER_BYTES + i * self._stride)
            for i in range(self.nslots)]
        self._lengths = [
            np.frombuffer(self._shm.buf, np.uint32, 1,
                          HEADER_BYTES + i * self._stride + 8)
            for i in range(self.nslots)]
        self.torn_reads = 0
        self._c_torn = get_registry().counter(
            INGEST_SHM_TORN,
            "shm slot-ring records dropped on a stamp mismatch "
            "(producer died mid-write or injected torn publish)")
        self._h_fanin = get_registry().histogram(
            INGEST_SHM_BATCH_FANIN,
            "records delivered per slot publish (1 = unbatched)",
            buckets=SHM_FANIN_BUCKETS)
        # Records of an already-popped batched slot awaiting delivery (only
        # the consumer touches it).
        self._pending_pop: "deque[bytes]" = deque()

    def _slot_data(self, i: int) -> memoryview:
        off = HEADER_BYTES + i * self._stride + SLOT_HEADER_BYTES
        return self._shm.buf[off:off + self.slot_size]

    def _claim(self) -> Optional[int]:
        """The write sequence number of a free slot, or None when full."""
        w = int(self._hdr[_WRITE_SEQ])
        if w - int(self._hdr[_READ_SEQ]) >= self.nslots:
            return None
        return w

    # -- producer ----------------------------------------------------------
    def push(self, payload) -> bool:
        """Publish one record; False when the ring is full (the caller
        retries: the lock-step actor keeps one record in flight, so a
        full ring means the learner is behind)."""
        n = len(payload)
        if n > self.slot_size:
            raise ValueError(f"record of {n} bytes exceeds slot_size "
                             f"{self.slot_size}")
        ev = chaos.fire("shm.publish")
        if ev is not None:
            if ev.fault == "drop":
                # Simulated loss: report success, publish nothing — the
                # stall watchdog / supervision path must recover.
                return True
            if ev.fault == "stall":
                chaos.sleep_for(ev)
        w = self._claim()
        if w is None:
            return False
        i = w % self.nslots
        self._stamps[i][0] = 2 * w + 1          # odd: write in flight
        self._lengths[i][0] = n
        self._slot_data(i)[:n] = payload
        if ev is not None and ev.fault == "torn":
            # Die-mid-write semantics: the seq advances but the stamp
            # stays odd — the consumer must detect and drop, never
            # decode. (Recovery proof = the next clean publish.)
            self._hdr[_WRITE_SEQ] = w + 1
            return True
        self._stamps[i][0] = 2 * w + 2          # even: published
        self._hdr[_WRITE_SEQ] = w + 1
        chaos.mark_recovered("shm.publish")
        return True

    def push_batch(self, payloads: Sequence) -> bool:
        """Publish up to N records in one slot: one stamp cycle and one
        ``write_seq`` advance for the batch. False when the ring is full
        (the caller retries the whole batch). A batch of one takes
        :meth:`push`, so it is the unbatched wire byte for byte."""
        if len(payloads) == 1:
            return self.push(payloads[0])
        if not payloads:
            return True
        total = batch_bytes(len(p) for p in payloads)
        if total > self.slot_size:
            raise ValueError(
                f"batch of {len(payloads)} records needs {total} bytes, "
                f"exceeds slot_size {self.slot_size}")
        ev = chaos.fire("shm.publish")
        if ev is not None:
            if ev.fault == "drop":
                return True
            if ev.fault == "stall":
                chaos.sleep_for(ev)
        w = self._claim()
        if w is None:
            return False
        i = w % self.nslots
        self._stamps[i][0] = 2 * w + 1          # odd: write in flight
        self._lengths[i][0] = total | BATCH_FLAG
        slot = self._slot_data(i)
        struct.pack_into("<I", slot, 0, len(payloads))
        off = 4
        for p in payloads:
            struct.pack_into("<I", slot, off, len(p))
            off += 4
            slot[off:off + len(p)] = p
            off += len(p)
        if ev is not None and ev.fault == "torn":
            # Die-mid-write semantics: the WHOLE batch must be dropped
            # by the consumer's stamp check — one seqlock covers one
            # slot, so partial delivery of a torn batch cannot happen.
            self._hdr[_WRITE_SEQ] = w + 1
            return True
        self._stamps[i][0] = 2 * w + 2          # even: published
        self._hdr[_WRITE_SEQ] = w + 1
        chaos.mark_recovered("shm.publish")
        return True

    def push_wait(self, payload, stop=lambda: False,
                  poll_s: float = 0.0005) -> bool:
        """Blocking push: retry until published or ``stop()``."""
        while not self.push(payload):
            if stop():
                return False
            time.sleep(poll_s)
        return True

    def push_batch_wait(self, payloads: Sequence, stop=lambda: False,
                        poll_s: float = 0.0005) -> bool:
        """Blocking :meth:`push_batch`: retry until published, or return
        False once ``stop()`` is true."""
        while not self.push_batch(payloads):
            if stop():
                return False
            time.sleep(poll_s)
        return True

    # -- consumer ----------------------------------------------------------
    def pop(self) -> Optional[bytes]:
        """Next record as an owned bytes copy, or None when empty. A torn
        slot is counted and skipped whole (for a batched slot, the whole
        batch). A batched slot's records queue consumer-side, and the next
        calls deliver them in order."""
        if self._pending_pop:
            return self._pending_pop.popleft()
        r = int(self._hdr[_READ_SEQ])
        if r >= int(self._hdr[_WRITE_SEQ]):
            return None
        i = r % self.nslots
        want = np.uint64(2 * r + 2)
        if self._stamps[i][0] != want:
            self.torn_reads += 1
            self._c_torn.inc()
            self._hdr[_READ_SEQ] = r + 1
            return None
        n = int(self._lengths[i][0])
        batched = bool(n & BATCH_FLAG)
        n &= ~BATCH_FLAG
        out = bytes(self._slot_data(i)[:n])
        if self._stamps[i][0] != want:          # torn during the copy
            self.torn_reads += 1
            self._c_torn.inc()
            self._hdr[_READ_SEQ] = r + 1
            return None
        self._hdr[_READ_SEQ] = r + 1
        if not batched:
            self._h_fanin.observe(1.0)
            return out
        (count,) = struct.unpack_from("<I", out, 0)
        self._h_fanin.observe(float(count))
        off = 4
        for _ in range(count):
            (ln,) = struct.unpack_from("<I", out, off)
            off += 4
            self._pending_pop.append(out[off:off + ln])
            off += ln
        return self._pending_pop.popleft() if self._pending_pop else None

    @property
    def pending(self) -> int:
        """Records awaiting drain: a batched slot still in shared memory
        counts as one until popped; records of a popped batch count each."""
        return (int(self._hdr[_WRITE_SEQ]) - int(self._hdr[_READ_SEQ])
                + len(self._pending_pop))

    def close(self) -> None:
        # Drop every numpy view of the mapping first: an exported buffer
        # keeps the mmap pinned and SharedMemory.close() raises.
        self._hdr = None
        self._stamps = []
        self._lengths = []
        try:
            self._shm.close()
        except BufferError:
            pass

    def unlink(self) -> None:
        try:
            self._shm.unlink()
        except FileNotFoundError:
            pass
