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

One record per slot, as rollout actors publish. The JAX package's batched
slot publish (``push_batch``), whose only producers are its feeder
processes, is not ported yet (ROADMAP.md A8, item 4).

Stdlib + numpy only (actor processes import no torch).
"""
from __future__ import annotations

from multiprocessing import shared_memory
from typing import Optional

import numpy as np

HEADER_BYTES = 32
SLOT_HEADER_BYTES = 16
# Header u64 indices.
_NSLOTS, _SLOT_SIZE, _WRITE_SEQ, _READ_SEQ = 0, 1, 2, 3


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
        w = self._claim()
        if w is None:
            return False
        i = w % self.nslots
        self._stamps[i][0] = 2 * w + 1          # odd: write in flight
        self._lengths[i][0] = n
        self._slot_data(i)[:n] = payload
        self._stamps[i][0] = 2 * w + 2          # even: published
        self._hdr[_WRITE_SEQ] = w + 1
        return True

    # -- consumer ----------------------------------------------------------
    def pop(self) -> Optional[bytes]:
        """Next record as an owned bytes copy, or None when empty. A torn
        slot is counted and skipped."""
        r = int(self._hdr[_READ_SEQ])
        if r >= int(self._hdr[_WRITE_SEQ]):
            return None
        i = r % self.nslots
        want = np.uint64(2 * r + 2)
        if self._stamps[i][0] != want:
            self.torn_reads += 1
            self._hdr[_READ_SEQ] = r + 1
            return None
        n = int(self._lengths[i][0])
        out = bytes(self._slot_data(i)[:n])
        if self._stamps[i][0] != want:          # torn during the copy
            self.torn_reads += 1
            self._hdr[_READ_SEQ] = r + 1
            return None
        self._hdr[_READ_SEQ] = r + 1
        return out

    @property
    def pending(self) -> int:
        """Records awaiting drain."""
        return int(self._hdr[_WRITE_SEQ]) - int(self._hdr[_READ_SEQ])

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
