"""The port's batched slot publish (dist_dqn_tpu_torch/ingest/shm_ring.py
``push_batch``, ``push_batch_wait``, the batched ``pop`` and
``batch_bytes``) against dist_dqn_tpu/ingest/shm_ring.py: the same bytes in
shared memory, pushed by either package and popped by the other. Every
comparison is exact."""
import uuid

import numpy as np
import pytest

from dist_dqn_tpu.ingest import shm_ring as jring
from dist_dqn_tpu_torch.ingest import shm_ring as tring


@pytest.fixture
def ring_name():
    return f"tb_{uuid.uuid4().hex[:10]}"


def _records(seed, n):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, int(rng.integers(1, 300))).astype(
        np.uint8).tobytes() for _ in range(n)]


def _slot_bytes(ring):
    """The whole mapping (header and slots) as bytes."""
    return bytes(ring._shm.buf)


@pytest.mark.parametrize("sizes", [[], [0], [5], [1, 2, 3], [4096] * 8])
def test_batch_bytes_equals_jax(sizes):
    assert tring.batch_bytes(sizes) == jring.batch_bytes(sizes)
    assert tring.BATCH_FLAG == jring.BATCH_FLAG


def test_a_pushed_batch_pops_record_for_record(ring_name):
    ring = tring.ShmSlotRing(ring_name, slot_size=4096, nslots=4,
                             create=True)
    try:
        batches = [_records(s, n) for s, n in ((0, 3), (1, 1), (2, 5))]
        for b in batches:
            assert ring.push_batch(b)
        assert ring.pending == 3
        got = []
        while (rec := ring.pop()) is not None:
            got.append(rec)
        assert got == [r for b in batches for r in b]
        assert ring.pending == 0 and ring.torn_reads == 0
        assert ring.push_batch([])          # nothing to publish
        assert ring.pop() is None
        with pytest.raises(ValueError, match="exceeds slot_size"):
            ring.push_batch([b"x" * 4000, b"y" * 100])
    finally:
        ring.close()
        ring.unlink()


@pytest.mark.parametrize("producer", ["jax", "torch"])
def test_batches_cross_between_the_packages(ring_name, producer):
    """A batch JAX's push_batch publishes into a ring the port created pops
    identically through the port's pop, and the reverse; the mappings are
    equal byte for byte after the same pushes."""
    mods = {"jax": jring, "torch": tring}
    consumer = "torch" if producer == "jax" else "jax"
    owner = mods[consumer].ShmSlotRing(ring_name, slot_size=2048, nslots=4,
                                       create=True)
    writer = mods[producer].ShmSlotRing(ring_name)
    twin = mods[consumer].ShmSlotRing(f"{ring_name}_b", slot_size=2048,
                                      nslots=4, create=True)
    try:
        batches = [_records(10 + s, n) for s, n in ((0, 4), (1, 1), (2, 2))]
        for b in batches:
            assert writer.push_batch(b)
            assert twin.push_batch(b)
        assert _slot_bytes(owner) == _slot_bytes(twin)
        got = []
        while (rec := owner.pop()) is not None:
            got.append(rec)
        assert got == [r for b in batches for r in b]
    finally:
        for r in (writer, owner, twin):
            r.close()
        owner.unlink()
        twin.unlink()


def test_a_batch_of_one_is_the_unbatched_wire(ring_name):
    a = tring.ShmSlotRing(ring_name, slot_size=512, nslots=2, create=True)
    b = tring.ShmSlotRing(f"{ring_name}_b", slot_size=512, nslots=2,
                          create=True)
    try:
        rec = _records(3, 1)[0]
        assert a.push_batch([rec]) and b.push(rec)
        assert _slot_bytes(a) == _slot_bytes(b)
        assert int(a._lengths[0][0]) & tring.BATCH_FLAG == 0
        assert a.pop() == rec
    finally:
        for r in (a, b):
            r.close()
            r.unlink()


def test_a_torn_batched_slot_drops_the_whole_batch(ring_name):
    ring = tring.ShmSlotRing(ring_name, slot_size=1024, nslots=2,
                             create=True)
    try:
        assert ring.push_batch(_records(4, 3))
        ring._stamps[0][0] = 1              # a producer died mid-write
        assert ring.push_batch(_records(5, 2))
        assert ring.pop() is None and ring.torn_reads == 1
        assert [ring.pop(), ring.pop(), ring.pop()] == \
            _records(5, 2) + [None]
    finally:
        ring.close()
        ring.unlink()


def test_push_batch_wait_honours_stop(ring_name):
    ring = tring.ShmSlotRing(ring_name, slot_size=1024, nslots=1,
                             create=True)
    try:
        recs = _records(6, 2)
        assert ring.push_batch_wait(recs)
        calls = []

        def stop():
            calls.append(1)
            return len(calls) >= 3

        # The ring is full: the wait polls until stop() is true.
        assert not ring.push_batch_wait(recs, stop=stop, poll_s=0.0)
        assert len(calls) == 3
        assert [ring.pop(), ring.pop()] == recs
        assert ring.push_batch_wait(recs, stop=lambda: True)
    finally:
        ring.close()
        ring.unlink()


@pytest.mark.chaos
def test_shm_push_batch_torn_drops_whole_batch(ring_name):
    """Twin of tests/test_ingest_dedup.py:318: one seqlock covers one
    slot, so a torn batched publish can never deliver a partial batch —
    all records dropped, counted once."""
    from dist_dqn_tpu_torch import chaos

    plan = chaos.FaultPlan(seed=1, events=(
        chaos.FaultEvent("shm.publish", "torn", at_hit=2),))
    ring = tring.ShmSlotRing(ring_name, slot_size=128, nslots=4,
                             create=True)
    try:
        with chaos.installed(plan) as inj:
            assert ring.push_batch([b"a1", b"a2"])
            assert ring.push_batch([b"b1", b"b2", b"b3"])   # torn whole
            assert ring.push_batch([b"c1"])
            got = [ring.pop() for _ in range(8)]
            assert [g for g in got if g is not None] == \
                [b"a1", b"a2", b"c1"]
            assert ring.torn_reads == 1
            assert "shm.publish" not in inj.open_trips()
    finally:
        ring.close()
        ring.unlink()
