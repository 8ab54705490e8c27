"""The port's same-host transport (dist_dqn_tpu_torch/actors/transport.py):
its own C++ ring and mailbox, built with g++ from
``dist_dqn_tpu_torch/actors/_native/transport.cc`` into
``build/dist_dqn_tpu_torch/``, round-trip records; the array codec and the
integrity frame give the JAX package's bytes (exact)."""
import uuid
from pathlib import Path

import numpy as np
import pytest

from dist_dqn_tpu.actors import transport as jt
from dist_dqn_tpu_torch.actors import transport as tt

REPO = Path(__file__).resolve().parents[1]


def _name(kind):
    return f"{kind}_test_{uuid.uuid4().hex[:8]}"


def test_native_library_builds_from_the_ports_source_into_build():
    path = tt.build_native_lib("transport.cc", "libdqntransport.so")
    assert path.parent == REPO / "build" / "dist_dqn_tpu_torch"
    assert path.name.startswith("libdqntransport_") and path.exists()
    assert tt.build_native_lib("transport.cc", "libdqntransport.so") == path
    src = REPO / "dist_dqn_tpu_torch" / "actors" / "_native" / "transport.cc"
    assert src.exists()
    assert tt.native_lib() is tt.native_lib()


def test_ring_round_trips_records_and_counts_drops():
    name = _name("ring")
    ring = tt.ShmRing(name, capacity=64, create=True)
    try:
        peer = tt.ShmRing(name)
        assert ring.pop() is None
        records = [b"a", b"bcd", b"", b"x" * 20]
        for r in records:
            assert peer.push(r)
        assert ring.pending_bytes > 0
        assert [ring.pop() for _ in records] == records
        assert ring.pop() is None and ring.pending_bytes == 0
        assert not peer.push(b"y" * 100)          # larger than the ring
        assert ring.dropped == 1
    finally:
        ring.unlink()
    with pytest.raises(OSError, match="attach failed"):
        tt.ShmRing(name)


def test_mailbox_broadcasts_the_latest_version():
    name = _name("box")
    box = tt.ShmMailbox(name, max_size=256, create=True)
    try:
        reader = tt.ShmMailbox(name)
        assert reader.read() == (None, 0)
        box.write(b"first", version=1)
        box.write(b"second", version=2)
        assert reader.read() == (b"second", 2)
        assert reader.read() == (b"second", 2)
        with pytest.raises(ValueError, match="exceeds mailbox size"):
            box.write(b"z" * 300, version=3)
    finally:
        box.unlink()


@pytest.mark.parametrize("compress", [False, True, "auto"])
def test_encode_arrays_gives_the_jax_bytes(compress):
    rng = np.random.default_rng(0)
    arrays = {"obs": rng.integers(0, 256, (3, 84, 84, 4)).astype(np.uint8),
              "reward": rng.normal(size=3).astype(np.float32),
              "flags": np.array([1, 0, 1], np.uint8)}
    meta = {"kind": "hello", "actor": 2, "t": 0, "proto": 4}
    blob = tt.encode_arrays(arrays, meta, compress=compress)
    assert blob == jt.encode_arrays(arrays, meta, compress=compress)
    back, got_meta = tt.decode_arrays(blob)
    assert got_meta == meta
    for k, v in arrays.items():
        np.testing.assert_array_equal(back[k], v)
        assert back[k].dtype == v.dtype
    jback, _ = jt.decode_arrays(blob)
    np.testing.assert_array_equal(jback["obs"], back["obs"])


def test_decode_arrays_refuses_a_bad_inflate_length(monkeypatch):
    monkeypatch.setattr(tt, "_CRC_ENABLED", False)
    arrays = {"x": np.zeros(5000, np.float32)}
    blob = bytearray(tt.encode_arrays(arrays, {}, compress=True))
    hlen = int.from_bytes(blob[:4], "little")
    header = blob[4:4 + hlen].replace(b'"z": 20000', b'"z": 19996')
    bad = len(header).to_bytes(4, "little") + bytes(header) + \
        bytes(blob[4 + hlen:])
    with pytest.raises(ValueError, match="decompressed"):
        tt.decode_arrays(bad)


def test_crc_catches_a_flipped_byte(monkeypatch):
    monkeypatch.setattr(tt, "_CRC_ENABLED", True)
    monkeypatch.setattr(jt, "_CRC_ENABLED", True)
    arrays = {"x": np.arange(10, dtype=np.int32)}
    blob = tt.encode_arrays(arrays, {"k": 1})
    assert blob == jt.encode_arrays(arrays, {"k": 1})
    flipped = blob[:-1] + bytes([blob[-1] ^ 1])
    with pytest.raises(ValueError, match="CRC mismatch"):
        tt.decode_arrays(flipped)


def test_frame_encode_gives_the_jax_bytes():
    for payload in (b"", b"abc", memoryview(b"zero-copy")):
        assert tt.frame_encode(payload) == jt.frame_encode(payload)


def test_shm_dir_is_writable():
    d = tt.shm_dir()
    assert d.is_dir() and d.name == "dqn_torch"
