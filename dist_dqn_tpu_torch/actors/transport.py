"""Same-host transport of the Ape-X actor/learner split (the single-host
part of ``dist_dqn_tpu/actors/transport.py``).

* The C++ shared-memory primitives (``actors/_native/transport.cc``, the
  port's own copy): :class:`ShmRing`, a multi-producer byte-record ring,
  and :class:`ShmMailbox`, a versioned single-writer broadcast slot (one
  per actor: its act replies). :func:`build_native_lib` compiles the source
  with ``g++`` at first use into ``build/dist_dqn_tpu_torch/``, named by a
  hash of the source and flags.
* The array codec :func:`encode_arrays` / :func:`decode_arrays` (a small
  JSON header and raw buffers; the hello records ride it), byte for byte
  the JAX package's.
* :func:`frame_encode`, the integrity frame (``magic | length | crc32 |
  payload``) of the TCP path.

The TCP record server and client (remote actors) are not ported yet
(ROADMAP.md A8). Stdlib + numpy only: actor processes import this module
and no torch.
"""
from __future__ import annotations

import ctypes
import hashlib
import json
import os
import struct
import subprocess
import tempfile
import threading
import zlib
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np

_NATIVE_DIR = Path(__file__).parent / "_native"
BUILD_DIR = (Path(__file__).resolve().parents[2] / "build"
             / "dist_dqn_tpu_torch")
_CXX_FLAGS = ["-O2", "-std=c++17", "-shared", "-fPIC", "-pthread"]
_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()


def build_native_lib(src_name: str, lib_name: str,
                     directory: Optional[Path] = None) -> Path:
    """Compile ``_native/<src_name>`` into ``build/dist_dqn_tpu_torch/``
    unless this source's build exists; returns the library path. The file
    is named ``<lib_name>`` with a hash of the source and the flags before
    its suffix, so an edited source never loads a stale build. Raises with
    the compiler's output when ``g++`` fails."""
    src = (directory or _NATIVE_DIR) / src_name
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(_CXX_FLAGS).encode()).hexdigest()[:16]
    stem, suffix = os.path.splitext(lib_name)
    out = BUILD_DIR / f"{stem}_{digest}{suffix}"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", *_CXX_FLAGS, str(src), "-o", str(tmp)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed ({proc.returncode}): {' '.join(cmd)}"
                           f"\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def native_lib() -> ctypes.CDLL:
    """Build (if needed) and load the C++ transport library."""
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build_native_lib("transport.cc",
                                                   "libdqntransport.so")))
            ptr, u64 = ctypes.c_void_p, ctypes.c_uint64
            for name, res, args in (
                    ("dqn_ring_create", ptr, [ctypes.c_char_p, u64]),
                    ("dqn_ring_attach", ptr, [ctypes.c_char_p]),
                    ("dqn_ring_push", ctypes.c_int,
                     [ptr, ctypes.c_char_p, ctypes.c_uint32]),
                    ("dqn_ring_pop", ctypes.c_long, [ptr, ptr, u64]),
                    ("dqn_ring_peek_len", ctypes.c_long, [ptr]),
                    ("dqn_ring_dropped", u64, [ptr]),
                    ("dqn_ring_pending", u64, [ptr]),
                    ("dqn_box_create", ptr, [ctypes.c_char_p, u64]),
                    ("dqn_box_attach", ptr, [ctypes.c_char_p]),
                    ("dqn_box_write", ctypes.c_int,
                     [ptr, ctypes.c_char_p, u64, u64]),
                    ("dqn_box_read", ctypes.c_long,
                     [ptr, ptr, u64, ctypes.POINTER(u64)])):
                fn = getattr(lib, name)
                fn.restype = res
                fn.argtypes = args
            _lib = lib
    return _lib


def shm_dir() -> Path:
    """Directory of the file-backed rings, mailboxes and stop files:
    ``/dev/shm/dqn_torch`` (memory) where ``/dev/shm`` exists, else under
    the temporary directory."""
    base = Path("/dev/shm") if Path("/dev/shm").is_dir() \
        else Path(tempfile.gettempdir())
    p = base / "dqn_torch"
    p.mkdir(exist_ok=True)
    return p


class ShmRing:
    """MPSC byte-record ring over shared memory (see transport.cc)."""

    def __init__(self, name: str, capacity: int = 0, create: bool = False):
        self.path = str(shm_dir() / name).encode()
        lib = native_lib()
        self._h = (lib.dqn_ring_create(self.path, capacity) if create
                   else lib.dqn_ring_attach(self.path))
        if not self._h:
            raise OSError(f"ring {'create' if create else 'attach'} failed: "
                          f"{self.path.decode()}")
        self._lib = lib

    def push(self, payload: bytes) -> bool:
        return self._lib.dqn_ring_push(self._h, payload, len(payload)) == 0

    def pop(self) -> Optional[bytes]:
        n = self._lib.dqn_ring_peek_len(self._h)
        if n < 0:
            return None
        buf = ctypes.create_string_buffer(int(n))
        got = self._lib.dqn_ring_pop(self._h, buf, int(n))
        if got < 0:
            return None
        return buf.raw[:got]

    @property
    def dropped(self) -> int:
        return int(self._lib.dqn_ring_dropped(self._h))

    @property
    def pending_bytes(self) -> int:
        return int(self._lib.dqn_ring_pending(self._h))

    def unlink(self) -> None:
        try:
            os.unlink(self.path)
        except OSError:
            pass


class ShmMailbox:
    """Single-writer / many-reader versioned broadcast slot."""

    def __init__(self, name: str, max_size: int = 0, create: bool = False):
        self.path = str(shm_dir() / name).encode()
        lib = native_lib()
        self._h = (lib.dqn_box_create(self.path, max_size) if create
                   else lib.dqn_box_attach(self.path))
        if not self._h:
            raise OSError(f"mailbox {'create' if create else 'attach'} "
                          f"failed: {self.path.decode()}")
        self._lib = lib
        self._cap = max_size
        self._read_buf = None   # sized lazily, reused across read() calls

    def write(self, payload: bytes, version: int) -> None:
        if self._lib.dqn_box_write(self._h, payload, len(payload),
                                   version) != 0:
            raise ValueError("payload exceeds mailbox size")

    def read(self, max_size: int = 1 << 20) -> Tuple[Optional[bytes], int]:
        """(payload, version), or (None, 0) before the first write. One
        reader per mailbox, so the scratch buffer is reused; it is clamped
        to the creation-time capacity where that is known."""
        if self._cap:
            max_size = min(max_size, self._cap)
        buf = self._read_buf
        if buf is None or ctypes.sizeof(buf) < max_size:
            self._read_buf = buf = ctypes.create_string_buffer(max_size)
        ver = ctypes.c_uint64(0)
        n = self._lib.dqn_box_read(self._h, buf, max_size, ctypes.byref(ver))
        if n < 0:
            raise ValueError("mailbox read buffer too small")
        if n == 0:
            return None, 0
        return buf.raw[:n], int(ver.value)

    def unlink(self) -> None:
        try:
            os.unlink(self.path)
        except OSError:
            pass


# --------------------------------------------------------------------------
# Array codec: dict[str, np.ndarray] <-> bytes.
# --------------------------------------------------------------------------

# With DQN_TRANSPORT_CRC=1 every encoded record carries a crc32 over its
# header and array bytes, and decode verifies it.
_CRC_ENABLED = os.environ.get("DQN_TRANSPORT_CRC") == "1"

# compress="auto" compresses bodies of at least this many bytes.
_COMPRESS_AUTO_MIN = 16 * 1024


def encode_arrays(arrays: Dict[str, np.ndarray],
                  meta: Optional[Dict] = None,
                  compress: "bool | str" = False) -> bytes:
    """``len(header) | JSON header | [crc32] | body`` (the JAX package's
    bytes): the header lists each array's name, dtype and shape."""
    body_parts = [np.ascontiguousarray(v).tobytes()
                  for v in arrays.values()]
    header = {
        "meta": meta or {},
        "arrays": [[k, v.dtype.str, list(v.shape)]
                   for k, v in arrays.items()],
    }
    body_len = sum(len(p) for p in body_parts)
    if compress == "auto":
        compress = body_len >= _COMPRESS_AUTO_MIN
    if compress:
        blob = zlib.compress(b"".join(body_parts), 1)
        header["z"] = body_len  # uncompressed body length (decode check)
        body_parts = [blob]
    if _CRC_ENABLED:
        header["crc"] = True
        hb = json.dumps(header).encode()
        crc = zlib.crc32(hb)
        for part in body_parts:
            crc = zlib.crc32(part, crc)
        return b"".join([struct.pack("<I", len(hb)), hb,
                         struct.pack("<I", crc)] + body_parts)
    hb = json.dumps(header).encode()
    return b"".join([struct.pack("<I", len(hb)), hb] + body_parts)


def decode_arrays(buf: bytes) -> Tuple[Dict[str, np.ndarray], Dict]:
    """Inverse of :func:`encode_arrays`: (arrays, meta). Raises on a CRC
    mismatch and on a body that inflates to another length than its
    header says."""
    (hlen,) = struct.unpack_from("<I", buf, 0)
    header = json.loads(buf[4:4 + hlen].decode())
    off = 4 + hlen
    if header.get("crc"):
        (want,) = struct.unpack_from("<I", buf, off)
        off += 4
        view = memoryview(buf)
        got = zlib.crc32(view[off:], zlib.crc32(view[4:4 + hlen]))
        if got != want:
            raise ValueError(
                f"transport record CRC mismatch (got {got:#010x}, frame "
                f"says {want:#010x}): torn or corrupted record")
    if "z" in header:
        want_len = int(header["z"])
        d = zlib.decompressobj()
        body = d.decompress(memoryview(buf)[off:], want_len + 1)
        if len(body) != want_len or d.unconsumed_tail:
            raise ValueError(
                f"transport record decompressed to {len(body)}(+) bytes, "
                f"header says {want_len}")
        buf, off = body, 0
    out: Dict[str, np.ndarray] = {}
    for name, dtype, shape in header["arrays"]:
        dt = np.dtype(dtype)
        count = int(np.prod(shape, dtype=np.int64))
        arr = np.frombuffer(buf, dtype=dt, count=count, offset=off)
        out[name] = arr.reshape(shape).copy()
        off += count * dt.itemsize
    return out, header["meta"]


# --------------------------------------------------------------------------
# The TCP integrity frame.
# --------------------------------------------------------------------------

FRAME_MAGIC = b"DQF1"
_FRAME_HDR = struct.Struct("<4sII")


def frame_encode(payload) -> bytes:
    """One integrity-framed wire record: ``magic | length | crc32 |
    payload`` (any bytes-like payload)."""
    return b"".join((_FRAME_HDR.pack(FRAME_MAGIC, len(payload),
                                     zlib.crc32(payload)), payload))
