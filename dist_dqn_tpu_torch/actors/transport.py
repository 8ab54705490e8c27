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
* The TCP record path of remote actors: :class:`TcpRecordServer` (the
  learner's listener: one serving thread per connection, replies routed by
  connection id, backpressure before shedding) and :class:`TcpRecordClient`
  (the lock-step actor's end), every record inside the integrity frame
  :func:`frame_encode` (``magic | length | crc32 | payload``).

The server's counts are plain attributes the service's summary reads, and
registry series of the JAX module's names besides: records, backlog,
backpressure, shed records and live connections of the TCP listener, and
frames failing the integrity check by ``{reason, side}``. Chaos seams:
``transport.send`` on the client's frame (drop, delay, bit_flip after the
CRC, truncate, disconnect) and ``transport.recv`` on the server's raw frame
before its CRC check (drop, delay, bit_flip, disconnect). Stdlib + numpy
only: actor processes import this module and no torch.
"""
from __future__ import annotations

import ctypes
import hashlib
import json
import os
import socket
import struct
import subprocess
import tempfile
import threading
import time
import zlib
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

from dist_dqn_tpu_torch import chaos
from dist_dqn_tpu_torch.telemetry import get_registry
from dist_dqn_tpu_torch.telemetry.collectors import (TRANSPORT_CORRUPT,
                                                     TRANSPORT_SHED)

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


# --------------------------------------------------------------------------
# The TCP record path of remote actors.
# --------------------------------------------------------------------------

#: Far above any sane record (a 256-lane pixel step is about 15 MB), far
#: below a memory-exhaustion length from a corrupt or hostile header.
MAX_FRAME_BYTES = 256 << 20

#: Reply-channel control record: the server could not use the actor's last
#: frame (a CRC drop); the actor reconnects and re-hellos instead of waiting
#: out its stall bound for an action that will never come.
CORRUPT_FRAME_NACK_KIND = "corrupt_frame"

#: Reply-channel control record: the hello declared a wire protocol version
#: or transport this service does not speak. Not churn: the actor raises
#: instead of reconnecting. ``meta["detail"]`` says why.
PROTO_MISMATCH_NACK_KIND = "proto_mismatch"


def _frame_check(payload: bytes, want_crc: int) -> bool:
    return zlib.crc32(payload) == want_crc


def _recv_exact(conn: socket.socket, n: int) -> Optional[bytes]:
    chunks = []
    while n:
        try:
            b = conn.recv(n)
        except OSError:
            return None
        if not b:
            return None
        chunks.append(b)
        n -= len(b)
    return b"".join(chunks)


def _corrupt_frame_counter(reason: str, side: str):
    return get_registry().counter(
        TRANSPORT_CORRUPT,
        "TCP frames failing the magic/length/CRC32 integrity check",
        labels={"reason": reason, "side": side})


class TcpRecordServer:
    """Full-duplex record endpoint for actors on other hosts.

    An accept thread hands each connection to a serving thread of its own,
    which reads integrity-framed records into one backlog: :meth:`pop`
    returns ``(conn_id, payload)`` and :meth:`send` routes a reply down
    that connection (the service maps each actor to the connection its
    latest record came on, so routing survives reconnects).

    A bad magic or an out-of-bound length drops the connection (the stream
    has no boundary to resume at); a CRC mismatch drops the frame and
    NACKs the sender. A full backlog pauses the connection's reads, so TCP
    flow control throttles the sender; only a drain that has stopped for
    ``max_backpressure_wait_s`` sheds records. ``corrupt_frames``,
    ``corrupt_by_reason``, ``backpressure_events`` and ``shed_records`` are
    counted under the lock. :meth:`close` ends and joins every thread.
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 max_backlog: int = 4096,
                 max_backpressure_wait_s: float = 30.0):
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(64)
        self._sock.settimeout(0.2)
        self.address = self._sock.getsockname()
        self._records: List[Tuple[int, bytes]] = []
        self._conns: Dict[int, socket.socket] = {}
        # One write lock per connection: service replies and serve-thread
        # NACKs must not interleave mid-frame on one socket.
        self._send_locks: Dict[int, threading.Lock] = {}
        self._threads: List[threading.Thread] = []
        self._next_conn = 0
        self._lock = threading.Lock()
        self._max_backlog = max_backlog
        self._max_backpressure_wait_s = float(max_backpressure_wait_s)
        self.records_received = 0
        self.backpressure_events = 0  # records that had to wait for space
        self.shed_records = 0         # records dropped after the wait bound
        self.corrupt_frames = 0       # frames failing the integrity check
        self.corrupt_by_reason: Dict[str, int] = {}
        self._shed_alarmed = False
        # The ingress queue's registry series: backlog depth is the
        # learner-behind signal on this path.
        reg = get_registry()
        self._c_records = reg.counter("dqn_transport_tcp_records_total",
                                      "records accepted from remote actors")
        self._g_backlog = reg.gauge("dqn_transport_tcp_backlog",
                                    "records queued awaiting service drain")
        self._c_backpressure = reg.counter(
            "dqn_transport_tcp_backpressure_total",
            "records that had to wait for backlog space")
        self._c_shed = reg.counter(
            TRANSPORT_SHED,
            "records shed after the bounded backpressure wait (drain "
            "stopped entirely — degrade instead of wedging)")
        self._g_conns = reg.gauge("dqn_transport_tcp_connections",
                                  "live remote-actor connections")
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._accept_loop,
                                        name="tcp-accept", daemon=True)
        self._thread.start()

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            conn.settimeout(None)
            with self._lock:
                if self._stop.is_set():
                    conn.close()
                    return
                conn_id = self._next_conn
                self._next_conn += 1
                self._conns[conn_id] = conn
                self._send_locks[conn_id] = threading.Lock()
                self._g_conns.set(len(self._conns))
                t = threading.Thread(target=self._serve,
                                     args=(conn_id, conn),
                                     name=f"tcp-serve-{conn_id}",
                                     daemon=True)
                self._threads.append(t)
            t.start()

    def _serve(self, conn_id: int, conn: socket.socket) -> None:
        conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        try:
            while not self._stop.is_set():
                hdr = _recv_exact(conn, _FRAME_HDR.size)
                if hdr is None:
                    return
                magic, n, crc = _FRAME_HDR.unpack(hdr)
                if magic != FRAME_MAGIC:
                    self._count_corrupt("bad_magic")
                    return
                if n > MAX_FRAME_BYTES:
                    self._count_corrupt("length")
                    return
                payload = _recv_exact(conn, n)
                if payload is None:
                    self._count_corrupt("truncated")
                    return
                ev = chaos.fire("transport.recv")
                if ev is not None:
                    if ev.fault == "bit_flip":
                        # Corrupt BEFORE verification: the CRC gate
                        # below must catch it — the e2e corrupt-frame
                        # invariant (a flipped bit never reaches the
                        # array codec).
                        payload = chaos.corrupt_bytes(payload, ev)
                    elif ev.fault == "drop":
                        continue
                    elif ev.fault == "delay":
                        chaos.sleep_for(ev)
                    elif ev.fault == "disconnect":
                        return
                if not _frame_check(payload, crc):
                    # The boundary held (the length matched): drop just
                    # this frame and NACK the lock-step sender.
                    self._count_corrupt("crc")
                    self.send(conn_id, encode_arrays(
                        {}, {"kind": CORRUPT_FRAME_NACK_KIND}))
                    continue
                chaos.mark_recovered("transport.recv")
                self._append(conn_id, payload)
        finally:
            with self._lock:
                self._conns.pop(conn_id, None)
                self._send_locks.pop(conn_id, None)
                self._g_conns.set(len(self._conns))
            conn.close()

    def _append(self, conn_id: int, payload: bytes) -> None:
        """Backpressure, not drops: wait for backlog space; shed only past
        the wait bound (the drain has stopped, not slowed)."""
        wait_start = None
        while not self._stop.is_set():
            with self._lock:
                if len(self._records) < self._max_backlog:
                    self._records.append((conn_id, payload))
                    self.records_received += 1
                    self._g_backlog.set(len(self._records))
                    self._c_records.inc()
                    # The drain is alive again: the next shed alarms.
                    self._shed_alarmed = False
                    return
                if wait_start is None:
                    wait_start = time.monotonic()
                    self.backpressure_events += 1
                    self._c_backpressure.inc()
            if time.monotonic() - wait_start > self._max_backpressure_wait_s:
                self._shed(conn_id)
                return
            time.sleep(0.001)

    def _count_corrupt(self, reason: str) -> None:
        with self._lock:
            self.corrupt_frames += 1
            self.corrupt_by_reason[reason] = \
                self.corrupt_by_reason.get(reason, 0) + 1
        _corrupt_frame_counter(reason, side="server").inc()

    def _shed(self, conn_id: int) -> None:
        # Under the lock: every serve thread whose wait expired sheds at
        # once; one alarm line per shed episode, every record counted.
        with self._lock:
            self.shed_records += 1
            alarm = not self._shed_alarmed
            self._shed_alarmed = True
        self._c_shed.inc()
        if alarm:
            print(json.dumps({
                "transport_shedding": True, "conn_id": conn_id,
                "backlog": self._max_backlog,
                "waited_s": self._max_backpressure_wait_s}), flush=True)

    @property
    def connections(self) -> int:
        with self._lock:
            return len(self._conns)

    def pop(self) -> Optional[Tuple[int, bytes]]:
        with self._lock:
            if not self._records:
                return None
            rec = self._records.pop(0)
            self._g_backlog.set(len(self._records))
            return rec

    def send(self, conn_id: int, payload: bytes) -> bool:
        """Reply down a connection; False if it is gone (actor churn)."""
        with self._lock:
            conn = self._conns.get(conn_id)
            send_lock = self._send_locks.get(conn_id)
        if conn is None or send_lock is None:
            return False
        try:
            with send_lock:
                conn.sendall(frame_encode(payload))
            return True
        except OSError:
            return False

    def close(self, timeout: float = 5.0) -> None:
        """Stop accepting, shut every connection down (the peers see EOF at
        once) and join the accept and serving threads."""
        self._stop.set()
        with self._lock:
            conns = list(self._conns.values())
            self._conns.clear()
        for c in conns:
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
        try:
            self._sock.close()
        except OSError:
            pass
        self._thread.join(timeout)
        with self._lock:
            threads = list(self._threads)
        for t in threads:
            t.join(timeout)


class TcpRecordClient:
    """Actor-side endpoint: push records, block on the reply.

    The remote-actor protocol is lock-step per actor (send observations,
    wait for actions), so replies are read synchronously off the same
    socket. A recv timeout is not a dead connection: the service stalls
    legitimately (a checkpoint, an evaluation), so :meth:`read_reply`
    keeps waiting while ``keep_waiting()`` approves and ``max_stall_s`` has
    not passed, and returns None on EOF, an error or a corrupt reply.
    """

    def __init__(self, address: Tuple[str, int], timeout_s: float = 5.0,
                 max_stall_s: float = 300.0):
        self._sock = socket.create_connection(address, timeout=timeout_s)
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        # A silent partition (no FIN or RST) is still torn down by the
        # kernel below the stall bound.
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_KEEPALIVE, 1)
        self._timeout_s = timeout_s
        self._max_stall_s = max_stall_s
        self.corrupt_replies = 0

    def push(self, payload) -> bool:
        """Send one record (any bytes-like payload); False on a dead
        connection. Sends get the whole stall bound: a large record may sit
        mid-send while the server's backpressure pauses its reads."""
        frame = frame_encode(payload)
        ev = chaos.fire("transport.send")
        if ev is not None:
            if ev.fault == "drop":
                # Simulated wire loss: report success, send nothing —
                # the reply never comes and the stall/reconnect path
                # must recover the lane.
                return True
            if ev.fault == "delay":
                chaos.sleep_for(ev)
            elif ev.fault == "bit_flip":
                # Corrupt AFTER the CRC was computed: genuine wire
                # corruption — the server's integrity gate must drop
                # and NACK it.
                frame = chaos.corrupt_bytes(frame, ev)
            elif ev.fault == "truncate":
                frame = chaos.truncate_bytes(frame, ev)
                try:
                    self._sock.sendall(frame)
                finally:
                    self.close()   # a half frame can never resync
                return False
            elif ev.fault == "disconnect":
                self.close()
                return False
        try:
            self._sock.settimeout(self._max_stall_s)
            self._sock.sendall(frame)
            return True
        except OSError:
            return False
        finally:
            try:
                self._sock.settimeout(self._timeout_s)
            except OSError:
                pass

    def _recv_exact(self, n: int, keep_waiting) -> Optional[bytes]:
        deadline = time.monotonic() + self._max_stall_s
        chunks = []
        while n:
            try:
                b = self._sock.recv(n)
            except socket.timeout:
                if keep_waiting() and time.monotonic() < deadline:
                    continue
                return None
            except OSError:
                return None
            if not b:
                return None
            chunks.append(b)
            n -= len(b)
            deadline = time.monotonic() + self._max_stall_s
        return b"".join(chunks)

    def read_reply(self, keep_waiting=lambda: True) -> Optional[bytes]:
        """The next reply record, or None: the connection is dead, stalled
        past ``max_stall_s``, ``keep_waiting`` said stop, or the reply
        failed the integrity check (indistinguishable from a desynced
        stream: reconnect)."""
        hdr = self._recv_exact(_FRAME_HDR.size, keep_waiting)
        if hdr is None:
            return None
        magic, n, crc = _FRAME_HDR.unpack(hdr)
        if magic != FRAME_MAGIC or n > MAX_FRAME_BYTES:
            self.corrupt_replies += 1
            _corrupt_frame_counter(
                "bad_magic" if magic != FRAME_MAGIC else "length",
                side="client").inc()
            return None
        payload = self._recv_exact(n, keep_waiting)
        if payload is None:
            return None
        if not _frame_check(payload, crc):
            self.corrupt_replies += 1
            _corrupt_frame_counter("crc", side="client").inc()
            return None
        return payload

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass
