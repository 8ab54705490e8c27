"""The port's TCP record path (dist_dqn_tpu_torch/actors/transport.py
``TcpRecordServer`` / ``TcpRecordClient``) against the JAX package's:

* the twins of JAX's ``test_tcp_roundtrip_and_reply_routing``,
  ``test_tcp_record_transport`` and ``test_shed_bookkeeping_is_threadsafe``;
* the wire is the JAX package's, byte for byte (exact): the integrity
  frame and the NACK records are equal, and a JAX client talks to the
  port's server and the port's client to a JAX server;
* the integrity gate: a CRC mismatch drops the frame, keeps the stream and
  NACKs; a bad magic drops the connection; both are counted by reason;
* a full backlog backpressures, then sheds past the wait bound;
* ``close()`` joins the accept and serving threads.

Every server binds port 0 (the tests run under xdist).
"""
import json
import socket
import struct
import sys
import threading
import time
import zlib

import numpy as np

from dist_dqn_tpu.actors import transport as jt
from dist_dqn_tpu_torch.actors import transport as tt


def _pop(server, n, timeout=10.0):
    got = []
    deadline = time.time() + timeout
    while len(got) < n and time.time() < deadline:
        rec = server.pop()
        if rec is None:
            time.sleep(0.002)
            continue
        got.append(rec)
    return got


def _tcp_threads():
    return [t for t in threading.enumerate()
            if t.name.startswith(("tcp-accept", "tcp-serve"))]


def test_tcp_roundtrip_and_reply_routing():
    server = tt.TcpRecordServer(host="127.0.0.1")
    try:
        c1 = tt.TcpRecordClient(server.address, max_stall_s=20)
        c2 = tt.TcpRecordClient(server.address, max_stall_s=20)
        c1.push(tt.encode_arrays({"x": np.arange(3)}, {"actor": 1}))
        c2.push(tt.encode_arrays({"x": np.arange(4)}, {"actor": 2}))
        got = {}
        for conn_id, payload in _pop(server, 2):
            _, meta = tt.decode_arrays(payload)
            got[meta["actor"]] = conn_id
        assert set(got) == {1, 2} and got[1] != got[2]
        # Replies route per connection, full duplex.
        assert server.send(got[1], tt.encode_arrays({"a": np.array([7])}))
        assert server.send(got[2], tt.encode_arrays({"a": np.array([9])}))
        r1, _ = tt.decode_arrays(c1.read_reply())
        r2, _ = tt.decode_arrays(c2.read_reply())
        assert int(r1["a"][0]) == 7 and int(r2["a"][0]) == 9
        c1.close()
        c2.close()
        # A send to a closed connection reports failure, not a crash.
        for _ in range(200):
            if not server.send(got[1], b"x"):
                break
            time.sleep(0.01)
        assert not server.send(got[1], b"x")
    finally:
        server.close()


def test_tcp_records_arrive_in_send_order_on_one_connection():
    server = tt.TcpRecordServer()
    try:
        client = tt.TcpRecordClient(server.address, max_stall_s=20)
        payloads = [tt.encode_arrays({"x": np.arange(i + 1)})
                    for i in range(5)]
        for p in payloads:
            assert client.push(p)
        got = _pop(server, 5)
        assert [p for _, p in got] == payloads
        assert len({c for c, _ in got}) == 1
        assert server.records_received == 5
        client.close()
    finally:
        server.close()


def test_shed_bookkeeping_is_threadsafe(capsys):
    """N concurrent sheds count N records and print one alarm line per
    shed episode; a successful append opens the next episode."""
    server = tt.TcpRecordServer()
    n_threads = 16
    old_interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        start = threading.Barrier(n_threads)

        def shed():
            start.wait()
            for _ in range(50):
                server._shed(0)

        workers = [threading.Thread(target=shed, daemon=True)
                   for _ in range(n_threads)]
        for w in workers:
            w.start()
        for w in workers:
            w.join()
    finally:
        sys.setswitchinterval(old_interval)
        server.close()
    assert server.shed_records == n_threads * 50
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if "transport_shedding" in ln]
    assert len(lines) == 1, lines
    assert json.loads(lines[0])["transport_shedding"] is True
    with server._lock:
        server._shed_alarmed = False
    server._shed(0)
    assert "transport_shedding" in capsys.readouterr().out


def test_frames_and_nacks_are_the_jax_bytes():
    rng = np.random.default_rng(0)
    for n in (0, 1, 17, 4096):
        payload = rng.integers(0, 256, n).astype(np.uint8).tobytes()
        assert tt.frame_encode(payload) == jt.frame_encode(payload)
        assert tt.frame_encode(memoryview(payload)) == jt.frame_encode(
            payload)
    assert tt.MAX_FRAME_BYTES == jt.MAX_FRAME_BYTES
    assert tt.CORRUPT_FRAME_NACK_KIND == jt.CORRUPT_FRAME_NACK_KIND
    assert tt.PROTO_MISMATCH_NACK_KIND == jt.PROTO_MISMATCH_NACK_KIND
    for meta in ({"kind": tt.CORRUPT_FRAME_NACK_KIND},
                 {"kind": tt.PROTO_MISMATCH_NACK_KIND, "detail": "v9"}):
        assert tt.encode_arrays({}, meta) == jt.encode_arrays({}, meta)


def test_jax_and_port_endpoints_interoperate():
    """A JAX client against the port's server, and the port's client
    against a JAX server: records and replies cross unchanged."""
    payload = tt.encode_arrays({"obs": np.arange(12, dtype=np.uint8)},
                               {"kind": "hello", "actor": 3, "t": 0})
    reply = tt.encode_arrays({"action": np.array([1, 0], np.int32)})
    for server_cls, client_cls in ((tt.TcpRecordServer, jt.TcpRecordClient),
                                   (jt.TcpRecordServer, tt.TcpRecordClient)):
        server = server_cls(host="127.0.0.1")
        try:
            client = client_cls(server.address, max_stall_s=20)
            assert client.push(payload)
            (conn_id, got), = _pop(server, 1)
            assert got == payload
            assert server.send(conn_id, reply)
            assert client.read_reply() == reply
            client.close()
        finally:
            server.close()


def test_crc_mismatch_drops_the_frame_and_nacks_bad_magic_drops_conn():
    server = tt.TcpRecordServer()
    try:
        client = tt.TcpRecordClient(server.address, max_stall_s=20)
        good = tt.encode_arrays({"x": np.arange(3)}, {"actor": 1})
        frame = bytearray(tt.frame_encode(good))
        frame[-1] ^= 0xFF                   # payload corrupt, length intact
        client._sock.sendall(bytes(frame))
        nack = client.read_reply()
        _, meta = tt.decode_arrays(nack)
        assert meta == {"kind": tt.CORRUPT_FRAME_NACK_KIND}
        # The stream survived the dropped frame.
        assert client.push(good)
        (_, got), = _pop(server, 1)
        assert got == good
        assert server.corrupt_by_reason == {"crc": 1}
        # A bad magic desyncs the stream: the server drops the connection.
        client._sock.sendall(struct.pack("<4sII", b"XXXX", 3,
                                         zlib.crc32(b"abc")) + b"abc")
        assert client.read_reply() is None
        client.close()
        deadline = time.time() + 10
        while server.connections and time.time() < deadline:
            time.sleep(0.01)
        assert server.connections == 0
        assert server.corrupt_frames == 2
        assert server.corrupt_by_reason == {"crc": 1, "bad_magic": 1}
    finally:
        server.close()


def test_client_counts_a_corrupt_reply():
    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)
    try:
        client = tt.TcpRecordClient(srv.getsockname(), max_stall_s=20)
        conn, _ = srv.accept()
        bad = bytearray(tt.frame_encode(b"reply"))
        bad[-1] ^= 1
        conn.sendall(bytes(bad))
        assert client.read_reply() is None
        assert client.corrupt_replies == 1
        client.close()
        conn.close()
    finally:
        srv.close()


def test_full_backlog_backpressures_then_sheds(capsys):
    server = tt.TcpRecordServer(max_backlog=2, max_backpressure_wait_s=0.3)
    try:
        client = tt.TcpRecordClient(server.address, max_stall_s=20)
        records = [tt.encode_arrays({"x": np.array([i])}) for i in range(4)]
        for r in records:
            assert client.push(r)
        deadline = time.time() + 10
        while server.shed_records < 2 and time.time() < deadline:
            time.sleep(0.01)
        # Nobody drained: two records queued, the third waited (one
        # backpressure event each) and was shed, then the fourth.
        assert server.shed_records == 2
        assert server.backpressure_events == 2
        assert [p for _, p in _pop(server, 2)] == records[:2]
        lines = [ln for ln in capsys.readouterr().out.splitlines()
                 if "transport_shedding" in ln]
        assert len(lines) == 1
        client.close()
    finally:
        server.close()


def test_close_joins_every_server_thread():
    before = set(_tcp_threads())
    server = tt.TcpRecordServer()
    clients = [tt.TcpRecordClient(server.address, max_stall_s=20)
               for _ in range(3)]
    for c in clients:
        c.push(b"x")
    _pop(server, 3)
    assert len(set(_tcp_threads()) - before) == 4
    server.close()
    assert set(_tcp_threads()) - before == set()
    # The peers see the end of the stream at once.
    for c in clients:
        assert c.read_reply() is None
        c.close()
