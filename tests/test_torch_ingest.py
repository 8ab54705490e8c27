"""Port parity of the zero-copy ingest path (dist_dqn_tpu_torch/ingest/)
against the JAX package's ``dist_dqn_tpu/ingest/``: the same schemas, the
same record and reply bytes (plain, with q planes, with the lineage
trailer, and the frame-stack dedup plane), the same sticky shards, and a
slot ring either package can read. Exact: these are bytes."""
import threading
import time
import uuid

import numpy as np
import pytest

from dist_dqn_tpu import ingest as jingest
from dist_dqn_tpu.ingest import shm_ring as jshm
from dist_dqn_tpu_torch import ingest as tingest
from dist_dqn_tpu_torch.envs.gym_adapter import make_host_env


def _records(rng, obs_shape, dtype, lanes, steps=6):
    """Step records with every field: random obs, some done lanes."""
    out = []
    for t in range(steps):
        if np.dtype(dtype) == np.uint8:
            obs, nxt = (rng.integers(0, 256, (lanes,) + obs_shape)
                        .astype(np.uint8) for _ in range(2))
        else:
            obs, nxt = (rng.normal(size=(lanes,) + obs_shape)
                        .astype(dtype) for _ in range(2))
        out.append({"obs": obs, "next_obs": nxt,
                    "reward": rng.normal(size=lanes).astype(np.float32),
                    "terminated": (rng.uniform(size=lanes) < 0.2)
                    .astype(np.uint8),
                    "truncated": (rng.uniform(size=lanes) < 0.1)
                    .astype(np.uint8)})
    return out


def test_protocol_and_wire_constants_match_jax():
    assert tingest.PROTOCOL_VERSION == jingest.PROTOCOL_VERSION
    from dist_dqn_tpu.ingest import codec as jc
    from dist_dqn_tpu_torch.ingest import codec as tc
    assert tc.WIRE_HEADER_FIELDS == jc.WIRE_HEADER_FIELDS
    assert tc.WIRE_KINDS == jc.WIRE_KINDS and tc.WIRE_FLAGS == jc.WIRE_FLAGS
    assert tc.WIRE_HISTORY == jc.WIRE_HISTORY
    assert tc.HEADER_BYTES == jc.HEADER_BYTES == 20


@pytest.mark.parametrize("obs_shape,dtype,lanes", [
    ((4,), np.float32, 3), ((84, 84, 4), np.uint8, 2), ((8, 8, 4), np.uint8,
                                                         5)])
def test_step_schema_matches_jax(obs_shape, dtype, lanes):
    t = tingest.step_schema(obs_shape, dtype, lanes)
    j = jingest.step_schema(obs_shape, dtype, lanes)
    assert t.to_dict() == j.to_dict() and t.to_json() == j.to_json()
    assert t.record_bytes == j.record_bytes
    assert tingest.TrajectorySchema.from_json(j.to_json()) == t
    assert tingest.max_record_bytes(t) == jingest.max_record_bytes(j)
    if len(obs_shape) == 3:
        assert (tingest.max_dedup_record_bytes(t, 4)
                == jingest.max_dedup_record_bytes(j, 4))


@pytest.mark.parametrize("stack,msg", [(1, "frame_stack >= 2"),
                                       (3, "stacks 4 frames")])
def test_validate_dedup_stack_refuses_as_jax_does(stack, msg):
    t = tingest.step_schema((8, 8, 4), np.uint8, 2)
    j = jingest.step_schema((8, 8, 4), np.uint8, 2)
    with pytest.raises(ValueError, match=msg) as te:
        tingest.validate_dedup_stack(t, stack)
    with pytest.raises(ValueError) as je:
        jingest.validate_dedup_stack(j, stack)
    assert str(te.value) == str(je.value)


@pytest.mark.parametrize("with_q,lineage", [(False, False), (True, False),
                                            (True, True)])
@pytest.mark.parametrize("obs_shape,dtype", [((4,), np.float32),
                                             ((84, 84, 4), np.uint8)])
def test_step_records_encode_to_jax_bytes_and_decode(obs_shape, dtype,
                                                     with_q, lineage):
    rng = np.random.default_rng(0)
    lanes = 3
    tenc = tingest.StepEncoder(tingest.step_schema(obs_shape, dtype, lanes))
    jenc = jingest.StepEncoder(jingest.step_schema(obs_shape, dtype, lanes))
    tdec = tingest.StepDecoder(tingest.step_schema(obs_shape, dtype, lanes))
    jdec = jingest.StepDecoder(jingest.step_schema(obs_shape, dtype, lanes))
    for t, rec in enumerate(_records(rng, obs_shape, dtype, lanes)):
        kw = {}
        if with_q:
            kw.update(q_sel=rng.normal(size=lanes).astype(np.float32),
                      q_max=rng.normal(size=lanes).astype(np.float32))
        if lineage:
            kw.update(birth_time=1.7e9 + t, params_version=40 + t)
        tb = bytes(tenc.encode_step(rec, actor=5, t=t + 1, shard=0, **kw))
        jb = bytes(jenc.encode_step(rec, actor=5, t=t + 1, shard=0, **kw))
        assert tb == jb
        arrays, meta = tdec.decode(tb)
        jarrays, jmeta = jdec.decode(jb)
        for k, v in rec.items():
            np.testing.assert_array_equal(arrays[k], v)
            np.testing.assert_array_equal(arrays[k], jarrays[k])
        assert {k: meta[k] for k in ("actor", "t", "shard")} == {
            "actor": 5, "t": t + 1, "shard": 0}
        if with_q:
            np.testing.assert_array_equal(meta["q_sel"], kw["q_sel"])
            np.testing.assert_array_equal(meta["q_max"], jmeta["q_max"])
        if lineage:
            assert meta["birth_time"] == jmeta["birth_time"] == 1.7e9 + t
            assert meta["params_version"] == 40 + t
        assert tingest.peek_header(tb) == jingest.peek_header(jb)


def test_step_decoder_rejects_what_jax_rejects():
    schema = tingest.step_schema((4,), np.float32, 2)
    rec = _records(np.random.default_rng(1), (4,), np.float32, 2, 1)[0]
    good = bytes(tingest.StepEncoder(schema).encode_step(rec, actor=1, t=1))
    dec = tingest.StepDecoder(schema)
    with pytest.raises(tingest.WireFormatError, match="record length"):
        dec.decode(good[:-4])
    with pytest.raises(tingest.WireFormatError, match="lanes"):
        tingest.StepDecoder(tingest.step_schema((4,), np.float32, 3)
                            ).decode(good)
    bad_version = good[:2] + (99).to_bytes(2, "little") + good[4:]
    with pytest.raises(tingest.ProtocolMismatchError):
        dec.decode(bad_version)
    assert not tingest.is_zc(b"\x10\x00\x00\x00{") and tingest.is_zc(good)


@pytest.mark.parametrize("with_q,version", [(False, None), (True, 7)])
def test_replies_encode_to_jax_bytes_and_decode(with_q, version):
    rng = np.random.default_rng(2)
    action = rng.integers(0, 6, 8).astype(np.int32)
    q = [rng.normal(size=8).astype(np.float32) for _ in range(2)] \
        if with_q else [None, None]
    kw = dict(actor=3, t=11, shard=0, q_sel=q[0], q_max=q[1],
              params_version=version)
    tb = tingest.encode_reply(action, **kw)
    assert tb == jingest.encode_reply(action, **kw)
    a, qs, qm, hdr = tingest.decode_reply(tb)
    np.testing.assert_array_equal(a, action)
    if with_q:
        np.testing.assert_array_equal(qs, q[0])
        np.testing.assert_array_equal(qm, q[1])
        assert hdr["params_version"] == 7
    else:
        assert qs is None and qm is None and "params_version" not in hdr


@pytest.mark.parametrize("verify", [False, True])
def test_dedup_records_match_jax_bytes_and_rebuild_the_stacks(verify):
    """A synthstack stream (8x8 frames stacked 4 deep, auto-reset lanes)
    through both packages' dedup encoders: the same bytes every record,
    canonical and boundary, and the port's decoder rebuilds the stacks."""
    lanes, fs = 4, 4
    env = make_host_env("synthstack", lanes, seed=3)
    obs = env.reset()
    tschema = tingest.step_schema(obs.shape[1:], obs.dtype, lanes)
    jschema = jingest.step_schema(obs.shape[1:], obs.dtype, lanes)
    tenc = tingest.DedupStepEncoder(tschema, fs, verify=verify)
    jenc = jingest.DedupStepEncoder(jschema, fs, verify=verify)
    tdec = tingest.DedupStepDecoder(tschema, fs, t0=0, history=64)
    jdec = jingest.DedupStepDecoder(jschema, fs, t0=0, history=64)
    rng = np.random.default_rng(4)
    canon = general = 0
    for t in range(300):
        prev = obs
        obs, nxt, reward, term, trunc = env.step(
            rng.integers(0, 4, lanes))
        rec = {"obs": obs, "next_obs": nxt, "reward": reward,
               "terminated": term.astype(np.uint8),
               "truncated": trunc.astype(np.uint8)}
        q = rng.normal(size=(2, lanes)).astype(np.float32)
        kw = dict(actor=2, t=t + 1, q_sel=q[0], q_max=q[1],
                  birth_time=1.0 + t, params_version=t)
        tb = bytes(tenc.encode_step(rec, **kw))
        assert tb == bytes(jenc.encode_step(rec, **kw)), t
        flags = tingest.peek_header(tb)["flags"]
        canon += bool(flags & tingest.FLAG_DEDUP_CANON)
        general += not flags & tingest.FLAG_DEDUP_CANON
        arrays, meta = tdec.decode(tb)
        jarrays, _ = jdec.decode(tb)
        np.testing.assert_array_equal(arrays["obs"], obs)
        np.testing.assert_array_equal(arrays["next_obs"], nxt)
        np.testing.assert_array_equal(arrays["obs"], jarrays["obs"])
        np.testing.assert_array_equal(meta["q_max"], q[1])
        assert not np.array_equal(prev, obs)
    assert general > 0 and (verify or canon > general)
    assert (tdec.frames_reused, tdec.bytes_saved) == (jdec.frames_reused,
                                                      jdec.bytes_saved)
    # A lost record breaks the chain: the next one is refused whole.
    obs, nxt, reward, term, trunc = env.step(np.zeros(lanes, np.int64))
    rec = {"obs": obs, "next_obs": nxt, "reward": reward,
           "terminated": term.astype(np.uint8),
           "truncated": trunc.astype(np.uint8)}
    skipped = bytes(tenc.encode_step(rec, actor=2, t=302))
    with pytest.raises(tingest.WireFormatError):
        tdec.decode(skipped)


@pytest.mark.parametrize("num_shards", [1, 2, 3, 8])
def test_router_shards_match_jax(num_shards):
    ids = list(range(200)) + [2 ** 31, 2 ** 32 - 1]
    assert ([tingest.shard_for(i, num_shards) for i in ids]
            == [jingest.shard_for(i, num_shards) for i in ids])
    router = tingest.StickyShardRouter(num_shards)
    for i in ids[:10]:
        assert router.record(i, 100, "shm") == jingest.shard_for(
            i, num_shards)
    router.decode_error("WireFormatError")
    assert sum(router.records_by_shard.values()) == 10
    assert router.bytes_by_transport == {"shm": 1000}
    assert router.decode_errors == 1
    with pytest.raises(ValueError, match="num_shards"):
        tingest.StickyShardRouter(0)


def _ring_name():
    return f"dqn_torch_test_{uuid.uuid4().hex[:8]}"


def test_slot_ring_round_trips_batches_and_fills():
    name = _ring_name()
    ring = tingest.ShmSlotRing(name, slot_size=64, nslots=4, create=True)
    try:
        peer = tingest.ShmSlotRing(name)
        assert ring.pop() is None and ring.pending == 0
        for k in range(4):
            assert peer.push(bytes([k]) * (k + 1))
        assert not peer.push(b"x")               # full: the caller retries
        assert ring.pending == 4
        assert [ring.pop() for _ in range(4)] == [
            bytes([k]) * (k + 1) for k in range(4)]
        # The sequence wraps the slots: records come back in order.
        batch = [b"ab", b"", b"cdef"]
        assert all(peer.push(p) for p in batch)
        assert [ring.pop() for _ in range(3)] == batch and ring.pop() is None
        with pytest.raises(ValueError, match="exceeds slot_size"):
            peer.push(b"y" * 65)
        # A producer that died mid-write leaves an odd stamp: the record
        # is dropped and counted, never returned.
        assert peer.push(b"torn")
        i = (int(ring._hdr[2]) - 1) % ring.nslots
        ring._stamps[i][0] = ring._stamps[i][0] - 1
        assert ring.pop() is None and ring.torn_reads == 1
        assert peer.push(b"next") and ring.pop() == b"next"
        peer.close()
    finally:
        ring.close()
        ring.unlink()


def test_slot_ring_layout_is_the_jax_packages():
    """Records cross between the packages' rings in both directions."""
    name = _ring_name()
    ring = tingest.ShmSlotRing(name, slot_size=128, nslots=4, create=True)
    try:
        jpeer = jshm.ShmSlotRing(name)
        assert jpeer.push(b"from jax") and ring.pop() == b"from jax"
        assert jpeer.push(b"a") and jpeer.push(b"bc")
        assert [ring.pop(), ring.pop()] == [b"a", b"bc"]
        assert ring.push(b"from the port") and jpeer.pop() == b"from the port"
        jpeer.close()
    finally:
        ring.close()
        ring.unlink()


@pytest.mark.parametrize("consumer", [tingest.ShmSlotRing, jshm.ShmSlotRing],
                         ids=["port", "jax"])
def test_shm_ring_concurrent_hammer(consumer):
    """Twin of JAX's hammer (tests/test_ingest.py): the port's
    ``push_wait`` from a producer thread on an attached ring, across many
    wraparounds, into either package's consumer: every record arrives
    once, in order, bit-intact, with no torn read."""
    rng = np.random.default_rng(6)
    name = _ring_name()
    ring = consumer(name, slot_size=512, nslots=8, create=True)
    att = tingest.ShmSlotRing(name)
    msgs = [rng.integers(0, 256, rng.integers(1, 512)).astype(np.uint8)
            .tobytes() for _ in range(2000)]
    try:
        def produce():
            for m in msgs:
                att.push_wait(m, poll_s=0.0)

        th = threading.Thread(target=produce, daemon=True,
                              name="hammer-producer")
        th.start()
        got = []
        deadline = time.monotonic() + 60.0
        while len(got) < len(msgs) and time.monotonic() < deadline:
            b = ring.pop()
            if b is not None:
                got.append(b)
        th.join(timeout=10)
        assert not th.is_alive()
        assert got == msgs
        assert ring.torn_reads == 0
    finally:
        att.close()
        ring.close()
        ring.unlink()


@pytest.mark.parametrize("fault", [
    None, pytest.param("drop", marks=pytest.mark.chaos)])
def test_push_wait_on_a_full_ring_publishes_nothing(fault):
    """On a full ring ``push_wait`` retries until ``stop()`` is true and
    returns False; under the ``shm.publish: drop`` seam it returns True at
    once, as JAX's does. Neither publishes the record."""
    from dist_dqn_tpu_torch import chaos

    ring = tingest.ShmSlotRing(_ring_name(), slot_size=16, nslots=2,
                               create=True)
    stops = []

    def stop():
        stops.append(1)
        return len(stops) >= 3

    events = () if fault is None else (
        chaos.FaultEvent("shm.publish", fault, at_hit=3),)
    try:
        with chaos.installed(chaos.FaultPlan(seed=1, events=events)):
            assert ring.push_wait(b"a") and ring.push_wait(b"b")
            published = ring.push_wait(b"c", stop=stop, poll_s=0.0)
        assert published is (fault == "drop")
        assert len(stops) == (0 if fault else 3)
        assert ring.pending == 2 and int(ring._hdr[2]) == 2
        assert [ring.pop(), ring.pop(), ring.pop()] == [b"a", b"b", None]
    finally:
        ring.close()
        ring.unlink()


# --------------------------------------------------------------------------
# Chaos seams (twins of tests/test_ingest.py:243-345 and
# tests/test_ingest_dedup.py:237-263).
# --------------------------------------------------------------------------

def _step_payload(seed):
    rng = np.random.default_rng(seed)
    schema = tingest.step_schema((4,), np.float32, 4)
    rec = _records(rng, (4,), np.float32, 4, steps=1)[0]
    return schema, bytes(tingest.StepEncoder(schema).encode_step(
        rec, actor=0, t=1))


@pytest.mark.chaos
def test_shm_ring_torn_publish_dropped_and_counted():
    """Chaos seam ``shm.publish: torn`` — die-mid-write semantics: the
    consumer must drop + count the slot, never decode it, and the next
    clean publish must flow (and close the chaos trip)."""
    from dist_dqn_tpu_torch import chaos

    plan = chaos.FaultPlan(seed=1, events=(
        chaos.FaultEvent("shm.publish", "torn", at_hit=2),))
    ring = tingest.ShmSlotRing(_ring_name(), slot_size=32, nslots=4,
                               create=True)
    try:
        with chaos.installed(plan) as inj:
            assert ring.push(b"first")
            assert ring.push(b"torn-victim")     # injected: stamp stays odd
            assert ring.push(b"after")
            assert ring.pop() == b"first"
            before = ring.torn_reads
            assert ring.pop() is None            # dropped, not decoded
            assert ring.torn_reads == before + 1
            assert ring.pop() == b"after"
            assert [e["fault"] for e in inj.injected] == ["torn"]
            assert "shm.publish" not in inj.open_trips()
    finally:
        ring.close()
        ring.unlink()


@pytest.mark.chaos
def test_chaos_decode_seam_rejects_and_recovers():
    """Chaos seam ``ingest.decode`` — header corruption at the codec
    gate mirrors the transport bit_flip pin: the record rejects whole,
    and the next clean decode proves recovery."""
    from dist_dqn_tpu_torch import chaos

    schema, payload = _step_payload(7)
    dec = tingest.StepDecoder(schema)
    plan = chaos.FaultPlan(seed=2, events=(
        chaos.FaultEvent("ingest.decode", "bit_flip", at_hit=1,
                         args={"bit": 0}),       # flips the ZC magic
        chaos.FaultEvent("ingest.decode", "truncate", at_hit=2,
                         args={"keep_frac": 0.3}),))
    with chaos.installed(plan) as inj:
        with pytest.raises(tingest.WireFormatError):
            dec.decode(payload)
        with pytest.raises(tingest.WireFormatError):
            dec.decode(payload)
        out, _ = dec.decode(payload)             # clean pass = recovery
        assert out["obs"].shape == (4, 4)
        assert len(inj.injected) == 2
        assert "ingest.decode" not in inj.open_trips()


@pytest.mark.chaos
def test_zc_wire_corruption_never_reaches_codec():
    """The layering pin: a bit flipped on a zero-copy TCP frame dies at
    the CRC gate — dropped + counted + NACKed — so the zero-copy decoder
    only ever sees intact payloads; disconnects cost the connection,
    which a reconnect + re-push recovers."""
    import time

    from dist_dqn_tpu_torch import chaos
    from dist_dqn_tpu_torch.actors.transport import (TcpRecordClient,
                                                     TcpRecordServer)

    schema, payload = _step_payload(8)
    dec = tingest.StepDecoder(schema)
    plan = chaos.FaultPlan(seed=3, events=(
        chaos.FaultEvent("transport.send", "bit_flip", at_hit=2,
                         args={"bit": 400}),     # lands in the body
        chaos.FaultEvent("transport.send", "disconnect", at_hit=4),))
    server = TcpRecordServer()
    try:
        with chaos.installed(plan) as inj:
            client = TcpRecordClient(server.address)
            assert client.push(payload)          # hit 1: clean
            assert client.push(payload)          # hit 2: flipped on wire
            assert client.push(payload)          # hit 3: clean
            deadline = 200
            got = []
            while len(got) < 2 and deadline:
                rec = server.pop()
                if rec is None:
                    time.sleep(0.01)
                    deadline -= 1
                    continue
                got.append(rec[1])
            assert len(got) == 2                 # corrupt frame dropped
            assert server.corrupt_frames == 1
            for g in got:                        # survivors decode intact
                out, _ = dec.decode(g)
                assert out["obs"].tobytes() == payload[
                    tingest.codec.HEADER_BYTES:
                    tingest.codec.HEADER_BYTES + out["obs"].nbytes]
            assert not client.push(payload)      # hit 4: disconnect
            client2 = TcpRecordClient(server.address)
            assert client2.push(payload)         # reconnect recovers
            chaos.mark_recovered("transport.send")
            client.close()
            client2.close()
            assert [e["fault"] for e in inj.injected] == \
                ["bit_flip", "disconnect"]
            assert not inj.open_trips()
    finally:
        server.close()


@pytest.mark.chaos
def test_dedup_chaos_bit_flip_rejects_then_rehello_recovers():
    """Chaos ``ingest.decode: bit_flip`` on a dedup stream: the
    corrupted record rejects whole, the chain stays broken (dedup records
    are not independently decodable), and the re-hello path recovers
    with the trip closed."""
    from dist_dqn_tpu_torch import chaos

    lanes, fs = 4, 4
    env = make_host_env("synthstack", lanes, seed=5)
    obs = env.reset()
    schema = tingest.step_schema(obs.shape[1:], obs.dtype, lanes)
    enc = tingest.DedupStepEncoder(schema, fs)
    dec = tingest.DedupStepDecoder(schema, fs, t0=0)
    rng = np.random.default_rng(2)

    def step():
        o, nxt, reward, term, trunc = env.step(rng.integers(0, 4, lanes))
        return {"obs": o, "next_obs": nxt, "reward": reward,
                "terminated": term.astype(np.uint8),
                "truncated": trunc.astype(np.uint8)}

    plan = chaos.FaultPlan(seed=2, events=(
        chaos.FaultEvent("ingest.decode", "bit_flip", at_hit=2,
                         args={"bit": 0}),))     # flips the ZC magic
    with chaos.installed(plan) as inj:
        dec.decode(bytes(enc.encode_step(step(), actor=0, t=1)))
        with pytest.raises(tingest.WireFormatError):
            dec.decode(bytes(enc.encode_step(step(), actor=0, t=2)))
        with pytest.raises(tingest.WireFormatError):
            dec.decode(bytes(enc.encode_step(step(), actor=0, t=3)))
        # Recovery = the NACK-driven reconnect + re-hello (transport
        # layer): fresh chain on both ends.
        enc.reset()
        dec = tingest.DedupStepDecoder(schema, fs, t0=3)
        arrays = step()
        out, _ = dec.decode(bytes(enc.encode_step(arrays, actor=0, t=4)))
        np.testing.assert_array_equal(out["obs"], arrays["obs"])
        assert [e["fault"] for e in inj.injected] == ["bit_flip"]
        assert not inj.open_trips()
