"""Zero-copy wire codec (twin of ``dist_dqn_tpu/ingest/codec.py``: the same
bytes on the wire, so either package's actors and services interoperate).

One record = a 20-byte fixed header + the raw C-order array bytes of a
negotiated :class:`~dist_dqn_tpu_torch.ingest.schema.TrajectorySchema`, in
declaration order, optionally followed by the actor-side priority
planes (``q_sel``/``q_max``, f32 per lane) when ``FLAG_HAS_Q`` is set::

    0      2      4     5     6       8        12       16      18      20
    +------+------+-----+-----+-------+--------+--------+-------+-------+
    |"ZC"  | ver  |kind |flags| shard | actor  |   t    | lanes | rsvd  |
    +------+------+-----+-----+-------+--------+--------+-------+-------+
    | field 0 bytes | field 1 bytes | ... | [q_sel f32] | [q_max f32]   |
    +---------------------------------------------------------------+
    | [lineage trailer: birth_time f64, params_version u32]         |
    +---------------------------------------------------------------+

Layering: this is the PAYLOAD format. On TCP it rides UNCHANGED under
the integrity frame (``magic|len|crc32`` — corruption handling
identical to the legacy codec); on the same-host path it is the slot
body of ``ingest/shm_ring.py``. The encoder writes every field straight
into one reusable buffer (no per-field ``tobytes`` copies, no JSON, no
pickle); the decoder returns ``np.frombuffer`` VIEWS into the received
buffer — zero copies on either side beyond the wire itself.

Aliasing contract: decoded arrays alias the payload buffer passed to
``decode`` — valid for as long as the caller keeps that buffer (both
transports hand over owned ``bytes``). Encoded views alias the
encoder's scratch — consumed (sent / ring-published) before the next
``encode`` call by every caller in this repo.

The header layout is the JAX package's: ``WIRE_HISTORY`` keeps its
fingerprints, and ``tests/test_torch_ingest.py`` holds the bytes equal.

Chaos seam ``ingest.decode`` at both step decoders, on the payload before
validation (bit_flip in the header, truncate), so a corrupt record is
rejected whole; the next record that decodes marks it recovered.

Stdlib + numpy only: actor processes import no torch.
"""
from __future__ import annotations

import struct
import zlib
from typing import Dict, Optional, Tuple

import numpy as np

from dist_dqn_tpu_torch import chaos
from dist_dqn_tpu_torch.ingest.schema import (PROTOCOL_VERSION,
                                        TrajectorySchema,
                                        validate_dedup_stack)

#: The frame-header layout, field by field. The JAX package's wire lint
#: fingerprints THIS tuple (plus the kind/flag registries below): edit
#: it and the lint fails until PROTOCOL_VERSION is bumped and the new
#: digest recorded in WIRE_HISTORY.
WIRE_HEADER_FIELDS = (
    ("magic", "2s"),        # b"ZC" — dispatch vs the legacy JSON codec
    ("version", "H"),       # PROTOCOL_VERSION; mismatch fails at decode
    ("kind", "B"),          # KIND_* record type
    ("flags", "B"),         # FLAG_* bitfield
    ("shard", "H"),         # sticky replay-shard id (ingest/router.py)
    ("actor", "I"),         # fleet-unique actor id
    ("t", "I"),             # actor step counter (lock-step protocol)
    ("lanes", "H"),         # vector-env width; must match the schema
    ("reserved", "H"),      # zero; room for one future field w/o resize
)
_HDR = struct.Struct("<" + "".join(fmt for _, fmt in WIRE_HEADER_FIELDS))
HEADER_BYTES = _HDR.size

MAGIC = b"ZC"
KIND_STEP = 1               # actor -> learner trajectory step record
KIND_REPLY = 2              # learner -> actor action (+ q-plane) reply
WIRE_KINDS = {"step": KIND_STEP, "reply": KIND_REPLY}
FLAG_HAS_Q = 0x01           # q_sel/q_max f32[lanes] planes appended
# Frame-stack dedup lanes: DEDUP marks a step record whose
# obs/next_obs travel as back-references into the per-lane frame ring +
# inline novel frames instead of raw stacks; DEDUP_CANON marks the
# steady-state shorthand (no done lanes, one implied novel frame per
# lane — the record body is JUST the novel plane; see DedupStepEncoder).
FLAG_DEDUP = 0x02
FLAG_DEDUP_CANON = 0x04
# Experience lineage: the record carries a trailing
# ``<d I`` stamp — birth wall-time (unix seconds, f64) + the params
# version the actor was acting with (u32) — aged at sample time into
# the dqn_replay_sample_* histograms. On KIND_REPLY the trailer is the
# ``<I`` params version alone (the learner telling the actor what it
# just shipped). Trailers sit at the very END of the payload so every
# existing offset (fields, q planes, dedup tables) is untouched.
FLAG_LINEAGE = 0x08
WIRE_FLAGS = {"has_q": FLAG_HAS_Q, "dedup": FLAG_DEDUP,
              "dedup_canon": FLAG_DEDUP_CANON, "lineage": FLAG_LINEAGE}

_LINEAGE = struct.Struct("<dI")     # birth_time f64, params_version u32
LINEAGE_BYTES = _LINEAGE.size
_REPLY_LINEAGE = struct.Struct("<I")  # params_version u32

_F32 = np.dtype(np.float32)
_I32 = np.dtype(np.int32)
_U32_MASK = 0xFFFFFFFF      # per-lane frame ids wrap at u32 (equality-
#                             only comparisons over a ~frame_stack-deep
#                             window, so modulo ids are unambiguous)

#: protocol version -> wire fingerprint (the JAX package's wire-lint digest
#: over WIRE_HEADER_FIELDS + WIRE_KINDS + WIRE_FLAGS). Append-only: a
#: header change lands as a NEW (version, digest) pair; rewriting an
#: existing entry is the drift the lint exists to block.
WIRE_HISTORY = {
    2: "4322d42d8ca0fadd",
    3: "b7fb2f531a18e303",
    4: "26d5d1a9a3b4fb80",
}


def _lineage_meta(payload, flags: int, meta: Dict) -> Dict:
    """Fold the trailing lineage stamp (when present) into ``meta``."""
    if flags & FLAG_LINEAGE:
        bt, ver = _LINEAGE.unpack_from(payload, len(payload) - LINEAGE_BYTES)
        meta["birth_time"] = bt
        meta["params_version"] = ver
    return meta


class WireFormatError(ValueError):
    """A payload that violates the zero-copy wire format (bad magic,
    wrong kind/lanes/length). The record is rejected whole — a frame
    that fails here never reaches the arrays."""


class ProtocolMismatchError(WireFormatError):
    """Peer speaks a different PROTOCOL_VERSION — fail loudly at the
    connection level instead of desyncing mid-stream."""


def is_zc(payload) -> bool:
    """Codec dispatch: zero-copy payloads lead with the ZC magic. The
    legacy JSON-header codec leads with a little-endian u32 header
    length, so a collision would require a legacy header of exactly
    0x..435A (>17 KB) bytes — far beyond any real header, and even then
    the ZC version/length gates reject the record loudly rather than
    mis-decoding it."""
    return bytes(payload[:2]) == MAGIC


def peek_header(payload) -> Dict[str, int]:
    """Header fields of a ZC payload without touching the body."""
    if len(payload) < HEADER_BYTES:
        raise WireFormatError(
            f"short ZC payload: {len(payload)} < header {HEADER_BYTES}")
    magic, version, kind, flags, shard, actor, t, lanes, _ = \
        _HDR.unpack_from(payload, 0)
    if magic != MAGIC:
        raise WireFormatError(f"bad ZC magic {magic!r}")
    if version != PROTOCOL_VERSION:
        raise ProtocolMismatchError(
            f"wire protocol {version} != local {PROTOCOL_VERSION} — "
            f"peer runs a different build; upgrade in lockstep")
    return {"kind": kind, "flags": flags, "shard": shard, "actor": actor,
            "t": t, "lanes": lanes}


def _chaos_decode_seam(payload, hdr):
    """The ``ingest.decode`` chaos seam, shared by the plain and dedup
    step decoders: corrupt BEFORE validation, so the gates below must
    reject the record whole (corruption never decodes) on the zero-copy
    path too. bit_flip targets the HEADER (the codec's own validation
    surface); body integrity belongs to the TCP CRC frame / shm seqlock.
    Returns (payload, parsed hdr)."""
    ev = chaos.fire("ingest.decode")
    if ev is not None:
        if ev.fault == "bit_flip":
            payload = (chaos.corrupt_bytes(
                bytes(payload[:HEADER_BYTES]), ev)
                + bytes(payload[HEADER_BYTES:]))
        elif ev.fault == "truncate":
            payload = chaos.truncate_bytes(bytes(payload), ev)
        hdr = None          # the bytes changed: re-validate them
    if hdr is None:
        hdr = peek_header(payload)
    return payload, hdr


class StepEncoder:
    """Encode step records into ONE reusable buffer.

    Each field is copied exactly once, from the caller's array straight
    into the scratch at its schema offset (``np.frombuffer`` views over
    the scratch — no intermediate ``tobytes``). Returns a memoryview;
    callers transfer it (socket send / ring publish) before the next
    ``encode`` call.
    """

    def __init__(self, schema: TrajectorySchema):
        self.schema = schema
        self._q_off = HEADER_BYTES + schema.record_bytes
        self._buf = bytearray(self._q_off + 2 * 4 * schema.lanes
                              + LINEAGE_BYTES)
        # Per-field destination views, built once.
        self._views = []
        off = HEADER_BYTES
        for f in schema.fields:
            dt = np.dtype(f.dtype)
            count = schema.lanes
            for s in f.shape:
                count *= s
            dst = np.frombuffer(self._buf, dtype=dt, count=count,
                                offset=off).reshape(
                                    (schema.lanes,) + f.shape)
            self._views.append((f.name, dst))
            off += count * dt.itemsize
        lanes = schema.lanes
        self._q_sel = np.frombuffer(self._buf, _F32, lanes, self._q_off)
        self._q_max = np.frombuffer(self._buf, _F32, lanes,
                                    self._q_off + 4 * lanes)

    def encode_step(self, arrays: Dict[str, np.ndarray], actor: int,
                    t: int, shard: int = 0,
                    q_sel: Optional[np.ndarray] = None,
                    q_max: Optional[np.ndarray] = None,
                    birth_time: Optional[float] = None,
                    params_version: Optional[int] = None) -> memoryview:
        flags = 0
        end = self._q_off
        for name, dst in self._views:
            np.copyto(dst, arrays[name], casting="same_kind")
        if q_sel is not None:
            flags |= FLAG_HAS_Q
            np.copyto(self._q_sel, q_sel, casting="same_kind")
            np.copyto(self._q_max, q_max, casting="same_kind")
            end += 2 * 4 * self.schema.lanes
        if birth_time is not None:
            flags |= FLAG_LINEAGE
            _LINEAGE.pack_into(self._buf, end, float(birth_time),
                               int(params_version or 0) & _U32_MASK)
            end += LINEAGE_BYTES
        _HDR.pack_into(self._buf, 0, MAGIC, PROTOCOL_VERSION, KIND_STEP,
                       flags, shard, actor, t, self.schema.lanes, 0)
        return memoryview(self._buf)[:end]


class StepDecoder:
    """Decode step records into views over the received buffer.

    Validates magic / version / kind / lanes / EXACT length before any
    array is built — a truncated or mis-schema'd payload raises
    :class:`WireFormatError` whole, mirroring the legacy codec's
    corruption posture (a bad record never becomes training data).
    """

    def __init__(self, schema: TrajectorySchema):
        self.schema = schema
        self._layout = []
        off = HEADER_BYTES
        for f in schema.fields:
            dt = np.dtype(f.dtype)
            count = schema.lanes
            for s in f.shape:
                count *= s
            self._layout.append(
                (f.name, dt, (schema.lanes,) + f.shape, count, off))
            off += count * dt.itemsize
        self._base = off
        self._with_q = off + 2 * 4 * schema.lanes

    def decode(self, payload,
               hdr: Optional[Dict[str, int]] = None
               ) -> Tuple[Dict[str, np.ndarray], Dict]:
        """-> (field arrays, meta). Meta carries actor/t/shard plus the
        ``q_sel``/``q_max`` planes when the frame shipped them.

        ``hdr``: a header already parsed by ``peek_header`` on the SAME
        payload — the ingest loop peeks once to route to the actor's
        decoder, and passing it here avoids a second unpack per record
        on the hot path."""
        payload, hdr = _chaos_decode_seam(payload, hdr)
        if hdr["kind"] != KIND_STEP:
            raise WireFormatError(f"expected step record, got kind "
                                  f"{hdr['kind']}")
        if hdr["flags"] & FLAG_DEDUP:
            raise WireFormatError(
                "frame-dedup record at a non-dedup decoder — the actor "
                "negotiated dedup this decoder was not built for")
        if hdr["lanes"] != self.schema.lanes:
            raise WireFormatError(
                f"record lanes {hdr['lanes']} != schema "
                f"{self.schema.lanes}")
        want = self._with_q if hdr["flags"] & FLAG_HAS_Q else self._base
        if hdr["flags"] & FLAG_LINEAGE:
            want += LINEAGE_BYTES
        if len(payload) != want:
            raise WireFormatError(
                f"record length {len(payload)} != schema-required {want} "
                f"(flags={hdr['flags']:#x})")
        out = {
            name: np.frombuffer(payload, dtype=dt, count=count,
                                offset=off).reshape(shape)
            for name, dt, shape, count, off in self._layout
        }
        meta = {"kind": "step", "actor": hdr["actor"], "t": hdr["t"],
                "shard": hdr["shard"]}
        if hdr["flags"] & FLAG_HAS_Q:
            lanes = self.schema.lanes
            meta["q_sel"] = np.frombuffer(payload, _F32, lanes, self._base)
            meta["q_max"] = np.frombuffer(payload, _F32, lanes,
                                          self._base + 4 * lanes)
        _lineage_meta(payload, hdr["flags"], meta)
        chaos.mark_recovered("ingest.decode")
        return out, meta


def encode_reply(action: np.ndarray, actor: int, t: int, shard: int = 0,
                 q_sel: Optional[np.ndarray] = None,
                 q_max: Optional[np.ndarray] = None,
                 params_version: Optional[int] = None) -> bytes:
    """Learner -> actor reply: actions (+ optional q planes the actor
    folds into its NEXT step frame — the actor-side priority loop).
    ``params_version`` (the learner's grad-step count at act time) rides
    as a lineage trailer the actor echoes into its next step records.
    Replies are small (a few bytes per lane); a fresh bytes object per
    reply keeps the mailbox/connection write simple."""
    lanes = int(action.shape[0])
    flags = FLAG_HAS_Q if q_sel is not None else 0
    if params_version is not None:
        flags |= FLAG_LINEAGE
    parts = [_HDR.pack(MAGIC, PROTOCOL_VERSION, KIND_REPLY, flags, shard,
                       actor, t, lanes, 0),
             np.ascontiguousarray(action, _I32).tobytes()]
    if q_sel is not None:
        parts.append(np.ascontiguousarray(q_sel, _F32).tobytes())
        parts.append(np.ascontiguousarray(q_max, _F32).tobytes())
    if params_version is not None:
        parts.append(_REPLY_LINEAGE.pack(int(params_version) & _U32_MASK))
    return b"".join(parts)


def decode_reply(payload) -> Tuple[np.ndarray, Optional[np.ndarray],
                                   Optional[np.ndarray], Dict]:
    """-> (actions, q_sel | None, q_max | None, header meta)."""
    hdr = peek_header(payload)
    if hdr["kind"] != KIND_REPLY:
        raise WireFormatError(f"expected reply record, got kind "
                              f"{hdr['kind']}")
    lanes = hdr["lanes"]
    want = HEADER_BYTES + 4 * lanes \
        + (8 * lanes if hdr["flags"] & FLAG_HAS_Q else 0) \
        + (_REPLY_LINEAGE.size if hdr["flags"] & FLAG_LINEAGE else 0)
    if len(payload) != want:
        raise WireFormatError(
            f"reply length {len(payload)} != required {want}")
    action = np.frombuffer(payload, _I32, lanes, HEADER_BYTES)
    q_sel = q_max = None
    if hdr["flags"] & FLAG_HAS_Q:
        off = HEADER_BYTES + 4 * lanes
        q_sel = np.frombuffer(payload, _F32, lanes, off)
        q_max = np.frombuffer(payload, _F32, lanes, off + 4 * lanes)
    if hdr["flags"] & FLAG_LINEAGE:
        (hdr["params_version"],) = _REPLY_LINEAGE.unpack_from(
            payload, len(payload) - _REPLY_LINEAGE.size)
    return action, q_sel, q_max, hdr


def max_record_bytes(schema: TrajectorySchema) -> int:
    """Worst-case encoded step size (header + body + q planes +
    lineage trailer) — the shm slot-sizing input."""
    return (HEADER_BYTES + schema.record_bytes + 2 * 4 * schema.lanes
            + LINEAGE_BYTES)


# ---------------------------------------------------------------------------
# Frame-stack dedup plane
# ---------------------------------------------------------------------------
#
# A pixel step record ships obs AND next_obs, each a stack of
# ``frame_stack`` frames — but per env step only ONE physical frame is
# new: ``next_obs`` is the previous acted-on stack shifted by one frame
# (HostVectorEnv contract), and ``obs`` (the post-auto-reset stack the
# next act request sees) EQUALS ``next_obs`` on every non-done lane.
# The plain zero-copy codec therefore ships every physical frame
# ~2*frame_stack times. The dedup plane ships each frame once per
# episode stream and reconstructs full stacks at append time in the
# service drain:
#
#   * per lane, every shipped frame gets a monotone u32 id; the encoder
#     tracks the id window of the current acted-on stack, the decoder a
#     ring of the last frames per lane (the "frame ring" negotiated at
#     hello via the ``dedup`` capability);
#   * the steady-state record (no done lanes) is CANONICAL
#     (FLAG_DEDUP_CANON): its whole frame section is the one novel
#     plane ``next_obs[..., -1]`` — the back-references are implied
#     (shift by one, obs == next_obs) and guarded by the header ``t``
#     continuity check, so a lost record can never be bridged silently;
#   * boundary records (episode end / truncation / first record after
#     hello) carry an explicit back-reference table + inline novel
#     frames; a back-reference that misses the ring rejects the record
#     WHOLE (WireFormatError — the posture unchanged; on TCP
#     the NACK-driven reconnect + re-hello resets both ends' rings,
#     which is the documented recovery).
#
# CANONICAL record layout (flags = DEDUP | DEDUP_CANON [| HAS_Q])::
#
#   header | small fields (reward, terminated, truncated) | [q planes]
#          | novel plane: lanes * frame_bytes   (next_obs[..., -1])
#
# GENERAL record layout (flags = DEDUP [| HAS_Q])::
#
#   header | small fields | [q planes]
#          | ref table u32[lanes][2*frame_stack]   (obs refs, next refs)
#          | u16 n_inline
#          | n_inline * (u16 lane, u32 id)          descriptors
#          | n_inline * frame_bytes                 inline frames
#
# Both layouts ride the existing 20-byte ZC header and the TCP CRC /
# shm seqlock integrity layers untouched.

_DESC = np.dtype([("lane", "<u2"), ("id", "<u4")])


class _DedupLayout:
    """Shared offset math for the dedup record layouts."""

    def __init__(self, schema: TrajectorySchema, frame_stack: int):
        validate_dedup_stack(schema, frame_stack)
        self.schema = schema
        self.fs = int(frame_stack)
        self.lanes = schema.lanes
        by_name = {f.name: f for f in schema.fields}
        obs = by_name["obs"]
        self.frame_shape = obs.shape[:-1]
        self.frame_dtype = np.dtype(obs.dtype)
        n = 1
        for s in self.frame_shape:
            n *= s
        self.frame_elems = n
        self.frame_bytes = n * self.frame_dtype.itemsize
        self.plane_bytes = self.lanes * self.frame_bytes
        # Small (non-stacked) fields keep their schema declaration order.
        self.small = []
        off = HEADER_BYTES
        for f in schema.fields:
            if f.name in ("obs", "next_obs"):
                continue
            dt = np.dtype(f.dtype)
            count = self.lanes
            for s in f.shape:
                count *= s
            self.small.append((f.name, dt, (self.lanes,) + f.shape,
                               count, off))
            off += count * dt.itemsize
        self.small_end = off
        self.q_bytes = 2 * 4 * self.lanes
        self.table_bytes = self.lanes * 2 * self.fs * 4
        # Hot-path constants, precomputed once (the canonical decode
        # runs per record — no per-record byte math).
        self._record_bytes = schema.record_bytes
        self.canon_len_q = self.body_off(True) + self.plane_bytes
        self.canon_len_nq = self.body_off(False) + self.plane_bytes
        self.plain_len_q = HEADER_BYTES + self._record_bytes + self.q_bytes
        self.plain_len_nq = HEADER_BYTES + self._record_bytes
        flag_offs = {name: (o, c) for name, _, _, c, o in self.small
                     if name in ("terminated", "truncated")}
        self.done_offs = tuple(flag_offs.values())
        self.zero_flags = b"\x00" * self.lanes

    def body_off(self, has_q: bool) -> int:
        return self.small_end + (self.q_bytes if has_q else 0)

    def canon_len(self, has_q: bool) -> int:
        return self.canon_len_q if has_q else self.canon_len_nq

    def general_len(self, has_q: bool, n_inline: int) -> int:
        return (self.body_off(has_q) + self.table_bytes + 2
                + n_inline * (_DESC.itemsize + self.frame_bytes))

    def plain_len(self, has_q: bool) -> int:
        """What the undeduped codec would ship — the savings baseline."""
        return self.plain_len_q if has_q else self.plain_len_nq


def max_dedup_record_bytes(schema: TrajectorySchema,
                           frame_stack: int) -> int:
    """Worst-case dedup step size (every frame slot of both stacks
    inline + tables + lineage trailer) — the shm slot-sizing input for
    dedup actors."""
    lay = _DedupLayout(schema, frame_stack)
    return lay.general_len(True, 2 * lay.fs * lay.lanes) + LINEAGE_BYTES


class DedupStepEncoder:
    """Frame-dedup twin of :class:`StepEncoder` (same ``encode_step``
    signature, drop-in for the actor loops).

    ``verify=False`` (production) trusts the HostVectorEnv stream
    contract — ``obs is next_obs`` on non-done lanes, ``next_obs`` =
    previous acted-on stack shifted by one — which the adapter tests
    pin, and emits CANONICAL records in steady state. ``verify=True``
    trusts nothing: every frame slot is content-hashed (crc32 +
    byte-equal confirm) against the referenceable window, so the wire
    is bit-exact for ANY input stream at extra encode cost; it never
    emits the canonical shorthand. Both modes decode identically.

    Call :meth:`reset` when the transport re-hellos (reconnect): the id
    chain must restart with the decoder's fresh state.
    """

    def __init__(self, schema: TrajectorySchema, frame_stack: int,
                 verify: bool = False):
        self.schema = schema
        self.lay = _DedupLayout(schema, frame_stack)
        self.verify = bool(verify)
        lay = self.lay
        self._buf = bytearray(max_dedup_record_bytes(schema, frame_stack))
        self._small = [
            (name, np.frombuffer(self._buf, dt, count, off).reshape(shape))
            for name, dt, shape, count, off in lay.small]
        self._q_sel = np.frombuffer(self._buf, _F32, lay.lanes,
                                    lay.small_end)
        self._q_max = np.frombuffer(self._buf, _F32, lay.lanes,
                                    lay.small_end + 4 * lay.lanes)
        # The canonical novel plane sits right after small [+ q] fields;
        # prebuild a destination view for both offsets.
        self._novel_q = np.frombuffer(
            self._buf, lay.frame_dtype, lay.lanes * lay.frame_elems,
            lay.body_off(True)).reshape((lay.lanes,) + lay.frame_shape)
        self._novel_nq = np.frombuffer(
            self._buf, lay.frame_dtype, lay.lanes * lay.frame_elems,
            lay.body_off(False)).reshape((lay.lanes,) + lay.frame_shape)
        self.reset()

    def reset(self) -> None:
        """Drop all dedup state (fresh hello: both ends restart)."""
        lanes = self.lay.lanes
        self._wid = [None] * lanes      # ids of the current acted-on stack
        self._next_id = [0] * lanes     # per-lane frame id counter
        self._frames = [{} for _ in range(lanes)]  # id -> contiguous copy
        #                                  (verify-mode compare source)

    # -- internals ----------------------------------------------------------
    def _alloc(self, lane: int, frame: np.ndarray) -> int:
        nid = self._next_id[lane] & _U32_MASK
        self._next_id[lane] = (self._next_id[lane] + 1) & _U32_MASK
        if self.verify:
            self._frames[lane][nid] = frame
        return nid

    def _intern(self, lane: int, frame: np.ndarray, local: dict,
                inline: list) -> int:
        """Content-addressed id for one contiguous frame: matched
        against this record's already-interned frames and (verify mode)
        the lane's referenceable window, else inlined fresh."""
        h = zlib.crc32(frame)
        hits = local.get(h)
        if hits is not None:
            for cid, cfr in hits:
                if np.array_equal(frame, cfr):
                    return cid
        if self.verify and self._wid[lane] is not None:
            for cid in self._wid[lane]:
                cfr = self._frames[lane].get(cid)
                if cfr is not None and np.array_equal(frame, cfr):
                    return cid
        nid = self._alloc(lane, frame)
        local.setdefault(h, []).append((nid, frame))
        inline.append((lane, nid, frame))
        return nid

    def _lane_refs(self, lane: int, obs, next_obs, novel, done: bool,
                   inline: list):
        """(obs refs, next refs) for one lane of a GENERAL record."""
        local: dict = {}
        wid = self._wid[lane]
        if self.verify or wid is None:
            next_refs = [
                self._intern(lane,
                             np.ascontiguousarray(next_obs[..., j]),
                             local, inline)
                for j in range(self.lay.fs)]
        else:
            # Structural shift (adapter contract): the only novel next
            # frame is the top of the stack — still inlined explicitly
            # here (only the CANONICAL shorthand implies it).
            nid = self._alloc(lane, novel)
            inline.append((lane, nid, novel))
            next_refs = list(wid[1:]) + [nid]
        if not done and not self.verify:
            # obs is next_obs on non-done lanes (HostVectorEnv contract).
            obs_refs = list(next_refs)
        else:
            obs_refs = [
                self._intern(lane, np.ascontiguousarray(obs[..., j]),
                             local, inline)
                for j in range(self.lay.fs)]
        if obs_refs[-1] != (self._next_id[lane] - 1) & _U32_MASK:
            # Canonical records imply next id = window top + 1, so the
            # top must ALWAYS be the latest allocated id. Content dedup
            # can break that when the newest frame matches an OLDER
            # slot while later allocations happened in between (e.g. a
            # blinking screen re-interned at a boundary): re-ship the
            # top frame under a fresh id — a rare duplicate frame on
            # the wire buys an unconditionally sound id chain.
            top = np.ascontiguousarray(obs[..., self.lay.fs - 1])
            nid = self._alloc(lane, top)
            inline.append((lane, nid, top))
            obs_refs = obs_refs[:-1] + [nid]
        self._wid[lane] = obs_refs
        return obs_refs, next_refs

    # -- API ----------------------------------------------------------------
    def encode_step(self, arrays: Dict[str, np.ndarray], actor: int,
                    t: int, shard: int = 0,
                    q_sel: Optional[np.ndarray] = None,
                    q_max: Optional[np.ndarray] = None,
                    birth_time: Optional[float] = None,
                    params_version: Optional[int] = None) -> memoryview:
        lay = self.lay
        obs, next_obs = arrays["obs"], arrays["next_obs"]
        has_q = q_sel is not None
        flags = FLAG_DEDUP | (FLAG_HAS_Q if has_q else 0)
        for name, dst in self._small:
            np.copyto(dst, arrays[name], casting="same_kind")
        if has_q:
            np.copyto(self._q_sel, q_sel, casting="same_kind")
            np.copyto(self._q_max, q_max, casting="same_kind")
        done = np.logical_or(arrays["terminated"], arrays["truncated"])
        steady = (not self.verify and not done.any()
                  and self._wid[0] is not None)
        # One vectorized strided gather for the novel plane — the only
        # per-step frame bytes the canonical record ships.
        novel = np.ascontiguousarray(next_obs[..., -1])
        if steady:
            flags |= FLAG_DEDUP_CANON
            np.copyto(self._novel_q if has_q else self._novel_nq, novel)
            for lane in range(lay.lanes):
                wid = self._wid[lane]
                wid.pop(0)
                wid.append(self._alloc(lane, novel[lane]))
            end = lay.canon_len(has_q)
        else:
            inline: list = []
            refs = np.empty((lay.lanes, 2 * lay.fs), np.uint32)
            for lane in range(lay.lanes):
                o_refs, n_refs = self._lane_refs(
                    lane, obs[lane], next_obs[lane], novel[lane],
                    bool(done[lane]), inline)
                refs[lane, :lay.fs] = o_refs
                refs[lane, lay.fs:] = n_refs
            off = lay.body_off(has_q)
            self._buf[off:off + lay.table_bytes] = refs.tobytes()
            off += lay.table_bytes
            self._buf[off:off + 2] = struct.pack("<H", len(inline))
            off += 2
            desc = np.empty(len(inline), _DESC)
            desc["lane"] = [e[0] for e in inline]
            desc["id"] = [e[1] for e in inline]
            self._buf[off:off + desc.nbytes] = desc.tobytes()
            off += desc.nbytes
            for _, _, fr in inline:
                b = fr.tobytes()
                self._buf[off:off + len(b)] = b
                off += len(b)
            end = off
            if self.verify:
                # Keep only frames still referenceable (the new window).
                for lane in range(lay.lanes):
                    keep = set(self._wid[lane])
                    fr = self._frames[lane]
                    self._frames[lane] = {i: fr[i] for i in keep
                                          if i in fr}
        if birth_time is not None:
            flags |= FLAG_LINEAGE
            _LINEAGE.pack_into(self._buf, end, float(birth_time),
                               int(params_version or 0) & _U32_MASK)
            end += LINEAGE_BYTES
        _HDR.pack_into(self._buf, 0, MAGIC, PROTOCOL_VERSION, KIND_STEP,
                       flags, shard, actor, t, lay.lanes, 0)
        return memoryview(self._buf)[:end]


class DedupStepDecoder:
    """Decode dedup step records, reconstructing full frame stacks at
    append time from a per-actor rolling frame history.

    The history is one contiguous ``(history, lanes, *frame)`` buffer;
    canonical records cost one novel-plane copy and return
    stride-permuted VIEWS over the window — the full-stack
    materialization the plain codec ships over the wire never happens
    on either side. ``history`` bounds view lifetime: decoded arrays
    alias the rolling buffer; a canonical decode consumes ONE slot, a
    general (boundary) decode reseeds ``frame_stack`` slots, so views
    stay valid for at least ``history // frame_stack - 2`` further
    ``decode`` calls even in the all-boundary worst case (the service
    sizes ``history`` as ``(max assembler hold + 4) * frame_stack``).

    Chain integrity: the header ``t`` must advance by exactly 1 per
    record. A rejected/lost record therefore poisons the chain — every
    subsequent record rejects — until a fresh hello rebuilds this
    decoder; on TCP the corrupt-frame NACK forces exactly that
    reconnect + re-hello, which is the recovery path.
    """

    def __init__(self, schema: TrajectorySchema, frame_stack: int,
                 t0: int = 0, history: int = 32):
        self.schema = schema
        self.lay = _DedupLayout(schema, frame_stack)
        lay = self.lay
        self._R = max(int(history), 2 * lay.fs + 4)
        self._hist = np.zeros((self._R, lay.lanes) + lay.frame_shape,
                              lay.frame_dtype)
        hist_flat = self._hist.reshape(self._R, -1)
        self._slot_flat = [hist_flat[i] for i in range(self._R)]
        # Precomputed (lanes, *frame, fs) window views, one per cursor
        # position — canonical decode just indexes these lists.
        axes = tuple(range(1, self._hist.ndim)) + (0,)
        self._windows = [None] * (lay.fs - 1) + [
            self._hist[i - lay.fs + 1:i + 1].transpose(axes)
            for i in range(lay.fs - 1, self._R)]
        self._canon_reused = (2 * lay.fs - 1) * lay.lanes
        self._expect_t = int(t0) + 1
        self._valid = False
        self._s = lay.fs - 2           # cursor: last written slot
        self._wid0 = np.zeros((lay.lanes, lay.fs), np.int64)
        self._k = 0                    # canonical records since _wid0
        # Canonical-path constants: direct byte offsets of the small
        # fields (the canonical step schema is reward/terminated/
        # truncated — resolved once so the per-record path is pure
        # frombuffer + one plane copy).
        flat_mv = memoryview(self._hist).cast("B")
        self._slot_mv = [flat_mv[i * lay.plane_bytes:
                                 (i + 1) * lay.plane_bytes]
                         for i in range(self._R)]
        self._offs = {name: (dt, count, off)
                      for name, dt, shape, count, off in lay.small
                      if len(shape) == 1}
        self._offs_nd = [(name, dt, shape, count, off)
                         for name, dt, shape, count, off in lay.small
                         if len(shape) > 1]
        # Savings accounting (service sweeps these into the
        # dqn_ingest_dedup_* counters; ints here keep the hot path free
        # of registry calls).
        self.frames_reused = 0
        self.bytes_saved = 0
        self.records_canon = 0
        self.records_general = 0

    # -- helpers ------------------------------------------------------------
    def _small_views(self, payload) -> Dict[str, np.ndarray]:
        # Every canonical small field is 1-D [lanes]; reshape only the
        # (hypothetical) higher-rank ones.
        return {name: (np.frombuffer(payload, dt, count, off)
                       if len(shape) == 1 else
                       np.frombuffer(payload, dt, count, off)
                       .reshape(shape))
                for name, dt, shape, count, off in self.lay.small}

    def _meta(self, hdr, payload) -> Dict:
        meta = {"kind": "step", "actor": hdr["actor"], "t": hdr["t"],
                "shard": hdr["shard"]}
        if hdr["flags"] & FLAG_HAS_Q:
            lanes = self.lay.lanes
            meta["q_sel"] = np.frombuffer(payload, _F32, lanes,
                                          self.lay.small_end)
            meta["q_max"] = np.frombuffer(payload, _F32, lanes,
                                          self.lay.small_end + 4 * lanes)
        return meta

    def _check_t(self, hdr) -> None:
        if hdr["t"] != self._expect_t:
            raise WireFormatError(
                f"dedup chain break: record t={hdr['t']} but the frame "
                f"ring expects t={self._expect_t} — a record was lost "
                f"or rejected; the stream must re-hello")

    def _wid_now(self) -> np.ndarray:
        """Materialize the current per-lane window ids: ``_wid0``
        advanced by ``_k`` canonical shifts (each appended one implied
        id = previous top + 1)."""
        lay = self.lay
        k = self._k
        if k == 0:
            return self._wid0
        wid = np.empty_like(self._wid0)
        top = self._wid0[:, -1]
        for j in range(lay.fs):
            src = j + k
            if src < lay.fs:
                wid[:, j] = self._wid0[:, src]
            else:
                wid[:, j] = (top + (src - lay.fs + 1)) & _U32_MASK
        return wid

    # -- API ----------------------------------------------------------------
    def decode(self, payload,
               hdr: Optional[Dict[str, int]] = None
               ) -> Tuple[Dict[str, np.ndarray], Dict]:
        payload, hdr = _chaos_decode_seam(payload, hdr)
        lay = self.lay
        if hdr["kind"] != KIND_STEP:
            raise WireFormatError(f"expected step record, got kind "
                                  f"{hdr['kind']}")
        flags = hdr["flags"]
        if not flags & FLAG_DEDUP:
            raise WireFormatError(
                "plain zero-copy record on a dedup-negotiated stream")
        if hdr["lanes"] != lay.lanes:
            raise WireFormatError(
                f"record lanes {hdr['lanes']} != schema {lay.lanes}")
        has_q = bool(flags & FLAG_HAS_Q)
        if flags & FLAG_DEDUP_CANON:
            return self._decode_canon(payload, hdr, has_q)
        return self._decode_general(payload, hdr, has_q)

    def _decode_canon(self, payload, hdr, has_q: bool):
        lay = self.lay
        lin = LINEAGE_BYTES if hdr["flags"] & FLAG_LINEAGE else 0
        if len(payload) != (lay.canon_len_q if has_q
                            else lay.canon_len_nq) + lin:
            raise WireFormatError(
                f"canonical dedup record length {len(payload)} != "
                f"{lay.canon_len(has_q) + lin}")
        if not self._valid:
            raise WireFormatError(
                "canonical dedup record before a seeding general "
                "record (fresh ring has no frames to reference)")
        self._check_t(hdr)
        zeros = lay.zero_flags
        for off, count in lay.done_offs:
            if payload[off:off + count] != zeros:
                raise WireFormatError(
                    "canonical dedup record with done lanes — boundary "
                    "records must ship the explicit reference table")
        s = self._s + 1
        if s >= self._R:
            self._hist[0:lay.fs - 1] = self._hist[
                self._R - lay.fs + 1:self._R]
            s = lay.fs - 1
        self._s = s
        body = lay.canon_len_q - lay.plane_bytes if has_q \
            else lay.canon_len_nq - lay.plane_bytes
        self._slot_mv[s][:] = memoryview(payload)[
            body:body + lay.plane_bytes]
        self._k += 1
        self._expect_t = (self._expect_t + 1) & _U32_MASK
        fb = np.frombuffer
        offs = self._offs
        stack = self._windows[s]
        out = {"obs": stack, "next_obs": stack}
        for name, (dt, count, off) in offs.items():
            out[name] = fb(payload, dt, count, off)
        for name, dt, shape, count, off in self._offs_nd:
            out[name] = fb(payload, dt, count, off).reshape(shape)
        meta = {"kind": "step", "actor": hdr["actor"], "t": hdr["t"],
                "shard": hdr["shard"]}
        if has_q:
            lanes = lay.lanes
            meta["q_sel"] = fb(payload, _F32, lanes, lay.small_end)
            meta["q_max"] = fb(payload, _F32, lanes,
                               lay.small_end + 4 * lanes)
        _lineage_meta(payload, hdr["flags"], meta)
        self.records_canon += 1
        self.frames_reused += self._canon_reused
        self.bytes_saved += (lay.plain_len_q if has_q
                             else lay.plain_len_nq) + lin - len(payload)
        chaos.mark_recovered("ingest.decode")
        return out, meta

    def _decode_general(self, payload, hdr, has_q: bool):
        lay = self.lay
        lin = LINEAGE_BYTES if hdr["flags"] & FLAG_LINEAGE else 0
        base = lay.body_off(has_q)
        if len(payload) < base + lay.table_bytes + 2:
            raise WireFormatError(
                f"dedup record too short for its reference table "
                f"({len(payload)} bytes)")
        refs = np.frombuffer(payload, np.uint32,
                             lay.lanes * 2 * lay.fs, base
                             ).reshape(lay.lanes, 2 * lay.fs)
        n_off = base + lay.table_bytes
        (n_inline,) = struct.unpack_from("<H", payload, n_off)
        if len(payload) != lay.general_len(has_q, n_inline) + lin:
            raise WireFormatError(
                f"dedup record length {len(payload)} != "
                f"{lay.general_len(has_q, n_inline) + lin} for "
                f"{n_inline} inline frames")
        if self._valid:
            self._check_t(hdr)
        desc = np.frombuffer(payload, _DESC, n_inline, n_off + 2)
        frames = np.frombuffer(
            payload, lay.frame_dtype, n_inline * lay.frame_elems,
            n_off + 2 + n_inline * _DESC.itemsize
            ).reshape((n_inline,) + lay.frame_shape)
        # Resolution universe per lane: the current window ids + this
        # record's inline ids. Anything else is a back-reference miss —
        # reject WHOLE, before any state mutates.
        wid = self._wid_now() if self._valid else None
        lookup = [dict() for _ in range(lay.lanes)]
        if wid is not None:
            w0 = self._s - lay.fs + 1
            for lane in range(lay.lanes):
                lut = lookup[lane]
                for j in range(lay.fs):
                    lut[int(wid[lane, j])] = self._hist[w0 + j, lane]
        for i in range(n_inline):
            lane = int(desc["lane"][i])
            if lane >= lay.lanes:
                raise WireFormatError(
                    f"inline frame for out-of-range lane {lane}")
            lookup[lane][int(desc["id"][i])] = frames[i]
        obs_stack = np.empty((lay.fs, lay.lanes) + lay.frame_shape,
                             lay.frame_dtype)
        next_stack = np.empty_like(obs_stack)
        for lane in range(lay.lanes):
            lut = lookup[lane]
            row = refs[lane]
            for j in range(lay.fs):
                o = lut.get(int(row[j]))
                n = lut.get(int(row[lay.fs + j]))
                if o is None or n is None:
                    missing = row[j] if o is None else row[lay.fs + j]
                    raise WireFormatError(
                        f"dedup back-reference miss: lane {lane} frame "
                        f"id {int(missing)} is not in the ring — "
                        f"stream desync; re-hello required")
                obs_stack[j, lane] = o
                next_stack[j, lane] = n
        # Reseed the rolling window with the new acted-on stacks and
        # re-anchor the id map; the canonical fast path resumes on the
        # next steady record.
        if self._s + lay.fs >= self._R:
            self._s = lay.fs - 2
        s0 = self._s + 1
        self._hist[s0:s0 + lay.fs] = obs_stack
        self._s = s0 + lay.fs - 1
        self._wid0 = refs[:, :lay.fs].astype(np.int64)
        self._k = 0
        self._valid = True
        self._expect_t = (int(hdr["t"]) + 1) & _U32_MASK
        axes = tuple(range(1, obs_stack.ndim)) + (0,)
        out = self._small_views(payload)
        out["obs"] = self._windows[self._s]
        out["next_obs"] = next_stack.transpose(axes)
        self.records_general += 1
        self.frames_reused += 2 * lay.fs * lay.lanes - n_inline
        self.bytes_saved += lay.plain_len(has_q) + lin - len(payload)
        chaos.mark_recovered("ingest.decode")
        return out, _lineage_meta(payload, hdr["flags"],
                                  self._meta(hdr, payload))
