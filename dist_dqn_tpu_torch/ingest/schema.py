"""Trajectory schemas: the one-time dtype/shape negotiation behind the
zero-copy wire codec.

The legacy array codec (``actors/transport.py encode_arrays``) re-states
every record's layout in a per-record JSON header — the flexible thing
to do when nothing about the stream is known, and pure overhead once an
actor has introduced itself: every step record of a session has the
SAME fields, dtypes and shapes. A :class:`TrajectorySchema` states that
layout ONCE, at hello, and every subsequent frame is a fixed-offset
slab of raw array bytes (``ingest/codec.py``) — no JSON, no pickle, no
per-field allocation on either side.

Schemas are value objects: built from an observation spec
(:func:`step_schema`), round-tripped through JSON for the hello
negotiation, and compared for equality when the learner validates an
actor's declared layout against its own env probe.

Stdlib + numpy only: actor processes import no torch.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, Sequence, Tuple

import numpy as np

#: Wire protocol version, negotiated in the hello and stamped into every
#: zero-copy frame header; a mismatch fails at connect. The JAX package's
#: value: v2 is the zero-copy frame format, v3 adds the frame-stack dedup
#: lanes (a hello capability: an actor that does not dedup never sets the
#: flags), v4 the lineage trailer (birth wall-time and the acting params'
#: version; optional per record).
PROTOCOL_VERSION = 4


@dataclasses.dataclass(frozen=True)
class FieldSpec:
    """One per-lane array field: ``shape`` EXCLUDES the lane axis."""

    name: str
    dtype: str                      # numpy dtype str, e.g. "<f4", "|u1"
    shape: Tuple[int, ...] = ()

    def __post_init__(self):
        np.dtype(self.dtype)        # validate eagerly, not at decode time
        object.__setattr__(self, "shape", tuple(int(s) for s in self.shape))

    @property
    def lane_bytes(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n * np.dtype(self.dtype).itemsize


@dataclasses.dataclass(frozen=True)
class TrajectorySchema:
    """Ordered field layout for one actor's step records.

    ``lanes`` is the actor's vector-env width; every field is stored
    ``[lanes, *field.shape]`` and serialized as raw C-order bytes in
    declaration order.
    """

    lanes: int
    fields: Tuple[FieldSpec, ...]

    def __post_init__(self):
        if self.lanes < 1:
            raise ValueError(f"schema lanes must be >= 1, got {self.lanes}")
        names = [f.name for f in self.fields]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate schema field names: {names}")

    @property
    def record_bytes(self) -> int:
        """Raw body bytes of one record (header and q planes excluded)."""
        return self.lanes * sum(f.lane_bytes for f in self.fields)

    def to_dict(self) -> Dict:
        return {"lanes": self.lanes,
                "fields": [[f.name, f.dtype, list(f.shape)]
                           for f in self.fields]}

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), sort_keys=True)

    @classmethod
    def from_dict(cls, d: Dict) -> "TrajectorySchema":
        return cls(lanes=int(d["lanes"]),
                   fields=tuple(FieldSpec(name, dtype, tuple(shape))
                                for name, dtype, shape in d["fields"]))

    @classmethod
    def from_json(cls, s: str) -> "TrajectorySchema":
        return cls.from_dict(json.loads(s))


def validate_dedup_stack(schema: TrajectorySchema, frame_stack: int
                         ) -> None:
    """Gate for the frame-stack dedup negotiation: the obs
    and next_obs fields must actually BE stacks of ``frame_stack``
    frames on their last axis, or the dedup codec would slice garbage.
    Raises ``ValueError`` with the reason (the service converts it into
    a hello rejection)."""
    if frame_stack < 2:
        raise ValueError(
            f"frame dedup needs frame_stack >= 2, got {frame_stack}")
    by_name = {f.name: f for f in schema.fields}
    for name in ("obs", "next_obs"):
        f = by_name.get(name)
        if f is None:
            raise ValueError(f"dedup schema has no {name!r} field")
        if len(f.shape) < 2:
            raise ValueError(
                f"dedup {name} field shape {f.shape} has no frame axis "
                f"(need at least [frame..., stack])")
        if f.shape[-1] != frame_stack:
            raise ValueError(
                f"dedup {name} field stacks {f.shape[-1]} frames on its "
                f"last axis but the hello declared frame_stack="
                f"{frame_stack}")


def step_schema(obs_shape: Sequence[int], obs_dtype,
                lanes: int) -> TrajectorySchema:
    """The canonical step-record schema: the exact field set
    ``actors/actor.py`` streams today (obs / reward / terminated /
    truncated / next_obs), declared once instead of per record. Both
    sides derive it independently from the env probe and the hello
    carries the actor's copy for verification — a drifted build fails
    at connect, not as garbage training data."""
    dt = np.dtype(obs_dtype).str
    shape = tuple(int(s) for s in obs_shape)
    return TrajectorySchema(lanes=lanes, fields=(
        FieldSpec("obs", dt, shape),
        FieldSpec("reward", np.dtype(np.float32).str),
        FieldSpec("terminated", np.dtype(np.uint8).str),
        FieldSpec("truncated", np.dtype(np.uint8).str),
        FieldSpec("next_obs", dt, shape),
    ))
