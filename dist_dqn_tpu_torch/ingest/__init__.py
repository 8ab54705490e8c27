"""The zero-copy ingest path between actors and the learner service (twin
of ``dist_dqn_tpu/ingest/``):

* ``schema``: :class:`TrajectorySchema` and :data:`PROTOCOL_VERSION`, the
  dtype/shape contract negotiated once at hello;
* ``codec``: fixed-header zero-copy records (encode into one reusable
  buffer, decode to views) and the frame-stack dedup plane;
* ``shm_ring``: a seqlock-stamped SPSC slot ring over
  ``multiprocessing.shared_memory`` for same-host actors;
* ``router``: sticky actor -> replay-shard assignment.

Stdlib + numpy only: actor processes import this package and no torch.
"""
from dist_dqn_tpu_torch.ingest.codec import (FLAG_DEDUP,  # noqa: F401
                                             FLAG_DEDUP_CANON, FLAG_HAS_Q,
                                             KIND_REPLY, KIND_STEP,
                                             DedupStepDecoder,
                                             DedupStepEncoder,
                                             ProtocolMismatchError,
                                             StepDecoder, StepEncoder,
                                             WireFormatError, decode_reply,
                                             encode_reply, is_zc,
                                             max_dedup_record_bytes,
                                             max_record_bytes, peek_header)
from dist_dqn_tpu_torch.ingest.router import (StickyShardRouter,  # noqa: F401
                                              shard_for)
from dist_dqn_tpu_torch.ingest.schema import (PROTOCOL_VERSION,  # noqa: F401
                                              FieldSpec, TrajectorySchema,
                                              step_schema,
                                              validate_dedup_stack)
from dist_dqn_tpu_torch.ingest.shm_ring import ShmSlotRing  # noqa: F401
