"""Policy-inference service of the port (twin of ``dist_dqn_tpu/serving/``).

The acting tier: a standalone low-latency policy server over trained
checkpoints —

  * :class:`~dist_dqn_tpu_torch.serving.batcher.MicroBatcher` — dynamic
    micro-batching of concurrent act requests into pow2-bucketed act
    steps on the card (the ingest path's bucket rule) with a max-wait
    deadline bounding p99 at low load;
  * :class:`~dist_dqn_tpu_torch.serving.model_store.ModelStore` —
    resident multi-tenant checkpoints with hot-reload off the serving
    path and atomic snapshot swaps (version header echoed per response);
  * :class:`~dist_dqn_tpu_torch.serving.router.Router` — per-request
    policy routing + per-tenant epsilon/greedy knobs;
  * :class:`~dist_dqn_tpu_torch.serving.server.PolicyServer` — the HTTP
    surface with SLO-backed /healthz and queue-full shedding
    (429 + Retry-After);
  * :class:`~dist_dqn_tpu_torch.serving.client.ServingClient` — the
    torch-free blocking client.

CLI: ``python -m dist_dqn_tpu_torch.serving --config cartpole
--checkpoint-dir RUNDIR [--device cpu]``.
"""
from dist_dqn_tpu_torch.serving.batcher import (MicroBatcher,  # noqa: F401
                                                SloTracker)
from dist_dqn_tpu_torch.serving.client import ServingClient  # noqa: F401
from dist_dqn_tpu_torch.serving.model_store import ModelStore  # noqa: F401
from dist_dqn_tpu_torch.serving.router import Router  # noqa: F401
from dist_dqn_tpu_torch.serving.server import (PolicyServer,  # noqa: F401
                                               build_server)
from dist_dqn_tpu_torch.serving.types import (ActResult,  # noqa: F401
                                              PolicySnapshot, QueueFullError,
                                              ServerClosedError, ServingError,
                                              UnknownPolicyError)
