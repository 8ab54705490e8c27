"""Multi-tenant request routing of the port (twin of
``dist_dqn_tpu/serving/router.py``): policy id -> resident snapshot + the
effective act knobs.

Several checkpoints stay resident in one server (ModelStore); every act
request names a policy id (default ``"default"``) and is routed to that
policy's current snapshot. Exploration resolves per request:
``greedy=True`` forces epsilon 0, an explicit request ``epsilon`` wins
otherwise, and the tenant's configured default (per --policy-epsilon)
is the fallback — so one server can serve a greedy product surface and
an exploring shadow tenant off the same checkpoints.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

from dist_dqn_tpu_torch.serving.model_store import ModelStore
from dist_dqn_tpu_torch.serving.types import PolicySnapshot

DEFAULT_POLICY = "default"


class Router:
    def __init__(self, store: ModelStore):
        self.store = store

    def resolve(self, policy_id: Optional[str],
                epsilon: Optional[float] = None,
                greedy: bool = False) -> Tuple[PolicySnapshot, float]:
        """(snapshot, effective epsilon) for one request. Raises
        UnknownPolicyError for an unregistered id and ValueError for an
        out-of-range epsilon — both BEFORE the request is admitted to
        the batch queue, so malformed requests never consume queue
        slots or ride a dispatched batch."""
        snap = self.store.snapshot(policy_id or DEFAULT_POLICY)
        if greedy:
            eps = 0.0
        elif epsilon is not None:
            eps = float(epsilon)
            if not 0.0 <= eps <= 1.0:
                raise ValueError(
                    f"epsilon must be in [0, 1], got {eps}")
        else:
            eps = snap.epsilon
        return snap, eps

    def policies(self) -> Dict[str, Dict]:
        return self.store.policies()
