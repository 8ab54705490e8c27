"""The one power-of-two bucket rule, torch-free so that the actor-side
modules (``actors/act_dispatch.py``) can share it with the loops
(``loop_common.py``) and the stores (``replay/host.py``)."""
from __future__ import annotations


def pad_pow2(n: int) -> int:
    """Smallest power of two >= n (the JAX package's ingest bucket rule,
    dist_dqn_tpu/replay/host.py)."""
    return 1 << max(int(n) - 1, 0).bit_length()
