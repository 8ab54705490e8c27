"""Replay snapshots across store layouts (the restore entry of
``dist_dqn_tpu/replay/sharded.py``).

:func:`restore_replay_snapshot` restores a prioritized replay snapshot
(``PrioritizedHostReplay.state_dict``) into a store. At one shard, the only
layout the port runs, the same-layout branch delegates to the store's exact
``load_state_dict``: cursors, slot generations, counters and the per-slot
``p ** alpha`` mass come back bit for bit, into the host sum-tree or the
device plane alike. A snapshot of a sharded store (``num_shards`` in it)
needs the migration branch and the sharded store, which belong to the
multi-device work: it raises "not ported yet (ROADMAP.md A6)".
"""
from __future__ import annotations

from typing import Dict

import numpy as np


def restore_replay_snapshot(replay, state: Dict[str, np.ndarray]) -> Dict:
    """Restore ``state`` into ``replay`` (one ``PrioritizedHostReplay``
    shard); returns the evidence dict ``{"records", "from_shards",
    "to_shards", "resharded"}``."""
    src_shards = int(state["num_shards"]) if "num_shards" in state else 1
    if src_shards != 1 or getattr(replay, "num_shards", 1) != 1:
        raise NotImplementedError(
            f"not ported yet: restoring a {src_shards}-shard replay "
            "snapshot (the resharding migration and the sharded store) "
            "(ROADMAP.md A6)")
    replay.load_state_dict(dict(state))
    return {"records": len(replay), "from_shards": 1, "to_shards": 1,
            "resharded": False}
