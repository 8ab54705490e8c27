"""Batched-act packing of the Ape-X service (twin of
``dist_dqn_tpu/actors/act_dispatch.py``): the observation rows of every
act request in one ingest pass concatenate into one ``[R, ...]`` batch,
padded up to a power-of-two row bucket (``pad_pow2``, the rule
``replay/host.py`` and ``loop_common.py`` share), so one act dispatch
serves every actor that reported. Padding rows are zeros with epsilon 0:
a row-independent network cannot let them perturb the real rows.

Numpy only: no torch.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from dist_dqn_tpu_torch.utils.pow2 import pad_pow2


def bucket_rows(n: int) -> int:
    """The dispatch row bucket for ``n`` queued rows: the smallest power
    of two >= n."""
    return pad_pow2(n)


def pack_act_rows(obs_list: Sequence[np.ndarray],
                  eps_list: Sequence[float]
                  ) -> Tuple[np.ndarray, np.ndarray, List[int], int]:
    """Pack per-request observation batches into one padded dispatch.

    ``obs_list[i]`` is request i's ``[r_i, ...]`` rows and ``eps_list[i]``
    its epsilon. Returns ``(obs_cat, eps, rows, total)``: ``obs_cat``
    ``[bucket_rows(total), ...]`` with zero rows past ``total``, ``eps``
    the per-row epsilon (zero on padding), ``rows`` the per-request row
    counts and ``total`` their sum.
    """
    rows = [int(o.shape[0]) for o in obs_list]
    total = sum(rows)
    padded = bucket_rows(total)
    first = obs_list[0]
    obs_cat = np.zeros((padded,) + first.shape[1:], first.dtype)
    np.concatenate(obs_list, out=obs_cat[:total])
    eps = np.zeros((padded,), np.float32)
    off = 0
    for e, r in zip(eps_list, rows):
        eps[off:off + r] = e
        off += r
    return obs_cat, eps, rows, total


def split_rows(values: np.ndarray, rows: Sequence[int]) -> List[np.ndarray]:
    """Split a dispatched result back into per-request slices (padding
    rows past ``sum(rows)`` are dropped)."""
    out, off = [], 0
    for r in rows:
        out.append(values[off:off + r])
        off += r
    return out
