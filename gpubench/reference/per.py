"""Judging a stratified prioritized draw, and the plane it was drawn from.

A stratified draw of S picks from a plane of masses m_i = p_i^alpha
(over the valid cells, in row-major order) puts pick i at a uniform
point of the i-th of S equal strata of the cumulative mass (Schaul et al.
2016, appendix B.2.1). The draw is judged without its random numbers:
pick i's cell, whose interval of the cumulative mass is where its point
fell, must overlap stratum i; its gap is the distance, in strata, from
the one to the other.
"""
from __future__ import annotations

from typing import Dict

import torch


def valid_rows(num_slots: int, pos: int, size: int, n_step: int,
               stack: int) -> torch.Tensor:
    """[T] bool: the ring slots that may start an n-step window: stored,
    with n_step stored slots after them, and, for single-frame storage,
    stack - 1 stored slots before them."""
    t = torch.arange(num_slots)
    offset = (t - (pos - size)) % num_slots
    before = max(stack - 1, 0)
    return (offset >= before) & (offset < size - n_step)


def judge_draw(plane: torch.Tensor, valid: torch.Tensor, alpha: float,
               cells: torch.Tensor, samples: int) -> Dict[str, object]:
    """A draw of ``samples`` picks from ``plane`` [T, B] (priorities), pick
    i at cell ``cells[i]`` (t, b), judged.

    Returns ``gap``, the widest distance, in strata, from pick i's cell's
    interval of the cumulative mass to stratum i (``samples`` where a
    pick has no mass or the count of picks is not ``samples``), and the
    picks' ``mass`` [S] with the plane's ``total`` and ``n_valid`` (the
    valid cells), from which the importance weights follow."""
    T, B = plane.shape
    mass = torch.where(valid[:, None], plane.double() ** alpha,
                       torch.zeros((), dtype=torch.float64))
    flat = mass.reshape(-1)
    cdf = torch.cumsum(flat, dim=0)
    total = float(cdf[-1])
    idx = cells[:, 0].long() * B + cells[:, 1].long()
    hi = cdf[idx] * samples / total
    lo = hi - flat[idx] * samples / total
    strata = torch.arange(len(idx), dtype=torch.float64)
    dist = torch.maximum(lo - (strata + 1), strata - hi).clamp(min=0.0)
    if len(idx) != samples or bool((flat[idx] <= 0).any()):
        gap = float(samples)
    else:
        gap = float(dist.max())
    return {"gap": gap, "mass": flat[idx], "total": total,
            "n_valid": float(valid.sum()) * B}
