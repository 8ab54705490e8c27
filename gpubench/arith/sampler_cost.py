"""Bytes and operations of one stratified priority draw, from shapes.

A frozen copy of the port's ``utils/flops.py`` ``stratified_sample_cost``:
read the plane and the uniforms once, write the three [S] outputs and the
total once; add every cell once, scan the row sums, and per pick search
log2(rows) rows and walk the lanes.
"""
from __future__ import annotations

import math
from typing import Dict


def stratified_sample_cost(rows: int, lanes: int, samples: int,
                           members: int = 1) -> Dict[str, float]:
    """``{"flops", "bytes"}`` of one draw of ``samples`` picks from each of
    ``members`` ``rows x lanes`` float32 mass planes."""
    bytes_moved = members * (rows * lanes * 4 + samples * 4
                             + samples * 12 + 4)
    ops = members * (rows * lanes + rows + samples * (
        math.ceil(math.log2(max(rows, 2))) + lanes))
    return {"flops": float(ops), "bytes": float(bytes_moved)}
