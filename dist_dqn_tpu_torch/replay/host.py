"""The host-DRAM replay pieces the host-replay runtime needs (twin of the
first half of ``dist_dqn_tpu/replay/host.py``).

* :func:`stratified_mass` (``:50``): the stratified jitter every host-side
  PER sampler shares.
* :class:`SumTree` (``:194``): the vectorized numpy sum-tree, and
  :func:`make_sum_tree` (``:174``), which returns it. The JAX package's
  default is its C++ ``NativeSumTree``; the port's copy of that tree comes
  with the Ape-X service, whose default it is.
* :class:`DevicePrioritySampler` (``:249-584``): the ``p ** alpha`` mass
  plane of a host-DRAM store, kept ``[ceil(capacity / lanes), lanes]`` f32
  on the card. Host writes buffer as (idx, mass) pairs, deduplicated last
  write wins, into a host float64 mirror that keeps the total without a
  device read; the next draw scatters them into the plane and re-sums the
  touched ``SAMPLE_BLOCK`` blocks, then draws. At or above 100,000 cells on
  the card the draw launches the sampler kernel
  (``ops/sampler.kernel_stratified_sample``); below that, and on the CPU,
  it runs :func:`~dist_dqn_tpu_torch.ops.sampler.stratified_sample_rows`
  over the block sums.

This module is numpy apart from the plane. ``PrioritizedHostReplay`` and
``UniformHostReplay`` (the Ape-X service's stores) are not ported yet.
"""
from __future__ import annotations

import time
from typing import Optional, Tuple

import numpy as np
import torch

from dist_dqn_tpu_torch.loop_common import pad_pow2
from dist_dqn_tpu_torch.ops.sampler import (SAMPLE_BLOCK,
                                            kernel_stratified_sample,
                                            stratified_sample_rows)
from dist_dqn_tpu_torch.utils.device import resolve_device

# Cells at or above which the plane's draw on the card goes through the
# sampler kernel (the JAX package's ``pallas_routing`` crossover).
KERNEL_MIN_CELLS = 100_000


def stratified_mass(rng: np.random.Generator, batch_size: int,
                    total: float) -> np.ndarray:
    """One mass value per batch row from equal-width strata:
    u_i ~ U[i, i+1) / S * total."""
    return (np.arange(batch_size) + rng.uniform(size=batch_size)) \
        / batch_size * total


def _check_tree_idx(idx: np.ndarray, capacity: int) -> np.ndarray:
    """Leaf-index validation: a negative numpy index would silently wrap
    onto an interior node, so out-of-range indices raise."""
    idx = np.ascontiguousarray(idx, np.int64)
    if idx.size and (idx.min() < 0 or idx.max() >= capacity):
        raise IndexError(f"sum-tree index out of range [0, {capacity}): "
                         f"{idx.min()}..{idx.max()}")
    return idx


def make_sum_tree(capacity: int, native: Optional[bool] = None):
    """The sum-tree backend: the numpy :class:`SumTree`. ``native=True``
    asks for the C++ tree, which the port does not have yet."""
    if native:
        raise ValueError("the native sum-tree is not ported yet; use the "
                         "numpy tree (native=None)")
    return SumTree(capacity)


class SumTree:
    """Flat-array binary sum-tree with vectorized batch set/sample."""

    def __init__(self, capacity: int):
        self.capacity = pad_pow2(capacity)
        self.depth = self.capacity.bit_length() - 1
        self.tree = np.zeros(2 * self.capacity, np.float64)

    @property
    def total(self) -> float:
        return float(self.tree[1])

    def get(self, idx: np.ndarray) -> np.ndarray:
        return self.tree[_check_tree_idx(idx, self.capacity) + self.capacity]

    def set(self, idx: np.ndarray, values: np.ndarray) -> None:
        """Vectorized leaf write + upward propagation."""
        leaf = _check_tree_idx(idx, self.capacity) + self.capacity
        self.tree[leaf] = values
        pos = np.unique(leaf >> 1)
        while pos[0] >= 1:
            self.tree[pos] = self.tree[2 * pos] + self.tree[2 * pos + 1]
            if pos[0] == 1:
                break
            pos = np.unique(pos >> 1)

    def sample(self, mass: np.ndarray) -> np.ndarray:
        """Map mass values in [0, total) to leaf indices, all in lockstep."""
        u = np.asarray(mass, np.float64).copy()
        idx = np.ones(u.shape[0], np.int64)
        for _ in range(self.depth):
            left = 2 * idx
            lmass = self.tree[left]
            go_right = u >= lmass
            u -= lmass * go_right
            idx = left + go_right
        return idx - self.capacity

    def state_dict(self) -> dict:
        """Exact snapshot: the whole heap (``writes`` is 0: the numpy tree
        recomputes parents on every set)."""
        return {"backend": np.bytes_(b"numpy"), "nodes": self.tree.copy(),
                "writes": np.uint64(0)}

    def load_state_dict(self, state: dict) -> None:
        nodes = np.ascontiguousarray(state["nodes"], np.float64)
        if nodes.shape[0] != 2 * self.capacity:
            raise ValueError(
                f"tree snapshot holds {nodes.shape[0] // 2} padded slots, "
                f"this tree has {self.capacity}")
        np.copyto(self.tree, nodes)


def _last_wins(idx: np.ndarray, vals: np.ndarray
               ) -> Tuple[np.ndarray, np.ndarray]:
    """The last write of each index, sorted by index."""
    _, last = np.unique(idx[::-1], return_index=True)
    keep = idx.shape[0] - 1 - last
    return idx[keep], vals[keep]


def _pad_pow2(a: np.ndarray) -> np.ndarray:
    """``a`` padded to a power-of-two length by repeating its first entry:
    every padded (index, value) pair repeats a real one, so the scatters
    write equal values at a duplicated index."""
    p = pad_pow2(a.shape[0])
    if p == a.shape[0]:
        return a
    return np.concatenate([a, np.repeat(a[:1], p - a.shape[0])])


class DevicePrioritySampler:
    """On-device priority sampling for a host-DRAM store: the ``p ** alpha``
    plane lives on ``device`` as [rows, lanes] f32 beside its
    ``SAMPLE_BLOCK`` block sums; the items stay in host memory and the
    caller gathers them at the drawn flat slot indices.

    ``total`` reads a host float64 mirror of the (f32-rounded) plane,
    updated on every :meth:`set` and re-summed exactly every
    ``_TOTAL_RESUM_EVERY`` flushes, so a caller can lay its stratified
    ladder without reading the device. :meth:`dispatch_at` and
    :meth:`materialize_at` split an explicit-uniform draw: the scatter of
    the pending writes and the draw are queued on the device, and only
    the materialize reads the result back. (The JAX plane's ``sample``,
    a draw from its own generator, serves the Ape-X service's store and
    comes with it.)

    ``use_kernel`` (default: on the card at or above ``KERNEL_MIN_CELLS``
    cells) draws through the sampler kernel's wrapper; otherwise through
    :func:`stratified_sample_rows`. ``draw_dispatches`` counts draws and
    ``writeback_rows`` the rows scattered into the plane.
    """

    #: Every this many flushes the mirror's running total is re-summed.
    _TOTAL_RESUM_EVERY = 256

    def __init__(self, capacity: int, lanes: int = 512,
                 use_kernel: Optional[bool] = None, device=None):
        self.device = resolve_device(device)
        self.capacity = int(capacity)
        self.lanes = int(lanes)
        self.rows = -(-self.capacity // self.lanes)
        if use_kernel is None:
            use_kernel = (self.device.type == "cuda"
                          and self.rows * self.lanes >= KERNEL_MIN_CELLS)
        self.use_kernel = bool(use_kernel)
        self._blk = SAMPLE_BLOCK if lanes % SAMPLE_BLOCK == 0 else lanes
        self._nb = lanes // self._blk
        self._plane = torch.zeros((self.rows, lanes), dtype=torch.float32,
                                  device=self.device)
        self._blk_sums = torch.zeros((self.rows, self._nb),
                                     dtype=torch.float32, device=self.device)
        self._pending_idx: list = []
        self._pending_val: list = []
        self._mirror = np.zeros(self.rows * lanes, np.float64)
        self._total = 0.0
        self._flushes = 0
        self.draw_dispatches = 0
        self.writeback_rows = 0

    @property
    def plane(self) -> torch.Tensor:
        """The [rows, lanes] f32 mass plane on the device."""
        return self._plane

    @property
    def total(self) -> float:
        """Total plane mass, from the host mirror (no device read)."""
        return max(self._total, 0.0)

    def set(self, idx: np.ndarray, mass: np.ndarray) -> None:
        """Buffer ``p ** alpha`` mass writes, applied before the next draw.
        The last write of a slot wins, within a call and across calls."""
        idx = np.asarray(idx, np.int32)
        vals = np.asarray(mass, np.float32)
        # Dedup up front (np.unique leaves idx sorted, which _prep_writes
        # relies on): the mirror delta below must see each slot once.
        if idx.shape[0] > 1:
            idx, vals = _last_wins(idx, vals)
        self._pending_idx.append(idx)
        self._pending_val.append(vals)
        m64 = vals.astype(np.float64)
        self._total += float(m64.sum() - self._mirror[idx].sum())
        self._mirror[idx] = m64

    def _prep_writes(self):
        """The pending writes as padded scatter operands ``(idx, vals,
        unique block ids)``, or None when nothing is pending."""
        if not self._pending_idx:
            return None
        if len(self._pending_idx) == 1:
            idx, vals = self._pending_idx[0], self._pending_val[0]
        else:
            idx, vals = _last_wins(np.concatenate(self._pending_idx),
                                   np.concatenate(self._pending_val))
        self._pending_idx, self._pending_val = [], []
        self.writeback_rows += int(idx.shape[0])
        self._flushes += 1
        if self._flushes % self._TOTAL_RESUM_EVERY == 0:
            self._total = float(self._mirror.sum())
        # idx is sorted, so the unique touched blocks are a diff away.
        blocks = idx // self._blk
        ub = blocks[np.flatnonzero(np.diff(blocks, prepend=-1))]
        return _pad_pow2(idx), _pad_pow2(vals), _pad_pow2(ub.astype(np.int32))

    def _apply(self, idx: np.ndarray, vals: np.ndarray,
               ub: np.ndarray) -> None:
        """Scatter the writes into the plane, then re-sum only the touched
        blocks into the block sums (a padded duplicate writes the same
        recomputed value again)."""
        dev = self.device
        idx_t = torch.as_tensor(idx, device=dev).long()
        ub_t = torch.as_tensor(ub, device=dev).long()
        self._plane.view(-1)[idx_t] = torch.as_tensor(vals, device=dev)
        newb = self._plane.view(-1, self._blk)[ub_t].sum(dim=1)
        self._blk_sums.view(-1)[ub_t] = newb

    def _flush_writes(self) -> None:
        w = self._prep_writes()
        if w is not None:
            self._apply(*w)

    def _select_at(self, u: torch.Tensor):
        if self.use_kernel:
            return kernel_stratified_sample(self._plane, u)
        return stratified_sample_rows(self._plane, self._blk_sums, u)

    def dispatch_at(self, u: np.ndarray):
        """Queue the pending writes and one draw at explicit uniforms ``u``
        [S] in [0, 1) on the device; returns a handle of device tensors for
        :meth:`materialize_at`."""
        self.draw_dispatches += 1
        t0 = time.perf_counter()
        self._flush_writes()
        u_t = torch.as_tensor(np.asarray(u, np.float32), device=self.device)
        t, b, mass, _ = self._select_at(u_t)
        return t0, (t.long() * self.lanes + b.long(), mass)

    def materialize_at(self, handle, size: int
                       ) -> Tuple[np.ndarray, np.ndarray]:
        """Read a :meth:`dispatch_at` handle back: (flat idx [S] int64,
        selected f64 mass [S]). A pick at or past ``size``, or on a
        zero-mass cell, is clamped into range with its mass zeroed, so the
        caller's IS weight for it is zero."""
        _, (idx, mass) = handle
        idx = idx.cpu().numpy().astype(np.int64)
        mass = mass.cpu().numpy().astype(np.float64)
        bad = (idx >= size) | (mass <= 0.0)
        if bad.any():
            idx = np.minimum(idx, size - 1)
            mass = np.where(bad, 0.0, mass)
        return idx, mass

    def sample_at(self, u: np.ndarray, size: int
                  ) -> Tuple[np.ndarray, np.ndarray]:
        """Synchronous explicit-uniform draw (dispatch + materialize)."""
        return self.materialize_at(self.dispatch_at(u), size)
