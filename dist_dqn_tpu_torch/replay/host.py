"""Host-DRAM replay (twin of ``dist_dqn_tpu/replay/host.py``).

* :func:`pad_pow2` (``:41``), the power-of-two bucket rule, and
  :func:`stratified_mass` (``:50``), the stratified jitter every host-side
  PER sampler shares.
* :class:`NativeSumTree` (``:107``): the C++ sum-tree
  (``replay/_native/sumtree.cc``, the port's own copy, built with ``g++``
  by ``actors/transport.py build_native_lib`` into
  ``build/dist_dqn_tpu_torch/``): delta-propagated writes, a descent per
  query, a periodic exact rebuild, and an exact ``state_dict``.
  :class:`SumTree` (``:194``): the vectorized numpy sum-tree.
  :func:`make_sum_tree` (``:174``) picks the native tree where it builds,
  else the numpy tree with a one-time ``RuntimeWarning``.
* :class:`DevicePrioritySampler` (``:249-584``): the ``p ** alpha`` mass
  plane of a host-DRAM store, kept ``[ceil(capacity / lanes), lanes]`` f32
  on the card. Host writes buffer as (idx, mass) pairs, deduplicated last
  write wins, into a host float64 mirror that keeps the total without a
  device read; the next draw scatters them into the plane and re-sums the
  touched ``SAMPLE_BLOCK`` blocks, then draws. At or above 100,000 cells on
  the card the draw launches the sampler kernel
  (``ops/sampler.kernel_stratified_sample``); below that, and on the CPU,
  it runs :func:`~dist_dqn_tpu_torch.ops.sampler.stratified_sample_rows`
  over the block sums. :meth:`DevicePrioritySampler.sample` draws from the
  plane's own generator; ``sample_at`` at explicit uniforms.
* :class:`PrioritizedHostReplay` (``:585``) and :class:`UniformHostReplay`
  (``:817``): the Ape-X service's stores, items in host numpy arrays.

This module is numpy apart from the plane.
"""
from __future__ import annotations

import ctypes
import threading
import time
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from dist_dqn_tpu_torch.ops.sampler import (SAMPLE_BLOCK,
                                            importance_weights,
                                            kernel_stratified_sample,
                                            stratified_sample_rows)
from dist_dqn_tpu_torch.utils.device import resolve_device
from dist_dqn_tpu_torch.utils.pow2 import pad_pow2  # noqa: F401

_NATIVE_DIR = Path(__file__).parent / "_native"
_tree_lib = None
_tree_lib_lock = threading.Lock()
_fallback_warned = False

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


# Leaf writes between the native tree's exact rebuilds of its interior
# nodes (the float64 drift bound of delta propagation; see sumtree.cc).
_REBUILD_EVERY_WRITES = 1 << 22


def _native_tree_lib() -> ctypes.CDLL:
    """Build (if needed) and load the C++ sum-tree library."""
    global _tree_lib
    with _tree_lib_lock:
        if _tree_lib is None:
            from dist_dqn_tpu_torch.actors.transport import build_native_lib
            lib = ctypes.CDLL(str(build_native_lib(
                "sumtree.cc", "libdqnsumtree.so", directory=_NATIVE_DIR)))
            lib.dqn_tree_create.restype = ctypes.c_void_p
            lib.dqn_tree_create.argtypes = [ctypes.c_int64]
            lib.dqn_tree_destroy.argtypes = [ctypes.c_void_p]
            lib.dqn_tree_total.restype = ctypes.c_double
            lib.dqn_tree_total.argtypes = [ctypes.c_void_p]
            lib.dqn_tree_writes.restype = ctypes.c_uint64
            lib.dqn_tree_writes.argtypes = [ctypes.c_void_p]
            lib.dqn_tree_rebuild.argtypes = [ctypes.c_void_p]
            lib.dqn_tree_dump.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                          ctypes.c_void_p]
            lib.dqn_tree_load.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                          ctypes.c_uint64]
            for name in ("dqn_tree_get", "dqn_tree_set", "dqn_tree_sample"):
                getattr(lib, name).argtypes = [
                    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                    ctypes.c_int64]
            _tree_lib = lib
    return _tree_lib


class NativeSumTree:
    """C++ sum-tree (``replay/_native/sumtree.cc``) with the
    :class:`SumTree` interface: the same P(i) contract and tie rule, writes
    by delta propagation with a periodic exact rebuild."""

    def __init__(self, capacity: int):
        self._lib = _native_tree_lib()
        self.capacity = pad_pow2(capacity)  # as dqn_tree_create pads it
        self._h = self._lib.dqn_tree_create(capacity)

    def __del__(self):
        h, self._h = getattr(self, "_h", None), None
        if h is not None:
            self._lib.dqn_tree_destroy(h)

    @property
    def total(self) -> float:
        return float(self._lib.dqn_tree_total(self._h))

    def get(self, idx: np.ndarray) -> np.ndarray:
        idx = _check_tree_idx(idx, self.capacity)
        out = np.empty(idx.shape[0], np.float64)
        self._lib.dqn_tree_get(self._h, idx.ctypes.data, out.ctypes.data,
                               idx.shape[0])
        return out

    def set(self, idx: np.ndarray, values: np.ndarray) -> None:
        idx = _check_tree_idx(idx, self.capacity)
        values = np.ascontiguousarray(
            np.broadcast_to(values, idx.shape), np.float64)
        self._lib.dqn_tree_set(self._h, idx.ctypes.data, values.ctypes.data,
                               idx.shape[0])
        if self._lib.dqn_tree_writes(self._h) >= _REBUILD_EVERY_WRITES:
            self._lib.dqn_tree_rebuild(self._h)

    def sample(self, mass: np.ndarray) -> np.ndarray:
        mass = np.ascontiguousarray(mass, np.float64)
        out = np.empty(mass.shape[0], np.int64)
        self._lib.dqn_tree_sample(self._h, mass.ctypes.data, out.ctypes.data,
                                  mass.shape[0])
        return out

    def state_dict(self) -> dict:
        """Exact snapshot: the whole interior-node heap and the write
        counter. Delta propagation makes interior sums path-dependent, so a
        bit-identical resume restores the heap as it is; a rebuild from the
        leaves would differ in the last ulp."""
        nodes = np.empty(2 * self.capacity, np.float64)
        writes = ctypes.c_uint64(0)
        self._lib.dqn_tree_dump(self._h, nodes.ctypes.data,
                                ctypes.byref(writes))
        return {"backend": np.bytes_(b"native"), "nodes": nodes,
                "writes": np.uint64(writes.value)}

    def load_state_dict(self, state: dict) -> None:
        nodes = np.ascontiguousarray(state["nodes"], np.float64)
        if nodes.shape[0] != 2 * self.capacity:
            raise ValueError(
                f"tree snapshot holds {nodes.shape[0] // 2} padded slots, "
                f"this tree has {self.capacity}")
        self._lib.dqn_tree_load(self._h, nodes.ctypes.data,
                                ctypes.c_uint64(int(state["writes"])))


def make_sum_tree(capacity: int, native: Optional[bool] = None):
    """The sum-tree backend: the native C++ tree where it builds (the
    default); else, with ``native=None``, the numpy tree and one
    ``RuntimeWarning`` per process. ``native=True`` raises when the native
    tree does not build; ``native=False`` takes the numpy tree."""
    global _fallback_warned
    if native is None or native:
        try:
            return NativeSumTree(capacity)
        except Exception as e:  # noqa: BLE001 — the build's own error
            if native:
                raise
            if not _fallback_warned:
                _fallback_warned = True
                import warnings

                warnings.warn(f"native sum-tree unavailable ({e!r}); "
                              "using numpy tree", RuntimeWarning)
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
    the materialize reads the result back. :meth:`sample` draws at
    stratified uniforms from the plane's own generator (``seed``, on the
    plane's device) and returns IS weights: the Ape-X store's draw.

    ``use_kernel`` (default: on the card at or above ``KERNEL_MIN_CELLS``
    cells) draws through the sampler kernel's wrapper; otherwise through
    :func:`stratified_sample_rows`. ``draw_dispatches`` counts draws and
    ``writeback_rows`` the rows scattered into the plane.
    """

    #: Every this many flushes the mirror's running total is re-summed.
    _TOTAL_RESUM_EVERY = 256

    def __init__(self, capacity: int, lanes: int = 512,
                 use_kernel: Optional[bool] = None, device=None,
                 seed: int = 0):
        self.device = resolve_device(device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
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

    def sample(self, batch_size: int, beta: float, size: int
               ) -> Tuple[np.ndarray, np.ndarray]:
        """The pending writes, then one draw of ``batch_size`` picks at
        stratified uniforms ``(arange(S) + U) / S`` from the plane's own
        generator: (flat slot indices [S] int64, IS weights [S] f32,
        ``(size * P(i)) ** -beta`` normalized by the batch max). A pick at
        or past ``size`` (a zero-mass cell past the written region) is
        clamped to ``size - 1`` with its weight zeroed."""
        self.draw_dispatches += 1
        self._flush_writes()
        dev = self.device
        u = (torch.arange(batch_size, dtype=torch.float32, device=dev)
             + torch.rand(batch_size, generator=self.generator, device=dev)
             ) / batch_size
        t, b, mass, total = self._select_at(u)
        w = importance_weights(mass, total.float(),
                               torch.tensor(float(size), device=dev),
                               float(beta))
        idx = (t.long() * self.lanes + b.long()).cpu().numpy()
        w = w.float().cpu().numpy()
        oob = idx >= size
        if oob.any():
            idx = np.minimum(idx, size - 1)
            w = np.where(oob, np.float32(0.0), w)
        return idx, w


class PrioritizedHostReplay:
    """One prioritized replay shard over host DRAM (the Ape-X service's
    store).

    Items are dicts of numpy arrays (n-step-folded transitions), stored
    from the first batch's dtypes and shapes. ``alpha`` is folded into the
    stored mass at write time. ``sampler="tree"`` draws on the host through
    the sum-tree :func:`make_sum_tree` picks (``native``: the C++ tree by
    default); ``sampler="device"`` keeps the mass plane on
    ``sampler_device`` (the card by default) and draws through
    :class:`DevicePrioritySampler`. The items stay in host memory either
    way.

    Every slot carries a write generation (``generation``), so a deferred
    priority write-back (``update_priorities(..., expected_gen=...)``)
    skips slots overwritten since they were drawn.
    """

    def __init__(self, capacity: int, alpha: float = 0.6,
                 priority_eps: float = 1e-6, seed: int = 0,
                 native: Optional[bool] = None, sampler: str = "tree",
                 sampler_device=None, shard: Optional[int] = None):
        if sampler not in ("tree", "device"):
            raise ValueError(f"sampler must be 'tree' or 'device', got "
                             f"{sampler!r}")
        self.capacity = capacity
        self.alpha = alpha
        self.priority_eps = priority_eps
        self.sampler = sampler
        self.shard = shard
        self.device_sampler = (
            DevicePrioritySampler(capacity, seed=seed, device=sampler_device)
            if sampler == "device" else None)
        # Device mode never reads a host tree.
        self.tree = (None if self.device_sampler is not None
                     else make_sum_tree(capacity, native=native))
        self._data: Optional[Dict[str, np.ndarray]] = None
        self._pos = 0
        self._size = 0
        self._max_priority = 1.0
        self._rng = np.random.default_rng(seed)
        self.added = 0
        self.sampled = 0
        # Items per sticky routing shard (ingest/router.py).
        self.added_by_shard: Dict[int, int] = {}
        self._slot_gen = np.zeros(capacity, np.int64)

    def __len__(self) -> int:
        return self._size

    def _ensure_storage(self, items: Dict[str, np.ndarray]) -> None:
        if self._data is None:
            self._data = {
                k: np.zeros((self.capacity,) + v.shape[1:], v.dtype)
                for k, v in items.items()
            }

    def _set_mass(self, idx: np.ndarray, mass: np.ndarray) -> None:
        if self.device_sampler is not None:
            self.device_sampler.set(idx, mass)
        else:
            self.tree.set(idx, mass)

    def add(self, items: Dict[str, np.ndarray],
            priorities: Optional[np.ndarray] = None,
            shard: Optional[int] = None) -> None:
        """Ring-write a batch; without ``priorities`` the items get the
        running max priority. ``shard`` (the sticky routing tag) counts
        into ``added_by_shard``."""
        batch = next(iter(items.values())).shape[0]
        if shard is not None:
            self.added_by_shard[shard] = \
                self.added_by_shard.get(shard, 0) + batch
        self._ensure_storage(items)
        idx = (self._pos + np.arange(batch)) % self.capacity
        for k, v in items.items():
            self._data[k][idx] = v
        if priorities is None:
            p = np.full(batch, self._max_priority)
        else:
            p = np.abs(np.asarray(priorities, np.float64)) \
                + self.priority_eps
            self._max_priority = max(self._max_priority, float(p.max()))
        self._set_mass(idx, p ** self.alpha)
        self.added += batch
        self._slot_gen[idx] = self.added
        self._pos = int((self._pos + batch) % self.capacity)
        self._size = int(min(self._size + batch, self.capacity))

    def sample(self, batch_size: int, beta: float
               ) -> Tuple[Dict[str, np.ndarray], np.ndarray, np.ndarray]:
        """Stratified prioritized sample -> (items, indices, IS weights)."""
        if self._size == 0:
            raise ValueError("sample() on an empty replay shard")
        if self.device_sampler is not None:
            idx, weights = self.device_sampler.sample(batch_size, beta,
                                                      self._size)
        else:
            total = self.tree.total
            idx = self.tree.sample(
                stratified_mass(self._rng, batch_size, total))
            idx = np.minimum(idx, self._size - 1)
            p_sel = self.tree.get(idx) / total
            weights = (self._size * np.maximum(p_sel, 1e-12)) ** (-beta)
            weights = (weights / weights.max()).astype(np.float32)
        items = {k: v[idx] for k, v in self._data.items()}
        self.sampled += batch_size
        return items, idx, weights

    def state_dict(self) -> Dict[str, np.ndarray]:
        """Snapshot: the item arrays over the whole ring, the per-slot
        ``p ** alpha`` mass, the generations and the cursor/counters."""
        if self._data is None:
            raise ValueError("state_dict() on an unallocated shard "
                             "(nothing added yet)")
        if self.device_sampler is not None:
            self.device_sampler._flush_writes()
            mass = self.device_sampler.plane.reshape(-1)[
                :self.capacity].cpu().numpy().copy()
        else:
            mass = np.asarray(
                self.tree.get(np.arange(self.capacity, dtype=np.int64)),
                np.float64)
        out = {f"data.{k}": v for k, v in self._data.items()}
        out.update(mass=mass, slot_gen=self._slot_gen.copy(),
                   meta=np.array([self._pos, self._size, self.added,
                                  self.sampled], np.int64),
                   max_priority=np.float64(self._max_priority),
                   alpha=np.float64(self.alpha),
                   capacity=np.int64(self.capacity))
        return out

    def load_state_dict(self, state: Dict[str, np.ndarray]) -> None:
        """Restore a :meth:`state_dict` snapshot into this (same-capacity,
        same-alpha) shard."""
        if int(state["capacity"]) != self.capacity:
            raise ValueError(
                f"replay snapshot capacity {int(state['capacity'])} != "
                f"configured {self.capacity} — restore with the same "
                "replay.capacity used at save time")
        if float(state["alpha"]) != self.alpha:
            raise ValueError(
                f"replay snapshot alpha {float(state['alpha'])} != "
                f"configured {self.alpha}")
        self._data = {k[len("data."):]: np.array(v)
                      for k, v in state.items() if k.startswith("data.")}
        self._pos, self._size, self.added, self.sampled = (
            int(x) for x in state["meta"])
        self._max_priority = float(state["max_priority"])
        self._slot_gen = np.array(state["slot_gen"], np.int64)
        idx = np.arange(self.capacity, dtype=np.int64)
        mass = np.asarray(state["mass"], np.float64)
        self._set_mass(idx, mass.astype(np.float32)
                       if self.device_sampler is not None else mass)

    def generation(self, idx: np.ndarray) -> np.ndarray:
        """Write-generation stamps of the given slots."""
        return self._slot_gen[np.asarray(idx, np.int64)].copy()

    def update_priorities(self, idx: np.ndarray, priorities: np.ndarray,
                          expected_gen: Optional[np.ndarray] = None) -> None:
        """Write back learner |TD| priorities. With ``expected_gen`` (the
        ``generation`` read at sample time), slots overwritten since are
        skipped."""
        idx = np.asarray(idx, np.int64)
        p = np.abs(np.asarray(priorities, np.float64)) + self.priority_eps
        if expected_gen is not None:
            live = self._slot_gen[idx] == expected_gen
            if not live.all():
                idx, p = idx[live], p[live]
            if idx.size == 0:
                return
        self._max_priority = max(self._max_priority, float(p.max()))
        self._set_mass(idx, p ** self.alpha)


class UniformHostReplay:
    """Uniform ring-buffer shard with the same item interface."""

    def __init__(self, capacity: int, seed: int = 0):
        self.capacity = capacity
        self._data: Optional[Dict[str, np.ndarray]] = None
        self._pos = 0
        self._size = 0
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return self._size

    def add(self, items: Dict[str, np.ndarray]) -> None:
        batch = next(iter(items.values())).shape[0]
        if self._data is None:
            self._data = {
                k: np.zeros((self.capacity,) + v.shape[1:], v.dtype)
                for k, v in items.items()
            }
        idx = (self._pos + np.arange(batch)) % self.capacity
        for k, v in items.items():
            self._data[k][idx] = v
        self._pos = int((self._pos + batch) % self.capacity)
        self._size = int(min(self._size + batch, self.capacity))

    def sample(self, batch_size: int) -> Dict[str, np.ndarray]:
        idx = self._rng.integers(0, self._size, size=batch_size)
        return {k: v[idx] for k, v in self._data.items()}

    def state_dict(self) -> Dict[str, np.ndarray]:
        if self._data is None:
            raise ValueError("state_dict() on an unallocated shard "
                             "(nothing added yet)")
        out = {f"data.{k}": v for k, v in self._data.items()}
        out.update(meta=np.array([self._pos, self._size], np.int64),
                   capacity=np.int64(self.capacity))
        return out

    def load_state_dict(self, state: Dict[str, np.ndarray]) -> None:
        if int(state["capacity"]) != self.capacity:
            raise ValueError(
                f"replay snapshot capacity {int(state['capacity'])} != "
                f"configured {self.capacity} — restore with the same "
                "replay.capacity used at save time")
        self._data = {k[len("data."):]: np.array(v)
                      for k, v in state.items() if k.startswith("data.")}
        self._pos, self._size = (int(x) for x in state["meta"])
