"""Sharded host replay: N per-shard stores behind one facade (twin of
``dist_dqn_tpu/replay/sharded.py``).

* :class:`ShardedHostReplay` (JAX ``:79-376``): N ``HostTimeRing`` shards,
  the lane blocks of a collect chunk, each with its own generation fence
  and, with PER, its own ``RingPrioritySampler`` (or
  ``RingDevicePrioritySampler`` plane). :meth:`ShardedHostReplay.sample`
  lays ONE stratified mass ladder over the concatenated per-shard totals,
  so P(i) = p_i^alpha / (the total over every shard) is the single-tree
  distribution, with IS weights from the global total and valid count.
  One shard delegates to the bare ring's sampler, bit for bit. The
  host-replay runtime's data-parallel ranks each hold one such shard and
  write the facade's key layout into the checkpoint sidecar
  (host_replay_loop.py).
* :class:`ShardedPrioritizedReplay` (JAX ``:377-667``): N
  ``PrioritizedHostReplay`` item shards. Inserts carry the sticky shard id
  the ingest router stamped (an unattributed insert is refused), slot ids
  are ``shard * shard_capacity + local``, draws use the same global-mass
  ladder, and ``sampler="device"`` gives every shard its own priority
  plane, every shard's draw dispatched before any is read back. On one
  card every plane sits on it; a plane of 100,000 cells or more draws
  through the sampler kernel there.
* :func:`restore_replay_snapshot` (JAX ``:919-1010``): the exact restore
  for a matching layout and the resharding migration otherwise
  (:func:`_live_records`, :func:`_snapshot_shards`,
  :func:`_insert_with_mass`): every live record lands exactly once in
  target shard ``global_id % M`` with its saved ``p ** alpha`` mass.

* :class:`ShardSampleService` (JAX ``:668-860``), the Ape-X service's
  ``--shard-sampling``: one worker thread per shard and a coordinator run
  :meth:`ShardedPrioritizedReplay._shard_draw`, the facade's own per-shard
  draw, and hand the learner up to ``depth`` pre-packed batches with the
  generations read at draw time; a thread that dies leaves a tombstone
  that raises :class:`ShardSamplerError` at the next ``sample``.

This module is numpy apart from the device planes.
"""
from __future__ import annotations

import queue
import re
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from dist_dqn_tpu_torch.replay.host import (PrioritizedHostReplay,
                                            stratified_mass)
from dist_dqn_tpu_torch.replay.host_ring import (HostBatch, HostTimeRing,
                                                 PerSample,
                                                 RingDevicePrioritySampler,
                                                 RingPrioritySampler)


def _map_mass_to_shards(mass: np.ndarray, totals: np.ndarray
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """(shard id, shard-local mass) per global mass value. ``mass`` is
    ascending (stratified), so rows come out shard-contiguous in shard
    order; an empty shard's zero-width interval takes no row."""
    edges = np.cumsum(totals)
    shard_of = np.searchsorted(edges, mass, side="right")
    shard_of = np.minimum(shard_of, totals.shape[0] - 1).astype(np.int64)
    local = mass - (edges[shard_of] - totals[shard_of])
    return shard_of, local


class ShardedHostReplay:
    """N per-shard ``HostTimeRing`` (lane blocks) behind one facade.

    ``num_shards == 1`` delegates every draw and write-back to the single
    ring's sampler: the facade is bit-identical to the bare store. Shards
    append in lockstep (every collect chunk lands one lane block per
    shard), so ``size`` reads shard 0.
    """

    def __init__(self, num_shards: int, num_slots: int,
                 lanes_per_shard: int, obs_shape, obs_dtype,
                 frame_stack: int = 0):
        if num_shards < 1:
            raise ValueError(f"num_shards must be >= 1, got {num_shards}")
        self.num_shards = int(num_shards)
        self.num_slots = int(num_slots)
        self.lanes_per_shard = int(lanes_per_shard)
        self.rings: List[HostTimeRing] = [
            HostTimeRing(num_slots, lanes_per_shard, obs_shape, obs_dtype,
                         frame_stack=frame_stack)
            for _ in range(self.num_shards)]
        self.samplers: Optional[List[RingPrioritySampler]] = None
        #: flat-leaf stride of the global slot encoding (shard * stride +
        #: local)
        self.leaf_stride = self.num_slots * self.lanes_per_shard
        #: bytes appended into each shard's ring: against the bytes each
        #: shard's device evacuated, the per-shard conservation pair
        self.bytes_by_shard: List[int] = [0] * self.num_shards

    def attach_priority_samplers(self, n_step: int, alpha: float,
                                 beta: float, eps: float,
                                 native: Optional[bool] = None,
                                 name: str = "host_replay",
                                 device_sampling: bool = False,
                                 devices: Optional[List] = None
                                 ) -> List[RingPrioritySampler]:
        """One priority sampler per shard, each on its ring's publish hook.
        ``device_sampling`` gives shard i a device plane on
        ``devices[i % len(devices)]`` (default: the card); otherwise a host
        sum-tree. JAX's ``shard``/``seed`` have no twin: the device pins
        the plane, and the ring draws at explicit uniforms."""
        if device_sampling:
            devs = list(devices) if devices else [None]
            self.samplers = [
                RingDevicePrioritySampler(
                    ring, n_step=n_step, alpha=alpha, beta=beta, eps=eps,
                    device=devs[i % len(devs)],
                    name=f"{name}_s{i}" if self.num_shards > 1 else name)
                for i, ring in enumerate(self.rings)]
            return self.samplers
        self.samplers = [
            RingPrioritySampler(ring, n_step=n_step, alpha=alpha, beta=beta,
                                eps=eps, native=native,
                                name=f"{name}_s{i}" if self.num_shards > 1
                                else name)
            for i, ring in enumerate(self.rings)]
        return self.samplers

    # -- aggregate ring surface ----------------------------------------------
    @property
    def size(self) -> int:
        return self.rings[0].size

    @property
    def generation(self) -> List[int]:
        return [r.generation for r in self.rings]

    @property
    def nbytes(self) -> int:
        return sum(r.nbytes for r in self.rings)

    @property
    def num_envs(self) -> int:
        return self.lanes_per_shard * self.num_shards

    def can_sample(self, n_step: int) -> bool:
        return all(r.can_sample(n_step) for r in self.rings)

    @property
    def current_params_version(self) -> int:
        return self.rings[0].current_params_version

    @current_params_version.setter
    def current_params_version(self, v: int) -> None:
        for r in self.rings:
            r.current_params_version = int(v)

    def add_chunk(self, shard: int, obs, action, reward, terminated,
                  truncated) -> None:
        """Append one lane block to its shard's ring (atomic under that
        shard's generation fence)."""
        self.rings[shard].add_chunk(obs, action, reward, terminated,
                                    truncated)
        self.bytes_by_shard[shard] += sum(
            np.asarray(a).nbytes
            for a in (obs, action, reward, terminated, truncated))

    def state_dict(self) -> Dict[str, np.ndarray]:
        """Whole-window snapshot, each shard's taken under its own fence;
        with samplers attached each shard's PER state rides along."""
        out: Dict[str, np.ndarray] = {
            "num_shards": np.int64(self.num_shards)}
        for i, r in enumerate(self.rings):
            out.update(shard_state(
                i, r, self.samplers[i] if self.samplers else None))
        return out

    def load_state_dict(self, state: Dict[str, np.ndarray]) -> None:
        """Restore a :meth:`state_dict` snapshot: rings first, then each
        shard's PER state against its restored ring. A changed shard count
        is refused (the lane blocks are positional), and so is a PER
        snapshot into a uniform facade or the reverse."""
        saved = int(state["num_shards"])
        if saved != self.num_shards:
            raise ValueError(
                f"replay snapshot was written with {saved} shards, this "
                f"run configures {self.num_shards} — resume with the "
                "same shard count (re-sharding a checkpointed lane-"
                "striped window is not supported; only the apex item "
                "store migrates across shard counts)")
        has_per = any(k.startswith("shard0_per_") for k in state)
        if has_per and self.samplers is None:
            raise ValueError(
                "replay snapshot carries PER sampler state but this run "
                "samples uniformly — resume with replay.prioritized "
                "(--per), or start a fresh --checkpoint-dir")
        if self.samplers is not None and not has_per:
            raise ValueError(
                "replay snapshot has no PER sampler state but this run "
                "is prioritized — it was written by a uniform run; "
                "resume uniform, or start a fresh --checkpoint-dir")
        ring_sub, per_sub = split_shard_state(state, self.num_shards)
        for i, r in enumerate(self.rings):
            r.load_state_dict(ring_sub[i])
            if self.samplers is not None:
                self.samplers[i].load_state_dict(per_sub[i])

    # -- cross-shard prioritized sampling -------------------------------------
    def sample(self, rng: np.random.Generator, batch_size: int,
               gamma: float) -> Tuple[HostBatch, PerSample]:
        """Stratified prioritized draw across every shard's sampler: one
        global mass ladder, one :class:`PerSample` whose ``leaf`` is
        globally encoded and whose IS weights use the global total and
        valid count, normalized over the batch's real rows. One shard
        delegates to the bare sampler."""
        if self.samplers is None:
            raise ValueError("attach_priority_samplers() first")
        if self.num_shards == 1:
            return self.samplers[0].sample(rng, batch_size, gamma)
        totals = np.array([s._backend_total() for s in self.samplers],
                          np.float64)
        T = float(totals.sum())
        if T <= 0.0:
            raise ValueError("sharded sample() with zero total priority "
                             "mass (gate on can_sample)")
        mass = stratified_mass(rng, batch_size, T)
        shard_of, local_mass = _map_mass_to_shards(mass, totals)
        valid_global = sum(
            (r.size - s.n_step - r._extra()) * r.num_envs
            for r, s in zip(self.rings, self.samplers))
        parts: Dict[str, list] = {k: [] for k in (
            "obs", "action", "reward", "discount", "next_obs", "leaf",
            "t", "b", "gen", "p")}
        generations = []
        for s_id in range(self.num_shards):
            rows = shard_of == s_id
            if not rows.any():
                generations.append(self.rings[s_id].generation)
                continue
            batch, per, p_mass = self.samplers[s_id].sample_at_mass(
                local_mass[rows], gamma)
            for k in ("obs", "action", "reward", "discount", "next_obs"):
                parts[k].append(getattr(batch, k))
            parts["leaf"].append(per.leaf + s_id * self.leaf_stride)
            parts["t"].append(per.t_idx)
            parts["b"].append(per.b_idx)
            parts["gen"].append(per.slot_gen)
            parts["p"].append(p_mass)
            generations.append(per.generation)
        p_raw = np.concatenate(parts["p"])
        bad = p_raw <= 0.0          # substituted boundary rows
        p_sel = p_raw / max(T, 1e-300)
        w = (valid_global * np.maximum(p_sel, 1e-12)) ** \
            (-self.samplers[0].beta)
        # Normalize over the real rows only: a substituted row's clamped
        # p would otherwise dominate the max.
        norm = float(w[~bad].max()) if (~bad).any() else float(w.max())
        w = (w / norm).astype(np.float32)
        if bad.any():
            w[bad] = 0.0
        batch = HostBatch(*(np.concatenate(parts[k]) for k in (
            "obs", "action", "reward", "discount", "next_obs")))
        per = PerSample(leaf=np.concatenate(parts["leaf"]),
                        t_idx=np.concatenate(parts["t"]),
                        b_idx=np.concatenate(parts["b"]),
                        slot_gen=np.concatenate(parts["gen"]),
                        weights=w, generation=max(generations))
        return batch, per

    def update_priorities(self, leaf: np.ndarray, priorities: np.ndarray,
                          expected_gen: np.ndarray) -> Tuple[int, int]:
        """Route globally encoded slot ids to their shard's sampler: one
        flush per shard, each under its own generation fence. Returns
        (applied, dropped)."""
        if self.samplers is None:
            raise ValueError("attach_priority_samplers() first")
        if self.num_shards == 1:
            return self.samplers[0].update_priorities(
                leaf, priorities, expected_gen=expected_gen)
        leaf = np.asarray(leaf, np.int64)
        priorities = np.asarray(priorities, np.float64)
        expected_gen = np.asarray(expected_gen, np.int64)
        shard_of = leaf // self.leaf_stride
        applied = dropped = 0
        for s_id in range(self.num_shards):
            rows = shard_of == s_id
            if not rows.any():
                continue
            a, d = self.samplers[s_id].update_priorities(
                leaf[rows] - s_id * self.leaf_stride, priorities[rows],
                expected_gen=expected_gen[rows])
            applied += a
            dropped += d
        return applied, dropped


def shard_state(shard: int, ring: HostTimeRing,
                sampler: Optional[RingPrioritySampler] = None
                ) -> Dict[str, np.ndarray]:
    """One shard's entries of :meth:`ShardedHostReplay.state_dict`
    (``shard{i}_{field}`` and ``shard{i}_per_{field}``), ring and sampler
    under one fence hold: the unit a data-parallel rank writes for its own
    shard."""
    with ring._fence:
        out = {f"shard{shard}_{k}": v
               for k, v in ring.state_dict().items()}
        if sampler is not None:
            out.update({f"shard{shard}_per_{k}": v
                        for k, v in sampler.state_dict().items()})
    return out


def split_shard_state(state: Dict[str, np.ndarray], num_shards: int
                      ) -> Tuple[List[Dict[str, np.ndarray]],
                                 List[Dict[str, np.ndarray]]]:
    """(ring sub-dicts, PER sub-dicts) per shard of a
    :meth:`ShardedHostReplay.state_dict`. Keys split by regex, not prefix:
    ``shard1_`` is a prefix of ``shard10_obs``."""
    ring_sub: List[Dict[str, np.ndarray]] = [{} for _ in range(num_shards)]
    per_sub: List[Dict[str, np.ndarray]] = [{} for _ in range(num_shards)]
    pat = re.compile(r"^shard(\d+)_(per_)?(.+)$")
    for k, v in state.items():
        m = pat.match(k)
        if m is None or int(m.group(1)) >= num_shards:
            continue
        (per_sub if m.group(2) else ring_sub)[int(m.group(1))][
            m.group(3)] = v
    return ring_sub, per_sub


def _plane_devices(num_shards: int, sampler_device) -> List:
    """Shard i's plane device: ``sampler_device`` for every shard when
    given, else the cards round-robin (shard i on card ``i % count``, as
    JAX assigns ``jax.devices()``), so on one card every plane sits on
    it."""
    if sampler_device is not None:
        return [sampler_device] * num_shards
    count = max(torch.cuda.device_count(), 1)
    return [torch.device("cuda", i % count) for i in range(num_shards)]


class ShardedPrioritizedReplay:
    """N ``PrioritizedHostReplay`` item shards for the Ape-X service.

    ``add`` routes each batch to the sticky shard the ingest router
    assigned its actor, ``sample`` runs the global-mass stratified draw
    across the shards, and slot ids are ``shard * shard_capacity + local``
    so the service's write-backs, generation guards and batched flushes
    work unchanged.

    ``sampler="device"`` gives every shard its own priority plane (on
    ``sampler_device``, default the cards round-robin): the coordinator
    lays the same global ladder over the planes' host-mirror totals,
    dispatches every shard's explicit-uniform draw before reading any
    back, and computes the global IS weights from the returned masses.
    Items stay in host memory either way.
    """

    def __init__(self, num_shards: int, capacity: int, alpha: float = 0.6,
                 priority_eps: float = 1e-6, seed: int = 0,
                 native: Optional[bool] = None, sampler: str = "tree",
                 sampler_device=None):
        if num_shards < 2:
            raise ValueError(
                "ShardedPrioritizedReplay needs num_shards >= 2; one "
                "shard is the plain PrioritizedHostReplay")
        self.num_shards = int(num_shards)
        # Total capacity split evenly; ceil so the configured window is a
        # floor, not a ceiling.
        self.shard_capacity = -(-int(capacity) // self.num_shards)
        self.capacity = self.shard_capacity * self.num_shards
        self.alpha = float(alpha)
        self.sampler = sampler
        devices: List = [None] * self.num_shards
        if sampler == "device":
            devices = _plane_devices(self.num_shards, sampler_device)
        self.shards: List[PrioritizedHostReplay] = [
            PrioritizedHostReplay(self.shard_capacity, alpha=alpha,
                                  priority_eps=priority_eps,
                                  seed=seed + 7 * i, native=native,
                                  sampler=sampler,
                                  sampler_device=devices[i], shard=i)
            for i in range(self.num_shards)]
        # Per-shard locks: each shard's mutations and draws serialize on
        # its own lock only.
        self._locks = [threading.Lock() for _ in range(self.num_shards)]
        self._rng = np.random.default_rng(seed)
        self.sampled = 0
        self.added_by_shard: Dict[int, int] = {}

    def __len__(self) -> int:
        return sum(len(s) for s in self.shards)

    @property
    def added(self) -> int:
        return sum(s.added for s in self.shards)

    def add(self, items: Dict[str, np.ndarray],
            priorities: Optional[np.ndarray] = None,
            shard: Optional[int] = None) -> None:
        """Insert into the sticky shard. ``shard`` is required: an
        unattributed insert cannot be placed honestly in a sharded
        store."""
        if shard is None:
            raise ValueError(
                "sharded replay insert without a shard id: ingest_shards "
                "> 1 requires per-actor insert attribution — run the "
                "zerocopy transport with actor priorities (or the "
                "recurrent assembler), not the legacy concatenated "
                "bootstrap path")
        if not 0 <= shard < self.num_shards:
            raise ValueError(f"shard {shard} out of range "
                             f"[0, {self.num_shards})")
        batch = next(iter(items.values())).shape[0]
        self.added_by_shard[shard] = \
            self.added_by_shard.get(shard, 0) + batch
        with self._locks[shard]:
            self.shards[shard].add(items, priorities=priorities)

    def sample(self, batch_size: int, beta: float
               ) -> Tuple[Dict[str, np.ndarray], np.ndarray, np.ndarray]:
        """Stratified prioritized draw across every shard: one global mass
        ladder, draws per shard in proportion to its mass, IS weights from
        the global total and size with one batch-wide max normalization.
        Returns (items, global slot ids, weights)."""
        size = len(self)
        if size == 0:
            raise ValueError("sample() on an empty replay shard")
        if self.sampler == "device":
            return self._sample_device(batch_size, beta, size)
        totals = np.array([s.tree.total for s in self.shards], np.float64)
        T = float(totals.sum())
        mass = stratified_mass(self._rng, batch_size, T)
        shard_of, local_mass = _map_mass_to_shards(mass, totals)
        idx_g = np.empty(batch_size, np.int64)
        p_sel = np.empty(batch_size, np.float64)
        out: Optional[Dict[str, np.ndarray]] = None
        for s_id in range(self.num_shards):
            out = self._shard_draw(s_id, shard_of == s_id, local_mass, T,
                                   batch_size, idx_g, p_sel, out)
        weights = (size * np.maximum(p_sel, 1e-12)) ** (-beta)
        weights = (weights / weights.max()).astype(np.float32)
        self.sampled += batch_size
        return out, idx_g, weights

    def _sample_device(self, batch_size: int, beta: float, size: int
                       ) -> Tuple[Dict[str, np.ndarray], np.ndarray,
                                  np.ndarray]:
        """The device-plane leg of :meth:`sample`: the same global ladder,
        each shard's rows one explicit-uniform draw on its own plane, every
        draw dispatched before any is read back; zero-mass substitutions
        get a zero weight."""
        totals = np.array([s.device_sampler.total for s in self.shards],
                          np.float64)
        T = float(totals.sum())
        mass = stratified_mass(self._rng, batch_size, T)
        shard_of, local_mass = _map_mass_to_shards(mass, totals)
        handles: List = [None] * self.num_shards
        for s_id in range(self.num_shards):
            rows = shard_of == s_id
            if not rows.any():
                continue
            u = local_mass[rows] / max(totals[s_id], 1e-300)
            with self._locks[s_id]:
                handles[s_id] = (rows, self.shards[s_id].device_sampler
                                 .dispatch_at(u))
        idx_g = np.empty(batch_size, np.int64)
        p_sel = np.zeros(batch_size, np.float64)
        out: Optional[Dict[str, np.ndarray]] = None
        for s_id, h in enumerate(handles):
            if h is None:
                continue
            rows, handle = h
            s = self.shards[s_id]
            with self._locks[s_id]:
                idx, mass_sel = s.device_sampler.materialize_at(handle,
                                                                len(s))
                # Masses come back relative to the shard's plane; P(i)
                # divides by the global total.
                p_sel[rows] = mass_sel / max(T, 1e-300)
                idx_g[rows] = idx + s_id * self.shard_capacity
                if out is None:
                    out = {k: np.empty((batch_size,) + v.shape[1:], v.dtype)
                           for k, v in s._data.items()}
                for k, v in s._data.items():
                    out[k][rows] = v[idx]
                s.sampled += int(rows.sum())
        bad = p_sel <= 0.0
        weights = (size * np.maximum(p_sel, 1e-12)) ** (-beta)
        weights = (weights / weights.max()).astype(np.float32)
        if bad.any():
            weights[bad] = 0.0
        self.sampled += batch_size
        return out, idx_g, weights

    @property
    def device_sample_dispatches(self) -> int:
        """Per-shard device draw dispatches, summed (one per shard that
        takes rows, per draw)."""
        return sum(s.device_sampler.draw_dispatches for s in self.shards
                   if s.device_sampler is not None)

    def _shard_draw(self, s_id: int, rows: np.ndarray,
                    local_mass: np.ndarray, T: float, batch_size: int,
                    idx_g: np.ndarray, p_sel: np.ndarray,
                    out: Optional[Dict[str, np.ndarray]],
                    gen: Optional[np.ndarray] = None
                    ) -> Optional[Dict[str, np.ndarray]]:
        """One shard's slice of a stratified draw: tree sample and item
        gather into the caller's batch rows, under the shard's lock. The
        unit :class:`ShardSampleService`'s workers run, so the threaded
        draw and the facade's are the same math. ``gen`` (the service's
        path) takes the drawn slots' write generations under the same lock
        hold as the gather: a batch that waits in the queue while inserts
        overwrite its slots still fails the write-back's generation
        guard."""
        if not rows.any():
            return out
        s = self.shards[s_id]
        with self._locks[s_id]:
            idx = s.tree.sample(local_mass[rows])
            idx = np.minimum(idx, max(len(s), 1) - 1)
            p_sel[rows] = s.tree.get(idx) / max(T, 1e-300)
            idx_g[rows] = idx + s_id * self.shard_capacity
            if gen is not None:
                gen[rows] = s.generation(idx)
            if out is None:
                out = {k: np.empty((batch_size,) + v.shape[1:], v.dtype)
                       for k, v in s._data.items()}
            for k, v in s._data.items():
                out[k][rows] = v[idx]
            s.sampled += int(rows.sum())
        return out

    def generation(self, idx: np.ndarray) -> np.ndarray:
        idx = np.asarray(idx, np.int64)
        shard_of = idx // self.shard_capacity
        out = np.empty(idx.shape[0], np.int64)
        for s_id in range(self.num_shards):
            rows = shard_of == s_id
            if rows.any():
                with self._locks[s_id]:
                    out[rows] = self.shards[s_id].generation(
                        idx[rows] - s_id * self.shard_capacity)
        return out

    def update_priorities(self, idx: np.ndarray, priorities: np.ndarray,
                          expected_gen: Optional[np.ndarray] = None
                          ) -> None:
        """Per-shard batched write-backs: rows route to their owning
        shard, each applied as one vectorized set under the generation
        guard."""
        idx = np.asarray(idx, np.int64)
        priorities = np.asarray(priorities, np.float64)
        shard_of = idx // self.shard_capacity
        for s_id in range(self.num_shards):
            rows = shard_of == s_id
            if not rows.any():
                continue
            with self._locks[s_id]:
                self.shards[s_id].update_priorities(
                    idx[rows] - s_id * self.shard_capacity,
                    priorities[rows],
                    expected_gen=(None if expected_gen is None
                                  else np.asarray(expected_gen)[rows]))

    def state_dict(self) -> Dict[str, np.ndarray]:
        out: Dict[str, np.ndarray] = {
            "num_shards": np.int64(self.num_shards),
            "shard_capacity": np.int64(self.shard_capacity)}
        for i, s in enumerate(self.shards):
            if len(s) == 0:
                continue
            out.update({f"shard{i}.{k}": v
                        for k, v in s.state_dict().items()})
        return out

    def load_state_dict(self, state: Dict[str, np.ndarray]) -> None:
        """Restore a snapshot written at the same shard count exactly; a
        changed shard count runs the resharding migration
        (:func:`restore_replay_snapshot`)."""
        if int(state["num_shards"]) != self.num_shards:
            restore_replay_snapshot(self, state)
            return
        self._load_same_layout(state)

    def _load_same_layout(self, state: Dict[str, np.ndarray]) -> None:
        for i, s in enumerate(self.shards):
            prefix = f"shard{i}."
            sub = {k[len(prefix):]: v for k, v in state.items()
                   if k.startswith(prefix)}
            if sub:
                s.load_state_dict(sub)


# --------------------------------------------------------------------------
# Ingest-side per-shard sampling.
# --------------------------------------------------------------------------

class ShardSamplerError(RuntimeError):
    """A sampling thread died; re-raised on the learner thread at the next
    ``sample`` (a tombstone)."""


class ShardSampleService:
    """The stratified draw and gather run where the data lives: one worker
    thread per replay shard and a coordinator hand the learner pre-packed
    batches through a bounded queue.

    The coordinator draws the one global stratified mass ladder from the
    facade's rng, splits it by tree mass, and each shard's worker runs its
    slice of :meth:`ShardedPrioritizedReplay._shard_draw` (the function
    the facade's inline draw runs, under the same per-shard lock)
    concurrently with the other shards and with the service's inserts.
    With inserts quiesced, ``sample`` is therefore bit for bit
    ``replay.sample`` at the same batch size; live, batches are drawn up
    to ``depth`` train events ahead against the replay of that moment,
    with priorities still written back through the generation guard.

    ``beta`` rides each request, so a queued batch's IS exponent lags the
    learner by at most ``depth`` draws. ``batch_size`` must stay the same
    over a service's life (the apex learner's does). Each shard's draw
    wall and the learner's wait are registry histograms
    (``dqn_replay_shard_sample_seconds{shard}``,
    ``dqn_replay_shard_sample_wait_seconds``).
    """

    def __init__(self, replay: ShardedPrioritizedReplay, depth: int = 2,
                 name: str = "apex"):
        from dist_dqn_tpu_torch.telemetry import collectors as tmc
        from dist_dqn_tpu_torch.telemetry import get_registry

        self.replay = replay
        self.depth = max(1, int(depth))
        self._requests: "queue.Queue" = queue.Queue()
        self._results: "queue.Queue" = queue.Queue()
        self._tasks: List["queue.Queue"] = [
            queue.Queue() for _ in range(replay.num_shards)]
        self._done: "queue.Queue" = queue.Queue()
        self._outstanding = 0
        self._err: Optional[BaseException] = None
        self._closed = False
        reg = get_registry()
        self._h_draw = {
            s_id: reg.histogram(
                tmc.REPLAY_SHARD_SAMPLE_SECONDS,
                "per-shard ingest-side stratified draw + gather wall",
                labels={"shard": str(s_id)})
            for s_id in range(replay.num_shards)}
        self._h_wait = reg.histogram(
            tmc.REPLAY_SHARD_SAMPLE_WAIT,
            "learner wait on the pre-packed per-shard block queue")
        self.batches = 0
        self._workers = [
            threading.Thread(target=self._shard_loop, args=(s_id,),
                             name=f"{name}-shard-sampler-{s_id}",
                             daemon=True)
            for s_id in range(replay.num_shards)]
        self._coord = threading.Thread(target=self._coord_loop,
                                       name=f"{name}-sample-coord",
                                       daemon=True)
        for w in self._workers:
            w.start()
        self._coord.start()

    # -- threads -------------------------------------------------------------
    def _shard_loop(self, s_id: int) -> None:
        h = self._h_draw[s_id]
        while True:
            task = self._tasks[s_id].get()
            if task is None:
                return
            rows, local_mass, T, batch, idx_g, p_sel, out, gen = task
            t0 = time.perf_counter()
            try:
                self.replay._shard_draw(s_id, rows, local_mass, T, batch,
                                        idx_g, p_sel, out, gen=gen)
                h.observe(time.perf_counter() - t0)
                self._done.put(None)
            except BaseException as e:  # noqa: BLE001 — tombstoned
                self._done.put(e)

    def _coord_loop(self) -> None:
        replay = self.replay
        while True:
            req = self._requests.get()
            if req is None:
                return
            batch, beta = req
            try:
                size = len(replay)
                if size == 0:
                    raise ValueError("sample() on an empty replay shard")
                totals = np.array([s.tree.total for s in replay.shards],
                                  np.float64)
                T = float(totals.sum())
                mass = stratified_mass(replay._rng, batch, T)
                shard_of, local_mass = _map_mass_to_shards(mass, totals)
                idx_g = np.empty(batch, np.int64)
                p_sel = np.empty(batch, np.float64)
                gen = np.empty(batch, np.int64)
                # The packed batch exists before any worker starts (the
                # facade allocates it inside its serial loop), from the
                # first shard that holds data.
                out = None
                for s in replay.shards:
                    if s._data is not None:
                        out = {k: np.empty((batch,) + v.shape[1:], v.dtype)
                               for k, v in s._data.items()}
                        break
                if out is None:
                    raise ValueError("sample() before any shard holds data")
                active = 0
                for s_id in range(replay.num_shards):
                    rows = shard_of == s_id
                    if not rows.any():
                        continue
                    self._tasks[s_id].put((rows, local_mass, T, batch,
                                           idx_g, p_sel, out, gen))
                    active += 1
                errs = [e for e in (self._done.get() for _ in range(active))
                        if e is not None]
                if errs:
                    raise errs[0]
                weights = (size * np.maximum(p_sel, 1e-12)) ** (-beta)
                weights = (weights / weights.max()).astype(np.float32)
                replay.sampled += batch
                self._results.put((out, idx_g, weights, gen))
            except BaseException as e:  # noqa: BLE001 — tombstoned
                self._results.put(e)
                return

    # -- the learner's side --------------------------------------------------
    def sample(self, batch_size: int, beta: float):
        """-> (items, idx, weights, generations): keeps up to ``depth``
        requests in flight and pops the oldest finished batch, waiting
        only when the workers are behind. The generations were read at
        draw time under the shard locks."""
        if self._err is not None:
            raise ShardSamplerError(
                f"shard sampling service died: {self._err!r}") \
                from self._err
        while self._outstanding < self.depth:
            self._requests.put((int(batch_size), float(beta)))
            self._outstanding += 1
        t0 = time.perf_counter()
        while True:
            try:
                res = self._results.get(timeout=5.0)
                break
            except queue.Empty:
                if not self._coord.is_alive():
                    self._err = ShardSamplerError(
                        "sample coordinator thread died silently")
                    raise self._err
        self._outstanding -= 1
        self._h_wait.observe(time.perf_counter() - t0)
        if isinstance(res, BaseException):
            self._err = res
            raise ShardSamplerError(
                f"shard sampling failed: {res!r}") from res
        self.batches += 1
        return res

    def close(self) -> None:
        """Stop the coordinator and the workers (idempotent)."""
        if self._closed:
            return
        self._closed = True
        self._requests.put(None)
        for q in self._tasks:
            q.put(None)
        self._coord.join(timeout=5)
        for w in self._workers:
            w.join(timeout=5)


# --------------------------------------------------------------------------
# Resharding restore: a snapshot of N item shards restores into M.
# --------------------------------------------------------------------------

def _live_records(sub: Dict[str, np.ndarray]
                  ) -> Tuple[Dict[str, np.ndarray], np.ndarray, float]:
    """(records oldest to newest, per-record ``p ** alpha`` mass,
    max_priority) of one ``PrioritizedHostReplay`` snapshot. The ring may
    have wrapped, so the live region is position-dependent."""
    pos, size = (int(x) for x in sub["meta"][:2])
    cap = int(sub["capacity"])
    idx = (pos - size + np.arange(size)) % cap
    records = {k[len("data."):]: np.asarray(v)[idx]
               for k, v in sub.items() if k.startswith("data.")}
    mass = np.asarray(sub["mass"], np.float64)[idx]
    return records, mass, float(sub["max_priority"])


def _snapshot_shards(state: Dict[str, np.ndarray]
                     ) -> List[Dict[str, np.ndarray]]:
    """Per-source-shard sub-dicts of a snapshot: a plain store's snapshot
    is one shard; a sharded one splits on its ``shard{i}.`` prefixes
    (shards empty at save time come back as empty dicts)."""
    if "num_shards" not in state:
        return [dict(state)]
    n = int(state["num_shards"])
    subs: List[Dict[str, np.ndarray]] = [{} for _ in range(n)]
    pat = re.compile(r"^shard(\d+)\.(.+)$")
    for k, v in state.items():
        m = pat.match(k)
        if m is not None:
            subs[int(m.group(1))][m.group(2)] = v
    return subs


def _insert_with_mass(store: PrioritizedHostReplay,
                      records: Dict[str, np.ndarray],
                      mass: np.ndarray) -> None:
    """Append records to a shard and stamp their exact saved ``p **
    alpha`` mass over the priorities ``add`` seeded: the migration must
    not reset every record to the running max."""
    n = next(iter(records.values())).shape[0]
    if n > store.capacity:
        # Only the newest capacity records survive an oversized insert.
        records = {k: v[-store.capacity:] for k, v in records.items()}
        mass = mass[-store.capacity:]
        n = store.capacity
    idx = (store._pos + np.arange(n)) % store.capacity
    store.add(records)
    if store.device_sampler is not None:
        store.device_sampler.set(idx, mass.astype(np.float32))
    else:
        store.tree.set(idx, mass)


def restore_replay_snapshot(replay, state: Dict[str, np.ndarray]) -> Dict:
    """Restore a prioritized replay snapshot (of a ``PrioritizedHostReplay``
    or a :class:`ShardedPrioritizedReplay`) into either kind of store.

    A matching layout delegates to the exact ``load_state_dict``: cursors,
    slot generations and counters bit for bit. A changed layout migrates:
    every live record of every source shard, in age order, gets its global
    slot id (``source_shard * shard_capacity + local``) and lands in target
    shard ``global_id % M`` with its saved mass, exactly once. A migration
    keeps neither the slot generations (deferred write-backs of the killed
    run drop at the guard) nor the interleaving across source shards. A
    changed ``alpha`` is refused.

    Returns the evidence dict ``{"records", "from_shards", "to_shards",
    "resharded"}``.
    """
    sharded = isinstance(replay, ShardedPrioritizedReplay)
    tgt_shards = replay.num_shards if sharded else 1
    src_shards = int(state["num_shards"]) if "num_shards" in state else 1
    if src_shards == tgt_shards:
        if not sharded:
            replay.load_state_dict(dict(state))
            return {"records": len(replay), "from_shards": 1,
                    "to_shards": 1, "resharded": False}
        saved_cap = int(state.get("shard_capacity", replay.shard_capacity))
        if saved_cap == replay.shard_capacity:
            replay._load_same_layout(state)
            return {"records": len(replay), "from_shards": src_shards,
                    "to_shards": tgt_shards, "resharded": False}
        # Same count, another per-shard capacity: the slot encodings
        # differ, so the records migrate.

    subs = _snapshot_shards(state)
    # The migrated mass is p ** alpha_saved: stamping it into a store that
    # folds another alpha on every later write would mix exponents.
    tgt_alpha = float(replay.alpha)
    for sub in subs:
        if sub and float(sub["alpha"]) != tgt_alpha:
            raise ValueError(
                f"replay snapshot alpha {float(sub['alpha'])} != "
                f"configured {tgt_alpha} — resharding cannot mix "
                "priority exponents; resume with the same "
                "replay.priority_exponent")
    src_cap = (int(state["shard_capacity"]) if "shard_capacity" in state
               else next((int(sub["capacity"]) for sub in subs if sub), 0))
    per_target: List[List[Tuple[Dict[str, np.ndarray], np.ndarray]]] = \
        [[] for _ in range(tgt_shards)]
    moved = 0
    max_prio = 1.0
    for s_id, sub in enumerate(subs):
        if not sub:
            continue
        records, mass, mp = _live_records(sub)
        max_prio = max(max_prio, mp)
        n = mass.shape[0]
        moved += n
        pos, size = (int(x) for x in sub["meta"][:2])
        local = (pos - size + np.arange(n)) % int(sub["capacity"])
        route = (s_id * src_cap + local) % tgt_shards
        for t in range(tgt_shards):
            rows = route == t
            if rows.any():
                per_target[t].append(
                    ({k: v[rows] for k, v in records.items()}, mass[rows]))
    targets = replay.shards if sharded else [replay]
    for t, parts in enumerate(per_target):
        for records, mass in parts:
            _insert_with_mass(targets[t], records, mass)
        targets[t]._max_priority = max(targets[t]._max_priority, max_prio)
    return {"records": moved, "from_shards": src_shards,
            "to_shards": tgt_shards, "resharded": True}
