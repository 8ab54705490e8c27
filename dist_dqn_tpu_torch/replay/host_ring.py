"""Host-DRAM time ring: the device ring's semantics, resident in host RAM
(twin of ``dist_dqn_tpu/replay/host_ring.py``).

The host-replay runtime (``host_replay_loop.py``) keeps its replay window
here instead of in device memory: device env chunks stream their
transitions down once, and sampled batches stream up per train step.
Storage is time-major [T, B] slices, each frame once, with the device
ring's n-step fold and frame-dedup stack rebuild. numpy throughout, like
the JAX module; only :class:`RingDevicePrioritySampler`'s plane is a torch
tensor on the device.

Concurrency: the pipelined runtime appends chunk slices from a background
evacuation worker while the main thread (or a prefetcher thread) samples,
so the ring carries a generation fence. Every ``add_chunk`` runs under the
ring lock and bumps ``generation`` only after its arrays are written, and
``sample``/``gather`` hold the same lock: a sampler never sees a
half-appended slice. The JAX module's telemetry (occupancy gauges, lineage
histograms, write-back counters) is not ported yet; the lineage stamps
themselves are kept, since checkpoints carry them.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, List, NamedTuple, Optional, Tuple

import numpy as np

from dist_dqn_tpu_torch.replay.host import (DevicePrioritySampler,
                                            make_sum_tree, stratified_mass)


class HostBatch(NamedTuple):
    obs: np.ndarray
    action: np.ndarray
    reward: np.ndarray
    discount: np.ndarray
    next_obs: np.ndarray


class HostSample(NamedTuple):
    """One drawn batch plus the slot identities it was drawn at."""

    batch: HostBatch
    t_idx: np.ndarray       # [S] time-slot index of each transition
    b_idx: np.ndarray       # [S] env-lane index of each transition
    generation: int         # ring generation the draw was made against


class PerSample(NamedTuple):
    """A prioritized draw's bookkeeping: what a deferred, batched priority
    write-back needs to land the learner's |TD| on the right slots, or to
    drop it when the slot was overwritten since the draw."""

    leaf: np.ndarray        # [S] flat slot ids (t * num_envs + b)
    t_idx: np.ndarray
    b_idx: np.ndarray
    slot_gen: np.ndarray    # [S] per-slot write generation at sample time
    weights: np.ndarray     # [S] normalized importance-sampling weights
    generation: int         # ring generation the draw was made against


def _np_n_step(reward_w, term_w, trunc_w, gamma: float):
    """numpy twin of replay/device.py compute_n_step (same returns)."""
    n = reward_w.shape[-1]
    done_w = np.logical_or(term_w, trunc_w)
    cont = 1.0 - done_w.astype(np.float32)
    prefix = np.concatenate(
        [np.ones_like(cont[:, :1]),
         np.cumprod(cont[:, :-1], axis=-1)], axis=-1)
    gammas = gamma ** np.arange(n, dtype=np.float32)
    returns = np.sum(prefix * gammas[None, :] * reward_w, axis=-1)
    any_done = done_w.any(axis=-1)
    first_done = np.argmax(done_w, axis=-1).astype(np.int32)
    kstar = np.where(any_done, first_done, n - 1)
    term_at_k = np.take_along_axis(term_w, kstar[:, None], axis=-1)[:, 0]
    discount = (gamma ** (kstar + 1).astype(np.float32)) * \
        (1.0 - term_at_k.astype(np.float32))
    return returns.astype(np.float32), discount.astype(np.float32), kstar


class HostTimeRing:
    """Time-major ring in host DRAM; every stored frame exactly once.

    ``frame_stack=S > 0`` declares dedup storage: callers add each step's
    NEWEST frame ([B, H, W, 1]) and ``gather``/``sample`` return rebuilt
    [N, H, W, S] stacks, with the reset-boundary rule of
    ``replay/device.py``'s stack rebuild. Truncation is treated as
    terminal (the pixel rings' no-final-obs semantics).
    """

    def __init__(self, num_slots: int, num_envs: int,
                 obs_shape: Tuple[int, ...], obs_dtype,
                 frame_stack: int = 0):
        self.num_slots = int(num_slots)
        self.num_envs = int(num_envs)
        self.frame_stack = int(frame_stack)
        self.obs = np.zeros((num_slots, num_envs) + tuple(obs_shape),
                            obs_dtype)
        self.action = np.zeros((num_slots, num_envs), np.int32)
        self.reward = np.zeros((num_slots, num_envs), np.float32)
        self.terminated = np.zeros((num_slots, num_envs), bool)
        self.truncated = np.zeros((num_slots, num_envs), bool)
        self.pos = 0
        self.size = 0
        # Generation fence: bumped once per completed add_chunk; waiters
        # and samplers synchronize on it.
        self._fence = threading.Condition(threading.RLock())
        self.generation = 0
        # Per-slot write generation: a deferred priority write-back drops
        # its update when the slot was overwritten since the draw.
        self.slot_gen = np.zeros(num_slots, np.int64)
        # Lineage stamps per t-slot: birth wall time and the acting params
        # version (the loop advances current_params_version as it trains).
        self.birth_time = np.zeros(num_slots, np.float64)
        self.slot_version = np.zeros(num_slots, np.int64)
        self.current_params_version = 0
        # Publish hooks: run under the fence with the t-slots just
        # written, after arrays/pos/size/generation are updated.
        self._publish_hooks: List[Callable[[np.ndarray], None]] = []

    @property
    def nbytes(self) -> int:
        return (self.obs.nbytes + self.action.nbytes + self.reward.nbytes
                + self.terminated.nbytes + self.truncated.nbytes)

    def add_chunk(self, obs, action, reward, terminated, truncated,
                  birth_time: Optional[float] = None,
                  params_version: Optional[int] = None) -> None:
        """Append [C, B, ...] arrays (one chunk, or one streamed slice of
        one) in time order, atomically under the generation fence."""
        C = action.shape[0]
        if C > self.num_slots:
            raise ValueError(f"chunk of {C} slices exceeds the "
                             f"{self.num_slots}-slot ring")
        with self._fence:
            idx = (self.pos + np.arange(C)) % self.num_slots
            self.obs[idx] = obs
            self.action[idx] = action
            self.reward[idx] = reward
            self.terminated[idx] = terminated
            self.truncated[idx] = truncated
            self.birth_time[idx] = (time.time() if birth_time is None
                                    else float(birth_time))
            self.slot_version[idx] = (self.current_params_version
                                      if params_version is None
                                      else int(params_version))
            self.pos = int((self.pos + C) % self.num_slots)
            self.size = int(min(self.size + C, self.num_slots))
            self.generation += 1
            self.slot_gen[idx] = self.generation
            for hook in self._publish_hooks:
                hook(idx)
            self._fence.notify_all()

    def add_publish_hook(self, hook: Callable[[np.ndarray], None]) -> None:
        """Register ``hook(idx)`` to run under the fence on every
        ``add_chunk``, after the write is published."""
        with self._fence:
            self._publish_hooks.append(hook)

    def state_dict(self) -> dict:
        """Whole-window snapshot (storage arrays, cursors, generation
        stamps), taken under the fence."""
        with self._fence:
            return {
                "obs": self.obs.copy(), "action": self.action.copy(),
                "reward": self.reward.copy(),
                "terminated": self.terminated.copy(),
                "truncated": self.truncated.copy(),
                "slot_gen": self.slot_gen.copy(),
                "birth_time": self.birth_time.copy(),
                "slot_version": self.slot_version.copy(),
                "pos": np.int64(self.pos), "size": np.int64(self.size),
                "generation": np.int64(self.generation),
            }

    def load_state_dict(self, state: dict) -> None:
        """Restore a :meth:`state_dict` snapshot of a ring built from the
        same config. Publish hooks are not replayed: a prioritized sampler
        is restored by its owner."""
        if state["obs"].shape != self.obs.shape \
                or state["obs"].dtype != self.obs.dtype:
            raise ValueError(
                f"ring snapshot {state['obs'].shape}/{state['obs'].dtype} "
                f"does not match this ring "
                f"{self.obs.shape}/{self.obs.dtype} — the checkpoint was "
                "written under a different replay/env config")
        with self._fence:
            np.copyto(self.obs, state["obs"])
            np.copyto(self.action, state["action"])
            np.copyto(self.reward, state["reward"])
            np.copyto(self.terminated, state["terminated"])
            np.copyto(self.truncated, state["truncated"])
            np.copyto(self.slot_gen, state["slot_gen"])
            if "birth_time" in state:
                np.copyto(self.birth_time, state["birth_time"])
                np.copyto(self.slot_version, state["slot_version"])
            self.pos = int(state["pos"])
            self.size = int(state["size"])
            self.generation = int(state["generation"])
            self._fence.notify_all()

    def wait_generation(self, target: int,
                        timeout: Optional[float] = None) -> bool:
        """Block until ``generation >= target``; False on timeout."""
        with self._fence:
            return self._fence.wait_for(lambda: self.generation >= target,
                                        timeout=timeout)

    # -- sampling -----------------------------------------------------------
    def _extra(self) -> int:
        return max(self.frame_stack - 1, 0)

    def can_sample(self, n_step: int) -> bool:
        return self.size > n_step + self._extra()

    def _take_stacked(self, t_idx: np.ndarray, b_idx: np.ndarray
                      ) -> np.ndarray:
        """Rebuild [N, ..., S] stacks at ``t_idx`` (dedup mode)."""
        S = self.frame_stack
        done = np.logical_or(self.terminated, self.truncated)
        age = np.full(t_idx.shape, S - 1, np.int32)
        for j in range(S - 1, 0, -1):  # descending: nearest done wins
            age = np.where(done[(t_idx - j) % self.num_slots, b_idx],
                           j - 1, age)
        frames = [self.obs[(t_idx - np.minimum(d, age)) % self.num_slots,
                           b_idx]
                  for d in range(S - 1, -1, -1)]  # oldest -> newest
        return np.concatenate(frames, axis=-1)

    def gather(self, t_idx: np.ndarray, b_idx: np.ndarray, n_step: int,
               gamma: float) -> HostBatch:
        """Window gather + n-step fold at explicit (t, b) pairs, under the
        fence."""
        with self._fence:
            return self._gather_locked(t_idx, b_idx, n_step, gamma)

    def _gather_locked(self, t_idx: np.ndarray, b_idx: np.ndarray,
                       n_step: int, gamma: float) -> HostBatch:
        offs = np.arange(n_step, dtype=np.int32)
        tt = (t_idx[:, None] + offs[None, :]) % self.num_slots
        bb = b_idx[:, None]
        returns, discount, kstar = _np_n_step(
            self.reward[tt, bb], self.terminated[tt, bb],
            self.truncated[tt, bb], gamma)
        # No final-obs buffer: zero the bootstrap at truncation too.
        trunc_at_k = np.take_along_axis(self.truncated[tt, bb],
                                        kstar[:, None], axis=-1)[:, 0]
        discount = discount * (1.0 - trunc_at_k.astype(np.float32))
        boot_t = (t_idx + kstar + 1) % self.num_slots
        if self.frame_stack:
            obs = self._take_stacked(t_idx, b_idx)
            next_obs = self._take_stacked(boot_t, b_idx)
        else:
            obs = self.obs[t_idx, b_idx]
            next_obs = self.obs[boot_t, b_idx]
        return HostBatch(obs=obs, action=self.action[t_idx, b_idx],
                         reward=returns, discount=discount,
                         next_obs=next_obs)

    def sample(self, rng: np.random.Generator, batch_size: int, n_step: int,
               gamma: float) -> HostSample:
        """Uniform over valid starts (the oldest size - n_step slots, minus
        the dedup context); the draw and the gather share one fence
        hold."""
        with self._fence:
            num_valid = self.size - n_step - self._extra()
            if num_valid <= 0:
                raise ValueError(
                    "ring not sampleable yet (gate on can_sample)")
            u = rng.integers(0, num_valid, batch_size)
            t_idx = ((self.pos - self.size + self._extra() + u)
                     % self.num_slots).astype(np.int32)
            b_idx = rng.integers(0, self.num_envs,
                                 batch_size).astype(np.int32)
            generation = self.generation
            batch = self._gather_locked(t_idx, b_idx, n_step, gamma)
        return HostSample(batch=batch, t_idx=t_idx, b_idx=b_idx,
                          generation=generation)


class RingPrioritySampler:
    """Prioritized (PER) sampling over a ``HostTimeRing``'s slots.

    Flat slot ids are ``t * num_envs + b`` over a sum-tree. The tree is
    kept in lockstep with the ring by the append path: construction
    registers a publish hook, so every ``add_chunk`` (from the main thread
    or the evacuation worker) seeds its new slots at the running max
    priority and re-masks the valid-region boundary, under the ring's
    fence.

    The tree carries mass only for sampleable slots (all but the newest
    ``n_step`` bootstrap window and the oldest frame-stack context); the
    authoritative per-slot mass lives in the ``_mass`` shadow, so a slot
    re-entering the valid region gets its priority back.

    Write-backs batch (:meth:`update_priorities`): a chronological concat,
    a per-slot expected-generation filter and one vectorized set, last
    write winning.
    """

    def __init__(self, ring: HostTimeRing, n_step: int,
                 alpha: float = 0.6, beta: float = 0.4,
                 eps: float = 1e-6, native: Optional[bool] = None):
        self._stratified = stratified_mass
        self._ring = ring
        self.n_step = int(n_step)
        self.alpha = float(alpha)
        self.beta = float(beta)
        self.eps = float(eps)
        B = ring.num_envs
        self.capacity = ring.num_slots * B
        self._make_backend(native)
        # Authoritative p^alpha per flat slot; the backend holds
        # _mass * valid_region_mask.
        self._mass = np.zeros(self.capacity, np.float64)
        self._max_priority = 1.0
        self._invalid_t = np.empty(0, np.int64)
        self.writeback_flushes = 0
        self.writeback_rows = 0
        self.writeback_dropped = 0
        with ring._fence:
            if ring.size:
                # Adopt a pre-filled ring: seed everything stored at max.
                j = np.arange(ring.size, dtype=np.int64)
                self._on_publish((ring.pos - ring.size + j)
                                 % ring.num_slots)
            ring.add_publish_hook(self._on_publish)

    # -- priority-mass backend seams -----------------------------------------
    # RingDevicePrioritySampler overrides exactly these five; every fence,
    # valid-mask and generation invariant lives once, in the methods around
    # them.
    def _make_backend(self, native: Optional[bool]) -> None:
        self.tree = make_sum_tree(self.capacity, native=native)

    def _backend_set(self, flat: np.ndarray, vals: np.ndarray) -> None:
        self.tree.set(flat, vals)

    def _backend_total(self) -> float:
        return self.tree.total

    def _draw_at_mass(self, positions: np.ndarray
                      ) -> Tuple[np.ndarray, np.ndarray]:
        """Inverse-CDF draw at explicit mass positions -> (leaf, mass)."""
        leaf = self.tree.sample(positions)
        return leaf, self.tree.get(leaf)

    def _backend_get(self, leaf: np.ndarray) -> np.ndarray:
        return self.tree.get(leaf)

    # -- ring-append synchronization (runs under the ring fence) ------------
    def _flat(self, t: np.ndarray) -> np.ndarray:
        B = self._ring.num_envs
        return (np.asarray(t, np.int64)[:, None] * B
                + np.arange(B, dtype=np.int64)[None, :]).reshape(-1)

    def _invalid_ts(self) -> np.ndarray:
        """t-slots stored but not sampleable: the oldest frame-stack
        context and the newest n_step bootstrap window."""
        ring = self._ring
        lo = min(ring._extra(), ring.size)
        hi = max(ring.size - self.n_step, lo)
        inv_j = np.concatenate([np.arange(lo, dtype=np.int64),
                                np.arange(hi, ring.size, dtype=np.int64)])
        return (ring.pos - ring.size + inv_j) % ring.num_slots

    def _on_publish(self, idx: np.ndarray) -> None:
        new_t = np.asarray(idx, np.int64)
        self._mass[self._flat(new_t)] = self._max_priority ** self.alpha
        cur_invalid = self._invalid_ts()
        # One vectorized write covers the fresh slots, those leaving the
        # invalid boundary (restored from the shadow) and those entering
        # it (zeroed).
        touched = np.unique(np.concatenate([new_t, self._invalid_t,
                                            cur_invalid]))
        flat = self._flat(touched)
        vals = self._mass[flat].copy().reshape(touched.shape[0], -1)
        vals[np.isin(touched, cur_invalid)] = 0.0
        self._backend_set(flat, vals.reshape(-1))
        self._invalid_t = cur_invalid

    # -- sampling -----------------------------------------------------------
    def sample(self, rng: np.random.Generator, batch_size: int,
               gamma: float) -> Tuple[HostBatch, PerSample]:
        """Stratified prioritized draw + gather under one fence hold ->
        (batch, PerSample). P(i) ~ p_i^alpha over the valid region; IS
        weights (N * P)^-beta, normalized to max 1."""
        ring = self._ring
        B = ring.num_envs
        with ring._fence:
            num_valid = ring.size - self.n_step - ring._extra()
            if num_valid <= 0:
                raise ValueError(
                    "ring not sampleable yet (gate on can_sample)")
            total = self._backend_total()
            leaf, mass = self._draw_at_mass(
                self._stratified(rng, batch_size, total))
            # A draw on a zero-mass (invalid-region) leaf, possible only
            # through rounding at a boundary: substitute the oldest valid
            # slot and zero its IS weight.
            bad = mass <= 0.0
            if bad.any():
                oldest_valid = ((ring.pos - ring.size + ring._extra())
                                % ring.num_slots) * B
                leaf = np.where(bad, oldest_valid, leaf)
                mass = self._backend_get(leaf)
            t_idx = (leaf // B).astype(np.int32)
            b_idx = (leaf % B).astype(np.int32)
            p_sel = mass / max(total, 1e-300)
            w = (num_valid * B * np.maximum(p_sel, 1e-12)) ** (-self.beta)
            w = (w / w.max()).astype(np.float32)
            if bad.any():
                w[bad] = 0.0
            slot_gen = self._ring.slot_gen[t_idx].copy()
            generation = ring.generation
            batch = ring._gather_locked(t_idx, b_idx, self.n_step, gamma)
        return batch, PerSample(leaf=leaf, t_idx=t_idx, b_idx=b_idx,
                                slot_gen=slot_gen, weights=w,
                                generation=generation)

    def sample_at_mass(self, mass_positions: np.ndarray, gamma: float
                       ) -> Tuple[HostBatch, PerSample, np.ndarray]:
        """Draw + gather at explicit sum-tree mass positions (one shard's
        leg of a cross-shard draw). Returns (batch, bookkeeping, raw
        p^alpha mass per row, zeroed where a boundary draw was
        substituted); ``PerSample.weights`` is a placeholder."""
        ring = self._ring
        B = ring.num_envs
        mass_positions = np.asarray(mass_positions, np.float64)
        n = mass_positions.shape[0]
        with ring._fence:
            num_valid = ring.size - self.n_step - ring._extra()
            if num_valid <= 0:
                raise ValueError(
                    "ring not sampleable yet (gate on can_sample)")
            leaf, mass = self._draw_at_mass(mass_positions)
            bad = mass <= 0.0
            if bad.any():
                oldest_valid = ((ring.pos - ring.size + ring._extra())
                                % ring.num_slots) * B
                leaf = np.where(bad, oldest_valid, leaf)
                mass = np.where(bad, 0.0, self._backend_get(leaf))
            t_idx = (leaf // B).astype(np.int32)
            b_idx = (leaf % B).astype(np.int32)
            slot_gen = self._ring.slot_gen[t_idx].copy()
            generation = ring.generation
            batch = ring._gather_locked(t_idx, b_idx, self.n_step, gamma)
        per = PerSample(leaf=leaf, t_idx=t_idx, b_idx=b_idx,
                        slot_gen=slot_gen,
                        weights=np.zeros(n, np.float32),
                        generation=generation)
        return batch, per, mass

    # -- checkpoint/resume ----------------------------------------------------
    def state_dict(self) -> dict:
        """The shadow mass, the running max, ``alpha``, the write-back
        counters and (with a host tree) the exact tree heap, under the
        ring fence."""
        with self._ring._fence:
            out = {
                "mass": self._mass.copy(),
                "max_priority": np.float64(self._max_priority),
                "alpha": np.float64(self.alpha),
                "wb_counters": np.array(
                    [self.writeback_flushes, self.writeback_rows,
                     self.writeback_dropped], np.int64),
            }
            if self.tree is not None:
                out.update({f"tree_{k}": v
                            for k, v in self.tree.state_dict().items()})
            return out

    def load_state_dict(self, state: dict) -> None:
        """Restore a :meth:`state_dict` snapshot after the owning ring was
        restored. A changed ``alpha`` is refused: the stored mass is
        p^alpha. The tree heap restores exactly when the backend matches;
        otherwise (and always for the device plane) the backend is rebuilt
        from the shadow and the ring's valid region."""
        if float(state["alpha"]) != self.alpha:
            raise ValueError(
                f"sampler snapshot was written with "
                f"alpha={float(state['alpha'])}, this run configures "
                f"alpha={self.alpha} — resume with the same "
                "replay.priority_exponent")
        mass = np.asarray(state["mass"], np.float64)
        if mass.shape != self._mass.shape:
            raise ValueError(
                f"sampler snapshot holds {mass.shape[0]} slots, this "
                f"ring has {self.capacity} — the checkpoint was written "
                "under a different replay config")
        saved_backend = bytes(np.asarray(
            state.get("tree_backend", b""))).decode() or None
        live_backend = (None if self.tree is None else
                        "native" if type(self.tree).__name__
                        == "NativeSumTree" else "numpy")
        with self._ring._fence:
            np.copyto(self._mass, mass)
            self._max_priority = float(state["max_priority"])
            self._invalid_t = self._invalid_ts()
            if live_backend is not None and \
                    saved_backend == live_backend and \
                    "tree_nodes" in state and \
                    np.asarray(state["tree_nodes"]).shape[0] \
                    == 2 * self.tree.capacity:
                self.tree.load_state_dict(
                    {k[len("tree_"):]: v for k, v in state.items()
                     if k.startswith("tree_")})
            else:
                flat = np.arange(self.capacity, dtype=np.int64)
                vals = self._mass.copy()
                vals[self._flat(self._invalid_t)] = 0.0
                self._backend_set(flat, vals)
        (self.writeback_flushes, self.writeback_rows,
         self.writeback_dropped) = (int(x) for x in state["wb_counters"])

    # -- priority write-backs ----------------------------------------------
    def update_priorities(self, leaf: np.ndarray, priorities: np.ndarray,
                          expected_gen: np.ndarray) -> Tuple[int, int]:
        """Write learner |TD| priorities back to their slots; rows whose
        slot was overwritten since the draw are dropped. Returns (applied,
        dropped). Callers batch several train steps' rows in chronological
        order into one call (last write wins)."""
        ring = self._ring
        leaf = np.asarray(leaf, np.int64)
        p = np.abs(np.asarray(priorities, np.float64)) + self.eps
        with ring._fence:
            live = ring.slot_gen[leaf // ring.num_envs] == \
                np.asarray(expected_gen, np.int64)
            dropped = int(leaf.shape[0] - int(live.sum()))
            leaf, p = leaf[live], p[live]
            if leaf.size:
                self._max_priority = max(self._max_priority,
                                         float(p.max()))
                mass = p ** self.alpha
                self._mass[leaf] = mass
                # A write-back to a slot inside the bootstrap/context
                # boundary stays shadow-only until an append re-validates
                # it.
                inv = np.isin(leaf // ring.num_envs, self._invalid_t)
                self._backend_set(leaf, np.where(inv, 0.0, mass))
        applied = int(leaf.size)
        self.writeback_flushes += 1
        self.writeback_rows += applied
        self.writeback_dropped += dropped
        return applied, dropped


class RingDevicePrioritySampler(RingPrioritySampler):
    """``RingPrioritySampler`` with the mass on a device plane
    (replay/host.py ``DevicePrioritySampler``) instead of a host sum-tree.

    Only the five backend seams differ: writes buffer into the plane (one
    last-wins scatter per draw), the stratified total reads the plane's
    host float64 mirror, and draws run on the device: through the sampler
    kernel on the card at or above 100,000 cells, else the three-level
    torch draw. ``self.tree is None``: a checkpoint carries only the
    ``_mass`` shadow, and resume rebuilds the plane from it.
    """

    def __init__(self, ring: HostTimeRing, n_step: int,
                 alpha: float = 0.6, beta: float = 0.4,
                 eps: float = 1e-6, device=None,
                 use_kernel: Optional[bool] = None):
        self._device = device
        self._use_kernel = use_kernel
        super().__init__(ring, n_step, alpha=alpha, beta=beta, eps=eps)

    def _make_backend(self, native: Optional[bool]) -> None:
        self.tree = None
        self.plane = DevicePrioritySampler(
            self.capacity, device=self._device, use_kernel=self._use_kernel)

    def _backend_set(self, flat: np.ndarray, vals: np.ndarray) -> None:
        self.plane.set(np.asarray(flat, np.int64),
                       np.asarray(vals, np.float64))

    def _backend_total(self) -> float:
        return self.plane.total

    def _draw_at_mass(self, positions: np.ndarray
                      ) -> Tuple[np.ndarray, np.ndarray]:
        # Absolute mass positions over [0, total) -> uniforms in [0, 1).
        total = self.plane.total
        u = np.asarray(positions, np.float64) / max(total, 1e-300)
        return self.plane.sample_at(u, self.capacity)

    def _backend_get(self, leaf: np.ndarray) -> np.ndarray:
        # The mass as the plane sees it (the shadow masked by the current
        # valid region), without a device read.
        mass = self._mass[np.asarray(leaf, np.int64)].copy()
        inv = np.isin(np.asarray(leaf, np.int64) // self._ring.num_envs,
                      self._invalid_t)
        mass[inv] = 0.0
        return mass
