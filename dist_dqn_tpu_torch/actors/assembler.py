"""Service-side trajectory assembly (twin of
``dist_dqn_tpu/actors/assembler.py``): actors stream raw per-step results,
and the learner service folds each (actor, env-lane) stream into Ape-X
n-step transitions (:class:`NStepAssembler`, or its C++ twin
:class:`NativeNStepAssembler` on the learner-side bootstrap path) or into
fixed-length R2D2 sequences (:class:`SequenceAssembler`), with the episode
semantics of the device rings:

  * n-step windows never span episodes: at a done, every open suffix
    window is flushed with its shrunken horizon;
  * terminal flushes carry discount 0; truncation flushes bootstrap from
    the actor-provided pre-reset final observation with discount gamma**h;
  * sequences may cross episodes, with reset flags where a new one opens.

:func:`initial_sequence_priorities` seeds a sequence's insertion priority
from the inference-time q planes. Numpy and ctypes only: no torch.
"""
from __future__ import annotations

import ctypes
import threading
from collections import deque
from typing import Deque, Dict, List, Optional

import numpy as np


class _Lane:
    __slots__ = ("obs", "action", "reward", "q_sel")

    def __init__(self):
        self.obs: Deque[np.ndarray] = deque()
        self.action: Deque[int] = deque()
        self.reward: Deque[float] = deque()
        self.q_sel: Deque[float] = deque()  # Q(obs, taken action), f32


class NStepAssembler:
    """One assembler per actor; lanes = that actor's vector envs.

    ``with_q=True`` (the zero-copy actor-priority path)
    threads the per-step ``q_sel``/``q_max`` planes (inference-time Q,
    shipped on the actor's frame) through the n-step fold: emitted
    transitions then carry ``q_start`` (q_sel at the window's first
    step), ``boot_lane`` (which lane's CURRENT next_obs is the
    bootstrap) and ``boot_q`` — NaN for within-episode windows (the
    bootstrap obs is exactly what the service's act flush computes
    q_max for this pass) or, for windows flushed by an episode END, the
    frame's own q_max: the bootstrap there is the PRE-reset final
    observation, which no act request ever sees, so the last in-episode
    plane (one step stale, same episode) is the honest in-band proxy —
    the post-reset flush q would price the window against the WRONG
    episode. (Terminal flushes carry discount 0, making boot_q inert;
    it matters for truncation flushes.) From these the service seeds
    ``|q_start - (R + discount * q_max_boot)|`` in pure numpy — the
    feed-forward twin of ``initial_sequence_priorities``, and what lets
    the ingest pass skip its priority-bootstrap dispatches entirely.
    """

    def __init__(self, num_lanes: int, n_step: int, gamma: float,
                 with_q: bool = False):
        self.n = n_step
        self.gamma = gamma
        self.with_q = with_q
        self.lanes = [_Lane() for _ in range(num_lanes)]
        self._out: Dict[str, List] = self._empty_out()

    def reset(self) -> None:
        """Drop partial lane windows (actor reconnected: the step stream
        has a gap, so open windows must not bridge it). Already-emitted
        transitions stay in the drain buffer — they are complete."""
        self.lanes = [_Lane() for _ in range(len(self.lanes))]

    def _empty_out(self) -> Dict[str, List]:
        out: Dict[str, List] = {"obs": [], "action": [], "reward": [],
                                "discount": [], "next_obs": []}
        if getattr(self, "with_q", False):
            out["q_start"] = []
            out["boot_lane"] = []
            out["boot_q"] = []
        return out

    def _emit(self, lane: _Lane, horizon: int, bootstrap: np.ndarray,
              terminal: bool, lane_idx: int,
              boot_q: float = np.nan) -> None:
        r, g = 0.0, 1.0
        for k in range(horizon):
            r += g * lane.reward[k]
            g *= self.gamma
        self._out["obs"].append(lane.obs[0])
        self._out["action"].append(lane.action[0])
        self._out["reward"].append(np.float32(r))
        self._out["discount"].append(np.float32(0.0 if terminal else g))
        self._out["next_obs"].append(bootstrap)
        if self.with_q:
            self._out["q_start"].append(lane.q_sel[0])
            self._out["boot_lane"].append(lane_idx)
            self._out["boot_q"].append(np.float32(boot_q))

    def step(self, obs: np.ndarray, action: np.ndarray, reward: np.ndarray,
             terminated: np.ndarray, truncated: np.ndarray,
             next_obs: np.ndarray,
             q_sel: Optional[np.ndarray] = None,
             q_max: Optional[np.ndarray] = None) -> None:
        """Feed one completed env step for every lane.

        ``obs``/``action`` are what the actor acted on/with; ``next_obs`` is
        the pre-reset successor (HostVectorEnv contract), used both as the
        within-episode bootstrap and the truncation bootstrap.
        ``q_sel``/``q_max`` [lanes] are required iff the assembler was
        built ``with_q`` (both aligned with THIS step's ``obs``).
        """
        if self.with_q and (q_sel is None or q_max is None):
            raise ValueError(
                "with_q assembler requires the q_sel and q_max planes")
        for i, lane in enumerate(self.lanes):
            lane.obs.append(obs[i])
            lane.action.append(int(action[i]))
            lane.reward.append(float(reward[i]))
            if self.with_q:
                lane.q_sel.append(float(q_sel[i]))
            done = bool(terminated[i]) or bool(truncated[i])
            if done:
                # Flush every suffix window at the episode end. The
                # bootstrap obs (pre-reset next_obs) never gets an act
                # request, so the in-band boot_q proxy is pinned here
                # (see class docstring); inert when terminal.
                while lane.obs:
                    self._emit(lane, len(lane.reward), next_obs[i],
                               terminal=bool(terminated[i]), lane_idx=i,
                               boot_q=(float(q_max[i]) if self.with_q
                                       else np.nan))
                    self._pop(lane)
            elif len(lane.obs) == self.n:
                self._emit(lane, self.n, next_obs[i], terminal=False,
                           lane_idx=i)
                self._pop(lane)

    @staticmethod
    def _pop(lane: _Lane) -> None:
        lane.obs.popleft()
        lane.action.popleft()
        lane.reward.popleft()
        if lane.q_sel:
            lane.q_sel.popleft()

    def drain(self) -> Optional[Dict[str, np.ndarray]]:
        """Collect emitted transitions as stacked arrays (None if empty)."""
        if not self._out["obs"]:
            return None
        out = {k: np.stack(v) if k in ("obs", "next_obs")
               else np.asarray(v)
               for k, v in self._out.items()}
        out["action"] = out["action"].astype(np.int32)
        if self.with_q:
            out["q_start"] = out["q_start"].astype(np.float32)
            out["boot_lane"] = out["boot_lane"].astype(np.int64)
            out["boot_q"] = out["boot_q"].astype(np.float32)
        self._out = self._empty_out()
        return out


class _SeqLane:
    __slots__ = ("obs", "action", "reward", "done", "opens", "carry_c",
                 "carry_h", "q_sel", "q_max", "count")

    def __init__(self):
        self.obs: Deque[np.ndarray] = deque()
        self.action: Deque[int] = deque()
        self.reward: Deque[float] = deque()
        self.done: Deque[bool] = deque()
        self.opens: Deque[bool] = deque()   # step's obs opened a new episode
        self.carry_c: Deque[np.ndarray] = deque()
        self.carry_h: Deque[np.ndarray] = deque()
        self.q_sel: Deque[float] = deque()  # Q(obs, taken action), f32
        self.q_max: Deque[float] = deque()  # max_a Q(obs, a), f32
        self.count = 0                      # total steps ever appended


class SequenceAssembler:
    """Per-actor assembly of step streams into fixed-length R2D2 sequences.

    Mirrors the on-device sequence ring (replay/sequence_device.py):
    windows of length L = burn_in + unroll + n_step start every ``stride``
    steps and may cross episode boundaries — each step carries an
    "opens episode" flag (the previous step ended one) so the learner
    re-zeroes the LSTM carry mid-window, and the emitted start state is the
    carry the inference server held *entering* the window's first step.
    Overlapping windows duplicate storage here (host DRAM is cheap and
    plentiful relative to HBM); the device ring instead stores once and
    gathers at sample time.
    """

    def __init__(self, num_lanes: int, seq_len: int, stride: int):
        self.L = seq_len
        self.stride = max(stride, 1)
        self.lanes = [_SeqLane() for _ in range(num_lanes)]
        self._prev_done = [False] * num_lanes
        self._out: List[Dict[str, np.ndarray]] = []

    def reset(self) -> None:
        """Drop partial windows after an actor reconnect (see
        NStepAssembler.reset); emitted sequences stay drainable."""
        self.lanes = [_SeqLane() for _ in range(len(self.lanes))]
        self._prev_done = [False] * len(self.lanes)

    def step(self, obs: np.ndarray, action: np.ndarray, reward: np.ndarray,
             terminated: np.ndarray, truncated: np.ndarray,
             carry_c: np.ndarray, carry_h: np.ndarray,
             q_sel: Optional[np.ndarray] = None,
             q_max: Optional[np.ndarray] = None) -> None:
        """Feed one completed env step for every lane.

        ``carry_c``/``carry_h`` are [lanes, lstm] — the recurrent state the
        server used to act on ``obs`` (pre-step carry). ``q_sel``/``q_max``
        [lanes] are the inference-time Q of the taken action and the greedy
        value; when provided, emitted sequences carry per-step q planes so
        the service can seed insertion priorities with real TD magnitudes
        (initial_sequence_priorities) instead of the running max.
        """
        with_q = q_sel is not None
        for i, lane in enumerate(self.lanes):
            done = bool(terminated[i]) or bool(truncated[i])
            lane.obs.append(obs[i])
            lane.action.append(int(action[i]))
            lane.reward.append(float(reward[i]))
            lane.done.append(done)
            lane.opens.append(self._prev_done[i])
            lane.carry_c.append(carry_c[i])
            lane.carry_h.append(carry_h[i])
            if with_q:
                lane.q_sel.append(float(q_sel[i]))
                lane.q_max.append(float(q_max[i]))
            self._prev_done[i] = done
            lane.count += 1
            # Same seeding rule as the device ring: the window whose last
            # step just landed starts at stream index count - L; emit when
            # that start is stride-aligned.
            if len(lane.obs) == self.L:
                if (lane.count - self.L) % self.stride == 0:
                    self._emit(lane, with_q)
                for q in (lane.obs, lane.action, lane.reward, lane.done,
                          lane.opens, lane.carry_c, lane.carry_h,
                          lane.q_sel, lane.q_max):
                    if q:
                        q.popleft()

    def _emit(self, lane: _SeqLane, with_q: bool) -> None:
        reset = np.asarray(lane.opens, bool)
        reset[0] = False  # start state is already episode-correct
        seq = {
            "obs": np.stack(lane.obs),
            "action": np.asarray(lane.action, np.int32),
            "reward": np.asarray(lane.reward, np.float32),
            "done": np.asarray(lane.done, bool),
            "reset": reset,
            "state_c": np.asarray(lane.carry_c[0], np.float32),
            "state_h": np.asarray(lane.carry_h[0], np.float32),
        }
        if with_q:
            seq["q_sel"] = np.asarray(lane.q_sel, np.float32)
            seq["q_max"] = np.asarray(lane.q_max, np.float32)
        self._out.append(seq)

    def drain(self) -> Optional[Dict[str, np.ndarray]]:
        """Collect emitted sequences as stacked [S, L, ...] arrays."""
        if not self._out:
            return None
        out = {k: np.stack([s[k] for s in self._out])
               for k in self._out[0]}
        self._out = []
        return out


def _h(x: np.ndarray, eps: float = 1e-3) -> np.ndarray:
    """R2D2 value rescale (numpy twin of ops/losses.value_rescale)."""
    return np.sign(x) * (np.sqrt(np.abs(x) + 1.0) - 1.0) + eps * x


def _h_inv(x: np.ndarray, eps: float = 1e-3) -> np.ndarray:
    inner = np.sqrt(1.0 + 4.0 * eps * (np.abs(x) + 1.0 + eps))
    return np.sign(x) * (np.square((inner - 1.0) / (2.0 * eps)) - 1.0)


def initial_sequence_priorities(seqs: Dict[str, np.ndarray], burn_in: int,
                                unroll: int, gamma: float, eta: float,
                                value_rescale: bool) -> np.ndarray:
    """Actor-side R2D2 insertion priorities from inference-time Q-values.

    The R2D2 seeding rule: priorities of a fresh sequence come from the TD
    errors the acting network itself saw, not from the running max. Using
    the per-step (q_sel, q_max) planes the SequenceAssembler recorded, the
    1-step TD proxy over the loss region [burn_in, burn_in + unroll) is

        td_t = q_sel_t - H( r_t + gamma * (1 - done_t) * H^-1(q_max_{t+1}) )

    (H = identity unless ``value_rescale``), mixed with the R2D2 eta rule
    p = eta * max|td| + (1 - eta) * mean|td|. Pure numpy — the Q planes rode
    along with inference, so seeding costs no extra device passes.
    """
    q_sel, q_max = seqs["q_sel"], seqs["q_max"]      # [S, L]
    r = seqs["reward"][:, burn_in:burn_in + unroll]  # [S, U]
    done = seqs["done"][:, burn_in:burn_in + unroll].astype(np.float32)
    boot = q_max[:, burn_in + 1:burn_in + unroll + 1]
    if value_rescale:
        boot = _h_inv(boot)
    target = r + gamma * (1.0 - done) * boot
    if value_rescale:
        target = _h(target)
    td = np.abs(q_sel[:, burn_in:burn_in + unroll] - target)
    return eta * td.max(axis=1) + (1.0 - eta) * td.mean(axis=1)


# ---------------------------------------------------------------------------
# Native (C++) n-step assembly: the learner-side bootstrap path's hot loop.
# ---------------------------------------------------------------------------

_asm_lib: Optional[ctypes.CDLL] = None
_asm_lock = threading.Lock()


def _assembler_lib() -> ctypes.CDLL:
    """Build (if needed) and load the C++ assembler
    (``_native/assembler.cc``, built by ``build_native_lib`` into
    ``build/dist_dqn_tpu_torch/``); raises with g++'s output when the build
    fails."""
    global _asm_lib
    with _asm_lock:
        if _asm_lib is None:
            from dist_dqn_tpu_torch.actors.transport import build_native_lib

            lib = ctypes.CDLL(str(build_native_lib("assembler.cc",
                                                   "libdqnassembler.so")))
            ptr, i64 = ctypes.c_void_p, ctypes.c_int64
            for name, res, args in (
                    ("dqn_asm_create", ptr,
                     [ctypes.c_int, ctypes.c_int, ctypes.c_double,
                      ctypes.c_uint64]),
                    ("dqn_asm_destroy", None, [ptr]),
                    ("dqn_asm_reset", None, [ptr]),
                    ("dqn_asm_set_arena", None, [ptr] + [ptr] * 5 + [i64]),
                    ("dqn_asm_step", None, [ptr] * 7),
                    ("dqn_asm_pending", i64, [ptr]),
                    ("dqn_asm_overflow", i64, [ptr]),
                    ("dqn_asm_take", i64, [ptr])):
                fn = getattr(lib, name)
                fn.restype = res
                fn.argtypes = args
            _asm_lib = lib
    return _asm_lib


def _ptr(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.c_void_p)


class NativeNStepAssembler:
    """C++ n-step assembly with the interface and the episode semantics of
    :class:`NStepAssembler` (without the q planes), bit-equal to it.

    The lane rings hold pointers into the caller's step-record arrays (the
    last ``n_step + 1`` records are kept alive here) and emissions land once
    in persistent numpy arenas. ``drain(copy=False)`` returns views of the
    arenas, valid until the next :meth:`step`; the default copies. Callers
    must not mutate the arrays they pass to :meth:`step`.
    """

    def __init__(self, num_lanes: int, n_step: int, gamma: float,
                 arena_capacity: int = 0):
        self.num_lanes = num_lanes
        self.n = n_step
        self.gamma = gamma
        self._lib = _assembler_lib()
        self._h = None
        # Worst case per step: every lane flushes n suffix windows; room
        # for several steps between drains.
        self._capacity = arena_capacity or max(64 * num_lanes * n_step, 1024)
        self._keepalive: Deque = deque(maxlen=n_step + 1)
        self._arena: Optional[Dict[str, np.ndarray]] = None

    def _init_native(self, obs: np.ndarray) -> None:
        shape, dtype = obs.shape[1:], obs.dtype
        self._h = self._lib.dqn_asm_create(
            self.num_lanes, self.n, float(self.gamma),
            obs.nbytes // obs.shape[0])
        cap = self._capacity
        self._arena = {
            "obs": np.empty((cap,) + shape, dtype),
            "action": np.empty((cap,), np.int32),
            "reward": np.empty((cap,), np.float32),
            "discount": np.empty((cap,), np.float32),
            "next_obs": np.empty((cap,) + shape, dtype),
        }
        a = self._arena
        self._lib.dqn_asm_set_arena(
            self._h, _ptr(a["obs"]), _ptr(a["action"]), _ptr(a["reward"]),
            _ptr(a["discount"]), _ptr(a["next_obs"]), cap)

    def step(self, obs, action, reward, terminated, truncated,
             next_obs) -> None:
        obs = np.ascontiguousarray(obs)
        next_obs = np.ascontiguousarray(next_obs)
        if self._h is None:
            self._init_native(obs)
        a = np.ascontiguousarray(action, np.int32)
        r = np.ascontiguousarray(reward, np.float32)
        te = np.ascontiguousarray(terminated, np.uint8)
        tr = np.ascontiguousarray(truncated, np.uint8)
        # The lane rings reference obs for up to n_step later calls.
        self._keepalive.append((obs, next_obs))
        self._lib.dqn_asm_step(self._h, _ptr(obs), _ptr(a), _ptr(r),
                               _ptr(te), _ptr(tr), _ptr(next_obs))
        if self._lib.dqn_asm_overflow(self._h):
            raise RuntimeError(
                "native assembler arena overflow: drain() more often or "
                "raise arena_capacity")

    def drain(self, copy: bool = True) -> Optional[Dict[str, np.ndarray]]:
        """Emitted transitions (None if none); ``copy=False`` returns arena
        views, valid until the next :meth:`step`."""
        if self._h is None:
            return None
        count = self._lib.dqn_asm_take(self._h)
        if count == 0:
            return None
        out = {k: v[:count] for k, v in self._arena.items()}
        if copy:
            out = {k: np.array(v) for k, v in out.items()}
        return out

    def reset(self) -> None:
        """Drop partial lane windows (see :meth:`NStepAssembler.reset`)."""
        if self._h is not None:
            self._lib.dqn_asm_reset(self._h)
        self._keepalive.clear()

    def __del__(self):
        if getattr(self, "_h", None) is not None:
            self._lib.dqn_asm_destroy(self._h)
