"""Service-side n-step assembly (the feed-forward part of
``dist_dqn_tpu/actors/assembler.py``): actors stream raw per-step results,
and the learner service folds each (actor, env-lane) stream into Ape-X
n-step transitions here, with the episode semantics of the device ring:

  * windows never span episodes: at a done, every open suffix window is
    flushed with its shrunken horizon;
  * terminal flushes carry discount 0; truncation flushes bootstrap from
    the actor-provided pre-reset final observation with discount gamma**h.

Pure numpy. The recurrent ``SequenceAssembler`` and the C++
``NativeNStepAssembler`` are not ported yet (ROADMAP.md A8).
"""
from __future__ import annotations

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
