"""Greedy-episode rollouts on host envs (twin of
``dist_dqn_tpu/utils/host_eval.py``): the eval protocol of the Ape-X
service's ``eval_every_steps``.

Numpy only: the caller's ``act`` owns the network, the device and the
random draws.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np


def run_greedy_episodes(env, act: Callable[[np.ndarray, float], np.ndarray],
                        *, episodes: int, epsilon: float = 0.001,
                        max_steps: int = 10_000,
                        on_done: Optional[Callable[[np.ndarray], None]] = None
                        ) -> Tuple[np.ndarray, int]:
    """Play one episode per lane of the host vector env ``env`` with a
    near-greedy policy; returns (per-episode returns [episodes], the
    number of episodes still running at the step cap).

    ``act(obs, epsilon) -> actions`` acts on a numpy obs batch. A lane's
    return stops accumulating at its first episode end, as in the JAX
    package. ``on_done(done)`` is called after every env step with the
    lanes whose episode just ended: a recurrent ``act`` keeps its carry and
    zeroes those lanes there, as the JAX package's recurrent eval does.
    """
    obs = env.reset()
    returns = np.zeros((episodes,), np.float64)
    alive = np.ones((episodes,), bool)
    for _ in range(max_steps):
        actions = act(obs, epsilon)
        obs, _, reward, term, trunc = env.step(np.asarray(actions))
        returns += np.asarray(reward, np.float64) * alive
        done = np.logical_or(term, trunc)
        if on_done is not None and done.any():
            on_done(done)
        alive &= ~done
        if not alive.any():
            break
    return returns, int(alive.sum())
