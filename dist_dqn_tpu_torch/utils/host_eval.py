"""Greedy-episode rollouts on host envs (twin of
``dist_dqn_tpu/utils/host_eval.py``): the eval protocol of the Ape-X
service's ``eval_every_steps``.

Numpy only: the caller's ``act`` owns the network, the device and the
random draws.
"""
from __future__ import annotations

from typing import Callable, Tuple

import numpy as np


def run_greedy_episodes(env, act: Callable[[np.ndarray, float], np.ndarray],
                        *, episodes: int, epsilon: float = 0.001,
                        max_steps: int = 10_000) -> Tuple[np.ndarray, int]:
    """Play one episode per lane of the host vector env ``env`` with a
    near-greedy policy; returns (per-episode returns [episodes], the
    number of episodes still running at the step cap).

    ``act(obs, epsilon) -> actions`` acts on a numpy obs batch. A lane's
    return stops accumulating at its first episode end, as in the JAX
    package (the recurrent carry of its R2D2 act is not ported here).
    """
    obs = env.reset()
    returns = np.zeros((episodes,), np.float64)
    alive = np.ones((episodes,), bool)
    for _ in range(max_steps):
        actions = act(obs, epsilon)
        obs, _, reward, term, trunc = env.step(np.asarray(actions))
        returns += np.asarray(reward, np.float64) * alive
        alive &= ~np.logical_or(term, trunc)
        if not alive.any():
            break
    return returns, int(alive.sum())
