"""Analytic FLOPs of the DQN family's Nature-CNN step, from shapes alone.

A frozen copy of the port's own arithmetic (``utils/flops.py``
``nature_cnn_fwd_flops``), kept here so that a change to the program
cannot move the yardstick, plus the heads and the count of forwards a
population iteration and a grad step make.
"""
from __future__ import annotations

# (features, kernel, stride) of the Nature torso (Mnih et al. 2015) on
# 84x84x4 frames.
NATURE_LAYERS = ((32, 8, 4), (64, 4, 2), (64, 3, 1))


def nature_cnn_fwd_flops(batch: float, hidden: int = 512,
                         num_actions: int = 0) -> float:
    """Forward FLOPs (2 per MAC) of the Nature CNN torso on 84x84x4
    frames, VALID convs 8x8/4, 4x4/2, 3x3/1, then the fc to ``hidden``;
    ``num_actions`` > 0 adds a linear head of that many outputs."""
    macs = (20 * 20 * 8 * 8 * 4 * 32        # conv1 -> [20,20,32]
            + 9 * 9 * 4 * 4 * 32 * 64       # conv2 -> [9,9,64]
            + 7 * 7 * 3 * 3 * 64 * 64       # conv3 -> [7,7,64]
            + 3136 * hidden                 # fc
            + hidden * num_actions)         # head
    return 2.0 * macs * batch


def head_outputs(network: dict, num_actions: int) -> int:
    """Outputs of the Q head: A x atoms, plus the value stream's atoms
    when the head is dueling."""
    atoms = max(int(network.get("num_atoms", 1)), 1)
    return num_actions * atoms + (atoms if network.get("dueling") else 0)


def forward_flops(network: dict, num_actions: int, rows: float) -> float:
    """FLOPs of one forward pass of ``rows`` observations."""
    return nature_cnn_fwd_flops(rows, int(network["hidden"]),
                                head_outputs(network, num_actions))


def grad_step_flops(network: dict, num_actions: int, batch: int,
                    double_dqn: bool = True) -> float:
    """FLOPs of one member's grad step of ``batch`` rows: the target
    net's and (double DQN) the online net's forwards of the next
    observations, the online forward of the observations and its
    backward, counted as twice a forward. The loss's elementwise work,
    the quantile pairs included, is left out: it is not matmul work."""
    forwards = (2 if double_dqn else 1) + 1 + 2
    return forwards * forward_flops(network, num_actions, batch)
