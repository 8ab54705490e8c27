"""Small sizes of the cells for CPU tests: the configurations' widths and
heads, with few lanes, a small ring, a batch of 16 and two members. The
ring's history carries a reward in a quarter of its slots, so that a
batch of 16 holds some, as a batch of 512 does at the cell's rate: a
loss of no reward is a few 1e-4, and its relative gap is rounding."""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

SMALL = {"replay.capacity": 4096, "replay.min_fill": 128,
         "learner.batch_size": 16, "actor.num_envs": 8,
         "actor.epsilon_decay_steps": 64}
TRAFFIC = {
    "apex.pop8": {"members": 2, "lr_scale": [1, 2], "gamma": [0.99, 0.98],
                  "chunk_iters": 5, "act_check_iters": 12,
                  "history": {"lit_share": 0.0089, "lit_value": 200,
                              "reward_rate": 0.25, "end_rate": 0.002}},
}
CELLS = tuple(TRAFFIC)
