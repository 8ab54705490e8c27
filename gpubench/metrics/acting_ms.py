"""Device ms per fused iteration of acting: the kernels launched in the
program's spans ``fused.act`` (epsilon and the actor's forward),
``fused.env`` (the envs' step) and ``fused.episode_stats`` (the episode
trackers), attributed by gpubench/arith/spans.py. Reads nothing where the
program has no such span or the trace's launches cannot be paired."""
from gpubench.arith.spans import per_iteration_ms

SPANS = ("fused.act", "fused.env", "fused.episode_stats")


def read(ctx):
    return per_iteration_ms(ctx, SPANS)
