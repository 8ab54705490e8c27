"""Device ms per fused iteration of the learner's forward: the kernels
launched in the program's span ``learner.forward`` (the members' losses),
attributed by gpubench/arith/spans.py. Reads nothing where the program
has no such span or the trace's launches cannot be paired."""
from gpubench.arith.spans import per_iteration_ms

SPANS = ("learner.forward",)


def read(ctx):
    return per_iteration_ms(ctx, SPANS)
