"""Device ms per fused iteration of the learner's optimizer: the kernels
launched in the program's span ``learner.optimizer`` (clipped Adam and
the target sync), attributed by gpubench/arith/spans.py. Reads nothing
where the program has no such span or the trace's launches cannot be
paired."""
from gpubench.arith.spans import per_iteration_ms

SPANS = ("learner.optimizer",)


def read(ctx):
    return per_iteration_ms(ctx, SPANS)
