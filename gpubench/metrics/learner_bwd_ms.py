"""Device ms per fused iteration of the learner's backward: the kernels
launched in the program's span ``learner.backward`` (autograd's gradients,
launched from its own thread while the caller waits in the span),
attributed by gpubench/arith/spans.py. Reads nothing where the program
has no such span or the trace's launches cannot be paired."""
from gpubench.arith.spans import per_iteration_ms

SPANS = ("learner.backward",)


def read(ctx):
    return per_iteration_ms(ctx, SPANS)
