"""Device ms per fused iteration of replay: the kernels launched in the
program's spans ``fused.ring_add`` (the ring's insert), ``replay.draw``
(the priority plane and the sampler), ``replay.gather`` (the transitions'
gather and n-step fold) and ``replay.writeback`` (the priorities'
write-back), attributed by gpubench/arith/spans.py. Reads nothing where
the program has no such span or the trace's launches cannot be paired."""
from gpubench.arith.spans import per_iteration_ms

SPANS = ("fused.ring_add", "replay.draw", "replay.gather",
         "replay.writeback")


def read(ctx):
    return per_iteration_ms(ctx, SPANS)
