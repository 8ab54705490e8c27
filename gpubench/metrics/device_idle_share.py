"""Percent of the traced stretch's wall time in which no device event
ran: 100 (1 - busy / wall), busy the union of the events' intervals."""


def read(ctx):
    trace = ctx["trace"]
    if not trace.device or trace.wall_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s() / trace.wall_s)
