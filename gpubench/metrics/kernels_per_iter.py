"""Device events (kernels, copies, memsets) per fused iteration, over the
traced stretch: the launch work ``run_chunk`` does per iteration."""


def read(ctx):
    iters = ctx["traced_iterations"]
    if not iters or not ctx["trace"].device:
        return None
    return len(ctx["trace"].device) / iters
