"""The whole step's share of the card's dense bf16 peak, in percent: the
analytic FLOPs of the window's acts (every lane of every member each
iteration) and grad steps (gpubench/arith/flops.py) over the window's
wall time. Where the card is not in the table of peaks it reads
nothing."""
from gpubench.arith import flops
from gpubench.arith.peaks import PEAK_BF16_FLOPS


def read(ctx):
    peak = PEAK_BF16_FLOPS.get(ctx["device_name"])
    window = ctx["window"]
    if peak is None or window["wall_s"] <= 0 or not window["iterations"]:
        return None
    net, A = ctx["network"], ctx["num_actions"]
    acting = window["env_steps"] * flops.forward_flops(net, A, 1)
    learning = window["grad_steps"] * flops.grad_step_flops(
        net, A, ctx["batch"], ctx["double_dqn"])
    return 100.0 * (acting + learning) / (window["wall_s"] * peak)
