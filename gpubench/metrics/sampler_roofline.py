"""The sampler kernel's share of its roofline, in percent: the least time
the card could take for one draw from the members' planes (its bytes,
gpubench/arith/sampler_cost.py, over the HBM peak) over the kernel's mean
device time in the trace. Reads nothing where no launch of the kernel
(``sample_kernel``) is in the trace."""
from gpubench.arith.peaks import PEAK_HBM_BYTES
from gpubench.arith.sampler_cost import stratified_sample_cost

KERNEL = "sample_kernel"


def read(ctx):
    peak = PEAK_HBM_BYTES.get(ctx["device_name"])
    times = [(e - s) / 1e6 for name, s, e in ctx["trace"].device
             if KERNEL in name]
    if peak is None or not times:
        return None
    M, T, B, S = ctx["plane"]
    bound = stratified_sample_cost(T, B, S, M)["bytes"] / peak
    return 100.0 * bound / (sum(times) / len(times))
