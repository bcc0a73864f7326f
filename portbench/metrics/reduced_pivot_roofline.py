"""`reduced_pivot_kernel` (`simplex_pivot.cu`): the least time the card
needs for the traced periods' calls (their bytes and FP64 operations,
counted call by call on a replay of the same periods) over the kernel's
profiled device time, in %."""
from portbench import trace, work


def read(ctx):
    tally = ctx.get("pivot_work")
    if not tally or not tally["calls"]:
        return None
    _n, seconds = trace.kernel_seconds(ctx["trace"], "reduced_pivot")
    if seconds <= 0:
        return None
    bound = work.bound_s(tally["bytes"], tally["flops"],
                         work.PEAK_FP64_FLOPS)
    return 100.0 * bound / seconds
