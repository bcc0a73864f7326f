"""Flash attention (`flash_attention.cu`): the least time the card needs
for the traced steps' calls (q, k, v read and o written once; 4 Hd
operations a live pair and q head) over the kernels' profiled device
time, in %."""
from portbench import trace


def read(ctx):
    bound = ctx.get("flash_bound_s")
    if not bound:
        return None
    _n, seconds = trace.kernel_seconds(ctx["trace"], "flash")
    return 100.0 * bound / seconds if seconds > 0 else None
