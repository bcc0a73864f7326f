"""Flash-decode (`decode_attention.cu`): the least time the card needs
for the traced steps' calls (q read and o written once, the K and V rows
of the valid slots read once; 4 Hd operations a q head and slot) over
the kernel's profiled device time, in %."""
from portbench import trace


def read(ctx):
    bound = ctx.get("decode_bound_s")
    if not bound:
        return None
    _n, seconds = trace.kernel_seconds(ctx["trace"], "decode_attention")
    return 100.0 * bound / seconds if seconds > 0 else None
