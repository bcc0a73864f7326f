"""The whole model step (`models/model.py`): the window's model FLOPs (2
x the parameters each token multiplies by, plus attention's 4 Hd a live
causal pair and q head) over the window's seconds and the card's bf16
peak, in %."""
from portbench import work


def read(ctx):
    if ctx.get("kind") != "lm" or ctx["window_s"] <= 0:
        return None
    return 100.0 * ctx["model_flops"] / ctx["window_s"] / work.PEAK_BF16_FLOPS
