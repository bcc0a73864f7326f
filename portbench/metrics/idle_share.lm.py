"""The card under the model: the share of the traced window in which no
device operation ran, in %."""


def read(ctx):
    if ctx.get("kind") != "lm" or ctx["trace"]["window_s"] <= 0:
        return None
    t = ctx["trace"]
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
