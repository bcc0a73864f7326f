"""Model entry (`models/model.py` `forward` / `decode_step`): device
operations a step in the traced steps (kernels, copies and sets), from
the device trace."""


def read(ctx):
    if ctx.get("kind") != "lm" or not ctx.get("steps_traced"):
        return None
    return ctx["trace"]["launches"] / ctx["steps_traced"]
