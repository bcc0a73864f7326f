"""Engine entry (`api/engine.py` `step`): device operations a period in
the traced periods (kernels, copies and sets), from the device trace."""


def read(ctx):
    if ctx.get("kind") != "fleet" or not ctx.get("periods_traced"):
        return None
    return ctx["trace"]["launches"] / ctx["periods_traced"]
