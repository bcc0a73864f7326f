"""LP solver (`core/lp.py`): `reduced_pivot` launches a period over the
window, from the kernel wrapper's launch counter."""


def read(ctx):
    if ctx.get("kind") != "fleet" or not ctx["periods"]:
        return None
    return ctx["pivots"] / ctx["periods"]
