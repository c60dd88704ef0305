"""reml_s: the harness's span around `wemai_multi_gmat`, mean per trait
over the window (layer reml.wemai)."""
from benchmark.harness import mean


def read(ctx):
    return mean(u.seconds("reml") for u in ctx.done if "reml" in u.spans)
