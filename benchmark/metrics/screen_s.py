"""screen_s: the approx pipeline's `LAST_APPROX_STAGES` screen, mean per
trait (layer scan.screen)."""
from benchmark.harness import mean


def read(ctx):
    return mean(u.stages["screen"] for u in ctx.done if "screen" in u.stages)
