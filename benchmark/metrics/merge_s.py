"""merge_s: the approx pipeline's `LAST_APPROX_STAGES` merge (host files),
mean per trait (layer scan.screen)."""
from benchmark.harness import mean


def read(ctx):
    return mean(u.stages["merge"] for u in ctx.done if "merge" in u.stages)
