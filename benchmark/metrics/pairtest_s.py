"""pairtest_s: the approx pipeline's exact pair tests, its
`LAST_APPROX_STAGES` calibrate + retest, mean per trait (layer
scan.pairs)."""
from benchmark.harness import mean


def read(ctx):
    return mean(u.stages["calibrate"] + u.stages["retest"]
                for u in ctx.done if "calibrate" in u.stages)
