"""exhaustive_s: the harness's span around the exhaustive scan of a trait
(`remma_epiAA`), mean per trait (layer scan.pairs, `_scan_anchors`)."""
from benchmark.harness import mean


def read(ctx):
    return mean(u.seconds("exhaustive") for u in ctx.done
                if "exhaustive" in u.spans and u.part is None)
