"""k1_roofline: the least time of every screen in the traced window (2n
FLOP per pair over all pairs of the mix's kind, m(m-1)/2 for AA and DD,
m(m-1) for AD, at 495/3 TFLOP/s, `roofline.py`) over the device time of
the screen kernels (`screen_count*`, `screen_extract*`), in percent."""
from benchmark.roofline import k1_least_seconds

KERNELS = ("screen_count", "screen_extract")


def read(ctx):
    tr = ctx.trace
    screens = [u for u in ctx.done if "screen" in u.stages]
    if tr is None or not screens or tr.seconds(*KERNELS) <= 0:
        return None
    least = len(screens) * k1_least_seconds(ctx.n_id, ctx.n_snp, ctx.kind)
    return 100.0 * least / tr.seconds(*KERNELS)
