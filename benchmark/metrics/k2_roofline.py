"""k2_roofline: the least time of the exact scans in the traced window
((n² + 7n) FP64 FLOP per pair tested at 67 TFLOP/s, `roofline.py`) over
the device time of the exact-scan kernel (`exact_scan`), in percent."""
from benchmark.roofline import k2_least_seconds

KERNELS = ("exact_scan",)


def read(ctx):
    tr = ctx.trace
    scans = [u for u in ctx.done if u.pairs]
    if tr is None or not scans or tr.seconds(*KERNELS) <= 0:
        return None
    least = sum(k2_least_seconds(ctx.n_id, ctx.n_snp, u.pairs) for u in scans)
    return 100.0 * least / tr.seconds(*KERNELS)
