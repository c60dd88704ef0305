"""What the readers of the program's spans (`gmat_tpu_torch.core.spans`)
share: the spans in the window, their union, and the text-file leaves
that `host_io_s` and `idle_host_io.trait` measure.  Not a metric."""

#: the spans that parse, read or write a text file: the yardstick of
#: `host_io_s` and `idle_host_io.trait`
HOST_IO = ("reml.parse", "reml.write", "design.parse", "draw.write",
           "pairs.read", "pairs.write", "calibrate.read", "screen.write",
           "screen.append", "approx.merge", "exact.write")


def window_spans(ctx, names=None):
    """The program's spans whose start lies in the window, those named in
    `names` where given; None where the program kept no span there (or
    has no `core.spans`)."""
    try:
        from gmat_tpu_torch.core import spans
    except ImportError:
        return None
    lo, hi = ctx.window
    found = [s for s in spans.spans() if lo <= s.start / 1e9 <= hi]
    if not found:
        return None
    return [s for s in found if names is None or s.name in names]


def union(intervals):
    """The (start, end) intervals merged into disjoint ones, in order."""
    out = []
    for start, end in sorted(intervals):
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], end)
        else:
            out.append([start, end])
    return out


def union_seconds(found):
    """Seconds of the union of the spans `found`."""
    return sum(e - s for s, e in union((r.start, r.end) for r in found)) / 1e9
