"""idle_host_io.trait: percent of the traced window in which the device
is idle (the trace's gaps) while the host is inside one of the program's
text-file spans (`_spans.HOST_IO`, `host_io_s`'s), their host clock put
on the trace's by `ctx.ns` (layer host.io)."""
from benchmark.metrics._spans import HOST_IO, union, window_spans


def read(ctx):
    tr = ctx.trace
    found = window_spans(ctx, HOST_IO)
    if tr is None or found is None or tr.window_s <= 0:
        return None
    host = union((ctx.ns(r.start / 1e9), ctx.ns(r.end / 1e9)) for r in found)
    gaps, both, g, h = tr.gaps, 0, 0, 0
    while g < len(gaps) and h < len(host):  # both sorted and disjoint
        lo, hi = max(gaps[g][0], host[h][0]), min(gaps[g][1], host[h][1])
        both += max(hi - lo, 0)
        if gaps[g][1] < host[h][1]:
            g += 1
        else:
            h += 1
    return 100.0 * both / (tr.window_ns[1] - tr.window_ns[0])
