"""host_io_s: the host seconds of a trait inside the program's text-file
leaves (`gmat_tpu_torch.core.spans`, `_spans.HOST_IO`): the union of those
spans over the window, over the traits completed (layer host.io)."""
from benchmark.metrics._spans import HOST_IO, union_seconds, window_spans


def read(ctx):
    found = window_spans(ctx, HOST_IO)
    if found is None or not ctx.done:
        return None
    return union_seconds(found) / len(ctx.done)
