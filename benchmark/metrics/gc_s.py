"""gc_s: the host seconds of a trait inside Python's garbage collector:
the union of the program's `gc` spans (`gmat_tpu_torch.core.spans`, one
per collection) over the window, over the traits completed (layer
python.gc)."""
from benchmark.metrics._spans import union_seconds, window_spans


def read(ctx):
    found = window_spans(ctx, ("gc",))
    if found is None or not ctx.done:
        return None
    return union_seconds(found) / len(ctx.done)
