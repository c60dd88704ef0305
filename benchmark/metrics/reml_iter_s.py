"""reml_iter_s: seconds of one REML iteration, the program's
`reml.iterate` spans (`gmat_tpu_torch.core.spans`) over the window: their
seconds over their `iterations` (layer reml.wemai)."""
from benchmark.metrics._spans import window_spans


def read(ctx):
    found = window_spans(ctx, ("reml.iterate",))
    iters = sum(s.counts.get("iterations", 0) for s in found or ())
    if not iters:
        return None
    return sum(s.seconds for s in found) / iters
