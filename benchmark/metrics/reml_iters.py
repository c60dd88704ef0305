"""reml_iters: REML's iterations a trait, the `iterations` counted by the
program's `reml.iterate` spans (`gmat_tpu_torch.core.spans`) over the
window, over the traits completed (layer reml.wemai)."""
from benchmark.metrics._spans import window_spans


def read(ctx):
    found = window_spans(ctx, ("reml.iterate",))
    if not found or not ctx.done:
        return None
    return sum(s.counts.get("iterations", 0) for s in found) / len(ctx.done)
