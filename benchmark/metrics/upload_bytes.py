"""upload_bytes: bytes a trait sends from host arrays to the device, the
`h2d_bytes` that the program's spans count (`gmat_tpu_torch.core.spans`:
`DesignMatrices.zgzt`'s GRMs, a genotype panel's cache miss) over the
window, over the traits completed (layer io.pheno)."""
from benchmark.metrics._spans import window_spans


def read(ctx):
    found = window_spans(ctx)
    if found is None or not ctx.done:
        return None
    return sum(s.counts.get("h2d_bytes", 0) for s in found) / len(ctx.done)
