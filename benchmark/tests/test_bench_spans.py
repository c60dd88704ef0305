"""The readers of the program's spans (`gmat_tpu_torch.core.spans`) on
small traced CPU runs of the trait cells: each reads a number, and
none where the program keeps no span."""
import pytest

from benchmark import harness
from benchmark.tests.conftest import small

SPAN_METRICS = ("reml_iters", "reml_iter_s", "upload_bytes", "host_io_s",
                "gc_s", "idle_host_io.trait")


@pytest.mark.parametrize("cell", ["yeast.approx_aa", "mouse.exact_aa",
                                  "yeast.approx_ad"])
def test_span_metrics_read_numbers_in_a_traced_run(bench, cell):
    config, traffic = small(cell, bench)
    res, _ = harness.run_cell(bench, cell, 2**33 + 41, 1.0, True,
                              device="cpu", config=config, traffic=traffic)
    assert res["correct"], res
    metrics = res["metrics"]
    for name in SPAN_METRICS:
        assert isinstance(metrics[name]["value"], float), name
    # REML iterates and both GRMs cross twice a trait (REML, the score
    # pieces): 2 x 2 x n² float64 bytes at the small configuration's n
    n = config["n_id"]
    assert metrics["reml_iters"]["value"] >= 1
    assert metrics["upload_bytes"]["value"] == 2 * 2 * n * n * 8
    assert 0 < metrics["idle_host_io.trait"]["value"] <= 100


def test_span_metrics_read_none_without_spans(bench):
    """An untraced run keeps no span: each reader returns None."""
    import types

    ctx = types.SimpleNamespace(window=(0.0, 1e-9), done=[object()],
                                trace=None)
    for name in SPAN_METRICS:
        assert harness.load_reader(name)(ctx) is None, name
