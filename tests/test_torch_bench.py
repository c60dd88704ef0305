"""The port's headline benchmark (gmat_tpu_torch/bench.py) on the CPU at
small shapes: its host inputs byte-equal to the root bench.py's, the
production-screen section against the JAX package's on the same inputs
(hit counts equal but for the pairs whose float64 |eff| lies within
±1e-4·cut of the cut), the GEMM ceiling's no-hit sweep, the exact-scan
section against a plain float64 count, and `main` printing one JSON line
of bench.py's shape.  tests/test_torch_cli.py checks that the module
imports no JAX.
"""
import importlib.util
import json
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch

from gmat_tpu_torch import bench

ROOT = Path(__file__).resolve().parents[1]
ML = ROOT / "tests" / "data" / "mouse_long"
BAND = 1e-4  # hit counts may differ only within cut·(1 ± BAND)
N_SUB, M_SUB = 150, 8  # ids and SNPs of the mouse_long subset

EXTRA_KEYS = {
    "screen_hits", "screen_gemm_ceiling_pairs_per_s",
    "yeast_screen_pairs_per_s", "yeast_screen_hits",
    "exact_scan_pairs_per_s", "exact_scan_tflops", "reml_mixed_iter_s",
    "reml_cpu_f64_iter_s", "reml_mixed_speedup", "bigpanel_pairs_per_s",
    "bigpanel_hits", "bigpanel_peak_hbm_gib", "longwas_fixed_snps_per_s",
    "longwas_trans_snps_per_s", "yeast_approx_end_to_end_s",
    "yeast_approx_rows", "yeast_approx_stages", "yeast_approx_warm_s",
}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread per pytest-xdist worker."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def root_bench():
    """The root bench.py (the JAX package's benchmark) as a module."""
    spec = importlib.util.spec_from_file_location("root_bench",
                                                  ROOT / "bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def f64_bracket(mat, py, cut):
    """(core, hull): pairs j > i whose float64 |eff| exceeds cut·(1 + BAND)
    and cut·(1 − BAND)."""
    m = mat.shape[1]
    eff = np.abs((mat.astype(np.float64) * py.astype(np.float64)[:, None]).T
                 @ mat.astype(np.float64))[np.triu_indices(m, 1)]
    return tuple(int((eff > cut * f).sum()) for f in (1 + BAND, 1 - BAND))


def test_panel_and_cut_equal_root_bench(root_bench):
    for seed in (0, 7):
        mat = bench._panel(np.random.default_rng(seed), 50, 300)
        want = root_bench._panel(np.random.default_rng(seed), 50, 300)
        assert mat.dtype == want.dtype and mat.tobytes() == want.tobytes()
        py = (np.random.default_rng(seed + 1).standard_normal(50) * 0.1
              ).astype(np.float32)
        for frac in (2e-7, 2e-5, 1e-3):
            assert bench._screen_cut(mat, py, frac) == \
                root_bench._screen_cut(want, py, frac)


def test_production_screen_matches_jax(root_bench, monkeypatch):
    """Hit counts of the port's and the JAX package's section on one panel,
    both inside the float64 bracket and apart by at most its width."""
    import jax.numpy as jnp

    n, m, frac = 64, 1024, 1e-3
    rng = np.random.default_rng(0)
    mat = bench._panel(rng, n, m)
    py = (rng.standard_normal(n) * 0.1).astype(np.float32)
    monkeypatch.setattr(root_bench, "REPS", 1)
    _, want = root_bench.bench_production_screen(
        jnp, jnp.asarray(mat), jnp.asarray(py), m, 128, hit_frac=frac)
    rate, got, (i, j, eff, cut) = bench.bench_production_screen(
        torch.as_tensor(mat), torch.as_tensor(py), hit_frac=frac, reps=1)
    assert cut == root_bench._screen_cut(mat, py, frac) and rate > 0
    core, hull = f64_bracket(mat, py, cut)
    assert core <= got <= hull and core <= want <= hull
    assert abs(got - want) <= hull - core
    assert len(i) == got and np.all(j > i)
    ref = (mat[:, i].astype(np.float64) * py[:, None]
           * mat[:, j].astype(np.float64)).sum(0)
    np.testing.assert_allclose(eff, ref, rtol=0, atol=BAND * cut)


def test_gemm_ceiling_counts_no_hits():
    n, m, tile = 64, 1000, 256
    rng = np.random.default_rng(3)
    mat = bench._panel(rng, n, m)
    py = (rng.standard_normal(n) * 0.1).astype(np.float32)
    mat_t, py_t = torch.as_tensor(mat), torch.as_tensor(py)
    assert bench.ceiling_count(mat_t, py_t, 1.0e9, tile) == 0
    cut = bench._screen_cut(mat, py, 1e-3)
    core, hull = f64_bracket(mat, py, cut)
    assert core <= bench.ceiling_count(mat_t, py_t, cut, tile) <= hull
    assert core > 0
    assert bench.bench_gemm_ceiling(mat_t, py_t, tile, reps=1) > 0


def test_exact_scan_hits_equal_plain_f64_count():
    n, m, seed = 64, 150, 5
    _, tflops, hits = bench.bench_exact_scan(
        np.random.default_rng(seed), torch.device("cpu"), n, m, reps=1)
    mat, py, pvp = (t.numpy() for t in bench.exact_inputs(
        np.random.default_rng(seed), n, m, "cpu"))
    i, j = np.triu_indices(m, 1)
    e = mat[:, i] * mat[:, j]
    chi = (e.T @ py) ** 2 / np.einsum("kp,kp->p", e, pvp @ e)
    assert hits == int((chi > 50.0).sum()) and tflops > 0


@pytest.fixture(scope="module")
def long_subset(tmp_path_factory):
    """The first N_SUB ids and M_SUB SNPs of mouse_long as a PLINK set
    with its balanced phenotypes."""
    from gmat_tpu_torch.io.bed import Bed, write_bed

    tmp = tmp_path_factory.mktemp("tbench_long")
    geno = Bed(str(ML / "plink")).read()
    read = dict(sep=r"\s+", header=None, dtype=str)
    fam = pd.read_csv(ML / "plink.fam", **read)[:N_SUB]
    bim = pd.read_csv(ML / "plink.bim", **read)[:M_SUB]
    write_bed(str(tmp / "plink"), geno[:N_SUB, :M_SUB], bim, fam)
    phe = pd.read_csv(ML / "phe.balance.txt", sep=r"\s+", header=0,
                      dtype={"ID": str})
    phe[phe["ID"].isin(set(fam[1]))].to_csv(tmp / "phe.balance.txt", sep=" ",
                                            index=False)
    return tmp


def test_main_prints_one_json_line(monkeypatch, capsys, long_subset):
    """`main(device="cpu")` at small shapes: one JSON line whose keys are
    bench.py's, every value set but the device memory peak, which a CPU
    run does not measure; every section recorded in LAST_RUN."""
    for name, value in (("N_ID", 64), ("N_SNP", 1024), ("TILE", 256),
                        ("REPS", 1), ("REML_REPS", 1), ("YEAST", (96, 700)),
                        ("EXACT", (64, 150)), ("REML", (80, 120, 64)),
                        ("BIGPANEL_LOG2", 10), ("LONGWAS_DATA", long_subset),
                        ("APPROX_PAIRS", 6000)):
        monkeypatch.setattr(bench, name, value)
    bench.main(device="cpu")
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert set(line) == {"metric", "value", "unit", "vs_baseline", "extra"}
    assert line["metric"] == "epiAA_production_screen_pairs_per_s"
    assert line["unit"] == "pairs/s" and line["value"] > 0
    base = json.loads((ROOT / "bench_baseline.json").read_text())
    assert line["vs_baseline"] == pytest.approx(
        line["value"] / base["reference_epiAA_screen_pairs_per_s"], abs=0.01)
    extra = line["extra"]
    assert set(extra) == EXTRA_KEYS
    assert extra.pop("bigpanel_peak_hbm_gib") is None
    assert all(v is not None for v in extra.values())
    assert extra["screen_hits"] == len(bench.LAST_RUN["production"]["i"])
    assert extra["bigpanel_hits"] == len(bench.LAST_RUN["bigpanel"]["i"])
    assert set(extra["yeast_approx_stages"]) == {
        "prep", "draw", "calibrate", "screen", "retest", "merge", "total"}
    assert list(bench.LAST_RUN["sections"]) == [
        "production_screen", "gemm_ceiling", "yeast_screen", "exact_scan",
        "reml_mixed", "bigpanel", "longwas", "yeast_approx"]
    # a CPU run launches no kernel
    assert not any(any(s["launches"].values())
                   for s in bench.LAST_RUN["sections"].values())

