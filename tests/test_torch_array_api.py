"""The array-level API of gmat_tpu_torch (scan/array_api.py, the `_remma_*`
and `_wemai_multi_gmat` twins that take (y, xmat, zmat)) and the legacy
`remma_*_cpu` engine it sits on (scan/legacy.py), against the JAX package.

Both packages get the same numpy arrays: the mouse fixture's design
(y, X and the dense 0/1 Z), the JAX additive GRM and the golden variances.
- exact scans (K2) and pair/select tests (the float64 pair test): the same
  rows, values at tests/test_torch_exact.py's tolerances;
- screens (K1): row sets that differ only inside ±1e-4 of the cut, as in
  tests/test_torch_screen.py, eff at rtol 1e-4 (printed with `%g`); a
  keep-all screen's eff held to the float64 oracle with the float32 dot
  product's error bound as floor;
- the single-SNP tests at rtol 1e-8, the REML at rtol 1e-6.

On the CPU the kernel wrappers run their plain versions.  The JAX package
and the conftest fixtures are reached only inside the tests that use them,
so that the `cuda` case also runs on a machine without JAX:
    python -m pytest --noconftest -m cuda tests/test_torch_array_api.py
"""
import filecmp
import shutil
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import gmat_tpu_torch
from gmat_tpu_torch.scan import array_api as TA
from gmat_tpu_torch.scan import legacy as TL

DATA = Path(__file__).resolve().parent / "data"
GOLDEN = Path(__file__).resolve().parent / "golden"
BAND = 1e-4
KINDS = ["AA", "AD", "DD"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread per pytest-xdist worker."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def setup(mouse_geno, mouse_pheno, mouse_prefix):
    """`tests/test_api_compat.py::legacy_setup`: the design arrays, the GRMs
    and the variances, plus the codings and pymat for the screen oracle."""
    import jax.numpy as jnp

    from gmat_tpu.core.coding import additive_code, dominance_code
    from gmat_tpu.grm.grm import additive_grm
    from gmat_tpu.io.pheno import design_matrix
    from gmat_tpu.scan.common import score_pieces

    g = jnp.asarray(mouse_geno)
    ag = np.asarray(additive_grm(g))
    var = np.array([0.06289206, 0.07641075, 0.08121168])
    dm = design_matrix(mouse_pheno, mouse_prefix)
    args = (dm.y, dm.xmat, dm.z_dense(), [ag, ag * ag], var, mouse_prefix)
    codes = {"A": np.asarray(additive_code(g)[0]),
             "D": np.asarray(dominance_code(g)[0])}
    py = np.asarray(score_pieces(dm, [ag, ag * ag], var).pymat)
    return {"args": args, "dm": dm, "codes": codes, "py": py}


def _rows(path):
    return np.loadtxt(path, skiprows=1, ndmin=2)


def _same_header(a, b):
    with open(a) as fa, open(b) as fb:
        return fa.readline() == fb.readline()


def _exact_close(got, want):
    """tests/test_torch_exact.py's tolerances for `snp_0 snp_1 eff chi p`."""
    assert got.shape == want.shape
    np.testing.assert_array_equal(got[:, :2], want[:, :2])
    np.testing.assert_allclose(got[:, 2], want[:, 2], rtol=1e-7, atol=1e-12)
    np.testing.assert_allclose(got[:, 3], want[:, 3], rtol=1e-6, atol=1e-10)
    np.testing.assert_allclose(got[:, 4], want[:, 4], rtol=1e-5, atol=1e-12)


def _run_both(tmp_path, name, jax_mod, *args, **kw):
    """The JAX function `name` of `jax_mod` and the port's twin on the same
    arguments; returns the two output paths (with `suffix`)."""
    import importlib

    suffix = kw.pop("suffix", "")
    port = TA if jax_mod.endswith("array_api") else TL
    out_t, out_j = str(tmp_path / f"t_{name}"), str(tmp_path / f"j_{name}")
    getattr(importlib.import_module(jax_mod), name)(*args, out_file=out_j,
                                                    **kw)
    getattr(port, name)(*args, out_file=out_t, device="cpu", **kw)
    return out_t + suffix, out_j + suffix


# design input ---------------------------------------------------------------

def test_as_dm_dense_sparse_and_design(setup):
    from scipy import sparse

    dm_j = setup["dm"]
    z = dm_j.z_dense()
    dense = TL._as_dm(dm_j.y[:, None], dm_j.xmat, z)
    np.testing.assert_array_equal(dense.rec_ids, dm_j.rec_ids)
    assert dense.n_col == dm_j.n_col and dense.y.shape == dm_j.y.shape
    np.testing.assert_array_equal(dense.xmat, dm_j.xmat)
    for fmt in ("csr", "coo", "csc"):
        sp = TL._as_dm(dm_j.y, dm_j.xmat, sparse.csr_matrix(z).asformat(fmt))
        np.testing.assert_array_equal(sp.rec_ids, dm_j.rec_ids)
        assert sp.n_col == dm_j.n_col
    assert TL._as_dm(None, None, dense) is dense
    bad = z.copy()
    bad[0, :2] = 1.0  # two 1s in a row
    half = z * 0.5
    for zb in (bad, half, z[:, :, None], sparse.csr_matrix(bad),
               sparse.csr_matrix(half), z[:-1]):
        with pytest.raises(ValueError, match="incidence"):
            TL._as_dm(dm_j.y, dm_j.xmat, zb)


def test_exports_equal_jax():
    """The public names of both packages are the same set."""
    import gmat_tpu

    def public(mod):
        return {n for n in dir(mod) if not n.startswith("__")
                and not isinstance(getattr(mod, n), types.ModuleType)}

    assert public(gmat_tpu) == public(gmat_tpu_torch)
    for n in public(gmat_tpu_torch):
        assert callable(getattr(gmat_tpu_torch, n)), n


def test_wemai_multi_gmat_matches_jax(setup):
    from gmat_tpu.scan.array_api import _wemai_multi_gmat

    y, x, z, gmat_lst, _, _ = setup["args"]
    want = _wemai_multi_gmat(y, x, z, gmat_lst)
    got = TA._wemai_multi_gmat(y, x, z, gmat_lst, device="cpu")
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-6)


@pytest.mark.parametrize("kind", ["add", "dom"])
def test_single_snp_matches_jax(tmp_path, setup, kind):
    """`_remma_add/_dom` and `remma_add/dom_cpu`: same SNP table."""
    for name, mod in ((f"_remma_{kind}", "gmat_tpu.scan.array_api"),
                      (f"remma_{kind}_cpu", "gmat_tpu.scan.legacy")):
        out_t, out_j = _run_both(tmp_path, name, mod, *setup["args"])
        got, want = (np.loadtxt(p, skiprows=1, usecols=(5, 6, 7, 8))
                     for p in (out_t, out_j))
        assert _same_header(out_t, out_j)
        np.testing.assert_allclose(got, want, rtol=1e-8, atol=1e-300)


# exact scans (K2) -------------------------------------------------------------

@pytest.mark.parametrize("kind", KINDS)
def test_exact_scans_match_jax(tmp_path, setup, kind):
    """`_remma_epi*` and `remma_epi*_cpu` on an anchor subset, and the
    `_parallel` part [100, 1] (AA also `remma_epiAA_cpu_parallel`)."""
    args = setup["args"]
    cases = [(f"_remma_epi{kind}", "gmat_tpu.scan.array_api",
              {"snp_lst_0": [0, 17, 39, 700], "p_cut": 1.1}, ""),
             (f"remma_epi{kind}_cpu", "gmat_tpu.scan.legacy",
              {"snp_lst_0": [3, 1300], "p_cut": 0.5}, ""),
             (f"_remma_epi{kind}_parallel", "gmat_tpu.scan.array_api",
              {"parallel": [100, 1], "p_cut": 0.05}, ".1")]
    if kind == "AA":
        cases.append(("remma_epiAA_cpu_parallel", "gmat_tpu.scan.legacy",
                      {"parallel": [100, 2], "p_cut": 0.05}, ".2"))
    for name, mod, kw, suffix in cases:
        out_t, out_j = _run_both(tmp_path, name, mod, *args, suffix=suffix,
                                 **kw)
        assert _same_header(out_t, out_j), name
        got, want = _rows(out_t), _rows(out_j)
        assert len(got) > 20, name
        _exact_close(got, want)


def test_dd_degenerate_pair_is_centred(tmp_path, setup, mouse_pheno,
                                       mouse_prefix):
    """The mouse DD pair (165, 201) has a nearly constant product column;
    the array path centres it like the file-level scan (byte-equal files)
    and stays inside the full-table floor of the reference."""
    from gmat_tpu_torch.scan.pairs import remma_epiDD

    args = setup["args"]
    arr, fil = str(tmp_path / "arr"), str(tmp_path / "file")
    TA._remma_epiDD(*args, snp_lst_0=[165], p_cut=1.1, out_file=arr,
                    device="cpu")
    remma_epiDD(mouse_pheno, mouse_prefix, args[3], args[4], snp_lst_0=[165],
                p_cut=1.1, out_file=fil, device="cpu")
    assert filecmp.cmp(arr, fil, shallow=False)
    rows = _rows(arr)
    row = rows[rows[:, 1] == 201][0]
    m = 1407
    gold = np.load(GOLDEN / "epi_full.npz")
    k = sum(m - 1 - i for i in range(165)) + (201 - 165 - 1)
    np.testing.assert_allclose(row[2], gold["dd_eff"][k], rtol=2e-6,
                               atol=1e-12)
    np.testing.assert_allclose(row[3], gold["dd_chi"][k], rtol=4e-6,
                               atol=5e-5)
    np.testing.assert_allclose(row[4], gold["dd_p"][k], atol=5e-5)


# pair lists and the rectangular select (the float64 pair test) ---------------

@pytest.mark.parametrize("kind", KINDS)
def test_pair_and_select_match_jax(tmp_path, setup, kind):
    args = setup["args"]
    gold = np.load(GOLDEN / "epiAA_pairs.npz")
    pair_file = str(tmp_path / "pairs")
    np.savetxt(pair_file, gold["pairs"][:300], fmt="%d",
               header="snp_0 snp_1", comments="")
    for name, mod, kw in (
            (f"_remma_epi{kind}_pair", "gmat_tpu.scan.array_api",
             {"snp_pair_file": pair_file, "p_cut": 1.1,
              "max_test_pair": 128}),
            (f"remma_epi{kind}_pair_cpu", "gmat_tpu.scan.legacy",
             {"snp_pair_file": pair_file, "p_cut": 0.5}),
            (f"remma_epi{kind}_select_cpu", "gmat_tpu.scan.legacy",
             {"snp_lst_0": [0, 1, 17], "snp_lst_1": [5, 6, 7, 17, 300]})):
        out_t, out_j = _run_both(tmp_path, name, mod, *args, **kw)
        assert _same_header(out_t, out_j), name
        got, want = _rows(out_t), _rows(out_j)
        assert got.shape == want.shape and len(got) >= 14, name
        np.testing.assert_array_equal(got[:, :2], want[:, :2])
        np.testing.assert_allclose(got[:, 2:], want[:, 2:], rtol=1e-6,
                                   atol=1e-12)


# screens (K1) -------------------------------------------------------------------

def _codes(kind, setup):
    """The codings of a written row's first and second SNP.  AD's flipped
    sweep writes the (D_i, A_j) product as row (j, i), so row (r0, r1) is
    A_r0·py·D_r1 in both sweeps."""
    codes = setup["codes"]
    return (codes["D" if kind == "DD" else "A"],
            codes["A" if kind == "AA" else "D"])


def _keys(rows):
    return [(int(a), int(b)) for a, b in rows[:, :2]]


def _assert_screen(got, want, eff64, cut):
    """Row sets equal outside ±BAND of the cut; eff of the common rows at
    rtol 1e-4."""
    gk, wk = _keys(got), _keys(want)
    for keys in (gk, wk):
        for k in keys:
            assert abs(eff64(k)) > cut * (1 - BAND), k
    for k in set(gk) ^ set(wk):
        assert abs(abs(eff64(k)) - cut) <= BAND * cut, k
    common = sorted(set(gk) & set(wk))
    gi = dict(zip(gk, got[:, 2]))
    wi = dict(zip(wk, want[:, 2]))
    np.testing.assert_allclose([gi[k] for k in common],
                               [wi[k] for k in common], rtol=1e-4)
    return common


@pytest.mark.parametrize("kind", KINDS)
def test_screens_match_jax(tmp_path, setup, kind):
    """`_remma_epi*_eff`, its `_parallel` part and `_maf_eff` over all
    anchors, `remma_epi*_eff_cpu` (and the `_cpu_c` alias) on an anchor
    subset, at a cut that ≈ 2e-4 of all pairs pass."""
    from scipy.stats import chi2

    from gmat_tpu.scan import screen as JS

    args = setup["args"]
    a, b = _codes(kind, setup)
    s64 = (a * setup["py"][:, None]).T @ b
    m = s64.shape[0]
    off = ~np.eye(m, dtype=bool) if kind == "AD" else np.triu(
        np.ones((m, m), dtype=bool), 1)
    cut = float(np.quantile(np.abs(s64[off]), 1 - 2e-4))
    chi_cut = chi2.isf(1e-5, 1)
    var_app = cut * cut / chi_cut

    def eff64(key):
        return s64[key]

    geno = np.asarray(gmat_tpu_torch.read_plink(args[5]))
    bins_a = (JS._het_bins if kind == "DD" else JS._maf_bins)(geno)[1]
    bins_b = JS._het_bins(geno)[1] if kind == "AD" else bins_a
    maf_kw = ({"freqA": bins_a, "freqD": bins_b} if kind == "AD"
              else {"freq": bins_a})
    deno = np.full(111, var_app)  # a flat table through the binned path
    cases = [
        (f"_remma_epi{kind}_eff", {"var_app": var_app}, ""),
        (f"_remma_epi{kind}_eff_parallel",
         {"parallel": [3, 2], "var_app": var_app}, ".2"),
        (f"_remma_epi{kind}_maf_eff", dict(maf_kw, freq_deno=deno), ""),
    ]
    for name, kw, suffix in cases:
        out_t, out_j = _run_both(tmp_path, name, "gmat_tpu.scan.array_api",
                                 *args, suffix=suffix, **kw)
        assert _same_header(out_t, out_j), name
        common = _assert_screen(_rows(out_t), _rows(out_j), eff64, cut)
        assert len(common) > (10 if suffix else 50), name
    anchors = list(range(0, m - 1, 7))
    out_t, out_j = _run_both(tmp_path, f"remma_epi{kind}_eff_cpu",
                             "gmat_tpu.scan.legacy", *args,
                             snp_lst_0=anchors, eff_cut=cut)
    with open(out_t) as f:
        assert f.readline() == "snp_0 snp_1 eff\n"
    common = _assert_screen(_rows(out_t), _rows(out_j), eff64, cut)
    assert len(common) > 5
    assert getattr(TL, f"remma_epi{kind}_eff_cpu_c") is getattr(
        TL, f"remma_epi{kind}_eff_cpu")


def _keep_all_check(rows, kind, setup, anchors):
    """Every pair of the anchors (both orientations for AD) is a row, and
    each eff lies within rtol 1e-4 of the float64 oracle, with the float32
    dot product's bound n·2^-24·Σ|a·py·b| as floor."""
    a, b = _codes(kind, setup)
    py = setup["py"]
    m = a.shape[1]
    want = {(i, j) for i in anchors for j in range(i + 1, m)}
    if kind == "AD":
        want |= {(j, i) for i in anchors for j in range(i + 1, m)}
    keys = _keys(rows)
    assert len(keys) == len(set(keys)) and set(keys) == want
    r0, r1 = rows[:, 0].astype(int), rows[:, 1].astype(int)
    e64 = np.einsum("nk,n,nk->k", a[:, r0], py, b[:, r1])
    floor = a.shape[0] * 2.0 ** -24 * np.einsum(
        "nk,n,nk->k", np.abs(a[:, r0]), np.abs(py), np.abs(b[:, r1]))
    assert np.all(np.abs(rows[:, 2] - e64) <= 1e-4 * np.abs(e64) + floor)


def test_keep_all_AD_eff_cpu(tmp_path, setup):
    """The reference's default eff_cut=-999 keeps every pair: on 4 anchors,
    both orientations, the same rows as JAX and effects inside the f64
    bracket."""
    anchors = [0, 5, 700, 1405]
    out_t, out_j = _run_both(tmp_path, "remma_epiAD_eff_cpu",
                             "gmat_tpu.scan.legacy", *setup["args"],
                             snp_lst_0=anchors)
    got, want = _rows(out_t), _rows(out_j)
    _keep_all_check(got, "AD", setup, anchors)
    assert set(_keys(got)) == set(_keys(want))


def test_eff_cpu_c_parallel_matches_jax(tmp_path, setup):
    out_t, out_j = _run_both(tmp_path, "remma_epiAA_eff_cpu_c_parallel",
                             "gmat_tpu.scan.legacy", *setup["args"],
                             parallel=[200, 3], suffix=".3")
    got, want = _rows(out_t), _rows(out_j)
    anchors = sorted({int(i) for i in want[:, 0]})
    _keep_all_check(got, "AA", setup, anchors)
    assert set(_keys(got)) == set(_keys(want))


def test_new_modules_import_no_jax():
    import subprocess
    import sys

    code = ("import sys, gmat_tpu_torch.scan.array_api, "
            "gmat_tpu_torch.scan.legacy; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'gmat_tpu.')) or m == 'gmat_tpu']; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code],
                   cwd=Path(__file__).resolve().parents[1], check=True,
                   timeout=120)


# the card ---------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_parallel_part_on_the_card(cuda, tmp_path):
    """`_remma_epiAA_parallel([100, 1])` on the card launches the exact-scan
    kernel and writes the CPU run's rows."""
    from gmat_tpu_torch.grm.grm import additive_grm
    from gmat_tpu_torch.io.pheno import design_matrix
    from gmat_tpu_torch.scan import kernels as K

    prefix = str(tmp_path / "plink")
    for ext in (".bed", ".bim", ".fam"):
        shutil.copy(str(DATA / ("plink" + ext)), prefix + ext)
    geno = torch.as_tensor(gmat_tpu_torch.read_plink(prefix), device=cuda)
    ag = additive_grm(geno).cpu().numpy()
    dm = design_matrix(str(DATA / "pheno"), prefix)
    var = np.load(GOLDEN / "epi_scans.npz")["var_com"]
    args = (dm.y, dm.xmat, dm.z_dense(), [ag, ag * ag], var, prefix)
    out = {}
    for dev in ("cpu", cuda):
        before = K.LAUNCHES["exact_scan"]
        TA._remma_epiAA_parallel(*args, parallel=[100, 1], p_cut=0.05,
                                 out_file=str(tmp_path / str(dev)),
                                 device=dev)
        out[str(dev)] = (_rows(str(tmp_path / f"{dev}.1")),
                         K.LAUNCHES["exact_scan"] - before)
    (got, launched), (want, plain) = out[str(cuda)], out["cpu"]
    assert launched > 0 and plain == 0
    assert len(got) > 20
    np.testing.assert_array_equal(got[:, :2], want[:, :2])
    np.testing.assert_allclose(got[:, 2:], want[:, 2:], rtol=1e-9,
                               atol=1e-300)
