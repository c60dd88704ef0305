"""The epistasis screen family of gmat_tpu_torch (scan/screen.py,
scan/accel.py, the general screen of scan/kernels.py) vs the JAX package.

Each case gives the same seeded numpy inputs to the JAX function (its XLA
engine on the CPU) and to the port with device="cpu", where the kernel
wrappers run their plain versions.  A hit set is held to the float64
oracle's bracket: every pair with |S| above cut·(1 + 1e-4) must be found,
every pair found must have |S| above cut·(1 - 1e-4), and the two packages
may differ only inside that band.  eff is held at rtol 1e-5 where both
packages hand over float32 values, and at rtol 1e-4 where they were printed
with `%g` (6 digits).
"""
import filecmp

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.stats import chi2

import gmat_tpu
import gmat_tpu_torch
from gmat_tpu.core.coding import additive_code, dominance_code
from gmat_tpu.grm.grm import additive_grm
from gmat_tpu.io.pheno import design_matrix as j_design_matrix
from gmat_tpu.scan import screen as JS
from gmat_tpu.scan.common import score_pieces as j_score_pieces
from gmat_tpu_torch.scan import kernels as K
from gmat_tpu_torch.scan import screen as TS

from conftest import DATA, GOLDEN

BAND = 1e-4
SCREEN_NAMES = sorted(
    f"remma_epi{k}_{v}{p}" for k in ("AA", "AD", "DD")
    for v in ("eff", "approx", "maf_eff", "maf_approx")
    for p in ("", "_parallel"))


@pytest.fixture(scope="module")
def mouse(mouse_geno, mouse_pheno, mouse_prefix):
    """GRMs, variances, the codings and pymat of the mouse fixture."""
    ag = np.asarray(additive_grm(jnp.asarray(mouse_geno)))
    var_com = np.load(GOLDEN / "epi_scans.npz")["var_com"]
    pieces = j_score_pieces(j_design_matrix(mouse_pheno, mouse_prefix),
                            [ag, ag * ag], var_com)
    codes = {"A": np.asarray(additive_code(jnp.asarray(mouse_geno))[0]),
             "D": np.asarray(dominance_code(jnp.asarray(mouse_geno))[0])}
    return {"gmat": [ag, ag * ag], "var_com": var_com,
            "py": np.asarray(pieces.pymat), "codes": codes,
            "geno": mouse_geno}


def _rows(path):
    return np.loadtxt(path, skiprows=1, ndmin=2)


def _assert_bracket(got, want, eff64, cuts):
    """got and want are (i, j) key lists; eff64 and cuts map a key to the
    f64 effect and its cut.  Both sets lie inside the f64 bracket, so they
    differ only inside the band; returns the common keys."""
    for keys in (got, want):
        for k in keys:
            assert abs(eff64(k)) > cuts(k) * (1 - BAND), k
    for k in set(got) ^ set(want):
        assert abs(abs(eff64(k)) - cuts(k)) <= BAND * abs(cuts(k)), k
    return set(got) & set(want)


def _assert_same_order(got, want):
    """The keys the two lists share come in the same order in both."""
    common = set(got) & set(want)
    assert [k for k in got if k in common] == [k for k in want if k in common]


# the general screen against JAX `_run_screen` ------------------------------

def _panel(n, m, seed):
    rng = np.random.default_rng(seed)
    geno = rng.choice([0.0, 1.0, 2.0], size=(n, m))
    geno[:, 5] = 1.0  # one monomorphic SNP: its scores are exact zeros
    a = np.asarray(geno - geno.mean(0), dtype=np.float32)
    het = (geno == 1.0).astype(np.float64)
    d = np.asarray(het - het.mean(0), dtype=np.float32)
    py = (rng.standard_normal(n) * 0.1).astype(np.float32)
    return {"A": a, "D": d}, py, rng


def _case(name, codes, py, rng):
    """(a, b, anchors, bins_a, bins_b, table, flip) of one screen case."""
    m = codes["A"].shape[1]
    zeros = np.zeros(m, dtype=np.int64)
    a, b = {"AD": "AD", "DA_flipped": "DA", "DD": "DD"}.get(name, "AA")
    s = (codes[a].astype(np.float64) * py[:, None]).T @ codes[b]
    cut = float(np.quantile(np.abs(s[np.triu_indices(m, 1)]), 0.98))
    table = np.full(111, cut)
    sub = np.sort(rng.choice(m - 2, size=150, replace=False))
    anchors, bins_a, bins_b, flip = list(range(m - 1)), zeros, zeros, False
    if name == "AA_ascending":
        anchors = sub.tolist() + [m - 2]
    elif name == "AA_unsorted":
        anchors = rng.permutation(sub).tolist()
    elif name in ("AD", "DA_flipped"):
        anchors, flip = list(range(m)), name == "DA_flipped"
    elif name == "maf_table":
        bins_a = rng.integers(0, 11, size=m)
        bins_b = rng.integers(0, 11, size=m)
        bins_a[:3], bins_b[-3:] = 10, 10
        table = cut * (0.7 + 0.1 * (np.arange(111) % 7))
        anchors = rng.permutation(m - 1)[:200].tolist()
    elif name == "keep_all":
        table = np.full(111, -999.0)
        anchors = [0, 5, 130, m - 2, 64]
    elif name == "zero_hits":
        table = np.full(111, 1e9)
    return (codes[a], codes[b], anchors, bins_a, bins_b,
            np.asarray(table, dtype=np.float32), flip)


GENERAL_CASES = ["AA_ascending", "AA_unsorted", "AD", "DA_flipped", "DD",
                 "maf_table", "keep_all", "zero_hits"]


@pytest.mark.parametrize("name", GENERAL_CASES)
def test_general_screen_matches_jax(name):
    codes, py, rng = _panel(40, 300, 11)
    a, b, anchors, bins_a, bins_b, table, flip = _case(name, codes, py, rng)
    args = (anchors, bins_a, bins_b, table)
    want = JS._run_screen(jnp.asarray(a), jnp.asarray(b), jnp.asarray(py),
                          *args, "tri", 128, flip_output=flip)
    ta, tb = torch.as_tensor(a), torch.as_tensor(b)
    got = TS._run_screen(ta, tb if b is not a else ta, torch.as_tensor(py),
                         *args, flip_output=flip)
    s64 = (a.astype(np.float64) * py.astype(np.float64)[:, None]).T @ b
    row = (lambda k: (k[1], k[0])) if flip else (lambda k: k)  # (anchor, partner)
    gk = list(zip(got[0].tolist(), got[1].tolist()))
    wk = list(zip(want[0].tolist(), want[1].tolist()))
    assert all(row(k)[1] > row(k)[0] and row(k)[0] in anchors for k in gk)
    common = _assert_bracket(
        gk, wk, lambda k: s64[row(k)],
        lambda k: float(table[bins_a[row(k)[0]] * 10 + bins_b[row(k)[1]]]))
    if anchors != sorted(anchors):  # the port writes the list order
        pos = {x: p for p, x in enumerate(anchors)}
        keys = [pos[i] * 300 + j for i, j in gk]
        assert keys == sorted(keys)
    else:
        _assert_same_order(gk, wk)
    if name == "zero_hits":
        assert len(gk) == len(wk) == 0
        return
    assert len(common) > 40
    if name == "keep_all":
        n_pairs = sum(299 - x for x in anchors)
        assert len(gk) == len(wk) == n_pairs
        assert np.count_nonzero(got[2] == 0.0) >= 299 - 5  # SNP 5's row
    ge = dict(zip(gk, got[2].tolist()))
    we = dict(zip(wk, want[2].tolist()))
    ks = sorted(common)
    scale = np.abs(s64).max()
    np.testing.assert_allclose([ge[k] for k in ks], [we[k] for k in ks],
                               rtol=1e-5, atol=1e-6 * scale)
    np.testing.assert_allclose([ge[k] for k in ks],
                               [s64[row(k)] for k in ks], rtol=1e-5,
                               atol=1e-6 * scale)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_worklist_follows_jax_rule(seed):
    """The kernel's work list holds exactly the tiles of the JAX package's
    `_tile_worklist` (padding slots carry the sentinel id m)."""
    rng = np.random.default_rng(seed)
    m = int(rng.integers(200, 900))
    anchors = rng.permutation(m - 1)[:int(rng.integers(1, m - 1))]
    got = K.screen_worklist(torch.as_tensor(anchors, dtype=torch.int32), m,
                            tile=64).numpy()
    padded = np.pad(anchors, (0, (-len(anchors)) % 64), constant_values=m)
    want = JS._tile_worklist(padded, m, "tri", 64)
    np.testing.assert_array_equal(got, want)


# the *_eff screens on the mouse fixture ------------------------------------

def _eff_oracle(kind, codes, py):
    a = codes["D" if kind == "DD" else "A"].astype(np.float64)
    b = codes["A" if kind == "AA" else "D"].astype(np.float64)
    return (a * py[:, None]).T @ b


def _pair_cut(kind, table, bins_a, bins_b):
    """The cut of a written row (r0, r1): the table is read at the anchor's
    bin and the partner's, the anchor of a flipped AD row being r1."""
    def cut(k):
        r0, r1 = k
        if kind == "AD" and r0 > r1:
            r0, r1 = r1, r0
        return float(table[bins_a[r0] * 10 + bins_b[r1]])
    return cut


@pytest.mark.parametrize("kind", ["AA", "AD", "DD"])
@pytest.mark.parametrize("maf", [False, True], ids=["eff", "maf_eff"])
def test_eff_screens_match_jax(tmp_path, mouse, mouse_pheno, mouse_prefix,
                               kind, maf):
    s64 = _eff_oracle(kind, mouse["codes"], mouse["py"])
    m = s64.shape[0]
    off = ~np.eye(m, dtype=bool) if kind == "AD" else np.triu(
        np.ones((m, m), dtype=bool), 1)
    cut = float(np.quantile(np.abs(s64[off]), 1 - 2e-4))
    chi_cut = chi2.isf(1e-5, 1)
    args = (mouse_pheno, mouse_prefix, mouse["gmat"], mouse["var_com"])
    out_t, out_j = str(tmp_path / "t"), str(tmp_path / "j")
    if maf:
        bins_a = JS._maf_bins(mouse["geno"])[1]
        bins_b = JS._het_bins(mouse["geno"])[1] if kind != "AA" else bins_a
        if kind == "DD":
            bins_a = bins_b
        deno = cut * cut / chi_cut * (0.8 + 0.1 * (np.arange(111) % 5))
        kw = ({"freqA": bins_a, "freqD": bins_b} if kind == "AD"
              else {"freq": bins_a})
        kw.update(freq_deno=deno, p_cut=1e-5)
        name = f"remma_epi{kind}_maf_eff"
        table = np.sqrt(chi_cut * deno).astype(np.float32)
    else:
        bins_a = bins_b = np.zeros(m, dtype=np.int64)
        kw = {"var_app": cut * cut / chi_cut, "p_cut": 1e-5}
        name = f"remma_epi{kind}_eff"
        table = np.full(111, np.sqrt(chi_cut * kw["var_app"]), np.float32)
    getattr(gmat_tpu_torch, name)(*args, out_file=out_t, device="cpu", **kw)
    getattr(gmat_tpu, name)(*args, out_file=out_j, **kw)
    assert open(out_t).readline() == open(out_j).readline() \
        == "snp_0 snp_1 eff chi_app p_app\n"
    got, want = _rows(out_t), _rows(out_j)
    gk = [(int(a), int(b)) for a, b in got[:, :2]]
    wk = [(int(a), int(b)) for a, b in want[:, :2]]
    common = _assert_bracket(gk, wk, lambda k: s64[min(k), max(k)]
                             if kind != "AD" else s64[k],
                             _pair_cut(kind, table, bins_a, bins_b))
    assert len(common) > 50
    _assert_same_order(gk, wk)
    _assert_approx_columns(got, gk, want, wk, common)


def _assert_approx_columns(got, gk, want, wk, keys):
    """eff and chi_app of the rows `keys` at rtol 1e-4 (eff printed with
    %g), p_app at rtol 1e-3 (as test_torch_scan.py's workflow test)."""
    gi = {k: r for k, r in zip(gk, got)}
    wi = {k: r for k, r in zip(wk, want)}
    a = np.array([gi[k] for k in sorted(keys)])
    b = np.array([wi[k] for k in sorted(keys)])
    np.testing.assert_allclose(a[:, 2:4], b[:, 2:4], rtol=1e-4)
    np.testing.assert_allclose(a[:, 4], b[:, 4], rtol=1e-3, atol=1e-300)


# the approx pipelines --------------------------------------------------------

APPROX_CASES = [("AD", False), ("DD", False), ("AA", True), ("AD", True),
                ("DD", True)]
SIDE_FILES = {"AA": [".freq"], "DD": [".heter"], "AD": [".maf", ".heter"]}


def _deno_cut(path, kind, bins_a, bins_b, p_cut):
    deno = np.ones(111)
    for k1, k2, v in np.loadtxt(path, ndmin=2):
        deno[int(k1) * 10 + int(k2)] = v
    table = np.sqrt(chi2.isf(p_cut, 1) * deno)
    return _pair_cut(kind, table, bins_a, bins_b)


@pytest.mark.parametrize("kind,maf", APPROX_CASES,
                         ids=[f"{k}{'_maf' if f else ''}"
                              for k, f in APPROX_CASES])
def test_approx_pipelines_match_jax(tmp_path, mouse, mouse_pheno,
                                    mouse_prefix, kind, maf):
    """As test_torch_scan.py::test_workflow_epiAA_table: the two tables
    differ only in pairs whose eff lies within 1e-4 of the run's cut, and
    the common rows agree; the maf side files are the same bytes, and the
    bin-pair denominators the same keys with values at rtol 1e-12 (each is
    a mean of the packages' float64 calibration variances)."""
    name = f"remma_epi{kind}_{'maf_' if maf else ''}approx"
    args = (mouse_pheno, mouse_prefix, mouse["gmat"], mouse["var_com"])
    kw = {"p_cut": 1e-4, "num_random_pair": 5000}
    t, j = tmp_path / "t", tmp_path / "j"
    getattr(gmat_tpu_torch, name)(*args, out_file=str(t), device="cpu", **kw)
    getattr(gmat_tpu, name)(*args, out_file=str(j), **kw)
    assert set(TS.LAST_APPROX_STAGES) == {"prep", "draw", "calibrate",
                                          "screen", "retest", "merge",
                                          "total"}
    head = "snp_0 snp_1 eff var chi p_app p\n"
    assert open(t).readline() == open(j).readline() == head
    got, want = _rows(t), _rows(j)
    s64 = _eff_oracle(kind, mouse["codes"], mouse["py"])
    m = s64.shape[0]
    if maf:
        for ext in SIDE_FILES[kind]:
            assert filecmp.cmp(f"{t}{ext}", f"{j}{ext}", shallow=False), ext
        dt = np.loadtxt(f"{t}.freq_denominator", ndmin=2)
        dj = np.loadtxt(f"{j}.freq_denominator", ndmin=2)
        np.testing.assert_array_equal(dt[:, :2], dj[:, :2])
        np.testing.assert_allclose(dt[:, 2], dj[:, 2], rtol=1e-12)
        geno = mouse["geno"]
        bins_a = (TS._het_bins if kind == "DD" else TS._maf_bins)(geno)[1]
        bins_b = TS._het_bins(geno)[1] if kind == "AD" else bins_a
        cut = _deno_cut(f"{t}.freq_denominator", kind, bins_a, bins_b, 1e-4)
    else:
        # the screen cut: sqrt(chi2.isf(p_cut) * var_app), with var_app
        # read back from a row as eff² / chi_app of the approx columns
        var_app = np.median(got[:, 2] ** 2 / chi2.isf(got[:, 5], 1))
        flat = float(np.sqrt(chi2.isf(1e-4, 1) * var_app))
        cut = lambda k: flat  # noqa: E731
    gk = [(int(a), int(b)) for a, b in got[:, :2]]
    wk = [(int(a), int(b)) for a, b in want[:, :2]]
    eff64 = (lambda k: s64[k]) if kind == "AD" else (
        lambda k: s64[min(k), max(k)])
    for k in set(gk) ^ set(wk):
        assert abs(abs(eff64(k)) - cut(k)) <= BAND * cut(k), k
    common = set(gk) & set(wk)
    assert len(common) > 20 and all(k[0] != k[1] for k in gk)
    _assert_same_order(gk, wk)
    gi = {k: r for k, r in zip(gk, got)}
    wi = {k: r for k, r in zip(wk, want)}
    ks = sorted(common)
    a = np.array([gi[k] for k in ks])
    b = np.array([wi[k] for k in ks])
    np.testing.assert_allclose(a[:, 4], a[:, 2] ** 2 / a[:, 3], rtol=1e-6)
    cols = [2, 3, 4, 6]  # eff var chi p
    np.testing.assert_allclose(a[:, cols], b[:, cols], rtol=1e-8, atol=1e-300)
    np.testing.assert_allclose(a[:, 5], b[:, 5], rtol=1e-3)
    assert m == 1407


# the approx pipelines against their file pipeline --------------------------

def _merge_approx_exact(approx_file, exact_file, out_file):
    """The file pipeline's merge: the approx p column inserted before the
    exact p, line by line."""
    p_dct = {}
    with open(approx_file) as fin:
        for line in fin:
            arr = line.split()
            p_dct[" ".join(arr[:2])] = arr[-1]
    with open(exact_file) as fin, open(out_file, "w") as fout:
        for line in fin:
            arr = line.split()
            arr.insert(-1, p_dct[" ".join(arr[:2])])
            fout.write(" ".join(arr) + "\n")


def _file_pipeline(kind, maf, args, p_cut, num_random_pair, seed, out):
    """The approx pipeline composed of the public file APIs: random_pair*
    -> remma_epi*_pair(p_cut=1.1) -> read_csv -> median (or the bin-pair
    means) -> remma_epi*[_maf]_eff -> remma_epi*_pair on its file -> merge,
    every stage through a file."""
    import pandas as pd

    from gmat_tpu_torch.scan.common import prepare_genotypes

    rp = out + ".random_pair"
    draw = gmat_tpu_torch.random_pairAD if kind == "AD" \
        else gmat_tpu_torch.random_pair
    draw(1407, out_file=rp, num_pair=num_random_pair, seed=seed)
    pair = getattr(gmat_tpu_torch, f"remma_epi{kind}_pair")
    pair(*args, snp_pair_file=rp, p_cut=1.1, out_file=out + ".random",
         device="cpu")
    calib = pd.read_csv(out + ".random", header=0, sep=r"\s+")
    approx = out + ".approx_p"
    if not maf:
        getattr(gmat_tpu_torch, f"remma_epi{kind}_eff")(
            *args, var_app=float(np.median(calib["var"])), p_cut=p_cut,
            out_file=approx, device="cpu")
    else:
        geno, _, _ = prepare_genotypes(args[1])
        if kind == "AD":
            (freq_a, bins_a), (freq_d, bins_b) = (TS._maf_bins(geno),
                                                  TS._het_bins(geno))
            np.savetxt(out + ".maf", freq_a)
            np.savetxt(out + ".heter", freq_d)
        else:
            freq, bins_a = (TS._maf_bins if kind == "AA" else
                            TS._het_bins)(geno)
            np.savetxt(out + SIDE_FILES[kind][0], freq)
            bins_b = bins_a
        deno = TS._bin_denominators(calib, bins_a, bins_b, kind != "AD",
                                    out + ".freq_denominator")
        bins = ({"freqA": bins_a, "freqD": bins_b} if kind == "AD"
                else {"freq": bins_a})
        getattr(gmat_tpu_torch, f"remma_epi{kind}_maf_eff")(
            *args, freq_deno=deno, p_cut=p_cut, out_file=approx,
            device="cpu", **bins)
    pair(*args, snp_pair_file=approx, p_cut=1.1, out_file=out + ".exact_p",
         device="cpu")
    _merge_approx_exact(approx, out + ".exact_p", out)


BYTE_CASES = [("AA", False, 1e-4), ("AD", False, 1e-4), ("DD", False, 1e-4),
              ("AA", True, 1e-4), ("AD", True, 1e-4), ("DD", True, 1e-4),
              ("AA", False, 1e-30)]


@pytest.mark.parametrize("kind,maf,p_cut", BYTE_CASES,
                         ids=[f"{k}{'_maf' if f else ''}"
                              f"{'_no_hits' if c < 1e-20 else ''}"
                              for k, f, c in BYTE_CASES])
def test_approx_table_is_the_file_pipelines_bytes(tmp_path, mouse,
                                                  mouse_pheno, mouse_prefix,
                                                  kind, maf, p_cut):
    """The approx pipeline hands its stages arrays, and its table (and the
    maf side files) are the bytes of the same stages run through the
    public file APIs; p_cut 1e-30 keeps no pair in the screen."""
    name = f"remma_epi{kind}_{'maf_' if maf else ''}approx"
    args = (mouse_pheno, mouse_prefix, mouse["gmat"], mouse["var_com"])
    got, want = str(tmp_path / "got"), str(tmp_path / "want")
    getattr(gmat_tpu_torch, name)(*args, p_cut=p_cut, num_random_pair=5000,
                                  out_file=got, seed=5, device="cpu")
    _file_pipeline(kind, maf, args, p_cut, 5000, 5, want)
    rows = sum(1 for _ in open(got)) - 1
    assert (rows == 0) if p_cut < 1e-20 else (rows > 20)
    assert filecmp.cmp(got, want, shallow=False)
    for ext in (SIDE_FILES[kind] + [".freq_denominator"]) if maf else []:
        assert filecmp.cmp(got + ext, want + ext, shallow=False), ext


def test_approx_pipeline_writes_no_temporary_file(tmp_path, mouse,
                                                  mouse_pheno, mouse_prefix,
                                                  monkeypatch):
    """Every path the pipelines open for writing: the table, and for the
    maf pipelines their side files."""
    import builtins

    written = []
    real_open, real_savetxt = builtins.open, np.savetxt

    def recording_open(file, mode="r", *a, **k):
        if any(c in mode for c in "wax+"):
            written.append(str(file))
        return real_open(file, mode, *a, **k)

    def recording_savetxt(fname, *a, **k):
        written.append(str(fname))
        return real_savetxt(fname, *a, **k)

    monkeypatch.setattr(builtins, "open", recording_open)
    monkeypatch.setattr(np, "savetxt", recording_savetxt)
    args = (mouse_pheno, mouse_prefix, mouse["gmat"], mouse["var_com"])
    kw = {"p_cut": 1e-4, "num_random_pair": 5000, "device": "cpu"}
    flat, maf = str(tmp_path / "flat"), str(tmp_path / "maf")
    gmat_tpu_torch.remma_epiAA_approx(*args, out_file=flat, **kw)
    gmat_tpu_torch.remma_epiAD_maf_approx(*args, out_file=maf, **kw)
    monkeypatch.undo()
    # (np.savetxt may open its file through open: a path twice)
    assert set(written) == {flat, maf} | {
        maf + ext for ext in (".maf", ".heter", ".freq_denominator")}
    assert sorted(p.name for p in tmp_path.iterdir()) == sorted(
        ["flat", "maf", "maf.maf", "maf.heter", "maf.freq_denominator"])


def _edge_doubles(seed):
    """Seeded doubles over many decades, calibration-like variances, and
    the edges: NaN, ±inf, ±0, subnormals, and values about 1e-4 and 1e16,
    where repr switches between positional and exponent notation."""
    rng = np.random.default_rng(seed)
    near = lambda c: c * (1 + rng.uniform(-1e-3, 1e-3, 200))  # noqa: E731
    return np.concatenate([
        rng.standard_normal(3000) * 10.0 ** rng.integers(-30, 30, 3000),
        rng.gamma(2.0, 1e-6, 1000), near(1e-4), near(1e16), near(1e-5),
        [np.nan, np.inf, -np.inf, 0.0, -0.0, 5e-324, 1e-310, -2.5e-320,
         1e-4, np.nextafter(1e-4, 0), np.nextafter(1e-4, 1), 1e16,
         np.nextafter(1e16, 0), np.nextafter(1e16, np.inf), -1e16,
         np.finfo(float).max, np.finfo(float).tiny, 0.1, 1 / 3]])


def _to_csv(frame, **kw):
    import io

    buf = io.StringIO()
    frame.to_csv(buf, sep=" ", header=False, index=False, **kw)
    return buf.getvalue()


@pytest.mark.parametrize("seed", [0, 1])
def test_var_round_trip_is_the_files(seed):
    """`_csv_round_trip` gives, bit for bit, the var column that the file
    pipeline read back: a pair test's six columns through `to_csv` and
    `read_csv(sep=r"\\s+")`.  NaN stays NaN (a NaN row's empty field
    would shift the file's columns, and its p is NaN: no such row is
    kept)."""
    import io

    import pandas as pd

    x = _edge_doubles(seed)
    ok = ~np.isnan(x)
    k = int(ok.sum())
    rng = np.random.default_rng(seed + 10)
    frame = pd.DataFrame({0: np.arange(k), 1: np.arange(k) + 1,
                          2: rng.standard_normal(k), 3: x[ok],
                          4: rng.gamma(1.0, 1.0, k), 5: rng.uniform(size=k)})
    text = "snp_0 snp_1 eff var chi p\n" + _to_csv(frame)
    want = pd.read_csv(io.StringIO(text), header=0, sep=r"\s+")["var"]
    got = TS._csv_round_trip(x)
    assert np.isnan(got[~ok]).all()
    np.testing.assert_array_equal(got[ok].view(np.uint64),
                                  want.to_numpy(dtype=np.float64)
                                  .view(np.uint64))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_g_rounding_is_the_screen_files(dtype):
    """`_g_round` is float() of the `%g` text that a screen file holds
    (`to_csv(float_format="%g")`; its empty field for NaN read as NaN)."""
    import pandas as pd

    with np.errstate(over="ignore"):
        eff = _edge_doubles(2).astype(dtype)
    k = len(eff)
    lines = _to_csv(pd.DataFrame({0: np.arange(k), 1: np.arange(k), 2: eff}),
                    float_format="%g").splitlines()
    want = np.array([float(t) if t else np.nan
                     for t in (line.split(" ")[2] for line in lines)])
    got = TS._g_round(eff)
    np.testing.assert_array_equal(got.view(np.uint64), want.view(np.uint64))


def test_table_writer_is_to_csv(tmp_path):
    """`_write_approx_table` writes the text of one `DataFrame.to_csv` of
    the seven columns, p_app as str() of each float64."""
    import pandas as pd

    x = _edge_doubles(3)
    rng = np.random.default_rng(4)
    cols = [rng.permutation(x) for _ in range(5)]
    i, j = rng.integers(0, 1 << 20, (2, len(x)))
    out = tmp_path / "table"
    TS._write_approx_table(str(out), (i, j, *cols[:3], cols[4]), cols[3])
    want = _to_csv(pd.DataFrame({
        0: i, 1: j, 2: cols[0], 3: cols[1], 4: cols[2],
        5: np.array([str(v) for v in cols[3]], dtype=object), 6: cols[4]}))
    assert out.read_text() == "snp_0 snp_1 eff var chi p_app p\n" + want
    TS._write_approx_table(str(out), (i[:0], j[:0], *(c[:0] for c in cols[:3]),
                                      cols[4][:0]), cols[3][:0])
    assert out.read_text() == "snp_0 snp_1 eff var chi p_app p\n"


# the *_parallel parts --------------------------------------------------------

def _keys(path):
    return [(int(a), int(b)) for a, b in _rows(path)[:, :2]]


@pytest.mark.parametrize("kind", ["AA", "AD"])
def test_eff_parallel_union_equals_serial(tmp_path, mouse, mouse_pheno,
                                          mouse_prefix, kind):
    """Three parts of the balanced split write, together, the serial
    table's rows.  On the card that is the same arithmetic on a gathered
    panel, bit for bit; here the plain version's float32 products round
    by their shapes, so the rows may differ inside the f64 band only."""
    args = (mouse_pheno, mouse_prefix, mouse["gmat"], mouse["var_com"])
    s64 = _eff_oracle(kind, mouse["codes"], mouse["py"])
    cut = float(np.quantile(np.abs(s64[np.triu_indices(1407, 1)]), 1 - 3e-4))
    kw = {"var_app": cut * cut / chi2.isf(1e-5, 1), "p_cut": 1e-5,
          "device": "cpu"}
    serial = str(tmp_path / "serial")
    getattr(gmat_tpu_torch, f"remma_epi{kind}_eff")(*args, out_file=serial,
                                                     **kw)
    part = str(tmp_path / "part")
    fn = getattr(gmat_tpu_torch, f"remma_epi{kind}_eff_parallel")
    parts = []
    for p in (1, 2, 3):
        fn(*args, parallel=[3, p], out_file=part, **kw)
        assert open(f"{part}.{p}").readline() \
            == "snp_0 snp_1 eff chi_app p_app\n"
        parts.append(_rows(f"{part}.{p}"))
    got = np.concatenate(parts)
    want = _rows(serial)
    gk = [(int(a), int(b)) for a, b in got[:, :2]]
    wk = [(int(a), int(b)) for a, b in want[:, :2]]
    assert len(set(gk)) == len(gk)
    eff64 = (lambda k: s64[k]) if kind == "AD" else (
        lambda k: s64[min(k), max(k)])
    flat = float(np.float32(cut))
    common = _assert_bracket(gk, wk, eff64, lambda k: flat)
    assert len(common) > 100
    _assert_approx_columns(got, gk, want, wk, common)


def test_maf_approx_parallel_union_equals_serial(tmp_path, mouse,
                                                 mouse_pheno):
    """remma_epiAA_maf_approx_parallel's three parts write the serial
    table's rows.  On 101 SNPs of the mouse panel every part's calibration
    draws all 5050 pairs (in its own seed's order), so every part and the
    serial run screen at the same bin-pair cuts."""
    import pandas as pd

    from gmat_tpu_torch.io.bed import write_bed

    prefix = str(tmp_path / "small")
    fam = pd.read_csv(DATA / "plink.fam", sep=r"\s+", header=None, dtype=str)
    write_bed(prefix, np.nan_to_num(mouse["geno"][:, :101], nan=1.0),
              fam=fam)
    args = (mouse_pheno, prefix, mouse["gmat"], mouse["var_com"])
    kw = {"p_cut": 0.05, "num_random_pair": 5050, "device": "cpu"}
    gmat_tpu_torch.remma_epiAA_maf_approx(*args, out_file=str(tmp_path / "s"),
                                          **kw)
    want = _rows(tmp_path / "s")
    got = []
    for p in (1, 2, 3):
        gmat_tpu_torch.remma_epiAA_maf_approx_parallel(
            *args, parallel=[3, p], out_file=str(tmp_path / "part"), **kw)
        rows = _rows(tmp_path / f"part.{p}")
        got.append(rows)
        anchors = TS._parallel_anchor_split("AA", prefix, [3, p], maf=True)
        assert set(rows[:, 0].astype(int)) <= set(anchors)
    got = np.concatenate(got)
    assert len(want) > 20 and len(got) == len(want)
    order = np.lexsort((got[:, 1], got[:, 0]))
    np.testing.assert_array_equal(got[order, :2], want[:, :2])
    np.testing.assert_allclose(got[order, 2:], want[:, 2:], rtol=1e-12)


# the reference's GPU API and the exports ------------------------------------

def test_eff_gpu_matches_jax(tmp_path, mouse_geno):
    """remma_epiAA_eff_gpu on a 40-SNP set with a monomorphic SNP, at the
    keep-all default and at a cut over an unsorted anchor list; the rows of
    exact zeros included."""
    from gmat_tpu.scan.accel import remma_epiAA_eff_gpu as j_eff_gpu
    from gmat_tpu_torch.io.bed import write_bed

    rng = np.random.default_rng(3)
    geno = np.nan_to_num(mouse_geno[:300, :40], nan=1.0)
    geno[:, 7] = 0.0
    prefix = str(tmp_path / "small")
    write_bed(prefix, geno)
    y = rng.standard_normal(300)
    x = np.ones((300, 1))
    ag = np.asarray(additive_grm(jnp.asarray(geno)))
    var = np.array([0.3, 0.7])
    cut = -999.0
    for anchors in (None, [30, 2, 17, 7]):
        t = gmat_tpu_torch.remma_epiAA_eff_gpu(
            y, x, [ag], var, prefix, snp_lst_0=anchors, eff_cut=cut,
            out_file=str(tmp_path / "t"), device="cpu")
        j = j_eff_gpu(y, x, [ag], var, prefix, snp_lst_0=anchors, eff_cut=cut,
                      out_file=str(tmp_path / "j"))
        assert open(tmp_path / "t").readline() == "snp_0 snp_1 eff\n"
        np.testing.assert_allclose(np.loadtxt(tmp_path / "t", skiprows=1),
                                   t, rtol=1e-15)
        if anchors is None:
            assert len(t) == 40 * 39 // 2
            assert np.count_nonzero(t[:, 2] == 0.0) == 39  # SNP 7's pairs
        else:  # the port writes the list order; JAX sorts within a tile
            keys = [anchors.index(int(i)) * 40 + int(k) for i, k in t[:, :2]]
            assert keys == sorted(keys) and len(t) > 20
        tj, jj = (r[np.lexsort((r[:, 1], r[:, 0]))] for r in (t, j))
        np.testing.assert_array_equal(tj[:, :2], jj[:, :2])
        np.testing.assert_allclose(tj[:, 2], jj[:, 2], rtol=1e-5,
                                   atol=1e-6 * np.abs(jj[:, 2]).max())
        cut = float(np.quantile(np.abs(t[:, 2]), 0.5))


def test_exports_cover_jax_screens():
    """Every screen entry point of the JAX package, and its GPU API, is
    exported by the port."""
    jax_names = {n for n in dir(gmat_tpu)
                 if n.startswith("remma_epi") and ("eff" in n or "approx" in n)}
    assert jax_names == set(SCREEN_NAMES) | {"remma_epiAA_eff_gpu"}
    for n in jax_names:
        assert callable(getattr(gmat_tpu_torch, n)), n
