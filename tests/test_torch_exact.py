"""The exhaustive exact scans of gmat_tpu_torch (scan/pairs.py on the
exact-scan kernel K2, scan/kernels.py::exact_hits) and its single-SNP tests
(scan/single.py), against the JAX package and the reference goldens.

- the plain version `exact_hits_ref` against the JAX package's float64 XLA
  engine (`_anchor_tiles_batch`): the same rows in the same order, values
  at rtol 1e-10 (both float64, summed in other orders);
- against the TPU kernel itself (`pallas_exact_hits` in interpret mode,
  float32): the hit set inside the ±1e-3·crit bracket and the rtols of
  tests/test_pallas_kernels.py;
- `remma_epiAA/AD/DD`, `*_pair`, `*_parallel`, `remma_add/dom` on the mouse
  fixture against tests/golden at the tolerances of tests/test_scans.py and
  against the JAX entry points' files.

On the CPU the wrapper runs its plain version; the cases marked `cuda` hold
the Hopper kernel against it and skip without a card.  The JAX package and
the conftest fixtures are reached only inside the tests that use them, so
that the `cuda` cases also run on a machine without JAX:
    python -m pytest --noconftest -m cuda tests/test_torch_exact.py
"""
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch

from gmat_tpu_torch.scan import kernels as K
from gmat_tpu_torch.scan import pairs as P

GOLDEN = Path(__file__).resolve().parent / "golden"


def _problem(n, m, seed):
    """The recipe of tests/test_pallas_kernels.py's `exact_problem`: float32
    values (so that the float32 TPU kernel sees the same inputs), a second,
    het-coded partner panel for the rectangle, a symmetric pvp."""
    rng = np.random.default_rng(seed)
    geno = rng.choice([0.0, 1.0, 2.0], size=(n, m))
    freq = geno.sum(0) / (2 * n)
    mat0 = (geno - 2 * freq[None, :]).astype(np.float32)
    het = 2 * freq * (1 - freq)
    mat1 = ((geno == 1.0) - het[None, :]).astype(np.float32)
    py = (rng.standard_normal(n) * 0.1).astype(np.float32)
    a = rng.standard_normal((n, n)).astype(np.float32) * 0.05
    pvp = (a @ a.T + np.eye(n, dtype=np.float32)).astype(np.float32)
    pvp = np.triu(pvp) + np.triu(pvp, 1).T  # bit-symmetric
    return mat0, mat1, py, pvp


@pytest.fixture(scope="module")
def problem():
    return _problem(64, 300, 2026)  # m not a multiple of the 128 tile


def _t(*arrays, device="cpu"):
    return [torch.as_tensor(np.asarray(a, dtype=np.float64), device=device)
            for a in arrays]


def _crit_between(chi, q):
    """A threshold halfway between two neighbouring chi values near the
    q-quantile, so that no pair lies on it."""
    s = np.sort(chi[np.isfinite(chi)])
    k = int(q * (len(s) - 1))
    return float((s[k] + s[k + 1]) / 2)


def _all_chi(mat0, mat1, py, pvp, anchors, mask):
    i, j, eff, var, chi = K.exact_hits_ref(*_t(mat0, mat1, py, pvp),
                                           torch.as_tensor(anchors), -1.0,
                                           mask)
    return chi.numpy()


def _jax_engine(mat0, mat1, py, pvp, anchors, crit, triangular):
    """The JAX package's float64 XLA engine on one tile holding the whole
    anchor list: its rows in list order, partners ascending."""
    import jax.numpy as jnp

    from gmat_tpu.scan.pairs import _anchor_tiles_batch

    tile = len(anchors)
    out = _anchor_tiles_batch(
        jnp.asarray([0], jnp.int32), jnp.asarray(anchors, jnp.int32),
        jnp.ones(tile, bool), *(jnp.asarray(np.asarray(a, np.float64))
                                for a in (mat0, mat1, py, pvp)),
        crit, triangular, tile, tile * mat1.shape[1])
    count = int(np.asarray(out[0])[0])
    return [np.asarray(a)[0, :count] for a in out[1:]]


_ENGINE_CASES = {
    "tri_all_threshold": ("tri", None, 0.98),
    "rect_subset_threshold": ("rect", [17, 3, 250, 120, 299, 0], 0.9),
    "tri_subset_keep_all": ("tri", [17, 3, 250, 120, 298, 0], None),
    "rect_subset_zero_hits": ("rect", [17, 3, 250], 1.0),
}


@pytest.mark.parametrize("case", sorted(_ENGINE_CASES))
def test_plain_version_matches_xla_engine(problem, case):
    mat0, mat1, py, pvp = problem
    mask, anchors, q = _ENGINE_CASES[case]
    mat1 = mat0 if mask == "tri" else mat1
    if anchors is None:
        anchors = list(range(mat0.shape[1] - 1))
    if q is None:
        crit = -1.0
    elif q == 1.0:
        crit = 1e30
    else:
        crit = _crit_between(_all_chi(mat0, mat1, py, pvp, anchors, mask), q)
    i, j, eff, var, chi = (a.numpy() for a in K.exact_hits(
        *_t(mat0, mat1, py, pvp), torch.as_tensor(anchors), crit, mask))
    wi, wj, weff, wvar, wchi = _jax_engine(mat0, mat1, py, pvp, anchors, crit,
                                           mask == "tri")
    if q == 1.0:
        assert len(i) == len(wi) == 0
        return
    assert len(i) > 100
    if q is None:
        assert len(i) == K.exact_pair_count(torch.as_tensor(anchors),
                                            mat1.shape[1], mask)
    np.testing.assert_array_equal(i, wi)
    np.testing.assert_array_equal(j, wj)
    np.testing.assert_allclose(eff, weff, rtol=1e-10, atol=1e-14)
    np.testing.assert_allclose(var, wvar, rtol=1e-10)
    np.testing.assert_allclose(chi, wchi, rtol=1e-10, atol=1e-14)


@pytest.mark.parametrize("mask", ["tri", "rect"])
def test_plain_version_matches_pallas_kernel(problem, mask):
    """The TPU kernel K2 in interpret mode (float32) against the port's
    float64 result; the port's rectangle minus its diagonal is the Pallas
    `nodiag` mode."""
    from gmat_tpu.scan.kernels import pallas_exact_hits

    mat0, _, py, pvp = problem
    m = mat0.shape[1]
    anchors = torch.arange(m)
    chi_all = _all_chi(mat0, mat0, py, pvp, anchors, "tri")
    crit = _crit_between(chi_all, 0.98)
    i, j, eff, var, chi = (a.numpy() for a in K.exact_hits(
        *_t(mat0, mat0, py, pvp), anchors, crit * (1 - 1e-3), mask))
    off = i != j
    i, j, eff, var, chi = (a[off] for a in (i, j, eff, var, chi))
    hull = dict(zip(zip(i.tolist(), j.tolist()), zip(eff, var, chi)))
    core = {k for k, v in hull.items() if v[2] > crit * (1 + 1e-3)}
    pi, pj, pe, pv, pc = pallas_exact_hits(
        mat0, mat0, py, pvp, crit, mask_mode="tri" if mask == "tri"
        else "nodiag", interpret=True)
    got = set(zip(pi.tolist(), pj.tolist()))
    assert len(core) > 100 and core <= got <= set(hull)
    want = np.array([hull[k] for k in zip(pi.tolist(), pj.tolist())])
    np.testing.assert_allclose(pe, want[:, 0], rtol=2e-3, atol=1e-5)
    np.testing.assert_allclose(pv, want[:, 1], rtol=2e-3, atol=1e-7)
    np.testing.assert_allclose(pc, want[:, 2], rtol=4e-3, atol=1e-5)


def test_wrapper_rejects_bad_input(problem):
    mat0, mat1, py, pvp = _t(*problem)
    anchors = torch.tensor([0, 1])
    with pytest.raises(TypeError):
        K.exact_hits(mat0.float(), mat1, py, pvp, anchors, 1.0, "tri")
    with pytest.raises(TypeError):
        K.exact_hits(mat0, mat1, py, pvp, anchors.double(), 1.0, "tri")
    with pytest.raises(ValueError):
        K.exact_hits(mat0, mat1, py, pvp, anchors, 1.0, "nodiag")
    with pytest.raises(ValueError):
        K.exact_hits(mat0, mat1[:10], py, pvp, anchors, 1.0, "rect")
    with pytest.raises(ValueError):
        K.exact_hits(mat0, mat1, py, pvp, torch.tensor([300]), 1.0, "rect")
    with pytest.raises(ValueError):
        K.exact_hits(mat0.T, mat1, py, pvp, anchors, 1.0, "rect")


# entry points on the mouse fixture ------------------------------------------

@pytest.fixture(scope="module")
def grms(mouse_geno):
    import jax.numpy as jnp

    from gmat_tpu.grm.grm import additive_grm, dominance_grm

    g = jnp.asarray(mouse_geno)
    return np.asarray(additive_grm(g)), np.asarray(dominance_grm(g))


def _load(path):
    return np.loadtxt(path, skiprows=1, ndmin=2)


_SCANS = {"aa": "remma_epiAA", "ad": "remma_epiAD", "dd": "remma_epiDD"}


@pytest.mark.parametrize("kind", sorted(_SCANS))
def test_scan_matches_golden_and_jax(tmp_path, mouse_pheno, mouse_prefix,
                                     grms, kind):
    import gmat_tpu.scan.pairs as J

    gold = np.load(GOLDEN / "epi_scans.npz")
    ag, _ = grms
    args = (mouse_pheno, mouse_prefix, [ag, ag * ag], gold["var_com"])
    out_t, out_j = str(tmp_path / "t"), str(tmp_path / "j")
    getattr(P, _SCANS[kind])(*args, snp_lst_0=list(gold["anchors"]),
                             p_cut=1.1, out_file=out_t, device="cpu")
    getattr(J, _SCANS[kind])(*args, snp_lst_0=list(gold["anchors"]),
                             p_cut=1.1, out_file=out_j)
    got, want, ref = _load(out_t), _load(out_j), gold[kind]
    assert open(out_t).readline() == open(out_j).readline()
    assert got.shape == ref.shape == want.shape
    for other in (ref, want):  # tests/test_scans.py's tolerances
        np.testing.assert_array_equal(got[:, :2], other[:, :2])
        np.testing.assert_allclose(got[:, 2], other[:, 2], rtol=1e-7,
                                   atol=1e-12)
        np.testing.assert_allclose(got[:, 3], other[:, 3], rtol=1e-6,
                                   atol=1e-10)
        np.testing.assert_allclose(got[:, 4], other[:, 4], rtol=1e-5,
                                   atol=1e-12)


def test_scan_threshold_and_anchor_order(tmp_path, mouse_pheno, mouse_prefix,
                                         grms):
    """Rows follow the anchor list's order (partners ascending), and a
    p_cut keeps exactly the rows of the keep-all table with p < p_cut."""
    gold = np.load(GOLDEN / "epi_scans.npz")
    ag, _ = grms
    args = (mouse_pheno, mouse_prefix, [ag, ag * ag], gold["var_com"])
    anchors = [39, 0, 17]
    out = str(tmp_path / "aa")
    P.remma_epiAA(*args, snp_lst_0=anchors, p_cut=1.1, out_file=out,
                  device="cpu")
    got = _load(out)
    ref = gold["aa"]
    want = np.concatenate([ref[ref[:, 0] == a] for a in anchors])
    np.testing.assert_array_equal(got[:, :2], want[:, :2])
    np.testing.assert_allclose(got[:, 2:], want[:, 2:], rtol=1e-5,
                               atol=1e-12)
    P.remma_epiAA(*args, snp_lst_0=anchors, p_cut=1e-2, out_file=out,
                  device="cpu")
    cut = _load(out)
    keep = got[:, 4] < 1e-2
    assert 0 < len(cut) < len(got)
    np.testing.assert_array_equal(cut, got[keep])
    with pytest.raises(ValueError, match="out of range"):
        P.remma_epiAA(*args, snp_lst_0=[1406], out_file=out, device="cpu")


def test_scan_in_anchor_runs_matches_one_run(tmp_path, monkeypatch,
                                            mouse_pheno, mouse_prefix, grms):
    """A pair budget that splits the anchor list into one kernel call per
    anchor writes the rows of one call (values to the last few ulps: the
    plain version's product width changes with the call)."""
    gold = np.load(GOLDEN / "epi_scans.npz")
    ag, _ = grms
    args = (mouse_pheno, mouse_prefix, [ag, ag * ag], gold["var_com"])
    kw = {"snp_lst_0": [39, 0, 17], "p_cut": 0.5, "device": "cpu"}
    P.remma_epiAD(*args, out_file=str(tmp_path / "one"), **kw)
    monkeypatch.setattr(P, "_SCAN_PAIR_BUDGET", 2000)
    assert len(list(P._anchor_runs(np.array([39, 0, 17]),
                                   np.full(3, 1407), 2000))) == 3
    P.remma_epiAD(*args, out_file=str(tmp_path / "runs"), **kw)
    one, runs = _load(tmp_path / "one"), _load(tmp_path / "runs")
    assert len(one) > 100
    np.testing.assert_array_equal(one[:, :2], runs[:, :2])
    np.testing.assert_allclose(one[:, 2:], runs[:, 2:], rtol=1e-12,
                               atol=1e-300)


@pytest.mark.parametrize("kind", ["AD", "DD"])
def test_pair_tests_match_jax(tmp_path, mouse_pheno, mouse_prefix, grms,
                              kind):
    import gmat_tpu.scan.pairs as J

    gold = np.load(GOLDEN / "epiAA_pairs.npz")
    ag, _ = grms
    pair_file = str(tmp_path / "pairs")
    np.savetxt(pair_file, gold["pairs"], fmt="%d", header="snp_0 snp_1",
               comments="")
    args = (mouse_pheno, mouse_prefix, [ag, ag * ag], gold["var_com"],
            pair_file)
    out_t, out_j = str(tmp_path / "t"), str(tmp_path / "j")
    getattr(P, f"remma_epi{kind}_pair")(*args, p_cut=1.1, out_file=out_t,
                                        device="cpu")
    getattr(J, f"remma_epi{kind}_pair")(*args, p_cut=1.1, out_file=out_j)
    got, want = _load(out_t), _load(out_j)
    assert open(out_t).readline() == open(out_j).readline()
    assert got.shape == want.shape == (len(gold["pairs"]), 6)
    np.testing.assert_array_equal(got[:, :2], want[:, :2])
    np.testing.assert_allclose(got[:, 2:], want[:, 2:], rtol=1e-6,
                               atol=1e-12)


def test_balanced_split_matches_jax():
    from gmat_tpu.scan.pairs import balanced_anchor_split as j_split

    for num_snp in (1407, 28220, 101):
        for n_parts in (1, 3, 100):
            for part in sorted({1, 2, n_parts}):
                if part > n_parts:
                    continue
                for tri in (True, False):
                    assert P.balanced_anchor_split(num_snp, n_parts, part,
                                                   tri) == \
                        j_split(num_snp, n_parts, part, tri)


@pytest.mark.parametrize("kind", ["AA", "AD"])
def test_parallel_part_matches_full_table(tmp_path, mouse_pheno, mouse_prefix,
                                          grms, kind):
    """One part of the split, written to `out.{part}`, holds the unsplit
    reference table's rows of its anchors (tests/golden/epi_full.npz, at the
    tolerances of tests/test_full_table.py)."""
    gold = np.load(GOLDEN / "epi_full.npz")
    ag, _ = grms
    m = 1407
    out = str(tmp_path / "epi")
    getattr(P, f"remma_epi{kind}_parallel")(
        mouse_pheno, mouse_prefix, [ag, ag * ag], gold["var_com"],
        parallel=[100, 1], p_cut=1.1, out_file=out, device="cpu")
    assert not Path(out).exists()
    got = pd.read_csv(out + ".1", sep=" ").to_numpy()
    anchors = P.balanced_anchor_split(m, 100, 1, kind == "AA")
    assert len(anchors) == (20 if kind == "AA" else 21)
    i, j = got[:, 0].astype(np.int64), got[:, 1].astype(np.int64)
    if kind == "AA":
        want = [(a, b) for a in anchors for b in range(a + 1, m)]
        rows = i * m - i * (i + 1) // 2 + (j - i - 1)
    else:
        want = [(a, b) for a in anchors for b in range(m)]
        rows = i * m + j
    assert list(zip(i.tolist(), j.tolist())) == want
    name = kind.lower()
    np.testing.assert_allclose(got[:, 2], gold[f"{name}_eff"][rows],
                               rtol=2e-6, atol=1e-12)
    gold_chi, gold_p = gold[f"{name}_chi"][rows], gold[f"{name}_p"][rows]
    np.testing.assert_allclose(got[:, 3], gold_chi, rtol=4e-6, atol=5e-5)
    noisy = np.abs(got[:, 3] - gold_chi) > 4e-6 * np.abs(gold_chi)
    assert noisy.sum() <= 5
    np.testing.assert_allclose(got[~noisy, 4], gold_p[~noisy], rtol=1e-5,
                               atol=1e-30)
    np.testing.assert_allclose(got[noisy, 4], gold_p[noisy], atol=5e-5)


def test_remma_add_golden(tmp_path, mouse_pheno, mouse_prefix, grms):
    """tests/test_scans.py::test_remma_add_golden, on the port."""
    from gmat_tpu_torch.scan.single import remma_add

    gold = np.load(GOLDEN / "remma_single.npz")
    ag, _ = grms
    res = remma_add(mouse_pheno, mouse_prefix, [ag, ag * ag],
                    gold["var_a_axa"], out_file=str(tmp_path / "add"),
                    device="cpu")
    np.testing.assert_allclose(res["eff_val"], gold["add_eff"], rtol=1e-8)
    np.testing.assert_allclose(res["chi_val"], gold["add_chi"], rtol=1e-8)
    np.testing.assert_allclose(res["p_val"], gold["add_p"], rtol=1e-6,
                               atol=1e-300)
    np.testing.assert_allclose(res["eff_val_to_fixed"], gold["add_eff_fixed"],
                               rtol=1e-8)
    first = open(tmp_path / "add").readline().split()
    assert first == ["chro", "snp_ID", "pos", "allele1", "allele2", "eff_val",
                     "chi_val", "eff_val_to_fixed", "p_val"]


def test_remma_dom_golden_and_jax(tmp_path, mouse_pheno, mouse_prefix, grms):
    from gmat_tpu.scan.single import remma_dom as j_remma_dom
    from gmat_tpu_torch.scan.single import remma_dom

    gold = np.load(GOLDEN / "remma_single.npz")
    ag, dg = grms
    args = (mouse_pheno, mouse_prefix, [ag, dg, ag * ag], gold["var_a_d_axa"])
    res = remma_dom(*args, out_file=str(tmp_path / "t"), device="cpu")
    np.testing.assert_allclose(res["eff_val"], gold["dom_eff"], rtol=1e-8)
    np.testing.assert_allclose(res["p_val"], gold["dom_p"], rtol=1e-6,
                               atol=1e-300)
    want = j_remma_dom(*args, out_file=str(tmp_path / "j"))
    assert list(res.columns) == list(want.columns)
    for c in ["chro", "snp_ID", "pos", "allele1", "allele2"]:
        assert (res[c].astype(str) == want[c].astype(str)).all(), c
    for c in ["eff_val", "chi_val", "eff_val_to_fixed", "p_val"]:
        np.testing.assert_allclose(res[c], want[c], rtol=1e-8, atol=1e-300)


@pytest.mark.slow
@pytest.mark.parametrize("kind", sorted(_SCANS))
def test_full_table_on_the_port(tmp_path, mouse_pheno, mouse_prefix, grms,
                                kind):
    """tests/test_full_table.py's complete mouse tables, on the port."""
    from test_full_table import _assert_table

    gold = np.load(GOLDEN / "epi_full.npz")
    ag, _ = grms
    out = str(tmp_path / kind)
    getattr(P, _SCANS[kind])(mouse_pheno, mouse_prefix, [ag, ag * ag],
                             gold["var_com"], p_cut=1.1, out_file=out,
                             device="cpu")
    _assert_table(pd.read_csv(out, sep=" ", header=0).to_numpy(), gold, kind,
                  1407, kind)


# the Hopper kernel: needs the card ------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


def _assert_same_hits(got, want, crit, band=1e-9):
    """Hit sets equal outside crit·(1 ± band); eff/var/chi at rtol 1e-9 on
    the common pairs, rows in the same order."""
    gk = dict(zip(zip(got[0].tolist(), got[1].tolist()), range(len(got[0]))))
    wk = dict(zip(zip(want[0].tolist(), want[1].tolist()),
                  range(len(want[0]))))
    for k in set(gk) ^ set(wk):
        c = float(got[4][gk[k]] if k in gk else want[4][wk[k]])
        assert abs(c - crit) <= band * abs(crit), k
    common = [k for k in gk if k in wk]
    g = [gk[k] for k in common]
    w = [wk[k] for k in common]
    assert g == sorted(g) and w == sorted(w)  # the same order
    for a, b in zip(got[2:], want[2:]):
        np.testing.assert_allclose(a.cpu().numpy()[g], b.cpu().numpy()[w],
                                   rtol=1e-9, atol=1e-12)
    return len(common)


_ANCHORS = [250, 3, 0, 17, 299, 120, 298]
# the edges of the kernel's design: 128-row tiles of pvp walked in slices of
# 32 rows, 128-partner blocks, 16-byte copies only where rows are aligned
_KERNEL_CASES = {  # (n, m, mask, quantile at the threshold, center, anchors)
    "tri_q0.8": (200, 300, "tri", 0.8, False, _ANCHORS),
    "rect_q0.9": (200, 300, "rect", 0.9, False, _ANCHORS),
    "tri_keep_all": (200, 300, "tri", None, False, _ANCHORS),
    "rect_zero_hits": (200, 300, "rect", 1.0, False, _ANCHORS),
    "odd_n_odd_m_tri": (201, 301, "tri", 0.8, False, _ANCHORS),
    "odd_n_odd_m_rect_center": (201, 301, "rect", None, True, _ANCHORS),
    "n_below_one_slice": (11, 300, "tri", None, False, _ANCHORS),
    "n_below_one_slice_rect_center": (11, 130, "rect", 0.5, True,
                                      [0, 127, 128, 129]),
    "n_above_tiles_tri_center": (257, 400, "tri", 0.8, True,
                                 [0, 126, 127, 128, 255, 256, 383, 384, 398]),
    "n_above_tile_rect": (129, 300, "rect", None, False,
                          [0, 127, 128, 255, 256, 299]),
    "m_below_tile_tri": (200, 100, "tri", None, False, [0, 1, 50, 98]),
    "m_below_tile_rect_center": (133, 61, "rect", 0.7, True, [60, 0, 31]),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(_KERNEL_CASES))
def test_kernel_matches_plain_version(cuda, case):
    n, m, mask, q, center, anchors = _KERNEL_CASES[case]
    mat0, mat1, py, pvp = _problem(n, m, 7)
    mat1 = mat0 if mask == "tri" else mat1
    tensors = _t(mat0, mat1, py, pvp, device=cuda)
    anchors = torch.tensor(anchors, device=cuda)
    if mask == "tri":
        anchors = anchors[anchors < m - 1]
    full = K.exact_hits_ref(*tensors, anchors, -1.0, mask, center)
    crit = {None: -1.0, 1.0: 1e30}.get(q)
    if crit is None:
        crit = _crit_between(full[4].cpu().numpy(), q)
    before = K.LAUNCHES["exact_scan"]
    got = K.exact_hits(*tensors, anchors, crit, mask, center)
    torch.cuda.synchronize()
    assert K.LAUNCHES["exact_scan"] == before + 1
    want = K.exact_hits_ref(*tensors, anchors, crit, mask, center)
    common = _assert_same_hits(got, want, crit)
    if q == 1.0:
        assert common == 0 and len(got[0]) == 0
    else:
        assert common >= min(100, len(full[0]) // 4)
    if q is None:
        assert len(got[0]) == len(full[0])
    with pytest.raises(TypeError):
        K.exact_hits(tensors[0].float(), *tensors[1:], anchors, crit, mask)


@pytest.mark.cuda
def test_kernel_relaunches_on_overflow(cuda, monkeypatch):
    mat0, _, py, pvp = _problem(96, 700, 11)
    tensors = _t(mat0, mat0, py, pvp, device=cuda)
    anchors = torch.arange(699, device=cuda)
    crit = _crit_between(
        K.exact_hits_ref(*tensors, anchors, -1.0, "tri")[4].cpu().numpy(), 0.5)
    monkeypatch.setattr(K, "EXACT_CAPACITY", 1000)
    before = K.LAUNCHES["exact_scan"]
    got = K.exact_hits(*tensors, anchors, crit, "tri")
    assert K.LAUNCHES["exact_scan"] == before + 2
    assert len(got[0]) > 100000
    _assert_same_hits(got, K.exact_hits_ref(*tensors, anchors, crit, "tri"),
                      crit)
