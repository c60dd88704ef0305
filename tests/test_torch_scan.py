"""gmat_tpu_torch scans vs the JAX package and the reference goldens on the
mouse fixture: score pieces (rtol 1e-10), the exact pair test (rtol 1e-6,
the tolerance of tests/test_scans.py), the effect screen's hit set (the f64
bracket of tests/test_screen.py), and the whole four-step REMMAX workflow
run through both packages."""
import filecmp
import shutil
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

import gmat_tpu
import gmat_tpu_torch
from gmat_tpu.core.coding import additive_code
from gmat_tpu.grm.grm import additive_grm
from gmat_tpu.io.pheno import design_matrix as j_design_matrix
from gmat_tpu.scan.common import score_pieces as j_score_pieces
from gmat_tpu.scan.pairs import remma_epiAA_pair as j_remma_epiAA_pair
from gmat_tpu_torch.io.pheno import design_matrix as t_design_matrix
from gmat_tpu_torch.scan.common import score_pieces as t_score_pieces
from gmat_tpu_torch.scan.common import score_pieces_from_numpy
from gmat_tpu_torch.scan.pairs import _pair_kernel, remma_epiAA_pair
from gmat_tpu_torch.scan.screen import remma_epiAA_eff

from conftest import DATA, GOLDEN

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def setup(mouse_geno, mouse_pheno, mouse_prefix):
    ag = np.asarray(additive_grm(jnp.asarray(mouse_geno)))
    var_com = np.load(GOLDEN / "epi_scans.npz")["var_com"]
    pieces = j_score_pieces(j_design_matrix(mouse_pheno, mouse_prefix),
                            [ag, ag * ag], var_com)
    return ag, var_com, np.asarray(pieces.pymat), np.asarray(pieces.pvpmat)


def test_score_pieces_match_jax(mouse_pheno, mouse_prefix, setup):
    ag, var_com, pymat, pvpmat = setup
    got = t_score_pieces(t_design_matrix(mouse_pheno, mouse_prefix),
                         [ag, ag * ag], var_com, device="cpu")
    np.testing.assert_allclose(got.pymat.numpy(), pymat, rtol=1e-10,
                               atol=1e-12)
    np.testing.assert_allclose(got.pvpmat.numpy(), pvpmat, rtol=1e-10,
                               atol=1e-12)


def test_pair_kernel_on_jax_pieces(mouse_geno, setup):
    """The same pieces, handed over as numpy arrays, give the same pair
    statistics as a float64 numpy evaluation."""
    _, _, pymat, pvpmat = setup
    pieces = score_pieces_from_numpy(pymat, pvpmat, "cpu")
    mat = np.asarray(additive_code(jnp.asarray(mouse_geno))[0])
    c0, c1 = np.array([0, 5, 17]), np.array([3, 900, 1406])
    eff, var, chi, p = _pair_kernel(torch.as_tensor(c0), torch.as_tensor(c1),
                                    torch.as_tensor(mat), torch.as_tensor(mat),
                                    pieces.pymat, pieces.pvpmat)
    e = mat[:, c0] * mat[:, c1]
    np.testing.assert_allclose(eff.numpy(), e.T @ pymat, rtol=1e-10)
    np.testing.assert_allclose(var.numpy(), np.sum(e * (pvpmat @ e), axis=0),
                               rtol=1e-10)
    np.testing.assert_allclose(chi.numpy(), eff.numpy() ** 2 / var.numpy(),
                               rtol=1e-12)


def _load(path):
    return np.loadtxt(path, skiprows=1, ndmin=2)


def test_epiAA_pair_matches_golden_and_jax(tmp_path, mouse_pheno,
                                           mouse_prefix, setup):
    ag, _, _, _ = setup
    gold = np.load(GOLDEN / "epiAA_pairs.npz")
    pair_file = str(tmp_path / "pairs")
    np.savetxt(pair_file, gold["pairs"], fmt="%d", header="snp_0 snp_1",
               comments="")
    out_t, out_j = str(tmp_path / "t"), str(tmp_path / "j")
    remma_epiAA_pair(mouse_pheno, mouse_prefix, [ag, ag * ag],
                     gold["var_com"], pair_file, p_cut=1.1, out_file=out_t,
                     device="cpu")
    j_remma_epiAA_pair(mouse_pheno, mouse_prefix, [ag, ag * ag],
                       gold["var_com"], pair_file, p_cut=1.1, out_file=out_j)
    got, want, ref = _load(out_t), _load(out_j), gold["res"]
    assert open(out_t).readline() == open(out_j).readline()
    assert got.shape == ref.shape == want.shape
    np.testing.assert_array_equal(got[:, :2], ref[:, :2])
    np.testing.assert_allclose(got[:, 2:], ref[:, 2:], rtol=1e-6, atol=1e-12)
    np.testing.assert_allclose(got[:, 2:], want[:, 2:], rtol=1e-6, atol=1e-12)


def test_epiAA_pair_p_cut_filters(tmp_path, mouse_pheno, mouse_prefix, setup):
    ag, var_com, _, _ = setup
    gold = np.load(GOLDEN / "epiAA_pairs.npz")
    pair_file = str(tmp_path / "pairs")
    np.savetxt(pair_file, gold["pairs"], fmt="%d", header="snp_0 snp_1",
               comments="")
    out = str(tmp_path / "res")
    remma_epiAA_pair(mouse_pheno, mouse_prefix, [ag, ag * ag], var_com,
                     pair_file, max_test_pair=100, p_cut=0.05, out_file=out,
                     device="cpu")
    rows = _load(out)
    assert len(rows) and np.all(rows[:, 5] < 0.05)
    np.savetxt(pair_file, np.empty((0, 2)), fmt="%d", header="snp_0 snp_1",
               comments="")
    remma_epiAA_pair(mouse_pheno, mouse_prefix, [ag, ag * ag], var_com,
                     pair_file, out_file=out, device="cpu")
    assert open(out).read().split() == "snp_0 snp_1 eff var chi p".split()


def test_screen_AA_matches_oracle(tmp_path, mouse_geno, mouse_pheno,
                                  mouse_prefix, setup):
    """The bracket of tests/test_screen.py::test_screen_AA_matches_oracle."""
    ag, var_com, pymat, _ = setup
    mat = np.asarray(additive_code(jnp.asarray(mouse_geno))[0])
    eff = (mat * pymat[:, None]).T @ mat
    m = eff.shape[0]
    tri = np.triu_indices(m, k=1)
    cut = np.quantile(np.abs(eff[tri]), 1 - 2e-4)
    var_app = cut * cut / 19.511420964657572  # chi2.isf(1e-5, 1)
    out = str(tmp_path / "eff")
    remma_epiAA_eff(mouse_pheno, mouse_prefix, [ag, ag * ag], var_com,
                    var_app=var_app, p_cut=1e-5, out_file=out, device="cpu")
    got = _load(out)
    got_set = {(int(r[0]), int(r[1])) for r in got}
    margin = 1e-4 * cut
    absd = np.abs(eff[tri])
    want_core = set(zip(tri[0][absd > cut + margin].tolist(),
                        tri[1][absd > cut + margin].tolist()))
    want_max = set(zip(tri[0][absd > cut - margin].tolist(),
                       tri[1][absd > cut - margin].tolist()))
    assert len(want_core) > 100 and want_core <= got_set <= want_max
    np.testing.assert_allclose(got[:, 2], eff[got[:, 0].astype(int),
                                              got[:, 1].astype(int)],
                               rtol=1e-5)
    np.testing.assert_allclose(got[:, 3], got[:, 2] ** 2 / var_app, rtol=1e-4)


def test_unported_screens_raise(tmp_path, mouse_pheno, mouse_prefix, setup):
    ag, var_com, _, _ = setup
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        remma_epiAA_eff(mouse_pheno, mouse_prefix, [ag, ag * ag], var_com,
                        snp_lst_0=[0, 1, 2], out_file=str(tmp_path / "e"),
                        device="cpu")


def _workflow(pkg, workdir, **kw):
    """The README's four steps, on a copy of the mouse fixture."""
    workdir.mkdir()
    for ext in (".bed", ".bim", ".fam"):
        shutil.copy(DATA / f"plink{ext}", workdir / f"plink{ext}")
    prefix, pheno = str(workdir / "plink"), str(DATA / "pheno")
    ag, _ = pkg.agmat(prefix, **kw)
    var = pkg.wemai_multi_gmat(pheno, prefix, [ag, ag * ag],
                               out_file=str(workdir / "var.txt"), **kw)
    pkg.remma_epiAA_approx(pheno, prefix, [ag, ag * ag], var, p_cut=1e-4,
                           num_random_pair=20000,
                           out_file=str(workdir / "epiAA"), **kw)
    pkg.annotation_snp_pos(str(workdir / "epiAA"), prefix, p_cut=1e-4)
    return workdir


@pytest.fixture(scope="module")
def workflows(tmp_path_factory):
    base = tmp_path_factory.mktemp("workflow")
    return (_workflow(gmat_tpu_torch, base / "torch", device="cpu"),
            _workflow(gmat_tpu, base / "jax"))


def test_workflow_grm_and_variances(workflows):
    t, j = workflows
    np.testing.assert_allclose(np.loadtxt(t / "plink.agrm0"),
                               np.loadtxt(j / "plink.agrm0"),
                               rtol=1e-12, atol=1e-13)
    np.testing.assert_allclose(np.loadtxt(t / "var.txt"),
                               np.loadtxt(j / "var.txt"), rtol=1e-6)


def test_workflow_epiAA_table(workflows, mouse_pheno, mouse_prefix):
    t, j = workflows
    head = "snp_0 snp_1 eff var chi p_app p"
    assert open(t / "epiAA").readline().strip() == head
    assert open(j / "epiAA").readline().strip() == head
    got, want = _load(t / "epiAA"), _load(j / "epiAA")
    assert len(got) > 50
    np.testing.assert_allclose(got[:, 4], got[:, 2] ** 2 / got[:, 3],
                               rtol=1e-6)
    # the screen cut of the run: sqrt(chi2.isf(p_cut) * median calibration var)
    from scipy.stats import chi2

    pairs = gmat_tpu_torch.random_pair(1407, out_file=str(t / "rp"),
                                       num_pair=20000)
    var_com = np.loadtxt(t / "var.txt")
    ag = np.loadtxt(t / "plink.agrm0")
    remma_epiAA_pair(mouse_pheno, mouse_prefix, [ag, ag * ag], var_com,
                     str(t / "rp"), p_cut=1.1, out_file=str(t / "rp.res"),
                     device="cpu")
    assert len(pairs) == 20000
    cut = np.sqrt(chi2.isf(1e-4, 1) * np.median(_load(t / "rp.res")[:, 3]))
    key_t = {(int(a), int(b)): r for a, b, *r in got}
    key_j = {(int(a), int(b)): r for a, b, *r in want}
    for k in set(key_t) ^ set(key_j):
        eff = (key_t.get(k) or key_j.get(k))[0]
        assert abs(abs(eff) - cut) <= 1e-4 * cut, k
    common = sorted(set(key_t) & set(key_j))
    assert len(common) > 50
    a = np.array([key_t[k] for k in common])
    b = np.array([key_j[k] for k in common])
    cols = [0, 1, 2, 4]  # eff var chi p
    np.testing.assert_allclose(a[:, cols], b[:, cols], rtol=1e-8, atol=1e-300)
    # p_app comes from the float32 screen's eff printed with %g (6 digits)
    np.testing.assert_allclose(a[:, 3], b[:, 3], rtol=1e-3)


def test_workflow_annotation(workflows, tmp_path, mouse_prefix):
    t, j = workflows
    got = pd.read_csv(t / "epiAA.anno", sep=" ", dtype=str)
    want = pd.read_csv(j / "epiAA.anno", sep=" ", dtype=str)
    assert list(got.columns) == list(want.columns)
    keys = ["snp_0", "snp_1"]
    both = got.merge(want, on=keys, suffixes=("_t", "_j"))
    assert len(both) >= min(len(got), len(want)) - 2
    for c in got.columns[:14].drop(keys):  # the verbatim .bim tokens
        assert (both[c + "_t"] == both[c + "_j"]).all(), c
    # the same table annotates to byte-identical files in both packages
    shutil.copy(j / "epiAA", tmp_path / "res")
    gmat_tpu_torch.annotation_snp_pos(str(tmp_path / "res"), mouse_prefix,
                                      p_cut=1e-4)
    assert filecmp.cmp(tmp_path / "res.anno", j / "epiAA.anno", shallow=False)


@pytest.mark.parametrize("fn", ["random_pair", "random_pairAD"])
def test_random_pairs_match_jax(tmp_path, fn):
    """Both packages draw the same pairs from one seed and write the same
    file."""
    from gmat_tpu.scan import random_pair as j_rp
    from gmat_tpu_torch.scan import random_pair as t_rp

    got = getattr(t_rp, fn)(300, out_file=str(tmp_path / "t"), num_pair=6000,
                            num_each_pair=1000, seed=11)
    want = getattr(j_rp, fn)(300, out_file=str(tmp_path / "j"), num_pair=6000,
                             num_each_pair=1000, seed=11)
    np.testing.assert_array_equal(got, want)
    assert filecmp.cmp(tmp_path / "t", tmp_path / "j", shallow=False)


def test_import_pulls_in_no_jax():
    code = ("import sys, gmat_tpu_torch, gmat_tpu_torch.scan.kernels, "
            "gmat_tpu_torch.scan.pairs, gmat_tpu_torch.scan.single; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'gmat_tpu.')) or m == 'gmat_tpu']; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=120)
