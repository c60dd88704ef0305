"""The uvlmm family of gmat_tpu_torch (eigen REML, the MME REML variants,
the fixed-effect GWAS and OLS) vs the JAX package and the reference
goldens, on the mouse fixture with the same numpy inputs.

Tolerances: REML variances rtol 1e-8 against the JAX package (ai_mme:
see its case) and the JAX tests' own against tests/golden/uvlmm_extras.npz;
eigenvalues rtol 1e-10 and U·diag(λ)·Uᵀ = G at atol 1e-10 (eigenvectors
are defined up to sign, so they are not compared one by one); GWAS tables
rtol 1e-10 with a floor of 1e-12 of each column's largest value (p: rtol
1e-8, atol 1e-300); epiAA eff/p rtol 1e-8 with the
same rows.  The `cuda` case holds the card's results to the CPU's at
rtol 1e-9 and skips without a card:
    python -m pytest --noconftest -m cuda tests/test_torch_uvlmm.py
"""
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch
from scipy import sparse

from gmat_tpu_torch.io.bed import Bed, read_plink, write_bed
from gmat_tpu_torch.io.pheno import design_matrix
from gmat_tpu_torch.reml import eigen as teigen
from gmat_tpu_torch.reml import mme as tmme
from gmat_tpu_torch.scan import fixed_gwas as tfg

DATA = Path(__file__).parent / "data"
GOLDEN = Path(__file__).parent / "golden"
PREFIX, PHENO = str(DATA / "plink"), str(DATA / "pheno")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The suite runs in several pytest-xdist workers at once: one torch
    thread per worker keeps the n³ CPU work from oversubscribing the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def setup():
    gold = np.load(GOLDEN / "uvlmm_extras.npz")
    geno = read_plink(PREFIX)
    from gmat_tpu_torch.grm.grm import additive_grm

    ag = additive_grm(torch.as_tensor(geno)).numpy()
    dm = design_matrix(PHENO, PREFIX)
    return gold, ag, dm, geno


def _subset(geno, cols, prefix):
    bed = Bed(PREFIX)
    write_bed(prefix, geno[:, cols], bim=bed.bim.iloc[cols], fam=bed.fam)
    return prefix


def _assert_frames(got, want, p_rtol=1e-8):
    assert list(got.columns) == list(want.columns)
    for col in got.columns:
        g, w = got[col].to_numpy(), want[col].to_numpy()
        if col == "p_val":
            np.testing.assert_allclose(g, w, rtol=p_rtol, atol=1e-300)
        elif g.dtype.kind == "f":
            # a floor for the values that cancel to about 0 (eff of a SNP
            # with no effect), where rounding is no relative error
            np.testing.assert_allclose(g, w, rtol=1e-10,
                                       atol=1e-12 * np.abs(w).max(),
                                       err_msg=col)
        else:
            np.testing.assert_array_equal(g, w, err_msg=col)


def test_eigen_reml_matches_jax(setup):
    from gmat_tpu.reml.eigen import uvlmm_varcom_eigen as j_eigen

    gold, ag, dm, _ = setup
    var, vecs, vals = teigen.uvlmm_varcom_eigen(dm.y, dm.xmat, ag, maxiter=20,
                                                device="cpu")
    j_var, _, j_vals = j_eigen(dm.y, dm.xmat, ag, maxiter=20)
    np.testing.assert_allclose(var, j_var, rtol=1e-8)
    np.testing.assert_allclose(var, gold["var_eigen"], rtol=1e-6)
    assert vals.shape == (ag.shape[0], 1)
    np.testing.assert_allclose(vals, j_vals, rtol=1e-10)
    np.testing.assert_allclose((vecs * vals[:, 0]) @ vecs.T, ag, rtol=0,
                               atol=1e-10)


@pytest.mark.parametrize(
    "name,key,rtol_jax,rtol_gold",
    [
        ("em_mme", "mme_em_mme", 1e-8, 1e-6),
        ("pxem_mme", "mme_pxem_mme", 1e-8, 1e-6),
        # the reference diverges here (tests/test_uvlmm_extras.py tracks it
        # at 1e-3 against the golden)
        ("ai_mme", "mme_ai_mme", 1e-8, 1e-3),
        ("emai_mme", "mme_emai_mme", 1e-8, 1e-6),
        ("pxemai_mme", "mme_pxemai_mme", 1e-8, 1e-6),
    ],
)
def test_mme_variants_match_jax(setup, name, key, rtol_jax, rtol_gold):
    from gmat_tpu.reml import mme as jmme

    gold, ag, dm, _ = setup
    ag_inv = np.linalg.inv(ag)
    got = getattr(tmme, name)(dm.y, dm.xmat, ag_inv, maxiter=5, device="cpu")
    want = getattr(jmme, name)(dm.y, dm.xmat, ag_inv, maxiter=5)
    np.testing.assert_allclose(got, want, rtol=rtol_jax)
    np.testing.assert_allclose(got, gold[key], rtol=rtol_gold)


@pytest.mark.parametrize("name,key", [("em_mme_multi", "em_multi"),
                                      ("em_vmat", "em_vmat")])
def test_em_multi_and_vmat_match_jax(setup, name, key):
    """Dense Z against the JAX package; a CSR Z gives the same bits."""
    from gmat_tpu.reml import mme as jmme

    gold, ag, dm, _ = setup
    n = len(dm.y)
    if name == "em_mme_multi":
        grms = [np.linalg.inv(ag)]
    else:
        grms = [ag, ag * ag]

    def run(fn, z, **kw):
        return fn(dm.y, dm.xmat, [z] * len(grms), grms, maxiter=5, **kw)

    got = run(getattr(tmme, name), np.eye(n), device="cpu")
    want = run(getattr(jmme, name), np.eye(n))
    np.testing.assert_allclose(got, want, rtol=1e-8)
    np.testing.assert_allclose(got, gold[key], rtol=1e-6)
    got_csr = run(getattr(tmme, name), sparse.identity(n, format="csr"),
                  device="cpu")
    np.testing.assert_array_equal(got_csr, got)


@pytest.mark.parametrize("name", ["uvlmm_gwas_add", "uvlmm_gwas_dom",
                                  "uvlmm_gwas_add_eigen",
                                  "uvlmm_gwas_dom_eigen"])
def test_gwas_tables_match_jax(setup, tmp_path, name):
    from gmat_tpu.scan import fixed_gwas as jfg

    gold, ag, dm, _ = setup
    var = gold["var_2g"]
    if name.endswith("_eigen"):
        grms, var = ag, np.array([var[0], var[-1]])
    else:
        grms = [ag, ag * ag]
    out_t, out_j = str(tmp_path / "t"), str(tmp_path / "j")
    got = getattr(tfg, name)(dm.y, dm.xmat, grms, var, PREFIX,
                             out_file=out_t, device="cpu")
    want = getattr(jfg, name)(dm.y, dm.xmat, grms, var, PREFIX,
                              out_file=out_j)
    _assert_frames(got, want)
    _assert_frames(pd.read_csv(out_t, sep=" "), pd.read_csv(out_j, sep=" "))
    if name == "uvlmm_gwas_add":
        np.testing.assert_allclose(got["eff_val"], gold["add_eff"], rtol=1e-7)
        np.testing.assert_allclose(got["scale_val"], gold["add_scale"],
                                   rtol=1e-7)
        np.testing.assert_allclose(got["chi_val"], gold["add_chi"], rtol=1e-7)
        np.testing.assert_allclose(got["p_val"], gold["add_p"], rtol=1e-5,
                                   atol=1e-300)
    elif name == "uvlmm_gwas_dom":
        np.testing.assert_allclose(got["eff_val"], gold["dom_eff"], rtol=1e-7)
        np.testing.assert_allclose(got["p_val"], gold["dom_p"], rtol=1e-5,
                                   atol=1e-300)


@pytest.mark.parametrize("anchors,p_cut", [(None, 1.0), ([30, 3, 17, 38], 0.5)])
def test_gwas_epiAA_matches_jax(setup, tmp_path, anchors, p_cut):
    from gmat_tpu.scan.fixed_gwas import uvlmm_gwas_epiAA as j_epi

    gold, ag, dm, geno = setup
    sub = _subset(geno, gold["picked"], str(tmp_path / "sub"))
    args = (dm.y, dm.xmat, [ag, ag * ag], gold["var_2g"], sub)
    got = tfg.uvlmm_gwas_epiAA(*args, snp_lst_0=anchors, p_cut=p_cut,
                               out_file=str(tmp_path / "t"), device="cpu")
    want = j_epi(*args, snp_lst_0=anchors, p_cut=p_cut)
    assert len(got) == len(want) > 0
    np.testing.assert_array_equal(got["snpi"], want["snpi"])
    np.testing.assert_array_equal(got["snpj"], want["snpj"])
    np.testing.assert_allclose(got["snp_eff"], want["snp_eff"], rtol=1e-8)
    np.testing.assert_allclose(got["p_val"], want["p_val"], rtol=1e-8,
                               atol=1e-300)
    assert pd.read_csv(str(tmp_path / "t"), sep=" ").shape == got.shape
    if anchors is None:
        epi = gold["epi"]
        np.testing.assert_array_equal(got["snpi"], epi[:, 0])
        np.testing.assert_allclose(got["snp_eff"], epi[:, 2], rtol=1e-6,
                                   atol=1e-10)


def test_gwas_epiAA_constant_snp_matches_jax(setup, tmp_path):
    """A constant SNP makes its 3x3 systems singular: the port drops those
    pairs (NaN p) as the JAX package does, and raises nothing."""
    from gmat_tpu.scan.fixed_gwas import uvlmm_gwas_epiAA as j_epi

    gold, ag, dm, geno = setup
    cols = np.asarray(gold["picked"][:6])
    panel = geno[:, cols].copy()
    panel[:, 2] = 1.0  # constant
    bed = Bed(PREFIX)
    prefix = str(tmp_path / "const")
    write_bed(prefix, panel, bim=bed.bim.iloc[cols], fam=bed.fam)
    args = (dm.y, dm.xmat, [ag], gold["var_2g"][[0, 2]], prefix)
    got = tfg.uvlmm_gwas_epiAA(*args, device="cpu")
    want = j_epi(*args)
    assert len(got) == len(want) == 10  # 15 pairs, the 5 with SNP 2 dropped
    assert 2 not in set(got["snpi"]) | set(got["snpj"])
    np.testing.assert_array_equal(got[["snpi", "snpj"]].to_numpy(),
                                  want[["snpi", "snpj"]].to_numpy())
    np.testing.assert_allclose(got["snp_eff"], want["snp_eff"], rtol=1e-8)
    np.testing.assert_allclose(got["p_val"], want["p_val"], rtol=1e-8,
                               atol=1e-300)


def test_lm_files_match_jax(setup, tmp_path):
    from gmat_tpu.scan import fixed_gwas as jfg

    gold, ag, dm, geno = setup
    sub = _subset(geno, gold["picked"], str(tmp_path / "sub"))
    df = tfg.lm_snp_eff(PHENO, sub, out_file=str(tmp_path / "lm_t"),
                        device="cpu")
    jfg.lm_snp_eff(PHENO, sub, out_file=str(tmp_path / "lm_j"))
    np.testing.assert_allclose(df["eff"], gold["lm_eff"], rtol=1e-8)
    t = pd.read_csv(tmp_path / "lm_t", sep=" ", header=None)
    j = pd.read_csv(tmp_path / "lm_j", sep=" ", header=None)
    assert t.shape == j.shape == (40, 7)
    pd.testing.assert_frame_equal(t.iloc[:, :6], j.iloc[:, :6])
    np.testing.assert_allclose(t[6], j[6], rtol=1e-10)
    eff = tfg.lm_pred(PHENO, PREFIX, ag, out_file=str(tmp_path / "p_t"),
                      device="cpu")
    jfg.lm_pred(PHENO, PREFIX, ag, out_file=str(tmp_path / "p_j"))
    np.testing.assert_allclose(np.loadtxt(tmp_path / "p_t.rand_eff"),
                               np.loadtxt(tmp_path / "p_j.rand_eff"),
                               rtol=1e-10)
    np.testing.assert_array_equal(np.loadtxt(tmp_path / "p_t.rand_eff"), eff)


def test_fixed_models_need_one_record_per_individual(setup):
    gold, ag, _, _ = setup
    dm = design_matrix(str(DATA / "pheno_repeat"), PREFIX)
    with pytest.raises(ValueError, match="one record per genotyped"):
        tfg.uvlmm_gwas_add(dm.y, dm.xmat, [ag], gold["var_2g"][[0, 2]],
                           PREFIX, device="cpu")
    with pytest.raises(ValueError, match="one record per genotyped"):
        tfg.uvlmm_gwas_add_eigen(dm.y, dm.xmat, ag, gold["var_2g"][[0, 2]],
                                 PREFIX, device="cpu")


# the card: the same entry points on CUDA against the CPU ---------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


@pytest.mark.cuda
def test_card_matches_cpu(cuda, setup, tmp_path):
    gold, ag, dm, geno = setup
    res = {}
    for dev in ("cpu", cuda):
        var = teigen.uvlmm_varcom_eigen(dm.y, dm.xmat, ag, maxiter=20,
                                        device=dev)[0]
        add = tfg.uvlmm_gwas_add(dm.y, dm.xmat, [ag, ag * ag],
                                 gold["var_2g"], PREFIX, device=dev)
        sub = _subset(geno, gold["picked"], str(tmp_path / "sub"))
        epi = tfg.uvlmm_gwas_epiAA(dm.y, dm.xmat, [ag, ag * ag],
                                   gold["var_2g"], sub, device=dev)
        res[str(dev)] = (var, add, epi)
    (v0, a0, e0), (v1, a1, e1) = res["cpu"], res[str(cuda)]
    np.testing.assert_allclose(v1, v0, rtol=1e-9)
    for col in ("eff_val", "scale_val", "chi_val", "p_val"):
        np.testing.assert_allclose(a1[col], a0[col], rtol=1e-9, atol=1e-300,
                                   err_msg=col)
    np.testing.assert_array_equal(e1[["snpi", "snpj"]].to_numpy(),
                                  e0[["snpi", "snpj"]].to_numpy())
    np.testing.assert_allclose(e1[["snp_eff", "p_val"]].to_numpy(),
                               e0[["snp_eff", "p_val"]].to_numpy(), rtol=1e-9,
                               atol=1e-300)
