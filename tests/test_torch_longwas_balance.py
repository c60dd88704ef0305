"""The balanced longwas slice of gmat_tpu_torch (Legendre bases, data
parsing, the eigen-space REML, the fixed and trans GWAS and their
permutation twins) vs the JAX package and the reference goldens, on
tests/data/mouse_long with the same numpy inputs.

Tolerances: host helpers (Legendre bases, parsing, kinship, the fixed
formula, OLS) at rtol 1e-12 against the JAX package; the EM matrix at
rtol 1e-10; one fd/AI evaluation
at the golden variances against `balance._fdai_step` at rtol 1e-9 with an
absolute floor of 1e-9 of each vector's largest entry (fd nearly cancels
there, and the port's closed-form V_i⁻¹ differs from the JAX package's
direct inverse in the last bits); the entry points at the JAX tests' own
tolerances against tests/golden: `balance_varcom` rtol 1e-6, trans eff and
chi rtol 1e-5 and p 1e-4, fixed rtol 1e-6 (p atol 1e-12); the fixed
permutation twin rtol 1e-6 against longwas_permutation.npz; the trans
permutation twin, whose golden is tied to one eigensolver's signs, against
the JAX package on the same eigenbasis at rtol 1e-8, and byte for byte
against itself under the same seed.  The `cuda` case holds the card's
results to the CPU's at rtol 1e-9, with a floor of 1e-9 of each column's
largest value (an eff that cancels, a small variance after a few REML
rounds: cuBLAS and the CPU BLAS sum in other orders), and skips without
a card:
    python -m pytest --noconftest -m cuda tests/test_torch_longwas_balance.py
"""
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch
from scipy import linalg as sla

from gmat_tpu_torch.longwas import balance as tbal
from gmat_tpu_torch.longwas import balance_gwas as tbg
from gmat_tpu_torch.longwas import data as tdata
from gmat_tpu_torch.longwas import legendre as tleg

ROOT = Path(__file__).resolve().parents[1]
DATA = Path(__file__).parent / "data"
GOLDEN = Path(__file__).parent / "golden"
ML = DATA / "mouse_long"
PHE = str(ML / "phe.balance.txt")
TPOINT = np.array(range(16)) + 1.0
TRAIT = list(range(2, 18))
SNPS = list(range(30))
SEED = 42  # the permutation goldens' seed (tests/test_permutation.py)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The suite runs in several pytest-xdist workers at once: one torch
    thread per worker keeps the CPU work from oversubscribing the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The port's GRM file of the mouse_long panel and the golden
    variances as the tidy frame."""
    from gmat_tpu_torch.grm.grm import agmat

    tmp = tmp_path_factory.mktemp("tml")
    prefix = str(tmp / "plink")
    for ext in (".bed", ".bim", ".fam"):
        shutil.copy(str(ML / ("plink" + ext)), prefix + ext)
    agmat(prefix, inv=False, out_fmt="id_id_val", device="cpu")
    return prefix + ".agrm2", _var_frame("longwas_balance_var.npz")


def _var_frame(name):
    g = np.load(GOLDEN / name)
    return pd.DataFrame({k: g[k] for k in ("vari", "varij", "varik",
                                           "var_val")})


def _gold(key):
    g = np.load(GOLDEN / "longwas_balance_gwas.npz")
    return pd.DataFrame(g[key], columns=list(g[key + "_cols"]))


def _close(got, want, cols, rtol, atol=1e-10):
    for col in cols:
        np.testing.assert_allclose(got[col], want[col], rtol=rtol, atol=atol,
                                   err_msg=col)


# host helpers ----------------------------------------------------------------

@pytest.mark.parametrize("name", ["leg_basis", "leg", "leg_mt"])
def test_legendre_matches_jax(name):
    from gmat_tpu.longwas import legendre as jleg

    t = np.linspace(1.0, 16.0, 37)
    args = {"leg_basis": (t, 4), "leg": (t, 3), "leg_mt": (t, 20.0, 0.5, 3)}
    got = getattr(tleg, name)(*args[name])
    want = getattr(jleg, name)(*args[name])
    np.testing.assert_allclose(np.hstack(got), np.hstack(want), rtol=1e-12,
                               atol=0)


@pytest.fixture(scope="module")
def small_file(tmp_path_factory):
    """The first 12 records of the balanced file with two missing values."""
    lines = open(PHE).read().splitlines()[:13]
    cells = [ln.split() for ln in lines]
    cells[3][4] = "NA"
    cells[7][9] = "NA"
    path = tmp_path_factory.mktemp("small") / "phe.small.txt"
    path.write_text("\n".join(" ".join(c) for c in cells) + "\n")
    return str(path)


@pytest.mark.parametrize("na_method", ["omit", "include"])
def test_parse_long_data_matches_jax(small_file, na_method):
    from gmat_tpu.longwas import data as jdata

    got = tdata.parse_long_data(small_file, "ID", na_method)
    want = jdata.parse_long_data(small_file, "ID", na_method)
    pd.testing.assert_frame_equal(got.df, want.df, rtol=1e-12)
    assert got.class_vec == want.class_vec
    assert got.code_dct == want.code_dct
    assert len(got.df) == (10 if na_method == "omit" else 12)
    assert got.raw_ids_in_code_order() == want.raw_ids_in_code_order()


def test_check_sorted_by_id_raises(tmp_path):
    df = pd.read_csv(ML / "phe.unbalance.txt", sep=r"\s+").iloc[:40]
    path = tmp_path / "unsorted.txt"
    df.iloc[np.r_[0:10, 20:30, 10:20, 30:40]].to_csv(path, sep=" ",
                                                     index=False)
    with pytest.raises(ValueError, match="not sorted"):
        tdata.check_sorted_by_id(tdata.parse_long_data(str(path), "ID"))
    tdata.check_sorted_by_id(tdata.parse_long_data(
        str(ML / "phe.unbalance.txt"), "ID"))


@pytest.mark.parametrize("add_missing", [False, True])
def test_read_kin_by_codes_matches_jax(setup, tmp_path, add_missing):
    """With add_missing the file's ids beyond the data's 50 get new codes."""
    from gmat_tpu.longwas import data as jdata

    kin_file, _ = setup
    path = str(tmp_path / "phe50.txt")
    pd.read_csv(PHE, sep=r"\s+").iloc[:50].to_csv(path, sep=" ", index=False)
    tdat, jdat = (m.parse_long_data(path, "ID") for m in (tdata, jdata))
    got = tdata.read_kin_by_codes(kin_file, tdat, add_missing=add_missing)
    want = jdata.read_kin_by_codes(kin_file, jdat, add_missing=add_missing)
    assert got.shape == want.shape == ((1212, 1212) if add_missing else (50, 50))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
    assert tdat.code_dct == jdat.code_dct


def test_fixed_formula_and_lm_match_jax():
    from gmat_tpu.longwas import data as jdata

    path = str(ML / "phe.unbalance.txt")
    tdat, jdat = (m.parse_long_data(path, "ID") for m in (tdata, jdata))
    for fix, width in (("Sex", 1), ("Sex + weak", 2)):
        got = tdata.build_fixed_formula(tdat, fix)
        want = jdata.build_fixed_formula(jdat, fix)
        assert got.shape == (19392, width)
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
    assert tdata.build_fixed_formula(tdat, None) is None
    y = tdat.df["trait"].to_numpy()
    xmat = np.column_stack([np.ones(len(y)), got])
    for a, b in zip(tdata.longwas_lm(y, xmat), jdata.longwas_lm(y, xmat)):
        np.testing.assert_allclose(a, b, rtol=1e-12)


# the REML --------------------------------------------------------------------

def test_fdai_matches_jax(setup):
    """One fd/AI evaluation and the EM matrix at the golden variances, both
    packages on the JAX package's rotated data."""
    import jax.numpy as jnp
    from gmat_tpu.longwas import balance as jbal

    kin_file, var_df = setup
    model = jbal.prepare_balance(PHE, "ID", TPOINT, TRAIT, kin_file)
    var = var_df["var_val"].to_numpy()
    vind = jbal.var_index(4)
    ka, kp, res = jbal.unpack_cov(4, var)
    fd_j, ai_j = (np.asarray(a) for a in jbal._fdai_step(
        jnp.asarray(model.y), jnp.asarray(model.xmat),
        jnp.asarray(model.leg_tp), jnp.asarray(model.eigvals),
        jnp.asarray(ka), jnp.asarray(kp), res,
        jnp.asarray(jbal._tit_stack(model.leg_tp, vind)),
        jnp.asarray(vind[:-1, 0] == 0), jnp.asarray(vind[:-1, 1]),
        jnp.asarray(vind[:-1, 2]), cov_dim=4))
    dev = torch.device("cpu")
    tit, is_add, jj, kk = tbal._tensors(model.leg_tp, vind, dev)
    cov_add, cov_per, res_var = tbal._cov_from_vec(
        torch.as_tensor(var)[None], 4, 4)
    fd, ai = tbal._fdai(torch.as_tensor(model.y),
                        torch.as_tensor(model.xmat)[None],
                        torch.as_tensor(model.leg_tp),
                        torch.as_tensor(model.eigvals), cov_add, cov_per,
                        res_var, tit, is_add, jj, kk)
    np.testing.assert_allclose(fd[0].numpy(), fd_j, rtol=1e-9,
                               atol=1e-9 * np.abs(fd_j).max())
    np.testing.assert_allclose(ai[0].numpy(), ai_j, rtol=1e-9,
                               atol=1e-9 * np.abs(ai_j).max())
    em_args = (4, ka, kp, len(model.eigvals), var, model.y.size)
    np.testing.assert_allclose(tbal.em_mat_eigen(*em_args, device="cpu"),
                               jbal.em_mat_eigen(*em_args), rtol=1e-10,
                               atol=0)


def test_balance_varcom_golden(setup, tmp_path):
    kin_file, _ = setup
    gold = np.load(GOLDEN / "longwas_balance_var.npz")
    res = tbal.balance_varcom(PHE, "ID", TPOINT, TRAIT, kin_file, maxiter=5,
                              prefix_outfile=str(tmp_path / "bvar"),
                              device="cpu")
    np.testing.assert_array_equal(res["vari"], gold["vari"])
    np.testing.assert_array_equal(res["varij"], gold["varij"])
    np.testing.assert_allclose(res["var_val"], gold["var_val"], rtol=1e-6,
                               atol=1e-10)
    disk = np.loadtxt(str(tmp_path / "bvar") + ".var", skiprows=1)
    np.testing.assert_allclose(disk[:, 3], res["var_val"], rtol=1e-12)


def test_weight_search_rejects_zero_residual():
    """A candidate whose residual is exactly 0 fails the PD test and the
    next gamma is taken (the JAX package's `_pd_ok` admits it)."""
    from gmat_tpu.longwas import balance_gwas as jbg

    var = tbal.default_init(np.arange(10.0), 4)
    var[-1] = 1.0
    nv = len(var)
    fd = np.zeros(nv)
    fd[-1] = -0.5  # at gamma 0: var_e + fd / 0.5 = 0 exactly
    gamma, delta = tbal.weight_search(0.5 * np.eye(nv), np.eye(nv), fd, var,
                                      4, 0.001, device="cpu")
    assert gamma == 0.001
    np.testing.assert_allclose(delta[-1], -0.5 / 0.5005, rtol=1e-15)
    ca, cp, res = tbal._cov_from_vec(torch.as_tensor(var)[None], 4, 4)
    assert bool(tbal._pd_ok(ca, cp, res)[0])
    assert not bool(tbal._pd_ok(ca, cp, torch.zeros(1, dtype=res.dtype))[0])
    assert bool(jbg._pd_ok(ca.numpy(), cp.numpy(), np.zeros(1))[0])


# the GWAS ---------------------------------------------------------------------

def test_trans_golden(setup, tmp_path):
    kin_file, var_df = setup
    res = tbg.balance_longwas_trans(
        PHE, "ID", TPOINT, TRAIT, kin_file, str(ML / "plink"), var_df,
        snp_lst=SNPS, prefix_outfile=str(tmp_path / "btrans"), device="cpu")
    want = _gold("trans")
    _close(res, want, ("eff0", "eff1", "eff2", "eff3", "chi_val"), 1e-5)
    _close(res, want, ("p_val", "p_min", "p_accum"), 1e-4, atol=1e-12)
    disk = pd.read_csv(str(tmp_path / "btrans.res"), sep=" ")
    assert list(disk.columns) == list(res.columns)


def test_precision_values(setup, tmp_path):
    """'f32' computes in float64 like 'auto'; an unknown value raises."""
    kin_file, var_df = setup
    args = (PHE, "ID", TPOINT, TRAIT, kin_file, str(ML / "plink"), var_df)
    a = tbg.balance_longwas_trans(*args, snp_lst=SNPS[:5], precision="f32",
                                  prefix_outfile=str(tmp_path / "a"),
                                  device="cpu")
    b = tbg.balance_longwas_trans(*args, snp_lst=SNPS[:5],
                                  prefix_outfile=str(tmp_path / "b"),
                                  device="cpu")
    pd.testing.assert_frame_equal(a, b, check_exact=True)
    with pytest.raises(ValueError, match="precision"):
        tbg.balance_longwas_trans(*args, snp_lst=SNPS[:5], precision="bf16",
                                  device="cpu")


def test_fixed_golden(setup, tmp_path):
    kin_file, var_df = setup
    res = tbg.balance_longwas_fixed(
        PHE, "ID", TPOINT, TRAIT, kin_file, str(ML / "plink"), var_df,
        snp_lst=SNPS, prefix_outfile=str(tmp_path / "bfix"), snp_batch=16,
        device="cpu")
    want = _gold("fixed")
    np.testing.assert_allclose(res["chi_val"], want["chi_val"], rtol=1e-6)
    _close(res, want, ("p_val",), 1e-6, atol=1e-12)
    _close(res, want, ("eff0", "eff1", "eff2", "eff3"), 1e-6)
    assert list(res.columns[:8]) == ["order", "chro", "snp_ID", "pos",
                                     "allele1", "allele2", "cc_par_val",
                                     "cc_gra_val"]


def test_fixed_permutation_golden(setup, tmp_path):
    kin_file, _ = setup
    gold = np.load(GOLDEN / "longwas_permutation.npz")
    tbg.balance_longwas_fixed_permutation(
        PHE, "ID", TPOINT, TRAIT, kin_file, str(ML / "plink"),
        _var_frame("longwas_balance_var.npz"), permutation_lst=[0, 1],
        snp_lst=SNPS, seed=SEED, prefix_outfile=str(tmp_path / "bfp"),
        device="cpu")
    for rep in (0, 1):
        got = pd.read_csv(f"{tmp_path / 'bfp'}.{rep}", sep=r"\s+")
        want = pd.DataFrame(gold[f"balance_fixed_{rep}"],
                            columns=list(gold[f"balance_fixed_cols_{rep}"]))
        _close(got, want, ("eff0", "eff1", "eff2", "eff3", "chi_val",
                           "p_val"), 1e-6)


def test_trans_permutation_matches_jax_on_one_basis(setup, tmp_path,
                                                    monkeypatch):
    """The rotated rows are shuffled, so replicates depend on the
    eigenvectors' signs: the port is handed scipy's basis, the one the JAX
    package takes (`prepare_balance`'s `sla.eigh(kin)`)."""
    from gmat_tpu.longwas import balance_gwas as jbg

    kin_file, var_df = setup
    monkeypatch.setattr(tbal, "_kin_eigh", lambda kin: tuple(
        torch.as_tensor(a, device=kin.device)
        for a in sla.eigh(kin.cpu().numpy())))
    args = (PHE, "ID", TPOINT, TRAIT, kin_file, str(ML / "plink"), var_df)
    kw = dict(permutation_lst=[0, 1], snp_lst=SNPS, seed=SEED)
    got = tbg.balance_longwas_trans_permutation(
        *args, prefix_outfile=str(tmp_path / "t"), device="cpu", **kw)
    want = jbg.balance_longwas_trans_permutation(
        *args, prefix_outfile=str(tmp_path / "j"), **kw)
    for g, w in zip(got, want):
        _close(g, w, ("eff0", "eff1", "eff2", "eff3", "chi_val", "p_val",
                      "p_min", "p_accum"), 1e-8, atol=0)
    tbg.balance_longwas_trans_permutation(
        *args, prefix_outfile=str(tmp_path / "t2"), device="cpu",
        permutation_lst=[0], snp_lst=SNPS, seed=SEED)
    assert (tmp_path / "t2.0").read_bytes() == (tmp_path / "t.0").read_bytes()


def test_import_pulls_in_no_jax():
    code = ("import sys, gmat_tpu_torch.longwas.balance_gwas, "
            "gmat_tpu_torch.longwas.unbalance_gwas; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'gmat_tpu.')) or m == 'gmat_tpu']; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=120)


# the card: the same entry points on CUDA against the CPU ---------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


@pytest.mark.cuda
def test_card_matches_cpu(cuda, setup, tmp_path):
    kin_file, var_df = setup
    args = (PHE, "ID", TPOINT, TRAIT, kin_file)
    res = {}
    for dev in ("cpu", cuda):
        var = tbal.balance_varcom(*args, maxiter=3, device=dev,
                                  prefix_outfile=str(tmp_path / "v"))
        gw = [fn(*args, str(ML / "plink"), var_df, snp_lst=SNPS, device=dev,
                 prefix_outfile=str(tmp_path / "g"))
              for fn in (tbg.balance_longwas_trans, tbg.balance_longwas_fixed)]
        res[str(dev)] = (var, *gw)
    for got, want in zip(res[str(cuda)], res["cpu"]):
        for col in want.columns:
            if col.startswith(("var_val", "eff", "chi", "p_")):
                np.testing.assert_allclose(got[col], want[col], rtol=1e-9,
                                           atol=1e-9 * np.abs(want[col]).max(),
                                           err_msg=col)
