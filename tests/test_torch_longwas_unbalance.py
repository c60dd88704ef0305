"""The unbalanced longwas slice of gmat_tpu_torch (the MME REML, the
fixed and trans GWAS and their permutation twins) vs the JAX package and
the reference goldens, on the 150-id subset of tests/data/mouse_long that
the JAX tests use (2,400 records).

Tolerances: one `_iter_step` at the initial variances against the JAX
package at rtol 1e-9 with an absolute floor of 1e-9 of each vector's
largest entry (fd, and the update of every EM weight: the port takes the
grid through the whitened pencil, the JAX package by one solve per
weight); V⁻¹ against the JAX package's at rtol 1e-10 of its largest entry;
`unbalance_varcom(tfix="Sex")` against the JAX package at rtol 1e-8 (no
golden covers tfix); the entry points at the JAX tests' own tolerances
against tests/golden: varcom rtol 1e-5 (atol 1e-8), fixed and trans rtol
1e-6 (p 1e-5, atol 1e-12), the permutation twins rtol 1e-5 against
longwas_permutation.npz.  The `slow` case runs the full 1,212-id cohort's
REML against longwas_unbalance_var_full.npz as the JAX test does.  The
`cuda` case holds the card's results to the CPU's at rtol 1e-9, with a
floor of 1e-9 of each column's largest value (an eff that cancels, a
small variance after a few REML rounds: cuBLAS and the CPU BLAS sum in
other orders), and skips without a card:
    python -m pytest --noconftest -m cuda tests/test_torch_longwas_unbalance.py
"""
import shutil
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch

from gmat_tpu_torch.longwas import unbalance as tub
from gmat_tpu_torch.longwas import unbalance_gwas as tug

DATA = Path(__file__).parent / "data"
GOLDEN = Path(__file__).parent / "golden"
ML = DATA / "mouse_long"
N_SUB = 150
SNPS = list(range(30))
SEED = 42  # the permutation goldens' seed (tests/test_permutation.py)
COLS = ("eff0", "eff1", "eff2", "eff3", "chi_val")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The suite runs in several pytest-xdist workers at once: one torch
    thread per worker keeps the CPU work from oversubscribing the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def subset(tmp_path_factory):
    """The port's GRM and inverse of the mouse_long panel, their rows of
    the first 150 .fam ids, and those ids' records."""
    from gmat_tpu_torch.grm.grm import agmat

    tmp = tmp_path_factory.mktemp("tmlu")
    prefix = str(tmp / "plink")
    for ext in (".bed", ".bim", ".fam"):
        shutil.copy(str(ML / ("plink" + ext)), prefix + ext)
    agmat(prefix, inv=True, out_fmt="id_id_val", device="cpu")
    fam = pd.read_csv(ML / "plink.fam", sep=r"\s+", header=None, dtype=str)
    sub_ids = set(fam[1][:N_SUB])
    for src, dst in ((prefix + ".agrm2", str(tmp / "kin.sub")),
                     (prefix + ".agiv2", str(tmp / "kininv.sub"))):
        with open(src) as fin, open(dst, "w") as fout:
            for line in fin:
                a = line.split()
                if a[0] in sub_ids and a[1] in sub_ids:
                    fout.write(line)
    df = pd.read_csv(ML / "phe.unbalance.txt", sep=r"\s+", header=0,
                     dtype={"ID": str})
    data_sub = str(tmp / "phe.unbalance.sub.txt")
    df[df["ID"].isin(sub_ids)].to_csv(data_sub, sep=" ", index=False)
    return data_sub, str(tmp / "kin.sub"), str(tmp / "kininv.sub"), tmp


def _var_frame(name="longwas_unbalance_var.npz"):
    g = np.load(GOLDEN / name)
    return pd.DataFrame({k: g[k] for k in ("vari", "varij", "varik",
                                           "var_val")})


def _close(got, want, cols, rtol, atol=1e-10):
    for col in cols:
        np.testing.assert_allclose(got[col], want[col], rtol=rtol, atol=atol,
                                   err_msg=col)


def test_iter_step_matches_jax(subset):
    """fd and the blended updates of the whole EM-weight grid at the
    REML's initial variances (its first iteration)."""
    import jax.numpy as jnp
    from gmat_tpu.longwas import unbalance as jub

    data_sub, _, kininv, _ = subset
    model = jub.prepare_unbalance(data_sub, "ID", "weak", "trait", kininv)
    var = np.zeros(21)
    var[[0, 2, 5, 9, 10, 12, 15, 19, 20]] = np.var(model.y) / 9
    covi_a, _ = jub._covi(4, var[:10])
    covi_p, _ = jub._covi(4, var[10:20])
    gammas = np.append(np.arange(0.0, 1.0, 0.001), 1.0)
    tril = np.tril_indices(4)
    fd_j, d_j = (np.asarray(a) for a in jub._iter_step(
        jub._MmePieces(model), jnp.asarray(model.kin), jnp.asarray(covi_a),
        jnp.asarray(covi_p), float(var[-1]), jnp.asarray(var),
        jnp.asarray(gammas), tril, tril))
    fd, deltas = tub._iter_step(
        tub._MmePieces(model, "cpu"), torch.as_tensor(model.kin),
        torch.as_tensor(covi_a), torch.as_tensor(covi_p),
        torch.tensor(var[-1], dtype=torch.float64), torch.as_tensor(gammas))
    np.testing.assert_allclose(fd.numpy(), fd_j, rtol=1e-9,
                               atol=1e-9 * np.abs(fd_j).max())
    assert d_j.shape == deltas.shape == (1001, 21)
    diff = np.abs(deltas.numpy() - d_j)
    tol = 1e-9 * (np.abs(d_j) + np.abs(d_j).max(axis=1, keepdims=True))
    assert np.all(diff <= tol), float((diff / tol).max())


def test_variance_pieces_match_jax(subset):
    from gmat_tpu.longwas import unbalance_gwas as jug

    data_sub, kin, _, _ = subset
    model = tub.prepare_unbalance(data_sub, "ID", "weak", "trait", kin,
                                  kin_is_inverse=False)
    var_df = _var_frame()
    args = (model, jug._unpack_cov_df(var_df, 1),
            jug._unpack_cov_df(var_df, 2), float(var_df["var_val"].iloc[-1]))
    want = np.asarray(jug._variance_pieces(*args))
    got = tug._variance_pieces(*args, device="cpu").numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-10 * np.abs(want).max())


def test_unbalance_varcom_golden(subset, tmp_path):
    data_sub, _, kininv, _ = subset
    gold = np.load(GOLDEN / "longwas_unbalance_var.npz")
    res = tub.unbalance_varcom(data_sub, "ID", "weak", "trait", kininv,
                               maxiter=5, prefix_outfile=str(tmp_path / "u"),
                               device="cpu")
    np.testing.assert_array_equal(res["vari"], gold["vari"])
    np.testing.assert_array_equal(res["varij"], gold["varij"])
    np.testing.assert_allclose(res["var_val"], gold["var_val"], rtol=1e-5,
                               atol=1e-8)
    disk = pd.read_csv(str(tmp_path / "u.var"), sep=" ")
    np.testing.assert_allclose(disk["var_val"], res["var_val"], rtol=1e-12)


def test_unbalance_varcom_tfix_matches_jax(subset, tmp_path):
    """The sex-specific Legendre fixed curves (tfix): 8 fixed columns."""
    from gmat_tpu.longwas import unbalance as jub

    data_sub, _, kininv, _ = subset
    args = (data_sub, "ID", "weak", "trait", kininv)
    got = tub.unbalance_varcom(*args, tfix="Sex", maxiter=2, device="cpu",
                               prefix_outfile=str(tmp_path / "t"))
    want = jub.unbalance_varcom(*args, tfix="Sex", maxiter=2,
                                prefix_outfile=str(tmp_path / "j"))
    np.testing.assert_allclose(got["var_val"], want["var_val"], rtol=1e-8)


@pytest.mark.parametrize("which", ["fixed", "trans"])
def test_gwas_golden(subset, tmp_path, which):
    data_sub, kin, _, _ = subset
    fn = getattr(tug, f"unbalance_longwas_{which}")
    res = fn(data_sub, "ID", "weak", "trait", str(ML / "plink"), kin,
             _var_frame(), snp_lst=SNPS, device="cpu",
             prefix_outfile=str(tmp_path / which))
    g = np.load(GOLDEN / "longwas_unbalance_gwas.npz")
    want = pd.DataFrame(g[which], columns=list(g[which + "_cols"]))
    _close(res, want, COLS, 1e-6)
    cols_p = ("p_val", "p_min", "p_accum") if which == "fixed" else ("p_val",)
    _close(res, want, cols_p, 1e-5, atol=1e-12)
    disk = pd.read_csv(str(tmp_path / which) + ".res", sep=" ")
    np.testing.assert_allclose(disk["chi_val"], res["chi_val"], rtol=1e-12)


@pytest.mark.parametrize("which", ["fixed", "trans"])
def test_permutation_golden(subset, tmp_path, which):
    data_sub, kin, _, _ = subset
    fn = getattr(tug, f"unbalance_longwas_{which}_permutation")
    fn(data_sub, "ID", "weak", "trait", str(ML / "plink"), kin, _var_frame(),
       permutation_lst=[0, 1], snp_lst=SNPS, seed=SEED, device="cpu",
       prefix_outfile=str(tmp_path / "up"))
    gold = np.load(GOLDEN / "longwas_permutation.npz")
    cols = COLS + (("p_val", "p_min", "p_accum") if which == "fixed"
                   else ("p_val",))
    for rep in (0, 1):
        got = pd.read_csv(f"{tmp_path / 'up'}.{rep}", sep=r"\s+")
        key = f"unbalance_{which}"
        want = pd.DataFrame(gold[f"{key}_{rep}"],
                            columns=list(gold[f"{key}_cols_{rep}"]))
        _close(got, want, cols, 1e-5)


@pytest.mark.slow
def test_unbalance_varcom_full_cohort_golden(subset, tmp_path):
    """The full 1,212-id cohort (19,392 records; 9,700 MME unknowns)."""
    _, _, _, tmp = subset
    gold = np.load(GOLDEN / "longwas_unbalance_var_full.npz")
    res = tub.unbalance_varcom(str(ML / "phe.unbalance.txt"), "ID", "weak",
                               "trait", str(tmp / "plink.agiv2"),
                               maxiter=int(gold["maxiter"]), device="cpu",
                               prefix_outfile=str(tmp_path / "full"))
    np.testing.assert_array_equal(res["vari"], gold["vari"])
    np.testing.assert_allclose(res["var_val"], gold["var_val"], rtol=1e-5,
                               atol=1e-8)


# the card: the same entry points on CUDA against the CPU ---------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


@pytest.mark.cuda
def test_card_matches_cpu(cuda, subset, tmp_path):
    data_sub, kin, kininv, _ = subset
    res = {}
    for dev in ("cpu", cuda):
        var = tub.unbalance_varcom(data_sub, "ID", "weak", "trait", kininv,
                                   maxiter=3, device=dev,
                                   prefix_outfile=str(tmp_path / "v"))
        gw = [fn(data_sub, "ID", "weak", "trait", str(ML / "plink"), kin,
                 _var_frame(), snp_lst=SNPS, device=dev,
                 prefix_outfile=str(tmp_path / "g"))
              for fn in (tug.unbalance_longwas_fixed,
                         tug.unbalance_longwas_trans)]
        res[str(dev)] = (var, *gw)
    for got, want in zip(res[str(cuda)], res["cpu"]):
        for col in want.columns:
            if col.startswith(("var_val", "eff", "chi", "p_")):
                np.testing.assert_allclose(got[col], want[col], rtol=1e-9,
                                           atol=1e-9 * np.abs(want[col]).max(),
                                           err_msg=col)
