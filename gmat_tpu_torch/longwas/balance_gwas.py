"""Balanced longitudinal GWAS: fixed-regression and linear-transformation tests.

Counterpart of `gmat_tpu/longwas/balance_gwas.py`.  Parity targets
(reference GMAT gmat/longwas/balance/):
- `balance_longwas_fixed` (balance_longwas_fixed.py:14-243 +
  balance_longwas_emai.py:13-95): per SNP, append SNP x Legendre fixed
  columns (rotated), re-run a short (maxiter=10) EM+AI REML, Wald
  chi-square on the SNP coefficients, plus per-timepoint p values, p_min
  and accumulated-effect p.
- `balance_longwas_trans` (balance_longwas_trans.py:185-269): single V/P
  computation, per SNP the effect is recovered from GBLUP retransformation
  snp_eff = K_a Phiᵀ (sum_i s_i py_i); no per-SNP REML.
- `*_permutation` twins (balance_longwas_fixed_permutation.py:185-252):
  shuffle individual rows of the SNP matrix per replicate (seeded here) and
  rerun, one result file per replicate.

The per-SNP REML is a plain loop over `maxiter` on tensors of shape
(S, ...) for a batch of S SNPs, through `balance._fdai` (the same fd/AI as
`balance_varcom`); converged SNPs are frozen and the loop leaves early
once every SNP of the batch has converged.  The trans test is a few
batched products for all SNPs.  Float64 on the device throughout: the
`precision=` argument takes the JAX package's values and changes nothing
(the card has native FP64), and no environment variable is read.

`_unpack_cov_df`, `_tpoint_stats`, `_result_frame` and
`_permutation_driver` also serve `unbalance_gwas`.
"""
from __future__ import annotations

import os
from functools import partial

import numpy as np
import pandas as pd
import torch

from gmat_tpu_torch.config import as_exact, resolve_device
from gmat_tpu_torch.core.stats import chi2_sf
from gmat_tpu_torch.longwas.balance import (
    BalanceModel,
    _cov_from_vec,
    _em_core,
    _fdai,
    _gls,
    _grid,
    _model_pieces,
    _search,
    _tensors,
    _weight_deltas,
    prepare_balance,
    var_index,
)
from gmat_tpu_torch.longwas.legendre import leg_basis

def _resolve_dtype(precision: str):
    """The compute dtype: float64 for every accepted `precision`
    ('auto', 'f32', 'f64', as the JAX package takes them); anything else
    raises.  The JAX package's f32 path exists because f64 is emulated on
    its TPU; the H100 has native FP64."""
    if str(precision).lower() not in ("auto", "f32", "f64"):
        raise ValueError(f"unknown longwas precision {precision!r}")
    return torch.float64


def _unpack_cov_df(var_com_df, block):
    sub = var_com_df[var_com_df["vari"] == block]
    dim = int(sub["varij"].max())
    m = np.zeros((dim, dim))
    m[np.asarray(sub["varij"]) - 1, np.asarray(sub["varik"]) - 1] = sub["var_val"]
    return m + np.tril(m, -1).T


def _load_snp(model: BalanceModel, bed_prefix, snp_lst):
    """Raw (uncentered — reference parity) SNP matrix rows matched to the
    data order, on the host."""
    from gmat_tpu_torch.scan.common import prepare_genotypes

    geno, bim, fam = prepare_genotypes(bed_prefix)
    id_geno = list(fam["iid"].astype(str))
    raw_ids = model.data.raw_ids_in_code_order()
    missing = set(raw_ids) - set(id_geno)
    if missing:
        raise ValueError(f"ids not in the snp file: {sorted(missing)[:5]}")
    rows = [id_geno.index(i) for i in raw_ids]
    if snp_lst is None:
        snp_lst = list(range(geno.shape[1]))
    snp_lst = list(snp_lst)
    return geno[np.ix_(rows, snp_lst)], bim, snp_lst, geno.shape[0]


def _tpoint_stats(eff, eff_var, ltm):
    """Per-timepoint chi (S, T) and the accumulated-effect chi (S,) of
    effects (S, cd) with variances (S, cd, cd) (reference
    balance_longwas_fixed.py:211-222)."""
    et = eff @ ltm.T
    vt = torch.einsum("tc,scd,td->st", ltm, eff_var, ltm)
    accum = ltm.sum(dim=0)
    ea = eff @ accum
    va = torch.einsum("c,scd,d->s", accum, eff_var, accum)
    return et * et / vt, ea * ea / va


def _p_values(chi, chi_t, chi_acc, df):
    """(p, p_min, p_accum) as host arrays."""
    return (chi2_sf(chi, df).cpu().numpy(),
            chi2_sf(chi_t, 1).amin(dim=1).cpu().numpy(),
            chi2_sf(chi_acc, 1).cpu().numpy())


def _result_frame(bim, snp_lst, eff, chi, p_val, p_min, p_accum, extra=None):
    res_df = bim.iloc[snp_lst][["chro", "snp_ID", "pos", "allele1",
                                "allele2"]].copy()
    res_df.insert(0, "order", snp_lst)
    if extra:
        for k, v in extra.items():
            res_df[k] = v
    for i in range(eff.shape[1]):
        res_df[f"eff{i}"] = eff[:, i]
    res_df["chi_val"] = chi
    res_df["p_val"] = p_val
    res_df["p_min"] = p_min
    res_df["p_accum"] = p_accum
    return res_df


# ---------------------------------------------------------------------------
# fixed-regression test: the per-SNP REML, batched over SNPs
# ---------------------------------------------------------------------------

def _emai_single(y, xmat, leg_tp, lam, var0, tit, is_add, jj, kk, gammas,
                 cov_dim, maxiter, cc_par, cc_gra):
    """Each SNP's short REML (reference balance_longwas_emai.py:13-95) for a
    batch: xmat (S, n, T, p), var0 (nv,).  A SNP without a PD candidate
    takes the last gamma; a converged SNP keeps its values.  Returns
    (cc_par, cc_gra, eff, chi, eff_var) of the Wald test on the trailing
    cov_dim coefficients."""
    s = xmat.shape[0]
    num_record = y.numel()
    ran_df = y.shape[0]
    var = var0[None].expand(s, -1).clone()
    converged = torch.zeros(s, dtype=torch.bool, device=y.device)
    ccp = torch.full((s,), 1e4, dtype=y.dtype, device=y.device)
    ccg = ccp.clone()
    for _ in range(maxiter):
        cov_add, cov_per, res_var = _cov_from_vec(var, cov_dim, cov_dim)
        fd, ai = _fdai(y, xmat, leg_tp, lam, cov_add, cov_per, res_var, tit,
                       is_add, jj, kk)
        em = _em_core(cov_add, cov_per, ran_df, ran_df, res_var, num_record)
        _, delta, _ = _search(var, _weight_deltas(ai, em, fd, gammas),
                              cov_dim, cov_dim)
        var_new = var + delta
        ccp_new = torch.sqrt(torch.sum(delta**2, 1) / torch.sum(var_new**2, 1))
        ccg_new = torch.sqrt(torch.sum(fd**2, 1)) / var.shape[1]
        done_now = (ccp_new < cc_par) & (ccg_new < cc_gra)
        var = torch.where(converged[:, None], var, var_new)
        ccp = torch.where(converged, ccp, ccp_new)
        ccg = torch.where(converged, ccg, ccg_new)
        converged = converged | done_now
        if bool(converged.all()):
            break

    cov_add, cov_per, res_var = _cov_from_vec(var, cov_dim, cov_dim)
    vinv = _model_pieces(leg_tp, lam, cov_add, cov_per, res_var)
    _, xvx_inv, beta = _gls(y, xmat, vinv)
    eff = beta[:, -cov_dim:]
    eff_var = xvx_inv[:, -cov_dim:, -cov_dim:]
    chi = torch.einsum("sc,scd,sd->s", eff, torch.linalg.inv(eff_var), eff)
    return ccp, ccg, eff, chi, eff_var


def balance_longwas_fixed(data_file, id_col, tpoint, trait, kin_file,
                          bed_prefix, var_com, snp_lst=None, tfix=None,
                          fix=None, forder=3, rorder=3, na_method="omit",
                          maxiter=10, cc_par=1.0e-6, cc_gra=1.0e6,
                          em_weight_step=0.001,
                          prefix_outfile="balance_longwas_fixed",
                          snp_batch=64, _snp_shuffle=None, precision="auto",
                          device=None):
    if tfix is not None or fix is not None:
        raise NotImplementedError("tfix/fix must be None (reference parity)")
    _resolve_dtype(precision)
    dev = resolve_device(device)
    model = prepare_balance(data_file, id_col, tpoint, trait, kin_file,
                            forder, rorder, na_method, dev)
    cov_dim = model.leg_tp.shape[1]
    if isinstance(var_com, pd.DataFrame):
        var0 = var_com["var_val"].to_numpy(dtype=float)
    else:
        var0 = np.asarray(var_com, dtype=float)
    snp_mat, bim, snp_lst, _ = _load_snp(model, bed_prefix, snp_lst)
    if _snp_shuffle is not None:
        snp_mat = snp_mat[_snp_shuffle, :]
    # rotated SNP fixed block: X_snp[i] = (Uᵀ s)_i * leg_fix
    snp_rot = model.eigvecs.T @ as_exact(snp_mat, dev)  # (n, S)
    tit, is_add, jj, kk = _tensors(model.leg_tp, var_index(cov_dim), dev)
    single = partial(
        _emai_single, model.y, leg_tp=as_exact(model.leg_tp, dev),
        lam=model.eigvals, var0=as_exact(var0, dev), tit=tit, is_add=is_add,
        jj=jj, kk=kk, gammas=as_exact(_grid(em_weight_step), dev),
        cov_dim=cov_dim, maxiter=maxiter, cc_par=cc_par, cc_gra=cc_gra)
    leg_fix = as_exact(model.leg_fix, dev)
    ltm = as_exact(leg_basis(model.tpoint, forder), dev)

    out = []
    for start in range(0, snp_rot.shape[1], snp_batch):
        block = snp_rot[:, start:start + snp_batch].T  # (S, n)
        x_snp = block[:, :, None, None] * leg_fix[None, None]
        xmat = torch.cat([model.xmat[None].expand(len(block), -1, -1, -1),
                          x_snp], dim=3)
        ccp, ccg, eff, chi, eff_var = single(xmat=xmat)
        out.append((ccp, ccg, eff, chi, *_tpoint_stats(eff, eff_var, ltm)))
    ccp, ccg, eff, chi, chi_t, chi_acc = (torch.cat(v) for v in zip(*out))
    res_df = _result_frame(
        bim, snp_lst, eff.cpu().numpy(), chi.cpu().numpy(),
        *_p_values(chi, chi_t, chi_acc, cov_dim),
        extra={"cc_par_val": ccp.cpu().numpy(),
               "cc_gra_val": ccg.cpu().numpy()})
    res_df.to_csv(prefix_outfile + ".res", sep=" ", index=False)
    return res_df


# ---------------------------------------------------------------------------
# linear-transformation test: all SNPs in a handful of products
# ---------------------------------------------------------------------------

def balance_longwas_trans(data_file, id_col, tpoint, trait, kin_file,
                          bed_prefix, var_com, snp_lst=None, tfix=None,
                          fix=None, forder=3, rorder=3, na_method="omit",
                          prefix_outfile="balance_longwas_trans",
                          snp_batch=1024, _snp_shuffle=None, precision="auto",
                          device=None):
    if tfix is not None or fix is not None:
        raise NotImplementedError("tfix/fix must be None (reference parity)")
    _resolve_dtype(precision)
    dev = resolve_device(device)
    model = prepare_balance(data_file, id_col, tpoint, trait, kin_file,
                            forder, rorder, na_method, dev)
    cov_dim = model.leg_tp.shape[1]
    cov_add = _unpack_cov_df(var_com, 1)
    cov_per = _unpack_cov_df(var_com, 2)
    res_var = float(var_com["var_val"].to_numpy()[-1])
    snp_mat, bim, snp_lst, num_id_full = _load_snp(model, bed_prefix, snp_lst)
    # trans uses CENTERED (-2p) then eigen-rotated dosages (reference
    # balance_longwas_trans.py:181-184); the fixed test uses raw dosages
    freq = snp_mat.sum(axis=0) / (2.0 * num_id_full)
    snp_mat = model.eigvecs.T @ as_exact(snp_mat - 2.0 * freq[None, :], dev)
    if _snp_shuffle is not None:
        # the reference permutes the EIGEN-ROTATED rows, not the raw dosage
        # rows (balance_longwas_trans_permutation.py:187,225) — unlike the
        # fixed twin, which shuffles before its per-SNP rotation
        snp_mat = snp_mat[torch.as_tensor(_snp_shuffle, device=dev), :]
    leg_tp = as_exact(model.leg_tp, dev)
    ltm = as_exact(leg_basis(model.tpoint, forder), dev)
    vinv = _model_pieces(leg_tp, model.eigvals, as_exact(cov_add, dev)[None],
                         as_exact(cov_per, dev)[None],
                         as_exact([res_var], dev))
    vx, xvx_inv, beta = _gls(model.y, model.xmat[None], vinv)
    vinv, vx, xvx_inv = vinv[0], vx[0], xvx_inv[0]
    py = (vinv @ (model.y - model.xmat @ beta[0])[..., None])[..., 0]
    temp_gt = as_exact(cov_add, dev) @ leg_tp.T  # (cd, T)

    out = []
    for start in range(0, snp_mat.shape[1], snp_batch):
        snp = snp_mat[:, start:start + snp_batch]  # (n, S)
        effs = (temp_gt @ (py.T @ snp)).T  # (S, cd)
        w2 = torch.einsum("ns,ntu->stu", snp * snp, vinv)
        cov1 = temp_gt @ w2 @ temp_gt.T
        b2 = temp_gt @ torch.einsum("ns,ntp->stp", snp, vx)  # (S, cd, p)
        cov = cov1 - b2 @ xvx_inv @ b2.transpose(1, 2)
        chi = torch.einsum("sc,scd,sd->s", effs, torch.linalg.inv(cov), effs)
        out.append((effs, chi, *_tpoint_stats(effs, cov, ltm)))
    eff, chi, chi_t, chi_acc = (torch.cat(v) for v in zip(*out))
    res_df = _result_frame(bim, snp_lst, eff.cpu().numpy(), chi.cpu().numpy(),
                           *_p_values(chi, chi_t, chi_acc, cov_dim))
    res_df.to_csv(prefix_outfile + ".res", sep=" ", index=False)
    return res_df


def _permutation_driver(test_fn, permutation_lst, seed, prefix_outfile,
                        n_id, **kwargs):
    """Seeded permutation replicates (the reference's unseeded
    random.shuffle is a documented deviation).  The perm vector is shuffled
    cumulatively with numpy's generator, matching the reference's in-place
    re-shuffling of the SNP matrix (balance_longwas_fixed_permutation.py:
    195-198); each replicate file is `<prefix>.<rep>` (reference :251)."""
    if permutation_lst is None:
        permutation_lst = range(1000)
    rng = np.random.default_rng(seed)
    perm = np.arange(n_id)
    results = []
    for rep in permutation_lst:
        rng.shuffle(perm)
        res = test_fn(_snp_shuffle=perm.copy(),
                      prefix_outfile=f"{prefix_outfile}.{rep}", **kwargs)
        # the inner test writes <prefix>.<rep>.res; the reference's
        # per-replicate contract is <prefix>.<rep> with no suffix
        os.replace(f"{prefix_outfile}.{rep}.res", f"{prefix_outfile}.{rep}")
        results.append(res)
    return results


def balance_longwas_fixed_permutation(data_file, id_col, tpoint, trait,
                                      kin_file, bed_prefix, var_com,
                                      permutation_lst=None, snp_lst=None,
                                      forder=3, rorder=3, na_method="omit",
                                      maxiter=10, cc_par=1.0e-6, cc_gra=1.0e6,
                                      em_weight_step=0.001, seed=0,
                                      prefix_outfile="balance_longwas_fixed_permutation",
                                      device=None):
    """Permutation replicates of the fixed test (reference
    balance_longwas_fixed_permutation.py; seeded here)."""
    data = pd.read_csv(data_file, sep=r"\s+", header=0)
    n_id = len(data.dropna())
    return _permutation_driver(
        partial(balance_longwas_fixed, data_file, id_col, tpoint, trait,
                kin_file, bed_prefix, var_com, snp_lst=snp_lst, forder=forder,
                rorder=rorder, na_method=na_method, maxiter=maxiter,
                cc_par=cc_par, cc_gra=cc_gra, em_weight_step=em_weight_step,
                device=device),
        permutation_lst, seed, prefix_outfile, n_id,
    )


def balance_longwas_trans_permutation(data_file, id_col, tpoint, trait,
                                      kin_file, bed_prefix, var_com,
                                      permutation_lst=None, snp_lst=None,
                                      forder=3, rorder=3, na_method="omit",
                                      seed=0,
                                      prefix_outfile="balance_longwas_trans_permutation",
                                      device=None):
    data = pd.read_csv(data_file, sep=r"\s+", header=0)
    n_id = len(data.dropna())
    return _permutation_driver(
        partial(balance_longwas_trans, data_file, id_col, tpoint, trait,
                kin_file, bed_prefix, var_com, snp_lst=snp_lst, forder=forder,
                rorder=rorder, na_method=na_method, device=device),
        permutation_lst, seed, prefix_outfile, n_id,
    )
