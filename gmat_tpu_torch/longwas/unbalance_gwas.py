"""Unbalanced longitudinal GWAS: fixed-regression and retransformation tests.

Counterpart of `gmat_tpu/longwas/unbalance_gwas.py`.  Parity targets
(reference GMAT gmat/longwas/unbalance/):
- `unbalance_longwas_fixed` (unbalance_longwas_fixed.py:17-333):
  observation-space V = Z_a (K_a ⊗ G) Z_aᵀ + Z_p (K_p ⊗ I) Z_pᵀ + sigma2 I
  built ONCE; per SNP a GLS with appended SNP x Legendre fixed columns (raw
  dosages), Wald chi-square with df = forder+1, per-timepoint p, p_min,
  p_accum.
- `unbalance_longwas_trans` (unbalance_longwas_trans.py:17-333):
  P-projection and qpymat = Z_aᵀ P y once; per SNP the kron(K_a, sᵀ)
  retransformation.
- permutation twins: shuffle individual rows of the SNP matrix per replicate.

V (n_rec²) is built in one buffer and inverted by Cholesky; the trans
test forms P in place of V⁻¹, then Z_aᵀ P Z_a as two GEMMs against the
dense Legendre-weighted incidence Z_a (n_rec x cd_a·q), and each SNP
block's quadratic form as one GEMM.  The fixed test multiplies V⁻¹ once
by every SNP column block of the batch.  Float64 throughout.
"""
from __future__ import annotations

from functools import partial

import numpy as np
import torch

from gmat_tpu_torch.config import as_exact, resolve_device
from gmat_tpu_torch.longwas.balance_gwas import (
    _p_values,
    _permutation_driver,
    _result_frame,
    _tpoint_stats,
    _unpack_cov_df,
)
from gmat_tpu_torch.longwas.legendre import leg_basis
from gmat_tpu_torch.longwas.unbalance import UnbalanceModel, prepare_unbalance

_ROW_CHUNK = 2048  # rows of V per kinship gather while V is built


def _load_snp_by_code_order(model: UnbalanceModel, bed_prefix, snp_lst):
    from gmat_tpu_torch.scan.common import prepare_genotypes

    geno, bim, fam = prepare_genotypes(bed_prefix)
    id_geno = list(fam["iid"].astype(str))
    raw_ids = model.data.raw_ids_in_code_order()[: model.q_p]
    missing = set(raw_ids) - set(id_geno)
    if missing:
        raise ValueError(f"ids not in the snp file: {sorted(missing)[:5]}")
    rows = [id_geno.index(i) for i in raw_ids]
    if snp_lst is None:
        snp_lst = list(range(geno.shape[1]))
    snp_lst = list(snp_lst)
    return geno[np.ix_(rows, snp_lst)], bim, snp_lst


def _same_id_pairs(rec_ids):
    """(rows, cols) of every record pair of one individual; the records of
    an individual are consecutive (`check_sorted_by_id`)."""
    n = len(rec_ids)
    starts = np.flatnonzero(np.r_[True, rec_ids[1:] != rec_ids[:-1]])
    count = np.diff(np.r_[starts, n])
    k = np.repeat(count, count)  # block size of each record
    rows = np.repeat(np.arange(n), k)
    offset = np.arange(len(rows)) - np.repeat(np.cumsum(k) - k, k)
    return rows, np.repeat(np.repeat(starts, count), k) + offset


def _variance_pieces(model: UnbalanceModel, cov_add, cov_per, res_var,
                     device=None):
    """V⁻¹ in observation space (unbalance_longwas_fixed.py:250-256).

    V is built in one n_rec² buffer: (Phi_a K_a Phi_aᵀ) scaled row block by
    row block by the gathered kinship, the permanent part added at the
    pairs of one individual, sigma2 on the diagonal; its Cholesky factor
    replaces it, and the inverse replaces the factor."""
    dev = resolve_device(device)
    la, lp = as_exact(model.leg_a, dev), as_exact(model.leg_p, dev)
    rid = torch.as_tensor(model.rec_ids, device=dev)
    kin = as_exact(model.kin, dev)
    vmat = (la @ as_exact(cov_add, dev)) @ la.T
    for r0 in range(0, len(rid), _ROW_CHUNK):
        rows = rid[r0:r0 + _ROW_CHUNK]
        vmat[r0:r0 + len(rows)] *= kin.index_select(0, rows).index_select(1, rid)
    ii, jj = (torch.as_tensor(v, device=dev)
              for v in _same_id_pairs(model.rec_ids))
    per = torch.sum((lp[ii] @ as_exact(cov_per, dev)) * lp[jj], dim=1)
    vmat.index_put_((ii, jj), per, accumulate=True)
    vmat.diagonal().add_(res_var)
    low = torch.linalg.cholesky(vmat)
    del vmat
    return torch.cholesky_inverse(low)


def _tpoint_mats(model: UnbalanceModel, forder):
    tvec = np.array(sorted(set(model.data.df[model.tpoint_col])))
    return leg_basis(tvec, forder, tmin=model.tmin, tmax=model.tmax)


def _gwas_setup(data_file, id_col, tpoint, trait, bed_prefix, kin_file,
                var_com, snp_lst, tfix, fix, forder, aorder, porder,
                na_method, _snp_shuffle, device):
    """The model, V⁻¹, K_a, the SNP matrix (q, m) on the device and the
    .bim rows of one unbalanced test."""
    dev = resolve_device(device)
    model = prepare_unbalance(data_file, id_col, tpoint, trait, kin_file,
                              tfix, fix, forder, aorder, porder, na_method,
                              kin_is_inverse=False)
    cov_add = _unpack_cov_df(var_com, 1)
    cov_per = _unpack_cov_df(var_com, 2)
    res_var = float(np.asarray(var_com["var_val"])[-1])
    vinv = _variance_pieces(model, cov_add, cov_per, res_var, dev)
    snp_mat, bim, snp_lst = _load_snp_by_code_order(model, bed_prefix, snp_lst)
    if _snp_shuffle is not None:
        snp_mat = snp_mat[_snp_shuffle, :]
    return (model, vinv, as_exact(cov_add, dev), as_exact(snp_mat, dev), bim,
            snp_lst, as_exact(_tpoint_mats(model, forder), dev))


def unbalance_longwas_fixed(data_file, id_col, tpoint, trait, bed_prefix,
                            kin_file, var_com, snp_lst=None, tfix=None,
                            fix=None, forder=3, aorder=3, porder=3,
                            na_method="omit",
                            prefix_outfile="unbalance_longwas_fixed",
                            snp_batch=256, _snp_shuffle=None, device=None):
    model, vinv, _, snp_mat, bim, snp_lst, ltm = _gwas_setup(
        data_file, id_col, tpoint, trait, bed_prefix, kin_file, var_com,
        snp_lst, tfix, fix, forder, aorder, porder, na_method, _snp_shuffle,
        device)
    dev = vinv.device
    chi_df = forder + 1
    x, y = as_exact(model.xmat, dev), as_exact(model.y, dev)
    leg_f = as_exact(model.leg_f, dev)
    rid = torch.as_tensor(model.rec_ids, device=dev)
    vx = vinv @ x
    xvx, xvy = x.T @ vx, vx.T @ y

    out = []
    for start in range(0, snp_mat.shape[1], snp_batch):
        snp = snp_mat[:, start:start + snp_batch]  # (q, S)
        s = snp.shape[1]
        cols = snp[rid][:, :, None] * leg_f[:, None, :]  # (n_rec, S, cd)
        vb = (vinv @ cols.reshape(len(rid), -1)).reshape(cols.shape)
        # per SNP [X, B]ᵀ V⁻¹ [X, B] and [X, B]ᵀ V⁻¹ y
        xvb = torch.einsum("rp,rsc->spc", vx, cols)
        lhs = torch.cat([
            torch.cat([xvx.expand(s, -1, -1), xvb], dim=2),
            torch.cat([xvb.transpose(1, 2),
                       torch.einsum("rsc,rsd->scd", cols, vb)], dim=2)], dim=1)
        rhs = torch.cat([xvy.expand(s, -1), torch.einsum("rsc,r->sc", vb, y)],
                        dim=1)
        xvx_inv = torch.linalg.inv(lhs)
        b = (xvx_inv @ rhs[..., None])[..., 0]
        eff = b[:, -chi_df:]
        eff_var = xvx_inv[:, -chi_df:, -chi_df:]
        chi = torch.einsum("sc,scd,sd->s", eff, torch.linalg.inv(eff_var), eff)
        out.append((eff, chi, *_tpoint_stats(eff, eff_var, ltm)))
    eff, chi, chi_t, chi_acc = (torch.cat(v) for v in zip(*out))
    res_df = _result_frame(bim, snp_lst, eff.cpu().numpy(), chi.cpu().numpy(),
                           *_p_values(chi, chi_t, chi_acc, chi_df))
    res_df.to_csv(prefix_outfile + ".res", sep=" ", index=False)
    return res_df


def unbalance_longwas_trans(data_file, id_col, tpoint, trait, bed_prefix,
                            kin_file, var_com, snp_lst=None, tfix=None,
                            fix=None, forder=3, aorder=3, porder=3,
                            na_method="omit",
                            prefix_outfile="unbalance_longwas_trans",
                            snp_batch=1024, _snp_shuffle=None, device=None):
    model, pmat, ka, snp_mat, bim, snp_lst, ltm = _gwas_setup(
        data_file, id_col, tpoint, trait, bed_prefix, kin_file, var_com,
        snp_lst, tfix, fix, forder, aorder, porder, na_method, _snp_shuffle,
        device)
    dev = pmat.device
    cd_a = model.leg_a.shape[1]
    q = model.kin.shape[0]
    x, y = as_exact(model.xmat, dev), as_exact(model.y, dev)
    la = as_exact(model.leg_a, dev)
    n_rec = len(model.rec_ids)
    # P in place of V⁻¹
    vx = pmat @ x
    pmat.addmm_(vx @ torch.linalg.inv(x.T @ vx), vx.T, alpha=-1.0)
    # Z_a (n_rec, cd_a·q), coefficient-major: column j·q + id
    zmat = torch.zeros((n_rec, cd_a, q), dtype=x.dtype, device=dev)
    zmat[torch.arange(n_rec, device=dev), :,
         torch.as_tensor(model.rec_ids, device=dev)] = la
    zmat = zmat.reshape(n_rec, cd_a * q)
    zp = zmat.T @ pmat  # Z_aᵀ P
    qpy = (zp @ y).reshape(cd_a, q)
    # qpq[j, k, a, b] = (Z_jᵀ P Z_k)[a, b], viewed as (cd²·q, q)
    qpq = (zp @ zmat).reshape(cd_a, q, cd_a, q).permute(0, 2, 1, 3)
    qpq = qpq.reshape(cd_a * cd_a * q, q)
    del zp, zmat

    out = []
    for start in range(0, snp_mat.shape[1], snp_batch):
        snp = snp_mat[:, start:start + snp_batch]  # (q, S)
        eff = (ka @ (qpy @ snp)).T  # (S, cd_a)
        w = torch.einsum("jkas,as->sjk",
                         (qpq @ snp).reshape(cd_a, cd_a, q, -1), snp)
        cov = ka @ w @ ka.T
        chi = torch.einsum("sc,scd,sd->s", eff, torch.linalg.inv(cov), eff)
        out.append((eff, chi, *_tpoint_stats(eff, cov, ltm)))
    eff, chi, chi_t, chi_acc = (torch.cat(v) for v in zip(*out))
    res_df = _result_frame(bim, snp_lst, eff.cpu().numpy(), chi.cpu().numpy(),
                           *_p_values(chi, chi_t, chi_acc, cd_a))
    res_df.to_csv(prefix_outfile + ".res", sep=" ", index=False)
    return res_df


def unbalance_longwas_fixed_permutation(data_file, id_col, tpoint, trait,
                                        bed_prefix, kin_file, var_com,
                                        permutation_lst=None, snp_lst=None,
                                        forder=3, aorder=3, porder=3,
                                        na_method="omit", seed=0,
                                        prefix_outfile="unbalance_longwas_fixed_permutation",
                                        device=None):
    model = prepare_unbalance(data_file, id_col, tpoint, trait, kin_file,
                              None, None, forder, aorder, porder, na_method,
                              kin_is_inverse=False)
    return _permutation_driver(
        partial(unbalance_longwas_fixed, data_file, id_col, tpoint, trait,
                bed_prefix, kin_file, var_com, snp_lst=snp_lst, forder=forder,
                aorder=aorder, porder=porder, na_method=na_method,
                device=device),
        permutation_lst, seed, prefix_outfile, model.q_p,
    )


def unbalance_longwas_trans_permutation(data_file, id_col, tpoint, trait,
                                        bed_prefix, kin_file, var_com,
                                        permutation_lst=None, snp_lst=None,
                                        forder=3, aorder=3, porder=3,
                                        na_method="omit", seed=0,
                                        prefix_outfile="unbalance_longwas_trans_permutation",
                                        device=None):
    model = prepare_unbalance(data_file, id_col, tpoint, trait, kin_file,
                              None, None, forder, aorder, porder, na_method,
                              kin_is_inverse=False)
    return _permutation_driver(
        partial(unbalance_longwas_trans, data_file, id_col, tpoint, trait,
                bed_prefix, kin_file, var_com, snp_lst=snp_lst, forder=forder,
                aorder=aorder, porder=porder, na_method=na_method,
                device=device),
        permutation_lst, seed, prefix_outfile, model.q_p,
    )
