"""Unbalanced longitudinal random-regression REML (Henderson MME, EM+AI).

Counterpart of `gmat_tpu/longwas/unbalance.py`.  Model (reference GMAT
gmat/longwas/unbalance/): records y_r at arbitrary times t_r per
individual,

    y = X b + Z_a u_a + Z_p u_p + e,
    u_a ~ N(0, K_a ⊗ G),  u_p ~ N(0, K_p ⊗ I),  e ~ N(0, sigma2 I)

with Z_* the Legendre-weighted incidence matrices, blocks ordered
coefficient-major (all individuals for coefficient 0, then coefficient 1, ...)
so the MME penalty is kron(K_*^{-1}, G^{-1}) (unbalance_varcom.py:199-219,
unbalance_emai.py:79-90).

Parity: `unbalance_emai` + `pre_fd_mat_x` + `pre_ai_mat` + `pre_em_mat` +
`pre_covi_mat` (unbalance_emai.py:15-135, iter_mat.py:40-190,
pre_mat.py:11-29), including the reference's quirk that a non-PD AI matrix
silently degrades the blended update to a pure EM step (pre_ai_mat returns
False, and (1-gamma)*False == 0).

Z never materialises: every Zᵀv is an `index_add_` keyed by the
record -> individual index and every Zu a gather.  The dense MME
coefficient matrix (p + cd_a·q_a + cd_p·q_p square) is assembled blockwise
on the device once and inverted once per iteration; the EM matrix, the
EM-weight grid and the PD test are `balance`'s.  Float64 throughout.
"""
from __future__ import annotations

import logging
from dataclasses import dataclass

import numpy as np
import pandas as pd
import torch
from scipy import linalg as sla

from gmat_tpu_torch.config import as_exact, resolve_device
from gmat_tpu_torch.longwas.balance import (
    _cov_from_vec,
    _em_core,
    _grid,
    _search,
    _weight_deltas,
)
from gmat_tpu_torch.longwas.data import (
    LongData,
    build_fixed_formula,
    check_sorted_by_id,
    parse_long_data,
    read_kin_by_codes,
)
from gmat_tpu_torch.longwas.legendre import leg_basis

logger = logging.getLogger(__name__)


@dataclass
class UnbalanceModel:
    data: LongData
    y: np.ndarray          # (n_rec,)
    xmat: np.ndarray       # (n_rec, p)
    rec_ids: np.ndarray    # (n_rec,) 0-based individual codes
    leg_a: np.ndarray      # (n_rec, cd_a)
    leg_p: np.ndarray      # (n_rec, cd_p)
    leg_f: np.ndarray      # (n_rec, forder+1) fixed-effect basis per record
    kin: np.ndarray        # (q_a, q_a): G^-1 for varcom, G for the GWAS phase
    q_a: int
    q_p: int
    tmin: float
    tmax: float
    tpoint_col: str


def prepare_unbalance(data_file, id_col, tpoint, trait, kin_file, tfix=None,
                      fix=None, forder=3, aorder=3, porder=3,
                      na_method="omit", kin_is_inverse=True) -> UnbalanceModel:
    data = parse_long_data(data_file, id_col, na_method)
    check_sorted_by_id(data)
    t = data.df[tpoint].to_numpy(dtype=float)
    y = data.df[trait].to_numpy(dtype=float)
    leg_f = leg_basis(t, forder)
    # time-varied fixed design (reference unbalance_varcom.py:125-142)
    if tfix is None:
        xmat_t = leg_f.copy()
    else:
        if tfix not in data.class_vec:
            raise ValueError(f"{tfix} is not a class variate")
        codes = data.df[tfix].to_numpy(dtype=np.int64) - 1
        n_lev = codes.max() + 1
        onehot = np.zeros((len(codes), n_lev))
        onehot[np.arange(len(codes)), codes] = 1.0
        xmat_t = np.concatenate(
            [onehot * leg_f[:, i:i + 1] for i in range(leg_f.shape[1])], axis=1
        )
    xmat_nt = build_fixed_formula(data, fix)
    xmat = xmat_t if xmat_nt is None else np.concatenate([xmat_t, xmat_nt], 1)
    q_p = int(data.df[id_col].max())
    kin = read_kin_by_codes(kin_file, data, add_missing=kin_is_inverse)
    return UnbalanceModel(
        data=data, y=y, xmat=xmat,
        rec_ids=data.df[id_col].to_numpy(dtype=np.int64) - 1,
        leg_a=leg_basis(t, aorder), leg_p=leg_basis(t, porder), leg_f=leg_f,
        kin=kin, q_a=kin.shape[0], q_p=q_p,
        tmin=float(t.min()), tmax=float(t.max()), tpoint_col=tpoint,
    )


def _covi(cov_dim, vals):
    """Inverse of a tril-packed covariance; None if not PD / residual <= 0
    handled by caller (reference pre_covi_mat, pre_mat.py:11-29)."""
    tril = np.tril_indices(cov_dim)
    m = np.zeros((cov_dim, cov_dim))
    m[tril] = vals
    m = m + np.tril(m, -1).T
    try:
        sla.cholesky(m)
    except sla.LinAlgError:
        return None, None
    return sla.inv(m), m


def _var_layout(cd_a, cd_p):
    """Index bookkeeping for the packed parameter vector."""
    ntr_a = cd_a * (cd_a + 1) // 2
    ntr_p = cd_p * (cd_p + 1) // 2
    vari, varij, varik = [], [], []
    for blk, cd in ((1, cd_a), (2, cd_p)):
        for j in range(cd):
            for k in range(j + 1):
                vari.append(blk)
                varij.append(j + 1)
                varik.append(k + 1)
    vari.append(3)
    varij.append(1)
    varik.append(1)
    return ntr_a, ntr_p, np.array(vari), np.array(varij), np.array(varik)


class _MmePieces:
    """Static per-dataset precomputations shared across iterations, on the
    device: WᵀW (dense, blockwise) and Wᵀy for W = [X, Z_a, Z_p]."""

    def __init__(self, model: UnbalanceModel, device=None):
        m = model
        dev = resolve_device(device)
        self.p = m.xmat.shape[1]
        self.cd_a = m.leg_a.shape[1]
        self.cd_p = m.leg_p.shape[1]
        self.q_a, self.q_p = m.q_a, m.q_p
        self.d_tot = self.p + self.cd_a * self.q_a + self.cd_p * self.q_p
        self.n_rec = len(m.y)
        self.x, self.la, self.lp, self.y = (
            as_exact(v, dev) for v in (m.xmat, m.leg_a, m.leg_p, m.y))
        self.rid = torch.as_tensor(m.rec_ids, device=dev)
        self.off_a = self.p
        self.off_p = self.p + self.cd_a * self.q_a
        x, la, lp = self.x, self.la, self.lp
        # dense WᵀW assembled blockwise (coefficient-major Z layout)
        c = torch.zeros((self.d_tot, self.d_tot), dtype=x.dtype, device=dev)
        c[:self.p, :self.p] = x.T @ x
        for leg, q, off in ((la, self.q_a, self.off_a),
                            (lp, self.q_p, self.off_p)):
            xz = self.seg(x[:, None, :] * leg[:, :, None], q)  # (q, cd, p)
            blk = xz.permute(1, 0, 2).reshape(-1, self.p)  # (cd·q, p)
            c[off:off + blk.shape[0], :self.p] = blk
            c[:self.p, off:off + blk.shape[0]] = blk.T
        # Z_*ᵀZ_* blocks are diagonal per coefficient pair; the a/p cross
        # blocks cover the first q_p individuals (reference layout)
        for (la_, qa, oa), (lb, qb, ob) in (
                ((la, self.q_a, self.off_a), (la, self.q_a, self.off_a)),
                ((la, self.q_a, self.off_a), (lp, self.q_p, self.off_p)),
                ((lp, self.q_p, self.off_p), (lp, self.q_p, self.off_p))):
            q = min(qa, qb)
            dg = self.seg(la_[:, :, None] * lb[:, None, :], q)  # (q, cdA, cdB)
            idx = torch.arange(q, device=dev)
            for j in range(la_.shape[1]):
                for k in range(lb.shape[1]):
                    c[oa + j * qa + idx, ob + k * qb + idx] = dg[:, j, k]
                    c[ob + k * qb + idx, oa + j * qa + idx] = dg[:, j, k]
        self.cmat_pure = c
        self.rhs_pure = self.wt_dot(self.y[:, None])[:, 0]

    def seg(self, v, q):
        """Zᵀ-style sum of record rows into q individual rows."""
        return torch.zeros((q,) + v.shape[1:], dtype=v.dtype,
                           device=v.device).index_add_(0, self.rid, v)

    def wt_dot(self, v):
        """Wᵀ v for (n_rec, k) columns: (d_tot, k)."""
        za = self.seg(self.la[:, :, None] * v[:, None, :], self.q_a)
        zp = self.seg(self.lp[:, :, None] * v[:, None, :], self.q_p)
        k = v.shape[1]
        return torch.cat([self.x.T @ v,
                          za.permute(1, 0, 2).reshape(-1, k),
                          zp.permute(1, 0, 2).reshape(-1, k)])


def _fd_block(covi, u_mat, q, cinv_blocks, kin_dense):
    """fd entries of one covariance block (reference pre_fd_mat_x):
    u_mat (q, cd) effects, cinv_blocks (cd, q, cd, q) of C⁻¹."""
    km = u_mat @ covi
    if kin_dense is None:
        tmat = torch.einsum("jaka->jk", cinv_blocks)
        quad = km.T @ km
    else:
        tmat = torch.einsum("ab,jakb->jk", kin_dense, cinv_blocks)
        quad = km.T @ (kin_dense @ km)
    temp = q * covi - covi @ tmat @ covi - quad
    dbl = temp + torch.tril(temp, -1)  # doubles strict-lower entries
    i0, i1 = np.tril_indices(covi.shape[0])
    return -0.5 * dbl[i0, i1]


def _wv_block(pieces, covi, u_mat, leg):
    """AI working variables of one block (reference pre_ai_mat): for each
    tril pair (j, k), record r's value sum_c leg[r,c] (U Mᵀ)[id_r, c] with
    M = E_jk (+ E_kj) covi."""
    cd = covi.shape[0]
    i0, i1 = np.tril_indices(cd)
    esym = np.zeros((len(i0), cd, cd))
    esym[np.arange(len(i0)), i0, i1] = 1.0
    esym[np.arange(len(i0)), i1, i0] = 1.0
    m_all = torch.as_tensor(esym, device=covi.device) @ covi
    tc = torch.einsum("qc,mjc->mqj", u_mat, m_all)  # (ntr, q, cd)
    return torch.einsum("rc,mrc->rm", leg, tc[:, pieces.rid, :])


def _iter_step(pieces: _MmePieces, kin_inv, covi_a, covi_p, var_e, gammas):
    """One EM+AI iteration at the covariances' inverses and the residual:
    (fd, ((1-g)·AI + g·EM)⁻¹ fd for every g of the grid)."""
    p, cd_a, cd_p = pieces.p, pieces.cd_a, pieces.cd_p
    q_a, q_p = pieces.q_a, pieces.q_p
    n_rec = pieces.n_rec
    dev = pieces.x.device
    cmat = pieces.cmat_pure / var_e
    sa = slice(pieces.off_a, pieces.off_a + cd_a * q_a)
    sp_ = slice(pieces.off_p, pieces.off_p + cd_p * q_p)
    cmat[sa, sa] += torch.kron(covi_a.contiguous(), kin_inv)
    cmat[sp_, sp_] += torch.kron(covi_p.contiguous(),
                                 torch.eye(q_p, dtype=cmat.dtype, device=dev))
    cmati = torch.linalg.inv(cmat)
    del cmat
    eff = cmati @ (pieces.rhs_pure / var_e)
    u_a = eff[sa].reshape(cd_a, q_a)
    u_p = eff[sp_].reshape(cd_p, q_p)
    zu = (torch.sum(pieces.la * u_a[:, pieces.rid].T, dim=1)
          + torch.sum(pieces.lp * u_p[:, pieces.rid].T, dim=1))
    e = pieces.y - pieces.x @ eff[:p] - zu

    # --- fd (reference pre_fd_mat_x)
    fd_a = _fd_block(covi_a, u_a.T, q_a,
                     cmati[sa, sa].reshape(cd_a, q_a, cd_a, q_a), kin_inv)
    fd_p = _fd_block(covi_p, u_p.T, q_p,
                     cmati[sp_, sp_].reshape(cd_p, q_p, cd_p, q_p), None)
    fd_res = -0.5 * (
        n_rec / var_e
        - torch.sum(pieces.cmat_pure * cmati) / (var_e * var_e)
        - torch.dot(e, e) / (var_e * var_e)
    )
    fd = torch.cat([fd_a, fd_p, fd_res[None]])

    # --- AI (reference pre_ai_mat)
    qmat = torch.cat([_wv_block(pieces, covi_a, u_a.T, pieces.la),
                      _wv_block(pieces, covi_p, u_p.T, pieces.lp),
                      (e / var_e)[:, None]], dim=1)
    qrq = (qmat.T @ qmat) / var_e
    left = pieces.wt_dot(qmat) / var_e
    ai = 0.5 * (qrq - left.T @ (cmati @ left))
    # reference: non-PD AI silently becomes 0 (pure EM step)
    ai = torch.where(torch.linalg.cholesky_ex(ai).info == 0, ai, 0.0)

    # --- EM (reference pre_em_mat) and the grid of blended updates
    em = _em_core(torch.linalg.inv(covi_a)[None], torch.linalg.inv(covi_p)[None],
                  q_a, q_p, var_e[None], n_rec)
    return fd, _weight_deltas(ai[None], em, fd[None], gammas)[0]


def unbalance_emai(model: UnbalanceModel, init=None, maxiter=30,
                   cc_par=1.0e-8, cc_gra=1.0e-6, em_weight_step=0.001,
                   device=None):
    """MME-based EM+AI loop (reference unbalance_emai.py:15-135); one host
    sync per iteration (the chosen weight and the convergence test)."""
    dev = resolve_device(device)
    cd_a = model.leg_a.shape[1]
    cd_p = model.leg_p.shape[1]
    ntr_a, ntr_p, vari, varij, varik = _var_layout(cd_a, cd_p)
    if init is None:
        y_var = np.var(model.y) / (cd_a + cd_p + 1)
        var_com = np.zeros(ntr_a + ntr_p + 1)
        diag_a = [j * (j + 3) // 2 for j in range(cd_a)]
        diag_p = [ntr_a + j * (j + 3) // 2 for j in range(cd_p)]
        var_com[diag_a] = y_var
        var_com[diag_p] = y_var
        var_com[-1] = y_var
    else:
        var_com = np.asarray(init, dtype=float)
    covi_a, _ = _covi(cd_a, var_com[:ntr_a])
    covi_p, _ = _covi(cd_p, var_com[ntr_a:ntr_a + ntr_p])
    if covi_a is None or covi_p is None or var_com[-1] <= 0:
        raise ValueError("initial variances are not positive definite")
    pieces = _MmePieces(model, dev)
    kin_inv = as_exact(model.kin, dev)
    gammas = _grid(em_weight_step)
    gammas_d = as_exact(gammas, dev)
    var = as_exact(var_com, dev)
    covi_a, covi_p = as_exact(covi_a, dev), as_exact(covi_p, dev)
    for it in range(1, maxiter + 1):
        fd, deltas = _iter_step(pieces, kin_inv, covi_a, covi_p, var[-1],
                                gammas_d)
        # first gamma whose update keeps both blocks PD and residual > 0
        idx, delta, any_ok = _search(var[None], deltas[None], cd_a, cd_p)
        if not bool(any_ok[0]):
            raise RuntimeError("updated variances are not positive definite")
        g_idx, delta = int(idx[0]), delta[0]
        var_new = var + delta
        ca, cp, _ = _cov_from_vec(var_new, cd_a, cd_p)
        covi_a, covi_p = torch.linalg.inv(ca), torch.linalg.inv(cp)
        cc_par_val = float(torch.sqrt(torch.sum(delta**2)
                                      / torch.sum(var_new**2)))
        cc_gra_val = float(torch.sqrt(torch.sum(fd**2))) / len(var_com)
        var = var_new
        logger.info("Round %d: gamma %.3f | cc_par %.3e | cc_gra %.3e",
                    it, gammas[g_idx], cc_par_val, cc_gra_val)
        if cc_par_val < cc_par and cc_gra_val < cc_gra:
            logger.info("Variances Converged")
            break
    return pd.DataFrame(
        {"vari": vari, "varij": varij, "varik": varik,
         "var_val": var.cpu().numpy()}
    )


def unbalance_varcom(data_file, id_col, tpoint, trait, kin_inv_file,
                     tfix=None, fix=None, forder=3, aorder=3, porder=3,
                     na_method="omit", init=None, maxiter=100, cc_par=1.0e-8,
                     cc_gra=1.0e6, em_weight_step=0.001,
                     prefix_outfile="unbalance_varcom", device=None):
    """Reference unbalance_varcom (unbalance_varcom.py:15-226)."""
    model = prepare_unbalance(data_file, id_col, tpoint, trait, kin_inv_file,
                              tfix, fix, forder, aorder, porder, na_method,
                              kin_is_inverse=True)
    res = unbalance_emai(model, init=init, maxiter=maxiter, cc_par=cc_par,
                         cc_gra=cc_gra, em_weight_step=em_weight_step,
                         device=device)
    res.to_csv(prefix_outfile + ".var", sep=" ", index=False)
    return res
