"""Balanced longitudinal random-regression REML (eigen space, batched).

Counterpart of `gmat_tpu/longwas/balance.py`.  Model (reference GMAT
gmat/longwas/balance/): every individual i shares the T timepoints; after
rotating phenotypes by the kinship eigenvectors U (K = U diag(lam) Uᵀ),
records decouple per individual:

    V_i = lam_i * Phi K_a Phiᵀ + Phi K_p Phiᵀ + sigma2_e I_T

with Phi the (T, cd) Legendre basis (cd = rorder+1), K_a/K_p the additive /
permanent-environment covariance matrices of the random-regression
coefficients.  Parameters: tril(K_a) ++ tril(K_p) ++ [sigma2_e]
(balance_varcom.py:146-165).

Algorithm parity: `balance_emai` + `pre_fdai_mat_eigen_glm` + `pre_em_mat_eigen`
+ the Cholesky-gated EM-weight search (balance_emai.py:13-84,
iter_mat.py:500-587,294-319, pre_mat.py:123-146).

One set of functions serves this REML and the per-SNP REMLs of
`balance_gwas.balance_longwas_fixed`, batched over a leading axis (a batch
of 1 here): `_fdai` (fd and AI, V_i⁻¹ in closed form from one Cholesky and
one `eigh` of a T x T matrix), `_em_core` (the EM matrix, also used by the
unbalanced REML), `_weight_deltas` (the whole EM-weight grid through the
whitened pencil) and `_pd_ok` (which requires a residual > 0).  Everything
runs in float64 on the device.
"""
from __future__ import annotations

import logging
from dataclasses import dataclass

import numpy as np
import pandas as pd
import torch
from scipy import linalg as sla

from gmat_tpu_torch.config import EXACT_DTYPE, as_exact, resolve_device
from gmat_tpu_torch.longwas.data import LongData, parse_long_data, read_kin_by_codes
from gmat_tpu_torch.longwas.legendre import leg_basis

logger = logging.getLogger(__name__)


def var_index(cov_dim: int) -> np.ndarray:
    """(nv, 3) parameter index table: (block 0/1/2, row j, col k) — reference
    balance_emai.py:26-36."""
    tril = np.tril_indices(cov_dim)
    rows = []
    for block in (0, 1):
        for j, k in zip(*tril):
            rows.append((block, j, k))
    rows.append((2, 0, 0))
    return np.array(rows)


def unpack_cov(cov_dim: int, var_com: np.ndarray):
    """var vector -> (K_a, K_p, sigma2_e); None if any block is not PD
    (reference pre_cov_mat_eigen, pre_mat.py:123-146)."""
    ntr = cov_dim * (cov_dim + 1) // 2
    tril = np.tril_indices(cov_dim)

    def block(vals):
        m = np.zeros((cov_dim, cov_dim))
        m[tril] = vals
        return m + np.tril(m, -1).T

    cov_add = block(var_com[:ntr])
    cov_per = block(var_com[ntr:2 * ntr])
    for m in (cov_add, cov_per):
        try:
            sla.cholesky(m)
        except sla.LinAlgError:
            return None
    if var_com[-1] < 0:
        return None
    return cov_add, cov_per, float(var_com[-1])


def _tit_stack(leg_tp: np.ndarray, vind: np.ndarray) -> np.ndarray:
    """(nv-1, T, T) stack of Phi (E_jk + E_kj - diag) Phiᵀ derivative kernels."""
    cd = leg_tp.shape[1]
    mats = []
    for block, j, k in vind[:-1]:
        one = np.zeros((cd, cd))
        one[j, k] = 1.0
        one = one + one.T - np.diag(np.diag(one))
        mats.append(leg_tp @ one @ leg_tp.T)
    return np.stack(mats)


# ---------------------------------------------------------------------------
# the parameter vector and its PD test, batched over leading axes
# ---------------------------------------------------------------------------

def _tril_index_map(cov_dim) -> np.ndarray:
    """(k, k) map from matrix position to packed-tril slot."""
    tril = np.tril_indices(cov_dim)
    idx = np.zeros((cov_dim, cov_dim), dtype=np.int64)
    idx[tril] = np.arange(len(tril[0]))
    return np.maximum(idx, idx.T)


def _cov_from_vec(var, cd_a, cd_p):
    """(..., ntr_a + ntr_p + 1) parameter vectors -> the two covariance
    blocks (..., cd, cd) and the residual (...,), by a static gather."""
    ntr_a = cd_a * (cd_a + 1) // 2
    ntr_p = cd_p * (cd_p + 1) // 2
    ia = torch.as_tensor(_tril_index_map(cd_a), device=var.device)
    ip = torch.as_tensor(_tril_index_map(cd_p), device=var.device)
    return (var[..., :ntr_a][..., ia], var[..., ntr_a:ntr_a + ntr_p][..., ip],
            var[..., -1])


def _chol_pd_unrolled(cov):
    """PD test for (..., k, k) batches by the unrolled Cholesky recurrence:
    k(k+1)/2 elementwise steps over the whole batch (the weight search tests
    one candidate per SNP and grid point).  A non-finite pivot fails."""
    k = cov.shape[-1]
    tiny = torch.finfo(cov.dtype).tiny
    low: list = [[None] * k for _ in range(k)]
    ok = torch.ones(cov.shape[:-2], dtype=torch.bool, device=cov.device)
    for i in range(k):
        for j in range(i + 1):
            s = cov[..., i, j]
            for p in range(j):
                s = s - low[i][p] * low[j][p]
            if i == j:
                ok = ok & (s > 0) & torch.isfinite(s)
                low[i][i] = torch.sqrt(torch.clamp(s, min=tiny))
            else:
                low[i][j] = s / low[j][j]
    return ok


def _pd_ok(cov_add, cov_per, res):
    """Both blocks PD and the residual > 0.  (The JAX package admits
    res = 0; V_i⁻¹'s closed form whitens by Phi K_p Phiᵀ + res·I, which has
    rank cd < T at res = 0.)"""
    return (_chol_pd_unrolled(cov_add) & _chol_pd_unrolled(cov_per)
            & (res > 0))


def _first_ok(ok):
    """Index of the first True along the last axis, the last index where
    none is (the per-SNP REML's rule), and whether any is."""
    any_ok = torch.any(ok, dim=-1)
    first = torch.argmax(ok.to(torch.int8), dim=-1)
    return torch.where(any_ok, first, ok.shape[-1] - 1), any_ok


# ---------------------------------------------------------------------------
# fd / AI / EM and the EM-weight grid, batched over a leading axis
# ---------------------------------------------------------------------------

def _model_pieces(leg_tp, lam, cov_add, cov_per, res_var):
    """Per-id V_i⁻¹ (S, n, T, T) in closed form from ONE (T, T) Cholesky
    and one `eigh` per batch entry.

    V_i = lam_i A + C with A = Phi K_a Phiᵀ and C = Phi K_p Phiᵀ + r I shared
    by every id.  Whiten A by C = M Mᵀ and take W = M⁻¹ A M⁻ᵀ = Q D Qᵀ; with
    U = M⁻ᵀ Q, V_i⁻¹ = U diag(1/(lam_i d + 1)) Uᵀ (gmat_tpu's
    balance_gwas._model_pieces)."""
    t = leg_tp.shape[0]
    amat = leg_tp @ cov_add @ leg_tp.T
    cmat = leg_tp @ cov_per @ leg_tp.T + res_var[:, None, None] * torch.eye(
        t, dtype=leg_tp.dtype, device=leg_tp.device)
    mchol = torch.linalg.cholesky(cmat)
    w = torch.linalg.solve_triangular(
        mchol, torch.linalg.solve_triangular(mchol, amat, upper=False)
        .transpose(-1, -2), upper=False)
    w = (w + w.transpose(-1, -2)) / 2
    d, q = torch.linalg.eigh(w)
    u = torch.linalg.solve_triangular(mchol.transpose(-1, -2), q, upper=True)
    wgt = 1.0 / (lam[None, :, None] * d[:, None, :] + 1.0)  # (S, n, T)
    return (u[:, None] * wgt[:, :, None, :]) @ u.transpose(-1, -2)[:, None]


def _gls(y, xmat, vinv):
    """V⁻¹X (S, n, T, p), (XᵀV⁻¹X)⁻¹ (S, p, p) and the GLS coefficients."""
    vx = vinv @ xmat
    xvx_inv = torch.linalg.inv(torch.einsum("sntp,sntq->spq", xmat, vx))
    beta = (xvx_inv @ torch.einsum("sntp,nt->sp", vx, y)[..., None])[..., 0]
    return vx, xvx_inv, beta


def _fdai(y, xmat, leg_tp, lam, cov_add, cov_per, res_var, tit, is_add, jj,
          kk):
    """fd (S, nv) and AI (S, nv, nv) of the REML at each batch entry's
    variances (reference pre_fdai_mat_eigen_glm).  y (n, T) is shared;
    xmat (S, n, T, p), cov_add/cov_per (S, cd, cd), res_var (S,)."""
    vinv = _model_pieces(leg_tp, lam, cov_add, cov_per, res_var)
    vx, xvx_inv, beta = _gls(y, xmat, vinv)
    py = (vinv @ (y[None] - (xmat @ beta[:, None, :, None])[..., 0])[..., None]
          )[..., 0]  # (S, n, T)
    c = torch.where(is_add[:, None], lam[None, :], torch.ones_like(lam)[None])

    # trace(V⁻¹ dV) via Phiᵀ V⁻¹ Phi sums
    g_all = leg_tp.T @ vinv @ leg_tp  # (S, n, cd, cd)
    s_add = torch.einsum("n,sncd->scd", lam, g_all)
    s_one = g_all.sum(dim=1)
    dbl = torch.where(jj != kk, 2.0, 1.0).to(y.dtype)
    trvk = torch.where(is_add, s_add[:, kk, jj], s_one[:, kk, jj]) * dbl

    # trace(P dV) correction: Phiᵀ V⁻¹ X per id
    h_all = torch.einsum("tc,sntp->sncp", leg_tp, vx)
    t4_add = torch.einsum("n,sncp,sndq->scdpq", lam, h_all, h_all)
    t4_one = torch.einsum("sncp,sndq->scdpq", h_all, h_all)
    xvkvx = torch.where(is_add[:, None, None], t4_add[:, jj, kk],
                        t4_one[:, jj, kk])
    xvkvx = xvkvx + torch.where((jj != kk)[:, None, None],
                                xvkvx.transpose(-1, -2), 0.0)
    trpk = torch.einsum("spq,smpq->sm", xvx_inv, xvkvx)

    kpy = torch.einsum("mtu,snu->smnt", tit, py) * c[None, :, :, None]
    ypkpy = torch.einsum("smnt,snt->sm", kpy, py)
    fd_m = -0.5 * (trvk - trpk) + 0.5 * ypkpy

    # residual entry
    trvk_res = torch.diagonal(vinv, dim1=-2, dim2=-1).sum(dim=(1, 2))
    xvvx = torch.einsum("sntp,sntq->spq", vx, vx)
    trpk_res = torch.sum(xvx_inv * xvvx, dim=(1, 2))
    fd_res = -0.5 * (trvk_res - trpk_res) + 0.5 * torch.sum(py * py, (1, 2))
    fd = torch.cat([fd_m, fd_res[:, None]], dim=1)

    # P·(dV_m P y): project each kpy through P
    kpy_all = torch.cat([kpy, py[:, None]], dim=1)  # (S, nv, n, T)
    u_all = torch.einsum("smnt,sntp->smp", kpy_all, vx)
    kpy_xb = kpy_all - torch.einsum("sntp,smp->smnt", xmat,
                                    u_all @ xvx_inv.transpose(-1, -2))
    pkpy_all = torch.einsum("sntu,smnu->smnt", vinv, kpy_xb)
    ai_full = torch.einsum("smnt,sknt->smk", kpy_all, pkpy_all)
    # reference symmetrization: the lower triangle mirrored
    ai = torch.tril(ai_full) + torch.tril(ai_full, -1).transpose(-1, -2)
    return fd, 0.5 * ai


def _em_core(cov_add, cov_per, df_a, df_p, res_var, num_record):
    """EM matrix (S, nv, nv) (reference pre_em_mat_eigen; the unbalanced
    pre_em_mat is the same matrix, built as the inverse of its inverse):
    per block (T_jk)⁻¹·df with T the tril-pair products of the block,
    and num_record / (2 res²) for the residual."""
    def block(cov, df):
        i0, i1 = (torch.as_tensor(v, device=cov.device)
                  for v in np.tril_indices(cov.shape[-1]))
        t = (cov[:, i0[:, None], i0[None, :]] * cov[:, i1[:, None], i1[None, :]]
             + cov[:, i0[:, None], i1[None, :]] * cov[:, i1[:, None], i0[None, :]]
             ) / (2.0 * df)
        return torch.linalg.inv(t) / 2.0

    res = (num_record / (res_var * res_var) / 2.0)[:, None, None]
    return _block_diag(block(cov_add, df_a), block(cov_per, df_p), res)


def _block_diag(*blocks):
    """Batched block-diagonal matrix of (S, k_i, k_i) blocks."""
    s = blocks[0].shape[0]
    n = sum(b.shape[-1] for b in blocks)
    out = blocks[0].new_zeros((s, n, n))
    off = 0
    for b in blocks:
        k = b.shape[-1]
        out[:, off:off + k, off:off + k] = b
        off += k
    return out


def _weight_deltas(ai, em, fd, gammas):
    """((1-g)·AI + g·EM)⁻¹ fd for every g of the grid: (S, G, nv).

    One Cholesky of EM = L Lᵀ and one symmetric eigendecomposition of the
    whitened pencil L⁻¹ AI L⁻ᵀ = Q diag(mu) Qᵀ give, for every g,
    delta(g) = L⁻ᵀ Q diag(1/((1-g) mu + g)) Qᵀ L⁻¹ fd, exactly the solve of
    the blend.  A singular blend gives inf/NaN, which the PD test rejects."""
    low = torch.linalg.cholesky(em)
    b = torch.linalg.solve_triangular(low, ai, upper=False)
    aw = torch.linalg.solve_triangular(low, b.transpose(-1, -2), upper=False)
    mu, q = torch.linalg.eigh((aw + aw.transpose(-1, -2)) / 2)
    rhs = (q.transpose(-1, -2) @ torch.linalg.solve_triangular(
        low, fd[..., None], upper=False))[..., 0]  # (S, nv)
    denom = ((1 - gammas)[None, :, None] * mu[:, None, :]
             + gammas[None, :, None])
    coef = rhs[:, None, :] / denom  # (S, G, nv)
    return torch.linalg.solve_triangular(
        low.transpose(-1, -2), q @ coef.transpose(-1, -2), upper=True
    ).transpose(-1, -2)


def _search(var, deltas, cd_a, cd_p):
    """Of the candidate updates `deltas` (S, G, nv) to `var` (S, nv), the
    first that keeps both blocks PD and the residual > 0 (the last where
    none does): (index (S,), delta (S, nv), any (S,))."""
    ok = _pd_ok(*_cov_from_vec(var[:, None, :] + deltas, cd_a, cd_p))
    idx, any_ok = _first_ok(ok)
    delta = deltas[torch.arange(len(idx), device=idx.device), idx]
    return idx, delta, any_ok


def _grid(step: float) -> np.ndarray:
    """The EM-weight grid {0, step, ..., 1} (reference balance_emai.py:53)."""
    return np.append(np.arange(0.0, 1.0, step), 1.0)


def em_mat_eigen(cov_dim: int, cov_add, cov_per, ran_df: int, var_com,
                 num_record: int, device=None) -> np.ndarray:
    """EM-style Hessian (reference pre_em_mat_eigen, iter_mat.py:294-319);
    host arrays in and out."""
    dev = resolve_device(device)
    em = _em_core(as_exact(cov_add, dev)[None], as_exact(cov_per, dev)[None],
                  ran_df, ran_df, as_exact([var_com[-1]], dev), num_record)
    return em[0].cpu().numpy()


def weight_search(ai, em, fd, var_com, cov_dim: int, step: float,
                  device=None):
    """First gamma in {0, step, ..., 1} whose blended update keeps both
    covariance blocks PD and the residual > 0 (reference
    balance_emai.py:53-64); host arrays in, (gamma, delta) out."""
    dev = resolve_device(device)
    gammas = _grid(step)
    deltas = _weight_deltas(as_exact(ai, dev)[None], as_exact(em, dev)[None],
                            as_exact(fd, dev)[None], as_exact(gammas, dev))
    idx, delta, any_ok = _search(as_exact(var_com, dev)[None], deltas,
                                 cov_dim, cov_dim)
    if not bool(any_ok[0]):
        raise RuntimeError("no EM weight yields positive-definite covariances")
    return float(gammas[int(idx[0])]), delta[0].cpu().numpy()


def _tensors(leg_tp, vind, dev):
    """The derivative kernels and the per-parameter tables on `dev`."""
    return (as_exact(_tit_stack(leg_tp, vind), dev),
            torch.as_tensor(vind[:-1, 0] == 0, device=dev),
            torch.as_tensor(vind[:-1, 1], device=dev),
            torch.as_tensor(vind[:-1, 2], device=dev))


def balance_emai(y, xmat, leg_tp, kin_eigen_val, init, maxiter=30,
                 cc_par=1.0e-8, cc_gra=1.0e-6, em_weight_step=0.02,
                 device=None):
    """Core REML loop; returns the tidy (vari, varij, varik, var_val) frame
    (reference balance_emai.py:13-84).  y (n, T) and xmat (n, T, p) are
    host arrays or tensors; one host sync per iteration (the convergence
    test)."""
    dev = resolve_device(device)
    y = torch.as_tensor(y, dtype=EXACT_DTYPE).to(dev)
    if y.dim() == 3:
        y = y[:, :, 0]
    xmat = torch.as_tensor(xmat, dtype=EXACT_DTYPE).to(dev)
    lam = torch.as_tensor(kin_eigen_val, dtype=EXACT_DTYPE).to(dev)
    leg_tp = np.asarray(leg_tp, dtype=np.float64)
    num_record = y.numel()
    ran_df = lam.shape[0]
    cov_dim = leg_tp.shape[1]
    var_com = np.asarray(init, dtype=np.float64)
    vind = var_index(cov_dim)
    tit, is_add, jj, kk = _tensors(leg_tp, vind, dev)
    if unpack_cov(cov_dim, var_com) is None:
        raise ValueError("The covariances are not positive defined!")
    leg_d = as_exact(leg_tp, dev)
    gammas = as_exact(_grid(em_weight_step), dev)
    var = as_exact(var_com, dev)[None]
    for it in range(1, maxiter + 1):
        cov_add, cov_per, res_var = _cov_from_vec(var, cov_dim, cov_dim)
        fd, ai = _fdai(y, xmat[None], leg_d, lam, cov_add, cov_per, res_var,
                       tit, is_add, jj, kk)
        em = _em_core(cov_add, cov_per, ran_df, ran_df, res_var, num_record)
        idx, delta, any_ok = _search(
            var, _weight_deltas(ai, em, fd, gammas), cov_dim, cov_dim)
        var_new = var + delta
        cc_par_val = torch.sqrt(torch.sum(delta**2) / torch.sum(var_new**2))
        cc_gra_val = torch.sqrt(torch.sum(fd**2)) / var.shape[1]
        ok, g_idx, cc_par_val, cc_gra_val = (
            bool(any_ok[0]), int(idx[0]), float(cc_par_val), float(cc_gra_val))
        if not ok:
            raise RuntimeError(
                "no EM weight yields positive-definite covariances")
        var = var_new
        logger.info("Round %d: gamma %.3f | cc_par %.3e | cc_gra %.3e",
                    it, float(gammas[g_idx]), cc_par_val, cc_gra_val)
        if cc_par_val < cc_par and cc_gra_val < cc_gra:
            logger.info("Variances Converged")
            break
    return pd.DataFrame(
        {
            "vari": vind[:, 0] + 1,
            "varij": vind[:, 1] + 1,
            "varik": vind[:, 2] + 1,
            "var_val": var[0].cpu().numpy(),
        }
    )


@dataclass
class BalanceModel:
    """Prepared eigen-space balanced design (shared by varcom + GWAS); the
    tensors live on the device of `prepare_balance`."""

    data: LongData
    y: torch.Tensor  # (n, T) rotated
    xmat: torch.Tensor  # (n, T, p) rotated fixed design
    leg_fix: np.ndarray  # (T, forder+1) unrotated fixed Legendre basis
    leg_tp: np.ndarray  # (T, rorder+1)
    eigvals: torch.Tensor
    eigvecs: torch.Tensor
    tpoint: np.ndarray


def _kin_eigh(kin):
    """(eigenvalues, eigenvectors) of the kinship tensor on its device."""
    return torch.linalg.eigh(kin)


def prepare_balance(data_file, id_col, tpoint, trait, kin_file, forder=3,
                    rorder=3, na_method="omit", device=None) -> BalanceModel:
    dev = resolve_device(device)
    data = parse_long_data(data_file, id_col, na_method)
    ids = data.df[id_col].to_numpy()
    if len(set(ids)) != len(ids):
        raise ValueError("Duplicated ids exist in the data file!")
    kin = read_kin_by_codes(kin_file, data)
    eigvals, eigvecs = _kin_eigh(as_exact(kin, dev))
    tpoint = np.asarray(tpoint, dtype=float)
    leg_fix = leg_basis(tpoint, forder)  # (T, forder+1)
    leg_tp = leg_basis(tpoint, rorder)
    y = as_exact(data.df.iloc[:, list(trait)].to_numpy(dtype=float), dev)
    y = eigvecs.T @ y  # rotate over individuals
    # fixed design: per id the same Legendre rows, rotated by Uᵀ over ids
    # (reference balance_varcom.py:134-142): X_rot[i] = (Uᵀ 1)_i * leg_fix
    colsum = eigvecs.sum(dim=0)
    xmat = colsum[:, None, None] * as_exact(leg_fix, dev)[None, :, :]
    return BalanceModel(data=data, y=y, xmat=xmat, leg_fix=leg_fix,
                        leg_tp=leg_tp, eigvals=eigvals, eigvecs=eigvecs,
                        tpoint=tpoint)


def default_init(y, cov_dim):
    """Initial variances (reference balance_varcom.py:150-156)."""
    y_var = np.var(y) / (cov_dim * 2 + 1)
    tril_vals = np.diag([y_var] * cov_dim)[np.tril_indices(cov_dim)]
    return np.concatenate([tril_vals, tril_vals, [y_var]])


def balance_varcom(data_file, id_col, tpoint, trait, kin_file, tfix=None,
                   fix=None, forder=3, rorder=3, na_method="omit", init=None,
                   maxiter=100, cc_par=1.0e-8, cc_gra=1.0e6,
                   em_weight_step=0.001, prefix_outfile="balance_varcom",
                   device=None):
    """Reference balance_varcom (balance_varcom.py:13-174).  tfix/fix must be
    None (same restriction as the reference's current version)."""
    if tfix is not None or fix is not None:
        raise NotImplementedError(
            "tfix/fix must be None for balanced data (reference parity)"
        )
    model = prepare_balance(data_file, id_col, tpoint, trait, kin_file,
                            forder, rorder, na_method, device)
    cov_dim = model.leg_tp.shape[1]
    raw_y = model.data.df.iloc[:, list(trait)].to_numpy(dtype=float)
    var_com = default_init(raw_y, cov_dim) if init is None else np.asarray(init)
    res = balance_emai(model.y, model.xmat, model.leg_tp, model.eigvals,
                       init=var_com, maxiter=maxiter, cc_par=cc_par,
                       cc_gra=cc_gra, em_weight_step=em_weight_step,
                       device=model.y.device)
    res.to_csv(prefix_outfile + ".var", sep=" ", index=False)
    return res
