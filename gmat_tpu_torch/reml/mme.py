"""Henderson-MME REML variants (counterpart of `gmat_tpu/reml/mme.py`).

- `em_mme`        single-GRM-inverse EM
- `pxem_mme`      parameter-expanded EM
- `ai_mme`        pure AI updates
- `emai_mme`      AI with an EM-weight fallback on the grid 0, 0.1, …, 5.0
  (past 1.0: the reference's grid, kept verbatim)
- `pxemai_mme`    PX-accelerated emai
- `em_mme_multi`  multi-GRM MME EM
- `em_vmat`       V-based EM with an AI-free diagonal update

All but `em_vmat` share one core: C = [X Z]ᵀ[X Z]/σ²_e +
blockdiag(G_k⁻¹/σ²_k), inverted once per iteration on `device` in float64.
The small AI systems are solved with `solve_ex` (`ai_mme`) and
`core.linalg.weighted_ai_step` (the EM-weight searches): a singular system
gives inf/NaN, as in the JAX package, instead of an error.
"""
from __future__ import annotations

import logging

import numpy as np
import torch

from gmat_tpu_torch.config import EXACT_DTYPE, as_exact, resolve_device
from gmat_tpu_torch.core.linalg import (chol_inv_logdet, projection_pieces,
                                         weighted_ai_step)

logger = logging.getLogger(__name__)


def _mme_setup(y, xmat, gmat_inv, device=None):
    """Device tensors of the single-GRM MME with Z = I:
    (y, X, G⁻¹, W = [X I], C₀ = WᵀW, p, q)."""
    dev = resolve_device(device)
    y = as_exact(np.asarray(y, float).reshape(-1), dev)
    xmat = as_exact(np.asarray(xmat, float).reshape(len(y), -1), dev)
    g_inv = as_exact(gmat_inv, dev)
    p, q = xmat.shape[1], g_inv.shape[0]
    eye = torch.eye(q, dtype=EXACT_DTYPE, device=dev)
    wmat = torch.cat([xmat, eye], dim=1)
    coef_pre = torch.eye(p + q, dtype=EXACT_DTYPE, device=dev)
    coef_pre[:p, :p] = xmat.T @ xmat
    coef_pre[:p, p:] = xmat.T
    coef_pre[p:, :p] = xmat
    return y, xmat, g_inv, wmat, coef_pre, p, q


def _mme_solve(var, y, xmat, g_inv, wmat, coef_pre):
    """(C⁻¹, [b; u], ê) at the variances `var` = (σ²_g, σ²_e)."""
    p = xmat.shape[1]
    coef = coef_pre / var[1]
    coef[p:, p:] += g_inv / var[0]
    coef_inv = torch.linalg.inv(coef)
    eff = coef_inv @ (wmat.T @ y) / var[1]
    e_hat = y - xmat @ eff[:p] - eff[p:]
    return coef_inv, eff, e_hat


def _em_update(var, coef_inv, eff, e_hat, g_inv, wmat, p, q, n):
    u = eff[p:]
    v0 = (u @ (g_inv @ u) + torch.sum(g_inv * coef_inv[p:, p:])) / q
    v1 = (torch.dot(e_hat, e_hat)
          + torch.sum((wmat @ coef_inv) * wmat)) / n
    return torch.stack([v0, v1])


def _gamma_px(eff, e_hat, y, xmat, coef_inv, p):
    u = eff[p:]
    g1 = torch.dot(u, y - xmat @ eff[:p]) - torch.trace(xmat @ coef_inv[:p, p:])
    g2 = torch.dot(u, u) + torch.trace(coef_inv[p:, p:])
    return g1 / g2


def _fd_ai(var, coef_inv, eff, e_hat, g_inv, wmat, p, q, n):
    """First derivatives of the REML log-likelihood and the AI matrix."""
    u = eff[p:]
    fd0 = q / var[0] - torch.sum(coef_inv[p:, p:] * g_inv) / var[0] ** 2 \
        - u @ (g_inv @ u) / var[0] ** 2
    fd1 = n / var[1] - torch.sum((coef_inv @ wmat.T) * wmat.T) / var[1] ** 2 \
        - torch.dot(e_hat, e_hat) / var[1] ** 2
    fd = -0.5 * torch.stack([fd0, fd1])
    h = torch.stack([u / var[0], e_hat / var[1]], dim=1)
    qrq = (h.T @ h) / var[-1]
    left = (wmat.T @ h) / var[-1]
    ai = 0.5 * (qrq - left.T @ (coef_inv @ left))
    return fd, ai


def _converge(step, var, maxiter, cc_par, cc_gra=None):
    """Iterate `step` (var tensor -> (var_new, grad or None)) from `var`
    until ‖Δ‖/‖σ²‖ < cc_par (and ‖∇‖ < cc_gra when given)."""
    for it in range(1, maxiter + 1):
        var_new, fd = step(var)
        var_new = var_new.cpu().numpy()
        delta = var_new - var
        cc_par_val = np.sqrt(np.sum(delta**2) / np.sum(var_new**2))
        var = var_new
        if fd is None:
            logger.info("Round %d: %s (cc %.3e)", it, var, cc_par_val)
            done = cc_par_val < cc_par
        else:
            cc_gra_val = float(torch.sqrt(torch.sum(fd**2)))
            logger.info("Round %d: %s (cc %.3e grad %.3e)", it, var,
                        cc_par_val, cc_gra_val)
            done = cc_gra_val < cc_gra and cc_par_val < cc_par
        if done:
            logger.info("Variances converged.")
            break
    return var


def _loop(y, xmat, gmat_inv, init, maxiter, cc, update_fn, device):
    y, xmat, g_inv, wmat, coef_pre, p, q = _mme_setup(y, xmat, gmat_inv,
                                                      device)
    n = y.shape[0]

    def step(var):
        var_d = torch.as_tensor(var, device=y.device)
        coef_inv, eff, e_hat = _mme_solve(var_d, y, xmat, g_inv, wmat,
                                          coef_pre)
        return update_fn(var_d, coef_inv, eff, e_hat, g_inv, wmat, xmat, y,
                         p, q, n), None

    var = np.asarray(init, float) if init is not None else np.ones(2)
    return _converge(step, var, maxiter, cc)


def em_mme(y, xmat, gmat_inv, init=None, maxiter=100, cc=1.0e-8,
           device=None):
    """EM-REML of (σ²_g, σ²_e) from the MME with G⁻¹; returns numpy."""
    def upd(var, coef_inv, eff, e_hat, g_inv, wmat, xmat_, y_, p, q, n):
        return _em_update(var, coef_inv, eff, e_hat, g_inv, wmat, p, q, n)

    return _loop(y, xmat, gmat_inv, init, maxiter, cc, upd, device)


def pxem_mme(y, xmat, gmat_inv, init=None, maxiter=100, cc=1.0e-8,
             device=None):
    """Parameter-expanded EM-REML; returns numpy (σ²_g, σ²_e)."""
    def upd(var, coef_inv, eff, e_hat, g_inv, wmat, xmat_, y_, p, q, n):
        v = _em_update(var, coef_inv, eff, e_hat, g_inv, wmat, p, q, n)
        gamma = _gamma_px(eff, e_hat, y_, xmat_, coef_inv, p)
        return torch.stack([v[0] * gamma * gamma, v[1]])

    return _loop(y, xmat, gmat_inv, init, maxiter, cc, upd, device)


def ai_mme(y, xmat, gmat_inv, init=None, maxiter=100, cc=1.0e-8,
           device=None):
    """AI-REML with no fallback; returns numpy (σ²_g, σ²_e)."""
    def upd(var, coef_inv, eff, e_hat, g_inv, wmat, xmat_, y_, p, q, n):
        fd, ai = _fd_ai(var, coef_inv, eff, e_hat, g_inv, wmat, p, q, n)
        return var + torch.linalg.solve_ex(ai, fd)[0]

    return _loop(y, xmat, gmat_inv, init, maxiter, cc, upd, device)


# the reference's EM-weight grid is j*0.1 for j in 0..50: it runs past 1.0
_EMAI_GRID = np.linspace(0.0, 5.0, 51)


def _emai_step(var, coef_inv, eff, e_hat, g_inv, wmat, p, q, n):
    """The AI update blended with the EM one at the first grid weight that
    keeps both variances positive; returns (var_new, weight)."""
    fd, ai = _fd_ai(var, coef_inv, eff, e_hat, g_inv, wmat, p, q, n)
    em = torch.diag(torch.stack([q / (var[0] * var[0]),
                                 n / (var[1] * var[1])]))
    grid = torch.as_tensor(_EMAI_GRID, dtype=var.dtype, device=var.device)
    delta, idx = weighted_ai_step(var, fd, ai, em, grid)
    return var + delta, grid[idx]


def emai_mme(y, xmat, gmat_inv, init=None, maxiter=100, cc=1.0e-8,
             device=None):
    """AI-REML with the 0.1-step EM-weight fallback; returns numpy."""
    def upd(var, coef_inv, eff, e_hat, g_inv, wmat, xmat_, y_, p, q, n):
        return _emai_step(var, coef_inv, eff, e_hat, g_inv, wmat, p, q, n)[0]

    return _loop(y, xmat, gmat_inv, init, maxiter, cc, upd, device)


def pxemai_mme(y, xmat, gmat_inv, init=None, maxiter=100, cc=1.0e-8,
               device=None):
    """PX-accelerated emai: the PX rescale of σ²_g applies only when the
    chosen EM weight is above 0.001; returns numpy."""
    def upd(var, coef_inv, eff, e_hat, g_inv, wmat, xmat_, y_, p, q, n):
        var_new, weight = _emai_step(var, coef_inv, eff, e_hat, g_inv, wmat,
                                     p, q, n)
        px = _gamma_px(eff, e_hat, y_, xmat_, coef_inv, p)
        scaled = torch.stack([var_new[0] * px * px, var_new[1]])
        return torch.where(weight > 0.001, scaled, var_new)

    return _loop(y, xmat, gmat_inv, init, maxiter, cc, upd, device)


def em_mme_multi(y, xmat, zmat_lst, gmat_inv_lst, init=None, maxiter=100,
                 cc_par=1.0e-8, device=None):
    """Multi-GRM MME EM.  `zmat_lst` entries are (n_rec, q_k) incidence
    matrices, dense or scipy sparse; returns numpy (σ²_1 … σ²_k, σ²_e)."""
    dev = resolve_device(device)
    y = np.asarray(y, float).reshape(-1)
    xmat = np.asarray(xmat, float).reshape(len(y), -1)
    zs = [np.asarray(z.todense()) if hasattr(z, "todense") else np.asarray(z)
          for z in zmat_lst]
    xz = as_exact(np.concatenate([xmat] + zs, axis=1), dev)
    y_d = as_exact(y, dev)
    coef_null = xz.T @ xz
    rhs_null = xz.T @ y_d
    p = xmat.shape[1]
    qs = [g.shape[0] for g in gmat_inv_lst]
    offs = np.concatenate([[p], p + np.cumsum(qs)]).tolist()
    g_ds = [as_exact(g, dev) for g in gmat_inv_lst]

    def step(var):
        var_ = torch.as_tensor(var, device=dev)
        coef = coef_null / var_[-1]
        for k, g in enumerate(g_ds):
            a, b = offs[k], offs[k + 1]
            coef[a:b, a:b] += g / var_[k]
        coef_inv = torch.linalg.inv(coef)
        eff = coef_inv @ (rhs_null / var_[-1])
        e_hat = y_d - xz @ eff
        v_res = (torch.dot(e_hat, e_hat)
                 + torch.sum(coef_null * coef_inv)) / len(y)
        news = []
        for k, g in enumerate(g_ds):
            a, b = offs[k], offs[k + 1]
            u = eff[a:b]
            news.append((torch.sum(coef_inv[a:b, a:b] * g) + u @ (g @ u))
                        / qs[k])
        return torch.stack(news + [v_res]), None

    var = np.asarray(init, float) if init is not None else np.ones(len(qs) + 1)
    return _converge(step, var, maxiter, cc_par)


def em_vmat(y, xmat, zmat_lst, gmat_lst, init=None, maxiter=100,
            cc_par=1.0e-8, cc_gra=1.0e-6, device=None):
    """V-based EM with the diagonal update Δ = (2σ⁴/n)·∇ (the reference's
    undefined `cc_gra` is an argument here, as in the JAX package).
    Z G Zᵀ is formed on the host (Z may be scipy sparse), then moved to
    `device`; returns numpy (σ²_1 … σ²_k, σ²_e)."""
    dev = resolve_device(device)
    y = np.asarray(y, float).reshape(-1)
    n = len(y)
    xmat_d = as_exact(np.asarray(xmat, float).reshape(n, -1), dev)
    zg = torch.stack([as_exact(z.dot(z.dot(np.asarray(g)).T), dev)
                      for z, g in zip(zmat_lst, gmat_lst)])
    y_d = as_exact(y, dev)
    eye = torch.eye(n, dtype=EXACT_DTYPE, device=dev)

    def step(var):
        var_ = torch.as_tensor(var, device=dev)
        vmat = torch.einsum("k,kij->ij", var_[:-1], zg) + var_[-1] * eye
        vinv, _ = chol_inv_logdet(vmat)
        pmat, _ = projection_pieces(vinv, xmat_d)
        py = pmat @ y_d
        tr_terms = torch.einsum("ij,kij->k", pmat, zg)
        quad = torch.einsum("i,kij,j->k", py, zg, py)
        fd = 0.5 * torch.cat([-tr_terms + quad,
                              (-torch.trace(pmat) + torch.dot(py, py))[None]])
        return var_ + (2.0 * var_ * var_ / n) * fd, fd

    var = (np.asarray(init, float) if init is not None
           else np.ones(len(gmat_lst) + 1))
    return _converge(step, var, maxiter, cc_par, cc_gra)
