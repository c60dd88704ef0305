"""Single-GRM REML via eigendecomposition — O(n²) per iteration.

Counterpart of `gmat_tpu/reml/eigen.py`: rotate y and X by the GRM's
eigenvectors so that V becomes diagonal, 1/(λ·σ²_g + σ²_e) on the inverse,
then AI-REML with the 0.02-step EM-weight search.  The eigendecomposition
(`torch.linalg.eigh`) and the rotation run on `device`; the 51 weight
candidates are one batched solve (`core.linalg.weighted_ai_step`).
"""
from __future__ import annotations

import logging

import numpy as np
import torch

from gmat_tpu_torch.config import as_exact, resolve_device
from gmat_tpu_torch.core.linalg import weighted_ai_step

logger = logging.getLogger(__name__)

_GAMMAS = np.linspace(0.0, 1.0, 51)


def _eigen_step(var, lam, y, xmat):
    """One AI-REML iteration in the rotated space; returns (var_new, cc)."""
    n = y.shape[0]
    vdiag = 1.0 / (lam * var[0] + var[1])  # V⁻¹ diagonal
    vx = vdiag[:, None] * xmat
    xvx_inv = torch.linalg.inv(xmat.T @ vx)

    def project(v):
        return vdiag * (v - xmat @ (xvx_inv @ (vx.T @ v)))

    py = project(y)
    add_py = lam * py
    p_add_py = project(add_py)
    p_res_py = project(py)

    tr_vd = torch.sum(vdiag * lam)
    tr_2d = torch.sum((xmat.T @ (vdiag[:, None] * lam[:, None] * vx)) * xvx_inv)
    fd0 = 0.5 * (-tr_vd + tr_2d + torch.dot(py, add_py))
    tr_vd = torch.sum(vdiag)
    tr_2d = torch.sum((xmat.T @ (vdiag[:, None] * vx)) * xvx_inv)
    fd1 = 0.5 * (-tr_vd + tr_2d + torch.dot(py, py))
    fd = torch.stack([fd0, fd1])

    a01 = torch.dot(add_py, p_res_py)
    ai = 0.5 * torch.stack([torch.stack([torch.dot(add_py, p_add_py), a01]),
                            torch.stack([a01, torch.dot(py, p_res_py)])])
    em = torch.diag(n / (var * var))
    delta, _ = weighted_ai_step(var, fd, ai, em, torch.as_tensor(
        _GAMMAS, dtype=var.dtype, device=var.device))
    var_new = var + delta
    cc = torch.sqrt(torch.sum(delta ** 2) / torch.sum(var_new ** 2))
    return var_new, cc


def uvlmm_varcom_eigen(y, xmat, gmat, init=None, maxiter=100, cc=1.0e-8,
                       device=None):
    """REML variances (σ²_g, σ²_e) of y = Xb + g + e, g ~ N(0, G σ²_g).

    Returns [var (2,), eigvecs (n, n), eigvals (n, 1)] as numpy arrays.
    Eigenvectors are defined up to sign (and rotation within a repeated
    eigenvalue): the default start var(Uᵀy)/2 depends on the signs, the
    REML maximum does not."""
    dev = resolve_device(device)
    lam, u = torch.linalg.eigh(as_exact(gmat, dev))
    y = np.asarray(y, dtype=np.float64).reshape(-1)
    yr = u.T @ as_exact(y, dev)
    xr = u.T @ as_exact(np.asarray(xmat, float).reshape(len(y), -1), dev)
    var = (np.asarray(init, float) if init is not None
           else np.array([float(torch.var(yr, correction=0)) / 2] * 2))
    for it in range(1, maxiter + 1):
        var_new, cc_val = _eigen_step(torch.as_tensor(var, device=dev), lam,
                                      yr, xr)
        var = var_new.cpu().numpy()
        logger.info("Round %d: cc %.3e vars %s", it, float(cc_val), var)
        if float(cc_val) < cc:
            break
    return [var, u.cpu().numpy(), lam.cpu().numpy().reshape(-1, 1)]
