"""Dense symmetric linear algebra for the mixed-model core (float64).

Counterpart of `gmat_tpu/core/linalg.py` without the TPU's mixed-precision
inverse: the card has native FP64, so V⁻¹ comes from one float64 Cholesky.
"""
from __future__ import annotations

import torch


def chol_inv_logdet(a):
    """(A⁻¹, log|A|) for SPD A via one Cholesky factorization."""
    c = torch.linalg.cholesky(a)
    logdet = 2.0 * torch.sum(torch.log(torch.diagonal(c)))
    eye = torch.eye(a.shape[0], dtype=a.dtype, device=a.device)
    return torch.cholesky_solve(eye, c), logdet


def projection_pieces(vinv, xmat):
    """P = V⁻¹ − V⁻¹X (XᵀV⁻¹X)⁻¹ XᵀV⁻¹ and log|XᵀV⁻¹X|."""
    vx = vinv @ xmat
    xvx = xmat.T @ vx
    xvx_inv, ll_xvx = chol_inv_logdet(xvx)
    return vinv - vx @ xvx_inv @ vx.T, ll_xvx


def sym_trace_product(a, b):
    """tr(A·B) for symmetric A, B as the Frobenius inner product."""
    return torch.sum(a * b)
