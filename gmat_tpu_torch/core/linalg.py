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


def weighted_ai_step(var, fd, ai, em, weights):
    """The REML update ((1-w)·AI + w·EM)⁻¹ fd for the first weight w in
    `weights` that keeps every variance positive, the last weight when none
    does; returns (delta, index of w).

    All candidates are one batched `solve_ex`: a singular blend gives
    inf/NaN, which the positivity test drops (where `solve` would raise),
    and nothing waits for the device."""
    w = weights[:, None, None]
    blends = (1.0 - w) * ai[None] + w * em[None]
    deltas = torch.linalg.solve_ex(
        blends, fd[None, :, None].expand(len(weights), -1, 1))[0][..., 0]
    ok = torch.amin(var[None, :] + deltas, dim=1) > 0.0
    idx = torch.where(torch.any(ok), torch.argmax(ok.to(torch.int8)),
                      torch.tensor(len(weights) - 1, device=ok.device))
    return deltas[idx], idx
