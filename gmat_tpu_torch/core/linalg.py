"""Dense symmetric linear algebra for the mixed-model core (float64).

Counterpart of `gmat_tpu/core/linalg.py` without the TPU's mixed-precision
inverse: the card has native FP64, so V⁻¹ comes from one float64 Cholesky
factorization and two triangular solves against the identity
(`chol_inv_logdet`).  REML's iteration on a card, one replayed CUDA graph,
takes V⁻¹ from recursive Schur complements instead (`spd_inverse_logdet`):
its work is matrix products on the FP64 tensor cores, and it waits for
nothing.  Launched eagerly, its ≈ 400 launches at n = 4,168 leave it slower
than the factorization and solves (13.6 against 10.7 ms on an H100), so no
eager caller takes it.
"""
from __future__ import annotations

import torch

from gmat_tpu_torch.core.native import SPD_LEAF, spd_leaf_inverse

_NO_FAILURE = 1 << 30  # a leaf's order where it has none


def spd_inverse_logdet(a):
    """(A⁻¹, log|A|, info) for symmetric A (n, n) by recursive Schur
    complements, with nothing waited for.

    A = [[A11, A21ᵀ], [A21, A22]] splits after the first half of its
    `SPD_LEAF`-row blocks; with T = A21 A11⁻¹ and S = A22 − T A21ᵀ,
    A⁻¹ = [[A11⁻¹ + TᵀS⁻¹T, (−S⁻¹T)ᵀ], [−S⁻¹T, S⁻¹]] and log|A| =
    log|A11| + log|S|.  Blocks of one leaf are inverted by
    `core.native.spd_leaf_inverse`.  That is a block Cholesky
    factorization, inverted as it goes: A is positive definite exactly where
    every leaf's pivots are positive, and `info` (0-dim int32) is 0 then,
    else the order of A's first leading minor that is not positive
    definite, as `torch.linalg.cholesky_ex` counts it.  The work is ≈ 4n³/3
    FLOP, all but the leaves' in matrix products on the FP64 tensor cores,
    where a Cholesky factorization and two triangular solves need 7n³/3."""
    n = a.shape[0]
    leaves = -(-n // SPD_LEAF)
    logdets = torch.empty(leaves, dtype=a.dtype, device=a.device)
    orders = torch.empty(leaves, dtype=torch.int32, device=a.device)
    out = torch.empty_like(a)
    _schur_into(a, out, 0, logdets, orders)
    first = torch.where(orders > 0, orders, _NO_FAILURE).amin()
    return out, logdets.sum(), torch.where(first == _NO_FAILURE, 0, first)


def _schur_into(a, out, offset, logdets, orders):
    """A⁻¹ into `out` (a view of the whole inverse), log|A| and the order
    of its leaves into their slots of `logdets` and `orders` (A's rows
    start at `offset` of the whole, a multiple of `SPD_LEAF`)."""
    n = a.shape[0]
    blocks = -(-n // SPD_LEAF)
    if blocks == 1:
        slot = offset // SPD_LEAF
        spd_leaf_inverse(a, out, logdets[slot], orders[slot], offset)
        return
    n1 = SPD_LEAF * ((blocks + 1) // 2)
    a21, a22 = a[n1:, :n1], a[n1:, n1:]
    x11, x21, x22 = out[:n1, :n1], out[n1:, :n1], out[n1:, n1:]
    _schur_into(a[:n1, :n1], x11, offset, logdets, orders)
    t = a21 @ x11
    _schur_into(torch.addmm(a22, t, a21.T, alpha=-1.0), x22, offset + n1,
                logdets, orders)
    x21.addmm_(x22, t, beta=0.0, alpha=-1.0)
    x11.addmm_(t.T, x21, alpha=-1.0)
    out[:n1, n1:].copy_(x21.T)


def chol_inv_logdet(a):
    """(A⁻¹, log|A|) for SPD A via one Cholesky factorization."""
    c = torch.linalg.cholesky(a)
    logdet = 2.0 * torch.sum(torch.log(torch.diagonal(c)))
    eye = torch.eye(a.shape[0], dtype=a.dtype, device=a.device)
    return torch.cholesky_solve(eye, c), logdet


def not_positive_definite(order):
    """The error `torch.linalg.cholesky` raises for a leading minor of
    `order` that is not positive definite."""
    return torch.linalg.LinAlgError(
        "linalg.cholesky: The factorization could not be completed because "
        f"the input is not positive-definite (the leading minor of order "
        f"{order} is not positive-definite).")


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
    and nothing waits for the device, so a CUDA graph may capture it."""
    w = weights[:, None, None]
    blends = (1.0 - w) * ai[None] + w * em[None]
    deltas = torch.linalg.solve_ex(
        blends, fd[None, :, None].expand(len(weights), -1, 1))[0][..., 0]
    ok = torch.amin(var[None, :] + deltas, dim=1) > 0.0
    idx = torch.where(torch.any(ok), torch.argmax(ok.to(torch.int8)),
                      len(weights) - 1)
    return deltas.index_select(0, idx.reshape(1))[0], idx
