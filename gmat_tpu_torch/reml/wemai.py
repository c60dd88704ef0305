"""Weighted EM + AI REML for the multi-GRM univariate mixed model.

Model: y = Xb + Σ_i Z u_i + e,  u_i ~ N(0, G_i σ²_i),  e ~ N(0, I σ²_e).

Counterpart of the float64 path of `gmat_tpu/reml/wemai.py`:
- per iteration: V, log|V|, V⁻¹ (one Cholesky), P, -2logL, gradient, AI
  matrix, EM Hessian diag(n/σ⁴), then the 0.01-step weight search picking
  the first w ∈ {0, .01, …, 1} whose blended update keeps all variances
  positive — the 101 candidate systems are one batched solve
  (`core.linalg.weighted_ai_step`);
- dual convergence on ‖Δ‖/‖σ²‖ < cc_par and ‖∇‖ < cc_gra.

The entry points take the JAX package's `precision=` ("auto", "f64" or
"mixed", any case) and reject any other value, but every value runs the
float64 path: the JAX package's mixed-precision inverse exists for the
TPU, where float64 is emulated, and Hopper has native FP64.  The JAX
package's `GMAT_TPU_REML` override selects that TPU path and is not read.
"""
from __future__ import annotations

import logging

import numpy as np
import torch

from gmat_tpu_torch.config import EXACT_DTYPE, resolve_device
from gmat_tpu_torch.core.linalg import (chol_inv_logdet, projection_pieces,
                                         weighted_ai_step)
from gmat_tpu_torch.core.spans import span
from gmat_tpu_torch.io.pheno import (DesignMatrices, design_matrix,
                                     design_matrix_pred)

logger = logging.getLogger(__name__)

_WEIGHTS = np.linspace(0.0, 1.0, 101)


def build_zgzt_stack(dm: DesignMatrices, gmat_lst, device=None) -> torch.Tensor:
    """(k, n_rec, n_rec) float64 stack of Z G_i Zᵀ."""
    return torch.stack([dm.zgzt(g, device) for g in gmat_lst])


def _vmat(var_com, zg_stack):
    n = zg_stack.shape[1]
    vmat = torch.einsum("k,kij->ij", var_com[:-1], zg_stack)
    return vmat + var_com[-1] * torch.eye(n, dtype=vmat.dtype,
                                          device=vmat.device)


def _reml_step(var_com, y, xmat, zg_stack):
    """One EM+AI iteration; returns (var_new, -2logL, cc_par, cc_gra,
    weight) as tensors on the step's device."""
    n = y.shape[0]
    vinv, ll_v = chol_inv_logdet(_vmat(var_com, zg_stack))
    pmat, ll_xvx = projection_pieces(vinv, xmat)
    py = pmat @ y
    ll_val = -2.0 * (ll_v + ll_xvx + torch.dot(y, py))

    # gradient: fd_i = ½(−tr(P ZG_i) + yᵀP ZG_i Py); residual uses ZG := I
    tr_terms = torch.einsum("ij,kij->k", pmat, zg_stack)
    zg_py = torch.einsum("kij,j->ik", zg_stack, py)  # (n, k)
    quad_terms = py @ zg_py
    fd_e = -torch.trace(pmat) + torch.dot(py, py)
    fd = 0.5 * torch.cat([-tr_terms + quad_terms, fd_e[None]])

    # AI matrix: W = [ZG_1·Py, …, ZG_k·Py, Py];  AI = ½ Wᵀ P W
    wv = torch.cat([zg_py, py[:, None]], dim=1)
    ai = 0.5 * wv.T @ (pmat @ wv)
    em = torch.diag(n / (var_com * var_com))

    weights = torch.as_tensor(_WEIGHTS, dtype=var_com.dtype,
                              device=var_com.device)
    delta, idx = weighted_ai_step(var_com, fd, ai, em, weights)
    var_new = var_com + delta

    cc_par = torch.sqrt(torch.sum(delta * delta) / torch.sum(var_new * var_new))
    cc_gra = torch.sqrt(torch.sum(fd * fd))
    return var_new, ll_val, cc_par, cc_gra, weights[idx]


def _check_precision(precision: str) -> None:
    """Raise ValueError, as the JAX package does, for a `precision` other
    than "auto", "f64" or "mixed"; all three run in float64 here."""
    mode = str(precision).lower()
    if mode not in ("auto", "f64", "mixed"):
        raise ValueError(f"unknown REML precision {mode!r}")


def wemai_reml(dm: DesignMatrices, gmat_lst, init=None, maxiter: int = 200,
               cc_par: float = 1.0e-8, cc_gra: float = 1.0e-6,
               precision: str = "auto", device=None):
    """Core REML driver; returns the converged variance-component vector.

    Spans: `reml.zgzt` (the GRMs to the device) and `reml.iterate` (the
    loop, counting `iterations` and `at_limit`, 1 where it stopped at
    `maxiter` unconverged).  A round's INFO line reads -2logL and the
    weight from the device only where that line is logged."""
    _check_precision(precision)
    dev = resolve_device(device)
    k = len(gmat_lst)
    var_com = (np.array(init, dtype=np.float64) if init is not None
               else np.ones(k + 1))
    y = torch.as_tensor(dm.y, dtype=EXACT_DTYPE, device=dev)
    xmat = torch.as_tensor(dm.xmat, dtype=EXACT_DTYPE, device=dev)
    with span("reml.zgzt"):
        zg = build_zgzt_stack(dm, gmat_lst, dev)
    logger.info("Initial variances: %s", " ".join(map(str, var_com)))
    converged = False
    with span("reml.iterate") as s:
        it = 0
        while it < maxiter:
            it += 1
            var_new, ll_val, ccp, ccg, weight = _reml_step(
                torch.as_tensor(var_com, device=dev), y, xmat, zg)
            var_com = var_new.cpu().numpy()
            ccp, ccg = float(ccp), float(ccg)
            if logger.isEnabledFor(logging.INFO):
                logger.info(
                    "Round %d: -2logL %.6f | grad %.3e | update %.3e | "
                    "weight %.2f | vars %s",
                    it, float(ll_val), ccg, ccp, float(weight),
                    " ".join(f"{v:.6g}" for v in var_com),
                )
            if ccg < cc_gra and ccp < cc_par:
                converged = True
                break
        s.count("iterations", it)
        s.count("at_limit", int(not converged))
    logger.info("Variances %sconverged.", "" if converged else "not ")
    return var_com


def wemai_multi_gmat(pheno_file: str, bed_prefix: str, gmat_lst, init=None,
                     maxiter: int = 200, cc_par: float = 1.0e-8,
                     cc_gra: float = 1.0e-6,
                     out_file: str = "wemai_multi_gmat.var",
                     precision: str = "auto", device=None):
    """File-level wrapper; writes the variance vector with np.savetxt.
    Spans: the root `reml`, and under it `reml.parse` (the design) and
    `reml.write` besides `wemai_reml`'s."""
    _check_precision(precision)
    with span("reml", root=True):
        with span("reml.parse"):
            dm = design_matrix(pheno_file, bed_prefix)
        var_com = wemai_reml(dm, gmat_lst, init=init, maxiter=maxiter,
                             cc_par=cc_par, cc_gra=cc_gra,
                             precision=precision, device=device)
        with span("reml.write"):
            np.savetxt(out_file, var_com)
    return var_com


def _blup_effects(var_com, y, xmat, zg_stack, gmat_stack, rec_ids, n_col):
    """BLUPs of the random effects, u_k = σ²_k G_k Zᵀ P y, as an
    (n_col, k) tensor."""
    vinv, _ = chol_inv_logdet(_vmat(var_com, zg_stack))
    pmat, _ = projection_pieces(vinv, xmat)
    py = pmat @ y
    zpy = torch.zeros(n_col, dtype=py.dtype, device=py.device).index_add_(
        0, rec_ids, py)
    return torch.einsum("k,kij,j->ik", var_com[:-1], gmat_stack, zpy)


def wemai_multi_gmat_pred(pheno_file: str, bed_prefix: str, gmat_lst,
                          init=None, maxiter: int = 200, cc_par: float = 1.0e-8,
                          cc_gra: float = 1.0e-6,
                          out_file: str = "wemai_multi_gmat_pred",
                          precision: str = "auto", device=None):
    """REML + BLUP of the random effects over every genotyped individual,
    phenotyped or not; writes `<out>.var` and `<out>.rand_eff` (one row per
    .fam individual, one column per GRM) and returns the variances.

    Documented deviation, as in the JAX package: the reference builds the
    prediction's P from V where its estimation path uses V⁻¹; here P is
    V⁻¹ − V⁻¹X(XᵀV⁻¹X)⁻¹XᵀV⁻¹.  Every accepted `precision` computes both
    the REML and the BLUPs in float64 (see the module docstring)."""
    _check_precision(precision)
    dev = resolve_device(device)
    with span("reml", root=True):
        with span("reml.parse"):
            dm = design_matrix_pred(pheno_file, bed_prefix)
        var_com = wemai_reml(dm, gmat_lst, init=init, maxiter=maxiter,
                             cc_par=cc_par, cc_gra=cc_gra,
                             precision=precision, device=dev)
        with span("reml.write"):
            np.savetxt(out_file + ".var", var_com)
        rand_eff = _blup_effects(
            torch.as_tensor(var_com, device=dev),
            torch.as_tensor(dm.y, dtype=EXACT_DTYPE, device=dev),
            torch.as_tensor(dm.xmat, dtype=EXACT_DTYPE, device=dev),
            build_zgzt_stack(dm, gmat_lst, dev),
            torch.stack([torch.as_tensor(g, dtype=EXACT_DTYPE, device=dev)
                         for g in gmat_lst]),
            dm.rec_index(dev),
            dm.n_col,
        )
        with span("reml.write"):
            np.savetxt(out_file + ".rand_eff", rand_eff.cpu().numpy())
    return var_com
