"""Weighted EM + AI REML for the multi-GRM univariate mixed model.

Model: y = Xb + Σ_i Z u_i + e,  u_i ~ N(0, G_i σ²_i),  e ~ N(0, I σ²_e).

Counterpart of the float64 path of `gmat_tpu/reml/wemai.py`:
- per iteration: V, log|V|, V⁻¹ (one Cholesky), P, -2logL, gradient, AI
  matrix, EM Hessian diag(n/σ⁴), then the 0.01-step weight search picking
  the first w ∈ {0, .01, …, 1} whose blended update keeps all variances
  positive — the 101 candidate systems are one batched solve
  (`core.linalg.weighted_ai_step`);
- dual convergence on ‖Δ‖/‖σ²‖ < cc_par and ‖∇‖ < cc_gra.

On a card the iteration is one CUDA graph, captured on a device for each
new (n, k, p) and replayed once per iteration (`_GraphStep`): V⁻¹ by recursive
Schur complements (`core.linalg.spd_inverse_logdet`), nothing waited for
inside the step, one copy of its results to pinned host memory after it.
The CPU runs the same step eagerly, with V⁻¹ from a Cholesky factor and
two triangular solves.

The entry points take the JAX package's `precision=` ("auto", "f64" or
"mixed", any case) and reject any other value, but every value runs the
float64 path: the JAX package's mixed-precision inverse exists for the
TPU, where float64 is emulated, and Hopper has native FP64.  The JAX
package's `GMAT_TPU_REML` override selects that TPU path and is not read.
"""
from __future__ import annotations

import logging
import threading

import numpy as np
import torch

from gmat_tpu_torch.config import EXACT_DTYPE, resolve_device
from gmat_tpu_torch.core import native
from gmat_tpu_torch.core.linalg import (chol_inv_logdet, not_positive_definite,
                                         projection_pieces,
                                         spd_inverse_logdet, weighted_ai_step)
from gmat_tpu_torch.core.spans import span
from gmat_tpu_torch.io.pheno import (DesignMatrices, design_matrix,
                                     design_matrix_pred)

logger = logging.getLogger(__name__)

_WEIGHTS = np.linspace(0.0, 1.0, 101)


def build_zgzt_stack(dm: DesignMatrices, gmat_lst, device=None,
                     out=None) -> torch.Tensor:
    """(k, n_rec, n_rec) float64 stack of Z G_i Zᵀ (into `out` if given)."""
    return torch.stack([dm.zgzt(g, device) for g in gmat_lst], out=out)


def _vmat(var_com, zg_stack):
    vmat = torch.einsum("k,kij->ij", var_com[:-1], zg_stack)
    vmat.diagonal().add_(var_com[-1])
    return vmat


def _reml_step(var_com, y, xmat, zg_stack, weights=None):
    """One EM+AI iteration; returns (var_new, -2logL, cc_par, cc_gra,
    weight, info) as tensors on the step's device.

    On the CPU a V or XᵀV⁻¹X that is not positive definite raises at once
    and info is None.  On a card nothing waits for the device, so that a
    CUDA graph may capture the step: info holds the two factorizations'
    `info` (0 where positive definite), and the other outputs mean nothing
    where one is not 0.  `weights`: the search's candidate weights on the
    step's device (`_WEIGHTS` when None)."""
    n = y.shape[0]
    if weights is None:
        weights = torch.as_tensor(_WEIGHTS, dtype=var_com.dtype,
                                  device=var_com.device)
    vmat = _vmat(var_com, zg_stack)
    if var_com.device.type == "cuda":
        vinv, ll_v, info_v = spd_inverse_logdet(vmat)
        vx = vinv @ xmat
        xvx_inv, ll_xvx, info_x = spd_inverse_logdet(xmat.T @ vx)
        pmat = vinv - vx @ xvx_inv @ vx.T  # `projection_pieces`' P
        info = torch.stack([info_v, info_x])
    else:
        vinv, ll_v = chol_inv_logdet(vmat)
        pmat, ll_xvx = projection_pieces(vinv, xmat)
        info = None
    py = pmat @ y
    ll_val = -2.0 * (ll_v + ll_xvx + torch.dot(y, py))

    # gradient: fd_i = ½(−tr(P ZG_i) + yᵀP ZG_i Py); residual uses ZG := I
    tr_terms = torch.einsum("ij,kij->k", pmat, zg_stack)
    k = zg_stack.shape[0]
    # (n, k); one product over the stack's rows, the einsum's bits on the
    # CPU, a third of its time on a card (which permutes the stack first)
    zg_py = (zg_stack.view(k * n, n) @ py).view(k, n).T.contiguous()
    quad_terms = py @ zg_py
    fd_e = -torch.trace(pmat) + torch.dot(py, py)
    fd = 0.5 * torch.cat([-tr_terms + quad_terms, fd_e[None]])

    # AI matrix: W = [ZG_1·Py, …, ZG_k·Py, Py];  AI = ½ Wᵀ P W
    wv = torch.cat([zg_py, py[:, None]], dim=1)
    ai = 0.5 * wv.T @ (pmat @ wv)
    em = torch.diag(n / (var_com * var_com))

    delta, idx = weighted_ai_step(var_com, fd, ai, em, weights)
    var_new = var_com + delta

    cc_par = torch.sqrt(torch.sum(delta * delta) / torch.sum(var_new * var_new))
    cc_gra = torch.sqrt(torch.sum(fd * fd))
    return var_new, ll_val, cc_par, cc_gra, torch.take(weights, idx), info


class _GraphStep:
    """`_reml_step` on a card as one CUDA graph, for one (n, k, p) shape:
    static buffers for the variances, y, X and the ZGZᵀ stack, captured
    once on the card's side stream `stream` and replayed once per
    iteration.  The graph writes var_new back into the variances' buffer,
    and one copy to pinned host memory brings var_new, -2logL, cc_par,
    cc_gra, the weight and both `info`s, on which the host waits once.  The first iteration after the buffers are made
    runs eagerly on that stream (the warm-up: cuBLAS's handle and
    workspace and the kernels' library are made there, outside the
    capture), then the graph is captured, into the memory pool of
    `previous` (the card's graph of the shape before, dropped once this
    one is captured) where there is one.  The capture neither synchronizes
    the card nor empties the allocator's caches, as `torch.cuda.graph`
    does: the host has waited for the warm-up already.  Replays add the
    graph's leaves to `core.native.LEAF_LAUNCHES`."""

    def __init__(self, dev, n, k, p, stream, previous=None):
        f = {"dtype": EXACT_DTYPE, "device": dev}
        self.shape = (n, k, p)
        self.stream = stream
        self.var = torch.empty(k + 1, **f)
        self.y = torch.empty(n, **f)
        self.xmat = torch.empty(n, p, **f)
        self.zg = torch.empty(k, n, n, **f)
        self.weights = torch.as_tensor(_WEIGHTS, **f)
        self.host = torch.empty(k + 7, dtype=EXACT_DTYPE, pin_memory=True)
        self.out = None
        self.graph = None
        self.leaves = 0  # leaf kernels in the graph
        self.previous = previous

    def _record(self):
        var_new, ll_val, ccp, ccg, weight, info = _reml_step(
            self.var, self.y, self.xmat, self.zg, self.weights)
        self.var.copy_(var_new)
        self.out = torch.cat([var_new, torch.stack([ll_val, ccp, ccg, weight]),
                              info.to(EXACT_DTYPE)])

    def _capture(self):
        graph = torch.cuda.CUDAGraph()
        pool = None if self.previous is None else self.previous.pool()
        before = native.LEAF_LAUNCHES["spd_leaf_inverse"]
        with torch.cuda.stream(self.stream):
            graph.capture_begin(pool=pool, capture_error_mode="thread_local")
            try:
                self._record()
            finally:
                graph.capture_end()
        self.leaves = native.LEAF_LAUNCHES["spd_leaf_inverse"] - before
        native.count_leaf_launches(-self.leaves)  # recorded, not run
        self.graph, self.previous = graph, None

    def __call__(self):
        """One iteration from the variances' buffer; returns (var_new,
        -2logL, cc_par, cc_gra, weight) on the host and whether the
        iteration was a replay.  Raises LinAlgError as the CPU's step."""
        dev = self.var.device
        replayed = self.graph is not None
        if replayed:
            self.graph.replay()
            native.count_leaf_launches(self.leaves)
        else:
            self.stream.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(self.stream):
                self._record()
            torch.cuda.current_stream(dev).wait_stream(self.stream)
        self.host.copy_(self.out, non_blocking=True)
        torch.cuda.current_stream(dev).synchronize()
        got = self.host.numpy().copy()
        k1 = self.shape[1] + 1
        for order in got[k1 + 4:]:
            if order:
                raise not_positive_definite(int(order))
        if not replayed:
            self._capture()
        return (got[:k1], *map(float, got[k1:k1 + 4]), replayed)


class _Card:
    """A card's REML graph: the lock that runs one REML at a time on the
    card, the side stream its graphs are captured on, and the `_GraphStep`
    of the last shape, kept across calls.  One stream for every shape, so
    that the allocator's blocks cached for it and cuBLAS's workspace for it
    serve each new shape."""

    def __init__(self):
        self.lock = threading.Lock()
        self.stream = None
        self.step = None

    def step_for(self, dev, n, k, p) -> _GraphStep:
        """The kept `_GraphStep` for (n, k, p), or a new one in its place,
        whose capture reuses the old graph's memory."""
        old = self.step
        if old is None or old.shape != (n, k, p):
            previous = (None if old is None else old.previous
                        if old.graph is None else old.graph)
            self.step = None  # the old buffers go before the new are made
            del old
            if self.stream is None:
                self.stream = torch.cuda.Stream(dev)
            self.step = _GraphStep(dev, n, k, p, self.stream, previous)
        return self.step


_CARDS: dict = {}  # device -> _Card
_CARDS_LOCK = threading.Lock()


def _card(dev) -> tuple:
    """(the device with its index, its `_Card`)."""
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    with _CARDS_LOCK:
        return dev, _CARDS.setdefault(dev, _Card())


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

    On a card each iteration is a replay of one CUDA graph (`_GraphStep`;
    each card keeps the graph of the last shape across calls, `_Card`); on
    the CPU the step runs eagerly.  Spans: `reml.zgzt` (the GRMs to the device) and
    `reml.iterate` (the loop, counting `iterations`, `at_limit`, 1 where it
    stopped at `maxiter` unconverged, and `replays`, the iterations that
    ran as a graph replay)."""
    _check_precision(precision)
    dev = resolve_device(device)
    var_com = (np.array(init, dtype=np.float64) if init is not None
               else np.ones(len(gmat_lst) + 1))
    if dev.type == "cuda":
        dev, card = _card(dev)
        with card.lock, torch.cuda.device(dev):
            return _iterate(dm, gmat_lst, var_com, maxiter, cc_par, cc_gra,
                            dev, card)
    return _iterate(dm, gmat_lst, var_com, maxiter, cc_par, cc_gra, dev)


def _iterate(dm, gmat_lst, var_com, maxiter, cc_par, cc_gra, dev, card=None):
    """`wemai_reml`'s loop from the initial variances `var_com`."""
    if dev.type == "cuda":
        step = card.step_for(dev, dm.y.shape[0], len(gmat_lst),
                             dm.xmat.shape[1])
        step.y.copy_(torch.as_tensor(dm.y, dtype=EXACT_DTYPE))
        step.xmat.copy_(torch.as_tensor(dm.xmat, dtype=EXACT_DTYPE))
        with span("reml.zgzt"):
            build_zgzt_stack(dm, gmat_lst, dev, out=step.zg)
        step.var.copy_(torch.as_tensor(var_com))
    else:
        y = torch.as_tensor(dm.y, dtype=EXACT_DTYPE, device=dev)
        xmat = torch.as_tensor(dm.xmat, dtype=EXACT_DTYPE, device=dev)
        with span("reml.zgzt"):
            zg = build_zgzt_stack(dm, gmat_lst, dev)
        weights = torch.as_tensor(_WEIGHTS, dtype=EXACT_DTYPE, device=dev)

        def step():  # from the loop's current `var_com`
            var_new, ll_val, ccp, ccg, weight, _ = _reml_step(
                torch.as_tensor(var_com, device=dev), y, xmat, zg, weights)
            return (var_new.cpu().numpy(), ll_val, float(ccp), float(ccg),
                    weight, False)

    logger.info("Initial variances: %s", " ".join(map(str, var_com)))
    converged = False
    with span("reml.iterate") as s:
        it = replays = 0
        while it < maxiter:
            it += 1
            var_com, ll_val, ccp, ccg, weight, replayed = step()
            replays += replayed
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
        s.count("replays", replays)
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
