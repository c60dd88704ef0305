"""The REML iteration of gmat_tpu_torch as it stood before its step became a
CUDA graph with V⁻¹ from potri: V⁻¹ by two triangular solves against the
identity, V as Σσ²ZGZᵀ + σ²_e·I, the weights uploaded each step, and the
variances through the host after every iteration.  Frozen here so that
the tests hold the present code to it: bit for bit on the CPU, to
rounding on a card.  Imports neither JAX nor the port's REML."""
import numpy as np
import torch

WEIGHTS = np.linspace(0.0, 1.0, 101)


def chol_inv_logdet(a):
    c = torch.linalg.cholesky(a)
    logdet = 2.0 * torch.sum(torch.log(torch.diagonal(c)))
    eye = torch.eye(a.shape[0], dtype=a.dtype, device=a.device)
    return torch.cholesky_solve(eye, c), logdet


def projection_pieces(vinv, xmat):
    vx = vinv @ xmat
    xvx = xmat.T @ vx
    xvx_inv, ll_xvx = chol_inv_logdet(xvx)
    return vinv - vx @ xvx_inv @ vx.T, ll_xvx


def weighted_ai_step(var, fd, ai, em, weights):
    w = weights[:, None, None]
    blends = (1.0 - w) * ai[None] + w * em[None]
    deltas = torch.linalg.solve_ex(
        blends, fd[None, :, None].expand(len(weights), -1, 1))[0][..., 0]
    ok = torch.amin(var[None, :] + deltas, dim=1) > 0.0
    idx = torch.where(torch.any(ok), torch.argmax(ok.to(torch.int8)),
                      torch.tensor(len(weights) - 1, device=ok.device))
    return deltas[idx], idx


def vmat(var_com, zg_stack):
    n = zg_stack.shape[1]
    v = torch.einsum("k,kij->ij", var_com[:-1], zg_stack)
    return v + var_com[-1] * torch.eye(n, dtype=v.dtype, device=v.device)


def reml_step(var_com, y, xmat, zg_stack):
    n = y.shape[0]
    vinv, ll_v = chol_inv_logdet(vmat(var_com, zg_stack))
    pmat, ll_xvx = projection_pieces(vinv, xmat)
    py = pmat @ y
    ll_val = -2.0 * (ll_v + ll_xvx + torch.dot(y, py))
    tr_terms = torch.einsum("ij,kij->k", pmat, zg_stack)
    zg_py = torch.einsum("kij,j->ik", zg_stack, py)
    quad_terms = py @ zg_py
    fd_e = -torch.trace(pmat) + torch.dot(py, py)
    fd = 0.5 * torch.cat([-tr_terms + quad_terms, fd_e[None]])
    wv = torch.cat([zg_py, py[:, None]], dim=1)
    ai = 0.5 * wv.T @ (pmat @ wv)
    em = torch.diag(n / (var_com * var_com))
    weights = torch.as_tensor(WEIGHTS, dtype=var_com.dtype,
                              device=var_com.device)
    delta, idx = weighted_ai_step(var_com, fd, ai, em, weights)
    var_new = var_com + delta
    cc_par = torch.sqrt(torch.sum(delta * delta) / torch.sum(var_new * var_new))
    cc_gra = torch.sqrt(torch.sum(fd * fd))
    return var_new, ll_val, cc_par, cc_gra, weights[idx]


def wemai_reml(y, xmat, zg, init=None, maxiter=200, cc_par=1.0e-8,
               cc_gra=1.0e-6):
    """The loop on the device of `zg` (y, xmat: host arrays); returns (the
    variances, the iterations run)."""
    dev = zg.device
    var_com = (np.array(init, dtype=np.float64) if init is not None
               else np.ones(zg.shape[0] + 1))
    y = torch.as_tensor(y, dtype=torch.float64, device=dev)
    xmat = torch.as_tensor(xmat, dtype=torch.float64, device=dev)
    it = 0
    while it < maxiter:
        it += 1
        var_new, _, ccp, ccg, _ = reml_step(
            torch.as_tensor(var_com, device=dev), y, xmat, zg)
        var_com = var_new.cpu().numpy()
        if float(ccg) < cc_gra and float(ccp) < cc_par:
            break
    return var_com, it
