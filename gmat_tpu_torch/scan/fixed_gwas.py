"""Fixed-effect (exact) single-SNP and pairwise LMM tests, and plain OLS.

Counterpart of `gmat_tpu/scan/fixed_gwas.py`:
- `uvlmm_gwas_add` / `uvlmm_gwas_dom`: per SNP, the SNP's column (for dom:
  the additive and the dominance column) appended to X, its coefficient
  GLS-tested under V = Σ σ²_k G_k + σ²_e I.  By partitioned regression the
  coefficient is eff = sᵀPy / sᵀPs with P the fixed-effect projection of
  V⁻¹, so the whole panel is two products with P;
- `uvlmm_gwas_add_eigen` / `uvlmm_gwas_dom_eigen`: the same for one GRM,
  with V diagonal in the GRM's eigenbasis (`torch.linalg.eigh` on
  `device`);
- `uvlmm_gwas_epiAA`: per pair, s_i, s_j and s_i·s_j appended to X and the
  interaction coefficient tested; one anchor's partners are one product
  P·(s_i ⊙ M) and a batch of 3x3 inverses;
- `lm_snp_eff` / `lm_pred`: per-SNP OLS effects and a naive prediction
  with V = I.

The models take the GRMs without Z, so y must hold one record per
genotyped individual, in .fam order; the entry points check the count.
Every product is a float64 `torch.matmul` on `device` (cuBLAS on the card).
"""
from __future__ import annotations

import logging

import numpy as np
import pandas as pd
import torch

from gmat_tpu_torch.config import as_exact, resolve_device
from gmat_tpu_torch.core.coding import additive_code, dominance_code
from gmat_tpu_torch.core.linalg import chol_inv_logdet, projection_pieces
from gmat_tpu_torch.core.stats import chi2_sf
from gmat_tpu_torch.reml.wemai import _vmat
from gmat_tpu_torch.scan.common import prepare_genotypes

logger = logging.getLogger(__name__)

_SNP_COLS = ["chro", "snp_ID", "pos", "allele1", "allele2"]


def _check_records(n_rec, n_id, what):
    if n_rec != n_id:
        raise ValueError(
            f"{n_rec} phenotype records against {n_id} individuals in the "
            f"{what}: these models need one record per genotyped individual, "
            "in .fam order")


def _pmat_direct(var_com, y, xmat, gmat_stack):
    """P from V = Σ σ²_k G_k + σ²_e I (no Z)."""
    vinv, _ = chol_inv_logdet(_vmat(var_com, gmat_stack))
    pmat, _ = projection_pieces(vinv, xmat)
    return pmat


def _direct_setup(y, xmat, gmat_lst, var_com, dev):
    """(y, P) on `dev` for the GRMs `gmat_lst`."""
    y = as_exact(np.asarray(y, float).reshape(-1), dev)
    xmat = as_exact(np.asarray(xmat, float).reshape(y.shape[0], -1), dev)
    for g in gmat_lst:
        _check_records(y.shape[0], np.shape(g)[0], "GRM")
    gstack = torch.stack([as_exact(g, dev) for g in gmat_lst])
    return y, _pmat_direct(as_exact(var_com, dev), y, xmat, gstack)


def _genotypes(bed_prefix, n_rec, dev):
    """(geno (n, m) float64 on `dev`, bim) after the record-count check."""
    geno, bim, _ = prepare_genotypes(bed_prefix)
    _check_records(n_rec, geno.shape[0], ".fam")
    return as_exact(geno, dev), bim


def _add_stats(mat, pm, py):
    """eff = sᵀPy / sᵀPs per column s of `mat` (pm = P·mat), its variance,
    chi and p."""
    quad = torch.sum(mat * pm, dim=0)  # sᵀPs
    eff = (mat.T @ py) / quad
    var = 1.0 / quad
    chi = eff * eff / var
    return eff, var, chi, chi2_sf(chi, 1)


def _dom_stats(mat_a, mat_d, pa, pd_, py):
    """The dominance coefficient of [X | s_add | s_dom], adjusted for the
    additive column: a 2x2 partitioned solve per SNP."""
    aa = torch.sum(mat_a * pa, dim=0)
    ad = torch.sum(mat_a * pd_, dim=0)
    dd = torch.sum(mat_d * pd_, dim=0)
    ay = mat_a.T @ py
    dy = mat_d.T @ py
    det = aa * dd - ad * ad
    eff = (aa * dy - ad * ay) / det
    var = aa / det
    chi = eff * eff / var
    return eff, var, chi, chi2_sf(chi, 1)


def _table(bim, out_file, **cols):
    res = bim[_SNP_COLS].copy()
    for name, val in cols.items():
        res[name] = val.cpu().numpy() if torch.is_tensor(val) else val
    if out_file:
        res.to_csv(out_file, sep=" ", index=False)
    return res


def _single_fixed_kernel(mat, pmat, y):
    return _add_stats(mat, pmat @ mat, pmat @ y)


def _dom_fixed_kernel(mat_a, mat_d, pmat, y):
    return _dom_stats(mat_a, mat_d, pmat @ mat_a, pmat @ mat_d, pmat @ y)


def uvlmm_gwas_add(y, xmat, gmat_lst, var_com, bed_prefix, out_file=None,
                   device=None):
    """Additive fixed-effect test of every SNP; returns (and writes to
    `out_file`) chro snp_ID pos allele1 allele2 eff_val scale_val chi_val
    p_val."""
    dev = resolve_device(device)
    y, pmat = _direct_setup(y, xmat, gmat_lst, var_com, dev)
    geno, bim = _genotypes(bed_prefix, y.shape[0], dev)
    mat, _, scale = additive_code(geno)
    eff, var, chi, p = _single_fixed_kernel(mat, pmat, y)
    return _table(bim, out_file, eff_val=eff,
                  scale_val=float(np.asarray(var_com)[0]) / (float(scale) * var),
                  chi_val=chi, p_val=p)


def uvlmm_gwas_dom(y, xmat, gmat_lst, var_com, bed_prefix, out_file=None,
                   device=None):
    """Dominance fixed-effect test of every SNP, adjusted for its additive
    column; returns (and writes) chro snp_ID pos allele1 allele2 eff_val
    chi_val p_val."""
    dev = resolve_device(device)
    y, pmat = _direct_setup(y, xmat, gmat_lst, var_com, dev)
    geno, bim = _genotypes(bed_prefix, y.shape[0], dev)
    eff, _, chi, p = _dom_fixed_kernel(additive_code(geno)[0],
                                       dominance_code(geno)[0], pmat, y)
    return _table(bim, out_file, eff_val=eff, chi_val=chi, p_val=p)


def _eigen_pmat(var_com, y, xmat, gmat, device=None):
    """Eigen path for one GRM: V⁻¹ is diagonal in the rotated space.
    Returns (U, Uᵀy, project) with project(Uᵀm) = Uᵀ P m."""
    dev = resolve_device(device)
    _check_records(len(np.asarray(y).reshape(-1)), np.shape(gmat)[0], "GRM")
    lam, u = torch.linalg.eigh(as_exact(gmat, dev))
    yr = u.T @ as_exact(np.asarray(y, float).reshape(-1), dev)
    xr = u.T @ as_exact(np.asarray(xmat, float).reshape(len(lam), -1), dev)
    var_com = np.asarray(var_com, float)
    vdiag = 1.0 / (lam * float(var_com[0]) + float(var_com[-1]))
    vx = vdiag[:, None] * xr
    xvx_inv = torch.linalg.inv(xr.T @ vx)

    def project(m):
        return vdiag[:, None] * (m - xr @ (xvx_inv @ (vx.T @ m)))

    return u, yr, project


def _run_fixed_eigen(y, xmat, gmat, var_com, bed_prefix, out_file, device):
    dev = resolve_device(device)
    u, yr, project = _eigen_pmat(var_com, y, xmat, gmat, dev)
    geno, bim = _genotypes(bed_prefix, yr.shape[0], dev)
    mat, _, scale = additive_code(geno)
    mr = u.T @ mat
    eff, var, chi, p = _add_stats(mr, project(mr), project(yr[:, None])[:, 0])
    return _table(bim, out_file, eff_val=eff,
                  scale_val=float(np.asarray(var_com)[0]) / (float(scale) * var),
                  chi_val=chi, p_val=p)


def uvlmm_gwas_add_eigen(y, xmat, agmat, var_com, bed_prefix, out_file=None,
                         device=None):
    """`uvlmm_gwas_add` for one GRM through its eigendecomposition
    (var_com = (σ²_g, σ²_e)); the same table."""
    return _run_fixed_eigen(y, xmat, agmat, var_com, bed_prefix, out_file,
                            device)


def uvlmm_gwas_dom_eigen(y, xmat, agmat, var_com, bed_prefix, out_file=None,
                         device=None):
    """`uvlmm_gwas_dom` for one GRM through its eigendecomposition; the same
    table."""
    dev = resolve_device(device)
    u, yr, project = _eigen_pmat(var_com, y, xmat, agmat, dev)
    geno, bim = _genotypes(bed_prefix, yr.shape[0], dev)
    mat_a = u.T @ additive_code(geno)[0]
    mat_d = u.T @ dominance_code(geno)[0]
    eff, _, chi, p = _dom_stats(mat_a, mat_d, project(mat_a), project(mat_d),
                                project(yr[:, None])[:, 0])
    return _table(bim, out_file, eff_val=eff, chi_val=chi, p_val=p)


def _epi_fixed_anchor(a_col, mat, pmat, py, pm, lo=0):
    """Exact interaction test of anchor `a_col` against the partners
    lo, …, m-1.

    Model per pair: y ~ X + s_i + s_j + s_i·s_j; the interaction
    coefficient of the 3x3 normal equations in the P-metric (X projected
    out in P).  A constant partner or anchor makes its system singular:
    `inv_ex` then gives inf/NaN and p < p_cut drops the pair, as the JAX
    package's `inv` does (torch's `inv` would raise).  Returns (eff, chi,
    p) per partner."""
    s_i = mat[:, a_col]
    part, ppart = mat[:, lo:], pm[:, lo:]
    d_ii = torch.dot(s_i, pm[:, a_col])
    d_ij = s_i @ ppart
    e = s_i[:, None] * part  # interaction columns
    pe = pmat @ e
    e_y = e.T @ py
    e_i = pe.T @ s_i
    e_j = torch.sum(pe * part, dim=0)
    e_e = torch.sum(e * pe, dim=0)
    d_jj = torch.sum(part * ppart, dim=0)
    j_y = part.T @ py
    amat = torch.stack(
        [
            torch.stack([d_ii.expand_as(d_ij), d_ij, e_i], dim=-1),
            torch.stack([d_ij, d_jj, e_j], dim=-1),
            torch.stack([e_i, e_j, e_e], dim=-1),
        ],
        dim=-2,
    )  # (partners, 3, 3)
    rhs = torch.stack([torch.dot(s_i, py).expand_as(e_y), j_y, e_y], dim=-1)
    ainv = torch.linalg.inv_ex(amat)[0]
    beta = torch.einsum("kij,kj->ki", ainv, rhs)
    eff = beta[:, 2]
    chi = eff * eff / ainv[:, 2, 2]
    return eff, chi, chi2_sf(chi, 1)


def uvlmm_gwas_epiAA(y, xmat, gmat_lst, var_com, bed_prefix, snp_lst_0=None,
                     p_cut=1.0, out_file=None, device=None):
    """Exhaustive fixed-effect interaction scan of the anchors `snp_lst_0`
    (default: all but the last SNP) against every partner j > i.

    Returns (and writes) rows snpi snpj snp_eff p_val with p_val < p_cut,
    anchors in list order, partners ascending."""
    dev = resolve_device(device)
    y, pmat = _direct_setup(y, xmat, gmat_lst, var_com, dev)
    geno, _ = _genotypes(bed_prefix, y.shape[0], dev)
    mat = additive_code(geno)[0]
    del geno
    num_snp = mat.shape[1]
    py = pmat @ y
    pm = pmat @ mat
    anchors = range(num_snp - 1) if snp_lst_0 is None else snp_lst_0
    cols = [[], [], [], []]
    for i in anchors:
        i = int(i)
        if not 0 <= i < num_snp:
            raise ValueError(f"anchor {i} outside 0..{num_snp - 1}")
        if i + 1 == num_snp:
            continue
        eff, _, p = _epi_fixed_anchor(i, mat, pmat, py, pm, lo=i + 1)
        keep = p < p_cut
        js = torch.nonzero(keep)[:, 0] + (i + 1)
        cols[0].append(torch.full_like(js, i))
        cols[1].append(js)
        cols[2].append(eff[keep])
        cols[3].append(p[keep])
    names = ["snpi", "snpj", "snp_eff", "p_val"]
    if cols[0]:
        vals = [torch.cat(c).cpu().numpy() for c in cols]
    else:
        vals = [np.zeros(0, np.int64)] * 2 + [np.zeros(0)] * 2
    res = pd.DataFrame(dict(zip(names, vals)))
    if out_file:
        res.to_csv(out_file, sep=" ", index=False)
    return res


def _ols_setup(pheno_file, bed_prefix, dev):
    """(design matrices, y, X, residual maker v -> v - X(XᵀX)⁻¹Xᵀv)."""
    from gmat_tpu_torch.io.pheno import design_matrix

    dm = design_matrix(pheno_file, bed_prefix)
    y = as_exact(dm.y, dev)
    x = as_exact(dm.xmat, dev)
    xtx_inv = torch.linalg.inv(x.T @ x)

    def resid(v):
        return v - x @ (xtx_inv @ (x.T @ v))

    return dm, y, resid


def lm_snp_eff(pheno_file, bed_prefix, out_file="lm_snp_eff", device=None):
    """Per-SNP OLS effects of the raw (imputed, uncoded) genotypes, with X
    partialled out; writes the .bim columns plus `eff` with no header and
    returns that frame."""
    dev = resolve_device(device)
    dm, y, resid = _ols_setup(pheno_file, bed_prefix, dev)
    geno, bim = _genotypes(bed_prefix, dm.n_rec, dev)
    rm = resid(geno)
    eff = (rm.T @ resid(y)) / torch.sum(rm * rm, dim=0)
    df = bim.copy()
    df["eff"] = eff.cpu().numpy()
    df.to_csv(out_file, sep=" ", header=False, index=False)
    return df


def lm_pred(pheno_file, bed_prefix, agmat, out_file="lm_pred", device=None):
    """Naive prediction with V = I: G · Zᵀ(y − Xb̂); writes
    `<out>.rand_eff` and returns the effects as numpy."""
    dev = resolve_device(device)
    dm, y, resid = _ols_setup(pheno_file, bed_prefix, dev)
    zpy = dm.ztdot(resid(y), dev)
    eff = (as_exact(agmat, dev) @ zpy).cpu().numpy()
    np.savetxt(out_file + ".rand_eff", eff)
    return eff
