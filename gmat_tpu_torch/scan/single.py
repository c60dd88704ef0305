"""Single-SNP score tests under the random SNP-BLUP model (counterpart of
`gmat_tpu/scan/single.py`).  Per SNP j:

    eff_j = (Mᵀ pymat)_j · σ²_g / scale
    var_j = (M_j ᵀ pvpmat M_j) · σ⁴_g / scale²
    eff_fixed_j = eff_j σ²_g / (var_j · scale)
    chi_j = eff_j² / var_j,  p_j = P[χ²₁ > chi_j]

The whole SNP axis is two float64 matrix products on the device; no kernel.
"""
from __future__ import annotations

import pandas as pd
import torch

from gmat_tpu_torch.config import EXACT_DTYPE, resolve_device
from gmat_tpu_torch.core.coding import additive_code, dominance_code
from gmat_tpu_torch.core.stats import chi2_sf
from gmat_tpu_torch.io.pheno import design_matrix
from gmat_tpu_torch.scan.common import prepare_genotypes, score_pieces


def _single_scan(mat, pymat, pvpmat, sigma2, scale):
    eff = (mat.T @ pymat) * sigma2 / scale
    var = torch.sum(mat * (pvpmat @ mat), dim=0) * sigma2 * sigma2 / (
        scale * scale)
    eff_fixed = eff * sigma2 / (var * scale)
    chi = eff * eff / var
    return eff, var, eff_fixed, chi, chi2_sf(chi, 1)


def _run_single(pheno_file, bed_prefix, gmat_lst, var_com, coding, sigma2,
                out_file, device=None):
    dev = resolve_device(device)
    dm = design_matrix(pheno_file, bed_prefix)
    pieces = score_pieces(dm, gmat_lst, var_com, dev)
    geno, bim, _ = prepare_genotypes(bed_prefix)
    mat, _, scale = coding(torch.as_tensor(geno, dtype=EXACT_DTYPE,
                                           device=dev))
    eff, _, eff_fixed, chi, p = (
        t.cpu().numpy() for t in _single_scan(mat, pieces.pymat,
                                              pieces.pvpmat, float(sigma2),
                                              scale))
    res = bim[["chro", "snp_ID", "pos", "allele1", "allele2"]].copy()
    res["eff_val"] = eff
    res["chi_val"] = chi
    res["eff_val_to_fixed"] = eff_fixed
    res["p_val"] = p
    if out_file:
        res.to_csv(out_file, index=False, header=True, sep=" ")
    return res


def remma_add(pheno_file: str, bed_prefix: str, gmat_lst, var_com,
              out_file: str = "remma_add", device=None) -> pd.DataFrame:
    """Additive single-SNP test; var_com[0] must be the additive variance."""
    return _run_single(pheno_file, bed_prefix, gmat_lst, var_com,
                       additive_code, var_com[0], out_file, device)


def remma_dom(pheno_file: str, bed_prefix: str, gmat_lst, var_com,
              out_file: str = "remma_dom", device=None) -> pd.DataFrame:
    """Dominance single-SNP test; var_com[1] must be the dominance variance."""
    return _run_single(pheno_file, bed_prefix, gmat_lst, var_com,
                       dominance_code, var_com[1], out_file, device)
