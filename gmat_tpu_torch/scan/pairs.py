"""Exact epistasis pair tests (the part of `gmat_tpu/scan/pairs.py` that the
approx pipeline runs).

Per pair (i, j) with epistasis covariate e = m_i ⊙ m_j (elementwise over
individuals):   eff = eᵀ·pymat,   var = eᵀ·pvpmat·e,   chi = eff²/var,
p = P[χ²₁ > chi], all in float64 on the pieces' device.  The pair list is
tested `max_test_pair` pairs at a time, in chunks padded to one canonical
width, and written as `snp_0 snp_1 eff var chi p` rows with p < p_cut.
"""
from __future__ import annotations

import numpy as np
import pandas as pd
import torch

from gmat_tpu_torch.config import resolve_device
from gmat_tpu_torch.core.coding import additive_code, dominance_code
from gmat_tpu_torch.core.stats import chi2_sf

_HEADER_PAIR = "snp_0 snp_1 eff var chi p"

_CODINGS = {
    "AA": (additive_code, additive_code, True),
    "AD": (additive_code, dominance_code, False),
    "DD": (dominance_code, dominance_code, True),
}

_CODING_KINDS = {"AA": ("add", "add"), "AD": ("add", "dom"),
                 "DD": ("dom", "dom")}


def _epi_setup(pheno_file, bed_prefix, gmat_lst, var_com, kind, device=None):
    """Pipeline-stage setup through the identity caches: the design parse,
    the O(n³) score pieces and the (n, m) coded panels are computed once
    and shared by the calibrate, screen and re-test stages."""
    from gmat_tpu_torch.scan.common import (coded_matrix, design_matrix_cached,
                                            prepare_genotypes_device,
                                            score_pieces_cached)

    dev = resolve_device(device)
    k0, k1 = _CODING_KINDS[kind]
    triangular = _CODINGS[kind][2]
    dm = design_matrix_cached(pheno_file, bed_prefix)
    pieces = score_pieces_cached(dm, gmat_lst, var_com, dev)
    g, num_snp = prepare_genotypes_device(bed_prefix, device=dev)
    mat0 = coded_matrix(g, k0)
    mat1 = coded_matrix(g, k1)
    return mat0, mat1, pieces, num_snp, triangular


def _pair_kernel(cols0, cols1, mat0, mat1, pymat, pvpmat):
    e = mat0[:, cols0] * mat1[:, cols1]  # (n, B)
    eff = e.T @ pymat
    var = torch.sum(e * (pvpmat @ e), dim=0)
    chi = eff * eff / var
    return eff, var, chi, chi2_sf(chi, 1)


def _remma_epi_pair(kind, pheno_file, bed_prefix, gmat_lst, var_com,
                    snp_pair_file, max_test_pair, p_cut, out_file,
                    device=None):
    """Exact test for an explicit pair list, chunked max_test_pair at a time."""
    mat0, mat1, pieces, num_snp, _ = _epi_setup(
        pheno_file, bed_prefix, gmat_lst, var_com, kind, device)
    try:
        pairs = pd.read_csv(snp_pair_file, sep=r"\s+", usecols=[0, 1],
                            skiprows=1, header=None).to_numpy(dtype=np.int64)
    except pd.errors.EmptyDataError:
        # header-only pair file: a screen with zero survivors gives an
        # empty (header-only) result
        pairs = np.empty((0, 2), dtype=np.int64)
    if pairs.size and (pairs.max() > num_snp - 1 or pairs.min() < 0):
        raise ValueError("snp_pair is out of range!")
    # one canonical chunk width for every chunk of a call: the batch width
    # changes the BLAS accumulation order and hence the last ulp of var/chi
    width = max_test_pair
    if len(pairs):
        width = min(max_test_pair,
                    max(8, 1 << int(len(pairs) - 1).bit_length()))
    np.savetxt(out_file, [_HEADER_PAIR], fmt="%s")
    dev = mat0.device
    with open(out_file, "a") as fout:
        for start in range(0, len(pairs), width):
            chunk = pairs[start:start + width]
            cpad = np.concatenate(
                [chunk, np.repeat(chunk[-1:], width - len(chunk), 0)])
            cpad_d = torch.as_tensor(cpad, device=dev)
            outs = _pair_kernel(cpad_d[:, 0], cpad_d[:, 1], mat0, mat1,
                                pieces.pymat, pieces.pvpmat)
            eff, var, chi, p = (a[: len(chunk)].cpu().numpy() for a in outs)
            keep = p < p_cut
            pd.DataFrame(
                {
                    0: chunk[keep, 0],
                    1: chunk[keep, 1],
                    2: eff[keep],
                    3: var[keep],
                    4: chi[keep],
                    5: p[keep],
                }
            ).to_csv(fout, sep=" ", header=False, index=False)
    return 0


def remma_epiAA_pair(pheno_file, bed_prefix, gmat_lst, var_com, snp_pair_file,
                     max_test_pair=50000, p_cut=1.0e-4, out_file="epiAA_pair",
                     device=None):
    return _remma_epi_pair("AA", pheno_file, bed_prefix, gmat_lst, var_com,
                           snp_pair_file, max_test_pair, p_cut, out_file,
                           device)
