"""Genomic relationship matrices (additive / dominance) and genomic
inbreeding coefficients.

Counterpart of `gmat_tpu/grm/grm.py`: K = M Mᵀ / scale as one float64 Gram
product (`torch.matmul`, as the JAX package leaves it to XLA), diagonal
inflated by (1 + small_val), written in the reference's file formats.
With `mesh=`, the SNP columns are split over its shards, each forming a
partial Gram, summed over the mesh (`dist/mesh.py::sharded_additive_grm`).
"""
from __future__ import annotations

import logging

import numpy as np
import torch

from gmat_tpu_torch.config import EXACT_DTYPE, resolve_device
from gmat_tpu_torch.core.coding import additive_code, dominance_code
from gmat_tpu_torch.io.bed import Bed, impute_geno
from gmat_tpu_torch.io.grm_io import write_grm

logger = logging.getLogger(__name__)


def _gram(mat, scale, small_val):
    kin = (mat @ mat.T) / scale
    kin.diagonal().mul_(1.0 + small_val)
    return kin


def additive_grm(geno, small_val=0.001):
    """K_a = M Mᵀ / sum(2p(1-p)) with diagonal inflated by (1+small_val)."""
    mat, _, scale = additive_code(geno)
    return _gram(mat, scale, small_val)


def dominance_grm(geno, small_val=0.001):
    """K_d = D Dᵀ / sum(s(1-s)) with diagonal inflated by (1+small_val)."""
    mat, _, scale = dominance_code(geno)
    return _gram(mat, scale, small_val)


def _run_grm(bed_prefix, kind, inv, small_val, out_fmt, impute_seed, device,
             mesh=None):
    bed = Bed(bed_prefix)
    geno = bed.read()
    if np.any(np.isnan(geno)):
        logger.info("Missing genotypes are imputed with random genotypes (seed=%d).",
                    impute_seed)
        geno = impute_geno(geno, seed=impute_seed)
    logger.info("There are %d individuals and %d SNPs.", *geno.shape)
    suffix, inv_suffix = ((".agrm", ".agiv") if kind == "add"
                          else (".dgrm_as", ".dgiv_as"))
    if mesh is not None:
        from gmat_tpu_torch.dist.mesh import (sharded_additive_grm,
                                              sharded_dominance_grm)

        fn = sharded_additive_grm if kind == "add" else sharded_dominance_grm
        kin_d = fn(geno, mesh, small_val)
    else:
        fn = additive_grm if kind == "add" else dominance_grm
        kin_d = fn(torch.as_tensor(geno, dtype=EXACT_DTYPE,
                                   device=resolve_device(device)), small_val)
    kin = kin_d.cpu().numpy()
    ids = np.array(bed.fam["iid"])
    write_grm(kin, ids, bed_prefix + suffix, out_fmt)
    kin_inv = None
    if inv:
        kin_inv = torch.linalg.inv(kin_d).cpu().numpy()
        write_grm(kin_inv, ids, bed_prefix + inv_suffix, out_fmt)
    return kin, kin_inv


def agmat(bed_prefix: str, inv: bool = False, small_val: float = 0.001,
          out_fmt: str = "mat", impute_seed: int = 0, mesh=None,
          device=None):
    """Additive GRM (and optional inverse); writes `<prefix>.agrm*`.
    Returns (kin, kin_inv) as host arrays.  With `mesh`, the Gram product
    shards SNP columns over it."""
    return _run_grm(bed_prefix, "add", inv, small_val, out_fmt, impute_seed,
                    device, mesh)


def dgmat_as(bed_prefix: str, inv: bool = False, small_val: float = 0.001,
             out_fmt: str = "mat", impute_seed: int = 0, mesh=None,
             device=None):
    """Dominance GRM (and optional inverse); writes `<prefix>.dgrm_as*`.
    Returns (kin, kin_inv) as host arrays.  With `mesh`, the Gram product
    shards SNP columns over it."""
    return _run_grm(bed_prefix, "dom", inv, small_val, out_fmt, impute_seed,
                    device, mesh)


def _inbreed_stats(geno):
    """Homozygosity F, GRM-diagonal F1 (common scale) and F2 (per-SNP
    scale) of each individual; geno (n, m) float64."""
    n, m = geno.shape
    het = torch.sum(torch.abs(geno - 1.0) < 0.01, dim=1).to(geno.dtype)
    homo_f = 1.0 - het / m
    freq = torch.sum(geno, dim=0) / (2.0 * n)
    scale_vec = 2.0 * freq * (1.0 - freq)
    scale = torch.sum(scale_vec)
    cen = geno - 2.0 * freq[None, :]
    grm_f1 = torch.sum(cen * cen, dim=1) / scale - 1.0
    grm_f2 = torch.sum(cen * cen / scale_vec[None, :], dim=1) / m - 1.0
    return homo_f, grm_f1, grm_f2


def ginbreedcoef(bed_prefix: str, impute_seed: int = 0, device=None):
    """Genomic inbreeding coefficients; writes `<prefix>.ginbreedcoef`
    (columns id homo_F grm_F1 grm_F2) and returns them as a DataFrame."""
    import pandas as pd

    bed = Bed(bed_prefix)
    geno = bed.read()
    if np.any(np.isnan(geno)):
        geno = impute_geno(geno, seed=impute_seed)
    stats = _inbreed_stats(torch.as_tensor(geno, dtype=EXACT_DTYPE,
                                           device=resolve_device(device)))
    homo_f, grm_f1, grm_f2 = (a.cpu().numpy() for a in stats)
    df = pd.DataFrame(
        {"id": np.array(bed.fam["iid"]), "homo_F": homo_f,
         "grm_F1": grm_f1, "grm_F2": grm_f2}
    )
    df.to_csv(bed_prefix + ".ginbreedcoef", sep=" ", header=True, index=False)
    return df
