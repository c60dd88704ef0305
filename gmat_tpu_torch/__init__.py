"""gmat-tpu on PyTorch and CUDA: REMMAX for one NVIDIA H100.

A port of `gmat_tpu` (JAX) that keeps its public names and file contracts.
Plain tensor code is PyTorch; the Pallas kernels of the JAX package are
CUDA kernels written for Hopper: the epistasis effect screen
(`csrc/screen.cu`) and the fused exact scan (`csrc/exact.cu`).
Every entry point takes a `device` (default: CUDA, see `config.py`).

This package imports neither `jax` nor `gmat_tpu`.

The four-step workflow: `agmat` -> `wemai_multi_gmat` ->
`remma_epiAA_approx` (or the exhaustive `remma_epiAA/AD/DD[_parallel]`,
and the single-SNP `remma_add` / `remma_dom`) -> `annotation_snp_pos`.
"""
from gmat_tpu_torch import config  # noqa: F401  -- sets the TF32 policy first
from gmat_tpu_torch.grm.grm import agmat, dgmat_as  # noqa: F401
from gmat_tpu_torch.io.bed import Bed, read_plink, write_bed  # noqa: F401
from gmat_tpu_torch.reml.wemai import wemai_multi_gmat  # noqa: F401
from gmat_tpu_torch.scan.annotation import annotation_snp_pos  # noqa: F401
from gmat_tpu_torch.scan.pairs import (  # noqa: F401
    remma_epiAA,
    remma_epiAA_pair,
    remma_epiAA_parallel,
    remma_epiAD,
    remma_epiAD_pair,
    remma_epiAD_parallel,
    remma_epiDD,
    remma_epiDD_pair,
    remma_epiDD_parallel,
)
from gmat_tpu_torch.scan.random_pair import random_pair  # noqa: F401
from gmat_tpu_torch.scan.screen import (  # noqa: F401
    remma_epiAA_approx,
    remma_epiAA_eff,
)
from gmat_tpu_torch.scan.single import remma_add, remma_dom  # noqa: F401

__version__ = "0.1.0"
