"""gmat-tpu on PyTorch and CUDA: REMMAX for one NVIDIA H100.

A port of `gmat_tpu` (JAX) that keeps its public names and file contracts.
Plain tensor code is PyTorch; the Pallas kernels of the JAX package are
CUDA kernels written for Hopper: the epistasis effect screen
(`csrc/screen.cu`) and the fused exact scan (`csrc/exact.cu`).
Every entry point takes a `device` (default: CUDA, see `config.py`).

This package imports neither `jax` nor `gmat_tpu`.

The four-step workflow: `agmat` -> `wemai_multi_gmat` ->
`remma_epiAA_approx` -> `annotation_snp_pos`.  Beside it: the whole
epistasis screen family `remma_epi{AA,AD,DD}_{eff,approx,maf_eff,
maf_approx}[_parallel]` and `remma_epiAA_eff_gpu`, the exhaustive scans
`remma_epiAA/AD/DD[_parallel]`, the pair tests `remma_epi*_pair` and the
single-SNP `remma_add` / `remma_dom`.

Not ported yet (ROADMAP.md queue 1): `reml/eigen.py`, `reml/mme.py` and
`scan/fixed_gwas.py` (item 14); longwas (15); the periphery, the
array-level `_remma_*` API and the CLI (16); the `mesh=` argument (17).
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
from gmat_tpu_torch.scan.accel import remma_epiAA_eff_gpu  # noqa: F401
from gmat_tpu_torch.scan.random_pair import random_pair, random_pairAD  # noqa: F401
from gmat_tpu_torch.scan.screen import (  # noqa: F401
    remma_epiAA_approx,
    remma_epiAA_approx_parallel,
    remma_epiAA_eff,
    remma_epiAA_eff_parallel,
    remma_epiAA_maf_approx,
    remma_epiAA_maf_approx_parallel,
    remma_epiAA_maf_eff,
    remma_epiAA_maf_eff_parallel,
    remma_epiAD_approx,
    remma_epiAD_approx_parallel,
    remma_epiAD_eff,
    remma_epiAD_eff_parallel,
    remma_epiAD_maf_approx,
    remma_epiAD_maf_approx_parallel,
    remma_epiAD_maf_eff,
    remma_epiAD_maf_eff_parallel,
    remma_epiDD_approx,
    remma_epiDD_approx_parallel,
    remma_epiDD_eff,
    remma_epiDD_eff_parallel,
    remma_epiDD_maf_approx,
    remma_epiDD_maf_approx_parallel,
    remma_epiDD_maf_eff,
    remma_epiDD_maf_eff_parallel,
)
from gmat_tpu_torch.scan.single import remma_add, remma_dom  # noqa: F401

__version__ = "0.1.0"
