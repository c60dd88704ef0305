"""gmat-tpu on PyTorch and CUDA: the REMMAX main path for one NVIDIA H100.

A port of `gmat_tpu` (JAX) that keeps its public names and file contracts.
Plain tensor code is PyTorch; the epistasis effect screen, a Pallas kernel in
the JAX package, is a CUDA kernel written for Hopper (`csrc/screen.cu`).
Every entry point takes a `device` (default: CUDA, see `config.py`).

This package imports neither `jax` nor `gmat_tpu`.

The four-step workflow: `agmat` -> `wemai_multi_gmat` ->
`remma_epiAA_approx` -> `annotation_snp_pos`.
"""
from gmat_tpu_torch import config  # noqa: F401  -- sets the TF32 policy first
from gmat_tpu_torch.grm.grm import agmat, dgmat_as  # noqa: F401
from gmat_tpu_torch.io.bed import Bed, read_plink, write_bed  # noqa: F401
from gmat_tpu_torch.reml.wemai import wemai_multi_gmat  # noqa: F401
from gmat_tpu_torch.scan.annotation import annotation_snp_pos  # noqa: F401
from gmat_tpu_torch.scan.pairs import remma_epiAA_pair  # noqa: F401
from gmat_tpu_torch.scan.random_pair import random_pair  # noqa: F401
from gmat_tpu_torch.scan.screen import (  # noqa: F401
    remma_epiAA_approx,
    remma_epiAA_eff,
)

__version__ = "0.1.0"
