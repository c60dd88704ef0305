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
single-SNP `remma_add` / `remma_dom`.  The uvlmm family: the eigen REML
`uvlmm_varcom_eigen`, the MME REML variants `em_mme` … `pxemai_mme`, the
fixed-effect tests `uvlmm_gwas_{add,dom}[_eigen]` and `uvlmm_gwas_epiAA`,
OLS `lm_snp_eff` / `lm_pred`, and prediction `wemai_multi_gmat_pred`;
beside them `ginbreedcoef`, `impute_geno`, `shuffle_bed`, the
`design_matrix_wemai_multi_gmat[_pred]` tuples, `gtf_to_gene_info` and
`annotation_snp_nearest_gene`.  Longitudinal GWAS with random-regression
models lives in `gmat_tpu_torch.longwas` (`balance_varcom`,
`balance_longwas_{fixed,trans}[_permutation]`, `unbalance_varcom`,
`unbalance_longwas_{fixed,trans}[_permutation]`) and, as in `gmat_tpu`,
is imported from its modules, not from here.  The periphery: the
array-level `_remma_*` / `_wemai_multi_gmat` twins that take
(y, xmat, zmat) (`scan/array_api.py`, on the legacy `remma_*_cpu` engine
of `scan/legacy.py`), the simulators `simu_epistasis[_freq]`, the pedigree
tools `ped_*`, the one-call `pipeline.remmax.remmax` and the
`gmat-tpu-torch` command line (`cli.py`).  Sharding over several devices
and processes: `gmat_tpu_torch.dist` (`make_mesh`,
`initialize_multihost`, the `sharded_*` primitives), the `mesh=` argument
of the GRM, screen, exhaustive-scan and pair-test entry points and the
command line's `--devices`; `core/roofline.py` logs achieved rates and
records `torch.profiler` traces (`GMAT_TPU_TRACE_DIR`).
"""
from gmat_tpu_torch import config  # noqa: F401  -- sets the TF32 policy first
from gmat_tpu_torch.grm.grm import agmat, dgmat_as, ginbreedcoef  # noqa: F401
from gmat_tpu_torch.io.bed import (  # noqa: F401
    Bed,
    impute_geno,
    read_plink,
    shuffle_bed,
    write_bed,
)
from gmat_tpu_torch.io.pheno import (  # noqa: F401
    design_matrix_wemai_multi_gmat,
    design_matrix_wemai_multi_gmat_pred,
)
from gmat_tpu_torch.reml.wemai import (  # noqa: F401
    wemai_multi_gmat,
    wemai_multi_gmat_pred,
)
from gmat_tpu_torch.reml.eigen import uvlmm_varcom_eigen  # noqa: F401
from gmat_tpu_torch.reml.mme import (  # noqa: F401
    ai_mme,
    em_mme,
    emai_mme,
    pxem_mme,
    pxemai_mme,
)
from gmat_tpu_torch.scan.fixed_gwas import (  # noqa: F401
    lm_pred,
    lm_snp_eff,
    uvlmm_gwas_add,
    uvlmm_gwas_add_eigen,
    uvlmm_gwas_dom,
    uvlmm_gwas_dom_eigen,
    uvlmm_gwas_epiAA,
)
from gmat_tpu_torch.scan.annotation import (  # noqa: F401
    annotation_snp_nearest_gene,
    annotation_snp_pos,
    gtf_to_gene_info,
)
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
from gmat_tpu_torch.scan.array_api import (  # noqa: F401
    _remma_add,
    _remma_dom,
    _remma_epiAA,
    _remma_epiAA_eff,
    _remma_epiAA_eff_parallel,
    _remma_epiAA_maf_eff,
    _remma_epiAA_pair,
    _remma_epiAA_parallel,
    _remma_epiAD,
    _remma_epiAD_eff,
    _remma_epiAD_eff_parallel,
    _remma_epiAD_maf_eff,
    _remma_epiAD_pair,
    _remma_epiAD_parallel,
    _remma_epiDD,
    _remma_epiDD_eff,
    _remma_epiDD_eff_parallel,
    _remma_epiDD_maf_eff,
    _remma_epiDD_pair,
    _remma_epiDD_parallel,
    _wemai_multi_gmat,
)
from gmat_tpu_torch.pipeline.simulate import (  # noqa: F401
    simu_epistasis,
    simu_epistasis_freq,
)
from gmat_tpu_torch.pedigree.pedigree import (  # noqa: F401
    ped_completeness,
    ped_correct,
    ped_recode,
    ped_sort,
    ped_trace,
)

__version__ = "0.1.0"
