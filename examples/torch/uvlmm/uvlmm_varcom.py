"""Variance-component partitions of the mouse phenotype.

Twin of examples/uvlmm/uvlmm_varcom.py on the PyTorch port: partition the
phenotypic variance under progressively richer null models by weighted
EM+AI REML (float64 on the device):

  A + AxA + e                       (the canonical epiAA null model)
  A + D + AxA + e
  A + D + AxA + AxD + DxD + e       (full 5-GRM partition)

    python examples/torch/uvlmm/uvlmm_varcom.py [--device cuda|cpu]
"""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from _common import out_dir, parse_device, stage_mouse  # noqa: E402

import numpy as np  # noqa: E402

from gmat_tpu_torch import agmat, dgmat_as, wemai_multi_gmat  # noqa: E402

dev = parse_device(__doc__)
out = out_dir(__file__)
bed = stage_mouse(out)
pheno = str(out / "pheno")

ag, _ = agmat(bed, out_fmt="mat", device=dev)
dg, _ = dgmat_as(bed, out_fmt="mat", device=dev)

for name, gmat_lst in (
    ("A + AxA", [ag, ag * ag]),
    ("A + D + AxA", [ag, dg, ag * ag]),
    ("A + D + AxA + AxD + DxD", [ag, dg, ag * ag, ag * dg, dg * dg]),
):
    var = np.asarray(
        wemai_multi_gmat(pheno, bed, gmat_lst, out_file=str(out / "var.txt"),
                         device=dev)
    ).ravel()
    total = var.sum()
    parts = " + ".join(f"{v / total:.3f}" for v in var)
    print(f"{name:28s} var = {np.round(var, 5)}  (ratios {parts})")
