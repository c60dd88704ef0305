"""Canonical 4-step REMMAX workflow on the mouse data.

Twin of examples/remma/remma_workflow.py on the PyTorch port: (1) additive
GRM, (2) multi-GRM REML under the A + AxA null model, (3) single-SNP
additive/dominance score tests and the exact exhaustive additive x additive
pair scan (the exact-scan kernel on CUDA), (4) annotation of the top hits
against the .bim positions.

    python examples/torch/remma/remma_workflow.py [--device cuda|cpu]
"""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from _common import out_dir, parse_device, stage_mouse  # noqa: E402

import numpy as np  # noqa: E402
import pandas as pd  # noqa: E402

from gmat_tpu_torch import (  # noqa: E402
    agmat,
    annotation_snp_pos,
    remma_add,
    remma_dom,
    remma_epiAA,
    wemai_multi_gmat,
)

dev = parse_device(__doc__)
out = out_dir(__file__)
bed = stage_mouse(out)
pheno = str(out / "pheno")

# step 1: additive GRM
ag, _ = agmat(bed, out_fmt="mat", device=dev)

# step 2: variance components under A + AxA + e
gmat_lst = [ag, ag * ag]
var = wemai_multi_gmat(pheno, bed, gmat_lst, out_file=str(out / "var.txt"),
                       device=dev)
print("variance components [A, AxA, e]:", np.round(np.asarray(var).ravel(), 5))

# step 3a: single-SNP score tests
res_add = remma_add(pheno, bed, gmat_lst, var, out_file=str(out / "remma_add"),
                    device=dev)
res_dom = remma_dom(pheno, bed, gmat_lst, var, out_file=str(out / "remma_dom"),
                    device=dev)
print("top additive SNPs:")
print(res_add.nsmallest(3, "p_val").to_string())

# step 3b: exact exhaustive epiAA scan, keep p < 1e-4 (989,121 pairs)
remma_epiAA(pheno, bed, gmat_lst, var, p_cut=1e-4,
            out_file=str(out / "epiAA"), device=dev)
tab = pd.read_csv(out / "epiAA", sep=r"\s+")
print(f"exact epiAA scan: {len(tab)} pairs below 1e-4")

# step 4: annotate hits with .bim info, thinning to one hit per 5 Mb
annotation_snp_pos(str(out / "epiAA"), bed, p_cut=1e-5, dis=5_000_000)
print((out / "epiAA.anno").read_text().splitlines()[0])
print("rows in epiAA.anno:",
      len((out / "epiAA.anno").read_text().splitlines()) - 1)
