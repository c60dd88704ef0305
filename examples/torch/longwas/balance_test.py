"""Balanced longitudinal (random-regression) GWAS on mouse_long.

Twin of examples/longwas/balance_test.py on the PyTorch port: all 1212 ids
share a 16-timepoint grid.  Estimate the Legendre random-regression
variance structure in kinship eigenspace, then run both longitudinal tests
on a SNP subset: the per-SNP fixed regression (short REML per SNP) and the
linear-retransformation test (no per-SNP REML).

    python examples/torch/longwas/balance_test.py [--device cuda|cpu]
"""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from _common import out_dir, parse_device, stage_mouse_long  # noqa: E402

import numpy as np  # noqa: E402

from gmat_tpu_torch.grm.grm import agmat  # noqa: E402
from gmat_tpu_torch.longwas.balance import balance_varcom  # noqa: E402
from gmat_tpu_torch.longwas.balance_gwas import (  # noqa: E402
    balance_longwas_fixed,
    balance_longwas_trans,
)

dev = parse_device(__doc__)
out = out_dir(__file__)
bed = stage_mouse_long(out)
data = str(out / "phe.balance.txt")
tpoint = np.arange(16) + 1.0
trait = list(range(2, 18))  # 16 phenotype columns

# GRM in id-id-val form (the longwas branch reads the .agrm2 file contract)
agmat(bed, inv=True, out_fmt="id_id_val", device=dev)

var = balance_varcom(data, "ID", tpoint, trait, bed + ".agrm2",
                     maxiter=10, prefix_outfile=str(out / "balance_varcom"),
                     device=dev)
print("variance table (tidy vari/varij/varik/var_val):")
print(var.head(6).to_string())

snps = list(range(100))  # demo subset; omit snp_lst for the full panel
trans = balance_longwas_trans(data, "ID", tpoint, trait, bed + ".agrm2",
                              bed, var, snp_lst=snps,
                              prefix_outfile=str(out / "balance_trans"),
                              device=dev)
print("\ntrans test top hits (retransformation, no per-SNP REML):")
print(trans.nsmallest(3, "p_val").to_string())

fixed = balance_longwas_fixed(data, "ID", tpoint, trait, bed + ".agrm2",
                              bed, var, snp_lst=snps[:20],
                              prefix_outfile=str(out / "balance_fixed"),
                              device=dev)
print("\nfixed-regression test (short per-SNP REML), 20 SNPs:")
print(fixed.nsmallest(3, "p_val").to_string())
