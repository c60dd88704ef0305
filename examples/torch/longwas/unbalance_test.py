"""Unbalanced longitudinal (random-regression) GWAS on mouse_long.

Twin of examples/longwas/unbalance_test.py on the PyTorch port: 19392
records at individual-specific timepoints.  REML runs on Henderson's MME
with the GRM inverse; the tests build the observation-space V once (no
per-SNP REML for `trans`).  A 150-id subset keeps the demo quick on the
CPU; drop the subsetting for the full cohort.

    python examples/torch/longwas/unbalance_test.py [--device cuda|cpu]
"""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from _common import out_dir, parse_device, stage_mouse_long  # noqa: E402

import pandas as pd  # noqa: E402

from gmat_tpu_torch.grm.grm import agmat  # noqa: E402
from gmat_tpu_torch.longwas.unbalance import unbalance_varcom  # noqa: E402
from gmat_tpu_torch.longwas.unbalance_gwas import (  # noqa: E402
    unbalance_longwas_fixed,
    unbalance_longwas_trans,
)

N_SUB = 150

dev = parse_device(__doc__)
out = out_dir(__file__)
bed = stage_mouse_long(out)

agmat(bed, inv=True, out_fmt="id_id_val", device=dev)  # .agrm2 and .agiv2

# subset ids for the demo (the MME dimension grows with the id count)
fam = pd.read_csv(bed + ".fam", sep=r"\s+", header=None, dtype=str)
sub_ids = set(fam[1][:N_SUB])
for src, dst in ((bed + ".agrm2", out / "kin.sub"),
                 (bed + ".agiv2", out / "kininv.sub")):
    with open(src) as fin, open(dst, "w") as fout:
        fout.writelines(line for line in fin
                        if all(t in sub_ids for t in line.split()[:2]))
df = pd.read_csv(out / "phe.unbalance.txt", sep=r"\s+", dtype={"ID": str})
data = str(out / "phe.unbalance.sub.txt")
df[df["ID"].isin(sub_ids)].to_csv(data, sep=" ", index=False)

# REML on the MME (tpoint column 'weak', trait column 'trait')
var = unbalance_varcom(data, "ID", "weak", "trait", str(out / "kininv.sub"),
                       maxiter=10,
                       prefix_outfile=str(out / "unbalance_varcom"),
                       device=dev)
print("variance table:")
print(var.head(6).to_string())

snps = list(range(50))
trans = unbalance_longwas_trans(data, "ID", "weak", "trait", bed,
                                str(out / "kin.sub"), var, snp_lst=snps,
                                prefix_outfile=str(out / "unbalance_trans"),
                                device=dev)
print("\ntrans test top hits:")
print(trans.nsmallest(3, "p_val").to_string())

fixed = unbalance_longwas_fixed(data, "ID", "weak", "trait", bed,
                                str(out / "kin.sub"), var, snp_lst=snps,
                                prefix_outfile=str(out / "unbalance_fixed"),
                                device=dev)
print("\nfixed GLS test top hits:")
print(fixed.nsmallest(3, "p_val").to_string())
