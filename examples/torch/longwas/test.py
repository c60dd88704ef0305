"""Unbalanced random-regression variance components on mouse_long.

Twin of examples/longwas/test.py on the PyTorch port: the one-call form of
the reference's hand-built Legendre design (forder=aorder=porder=3) on the
same inputs: agmat with inverse, then REML on `phe.unbalance.txt`
(ID/weak/trait columns).  A 150-id subset keeps the demo quick on the CPU;
drop the subsetting for the full cohort.

    python examples/torch/longwas/test.py [--device cuda|cpu]
"""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from _common import out_dir, parse_device, stage_mouse_long  # noqa: E402

import pandas as pd  # noqa: E402

from gmat_tpu_torch.grm.grm import agmat  # noqa: E402
from gmat_tpu_torch.longwas.unbalance import unbalance_varcom  # noqa: E402

N_SUB = 150

dev = parse_device(__doc__)
out = out_dir(__file__)
bed = stage_mouse_long(out)

agmat(bed, inv=True, small_val=0.001, out_fmt="id_id_val", device=dev)

data_file = str(out / "phe.unbalance.txt")
df = pd.read_csv(data_file, sep=r"\s+", header=0)
ids = df["ID"].unique()[:N_SUB]
sub_file = str(out / "phe.unbalance.sub.txt")
df[df["ID"].isin(ids)].to_csv(sub_file, sep=" ", index=False)

res = unbalance_varcom(
    sub_file, "ID", "weak", "trait", bed + ".agiv2",
    forder=3, aorder=3, porder=3, maxiter=10,
    prefix_outfile=str(out / "unbalance_test_varcom"), device=dev,
)
print(res)
