"""Additive genomic relationship matrix in every output format.

Twin of examples/grm/cal_agmat.py on the PyTorch port: the additive GRM
with inverse in 'mat', 'row_col_val' and 'id_id_val' forms (center by 2p,
scale by sum 2p(1-p), diagonal inflation by small_val), plus the genomic
inbreeding coefficients.

    python examples/torch/grm/cal_agmat.py [--device cuda|cpu]
"""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from _common import out_dir, parse_device, stage_mouse  # noqa: E402

import numpy as np  # noqa: E402

from gmat_tpu_torch import agmat, ginbreedcoef  # noqa: E402

dev = parse_device(__doc__)
out = out_dir(__file__)
bed = stage_mouse(out)

# matrix form -> plink.agrm0 / plink.agiv0
kin, kin_inv = agmat(bed, inv=True, small_val=0.001, out_fmt="mat",
                     device=dev)
print("GRM diag mean:", float(np.mean(np.diag(kin))))
print("K @ K^-1 == I:", np.allclose(kin @ kin_inv, np.eye(kin.shape[0]),
                                    atol=1e-8))

# row-column-value form (asreml-style) -> plink.agrm1 / plink.agiv1
agmat(bed, inv=True, small_val=0.001, out_fmt="row_col_val", device=dev)

# id-id-value form -> plink.agrm2 / plink.agiv2
agmat(bed, inv=True, small_val=0.001, out_fmt="id_id_val", device=dev)

# genomic inbreeding coefficients -> plink.ginbreedcoef
ginbreedcoef(bed, device=dev)

for suffix in (".agrm0", ".agrm1", ".agrm2", ".agiv0", ".ginbreedcoef"):
    print(suffix, "->", Path(bed + suffix).stat().st_size, "bytes")
