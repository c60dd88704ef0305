"""Dominance genomic relationship matrix (as-coding).

Twin of examples/grm/cal_dgmat.py on the PyTorch port: the dominance GRM
with inverse in all three output formats (het-coding {0,1,2}->{0,1,0},
center by 2p(1-p), scale by sum s(1-s)).

    python examples/torch/grm/cal_dgmat.py [--device cuda|cpu]
"""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from _common import out_dir, parse_device, stage_mouse  # noqa: E402

import numpy as np  # noqa: E402

from gmat_tpu_torch import dgmat_as  # noqa: E402

dev = parse_device(__doc__)
out = out_dir(__file__)
bed = stage_mouse(out)

kin, kin_inv = dgmat_as(bed, inv=True, small_val=0.001, out_fmt="mat",
                        device=dev)
print("dominance GRM diag mean:", float(np.mean(np.diag(kin))))
print("K @ K^-1 == I:", np.allclose(kin @ kin_inv, np.eye(kin.shape[0]),
                                    atol=1e-8))

dgmat_as(bed, inv=True, small_val=0.001, out_fmt="row_col_val", device=dev)
dgmat_as(bed, inv=True, small_val=0.001, out_fmt="id_id_val", device=dev)

for suffix in (".dgrm_as0", ".dgrm_as1", ".dgrm_as2", ".dgiv_as0"):
    print(suffix, "->", Path(bed + suffix).stat().st_size, "bytes")
