"""The flagship approximate epistasis pipeline ("recommended for big data").

Twin of examples/remma/remma_approx.py on the PyTorch port: (1) exact-test
a random pair sample to calibrate the shared effect-variance denominator
(median), (2) screen all pairs with the effect-screen kernels at the
calibrated |eff| threshold, (3) exact float64 re-test of the survivors,
(4) merge approx + exact p columns.  Also runs the MAF-stratified variant
and one part of the manual `parallel=[N, i]` twin.

    python examples/torch/remma/remma_approx.py [--device cuda|cpu]
"""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from _common import out_dir, parse_device, stage_mouse  # noqa: E402

import numpy as np  # noqa: E402
import pandas as pd  # noqa: E402

from gmat_tpu_torch import (  # noqa: E402
    agmat,
    remma_epiAA_approx,
    remma_epiAA_approx_parallel,
    remma_epiAA_maf_approx,
    wemai_multi_gmat,
)

dev = parse_device(__doc__)
out = out_dir(__file__)
bed = stage_mouse(out)
pheno = str(out / "pheno")

ag, _ = agmat(bed, out_fmt="mat", device=dev)
gmat_lst = [ag, ag * ag]
var = wemai_multi_gmat(pheno, bed, gmat_lst, out_file=str(out / "var.txt"),
                       device=dev)

# flagship pipeline: calibrate -> screen -> exact re-test -> merge
remma_epiAA_approx(pheno, bed, gmat_lst, var, p_cut=1e-4,
                   num_random_pair=20000, out_file=str(out / "epiAA_approx"),
                   device=dev)
tab = pd.read_csv(out / "epiAA_approx", sep=r"\s+")
print(f"approx pipeline: {len(tab)} survivors "
      f"(columns: {' '.join(tab.columns)})")
print(tab.nsmallest(3, "p").to_string())

# MAF-stratified thresholds (per int(maf*20)-bin-pair variance denominators)
remma_epiAA_maf_approx(pheno, bed, gmat_lst, var, p_cut=1e-4,
                       num_random_pair=20000,
                       out_file=str(out / "epiAA_maf_approx"), device=dev)
tab_maf = pd.read_csv(out / "epiAA_maf_approx", sep=r"\s+")
print(f"maf_approx pipeline: {len(tab_maf)} survivors; "
      f"denominator table -> {out.name}/epiAA_maf_approx.freq_denominator")

# manual multi-machine sharding: run part 1 of 2 (balanced triangular
# anchor split); the parts' outputs concatenate into the full result
remma_epiAA_approx_parallel(pheno, bed, gmat_lst, var, parallel=[2, 1],
                            p_cut=1e-4, num_random_pair=20000,
                            out_file=str(out / "epiAA_par"), device=dev)
shard = pd.read_csv(out / "epiAA_par.1", sep=r"\s+")
print(f"parallel part 1/2: {len(shard)} survivors")
assert np.isfinite(tab["p"]).all()
