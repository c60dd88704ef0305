"""Low-depth sequencing read-count simulator (counterpart of
`gmat_tpu/omics/simu_lds.py`, the reference's `gmat/omics/simu_LDS.py`).

Per individual, total_snp*depth reads land uniformly over the SNP
positions, and the coverage per SNP is counted: one vectorised, seeded RNG
pass per individual on the host.
"""
from __future__ import annotations

import numpy as np


def simu_lds(total_snp: int, depth: float, rep: int) -> np.ndarray:
    """Per-individual coverage counts, seeded like the reference (seed=rep*100)."""
    rng = np.random.default_rng(rep * 100)
    reads = rng.integers(0, total_snp, size=int(total_snp * depth))
    return np.bincount(reads, minlength=total_snp).reshape(-1, 1)


def simu(total_snp: int, depth: float, num_id: int,
         num_processes: int | None = None) -> np.ndarray:
    """(total_snp, num_id) coverage matrix.  `num_processes` accepted for
    API parity; the vectorized path needs no pool."""
    out = np.empty((total_snp, num_id), dtype=np.int64)
    for rep in range(num_id):
        out[:, rep] = simu_lds(total_snp, depth, rep)[:, 0]
    return out


# reference-name alias (omics/simu_LDS.py:8)
simu_LDS = simu_lds
