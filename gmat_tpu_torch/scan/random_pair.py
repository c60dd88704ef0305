"""Random SNP-pair sampling for variance calibration.

Counterpart of `gmat_tpu/scan/random_pair.py` (numpy only): rejection-sample
unique unordered (i<j) or ordered (i!=j) pairs from a seeded
`default_rng`, so both packages draw the same pairs, and write a
`snp_0 snp_1` file.
"""
from __future__ import annotations

import numpy as np

from gmat_tpu_torch.core.spans import span


def _sample_pairs(num_snp, num_pair, num_each_pair, ordered, seed):
    cap = num_snp * (num_snp - 1) * (1 if ordered else 0.5)
    if num_pair > cap:
        raise ValueError(f"num_pair must be not greater than: {cap:g}")
    if num_pair < num_each_pair:
        raise ValueError("num_pair must be greater than num_each_pair")
    rng = np.random.default_rng(seed)
    seen = set()
    out = []
    while len(out) < num_pair:
        arr = rng.integers(0, num_snp, size=(num_each_pair, 2))
        arr = arr[arr[:, 0] != arr[:, 1]] if ordered else arr[arr[:, 0] < arr[:, 1]]
        for i, j in arr:
            key = (int(i), int(j))
            if key not in seen:
                seen.add(key)
                out.append(key)
    return np.asarray(out[:num_pair], dtype=np.int64)


def _write(pairs, out_file):
    with span("draw.write"):
        np.savetxt(out_file, pairs, fmt="%d", header="snp_0 snp_1",
                   comments="")
    return pairs


def random_pair(num_snp, out_file="random_pair", num_pair=100000,
                num_each_pair=5000, seed=0):
    """Unique unordered pairs (i < j) — for epiAA / epiDD calibration."""
    return _write(_sample_pairs(num_snp, num_pair, num_each_pair, False, seed),
                  out_file)


def random_pairAD(num_snp, out_file="random_pair", num_pair=100000,
                  num_each_pair=5000, seed=0):
    """Unique ordered pairs (i != j) — for epiAD calibration."""
    return _write(_sample_pairs(num_snp, num_pair, num_each_pair, True, seed),
                  out_file)
