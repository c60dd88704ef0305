"""Chi-square tail probabilities (counterpart of `gmat_tpu/core/stats.py`).

df=1 uses the erfc identity on the tensor's own device; other df use the
regularized upper incomplete gamma.
"""
from __future__ import annotations

import torch


def chi2_sf(x, df: int = 1):
    """P[Chi2_df > x] for a tensor x."""
    x = torch.clamp(x, min=0.0)
    if df == 1:
        return torch.special.erfc(torch.sqrt(x / 2.0))
    return torch.special.gammaincc(torch.full_like(x, df / 2.0), x / 2.0)


def chi2_isf(p, df: int = 1):
    """Inverse survival as a host scalar (p_cut -> effect thresholds)."""
    from scipy.stats import chi2

    return float(chi2.isf(p, df))
