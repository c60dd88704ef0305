"""Normalized Legendre polynomial bases for random-regression models.

A copy of `gmat_tpu/longwas/legendre.py` (host numpy tables, uploaded by
the callers): the port imports nothing of the JAX package.

Parity: reference `leg`/`leg_mt` (reference GMAT gmat/longwas/balance/
common.py:69-105): time rescaled to [-1, 1] by the observed (or supplied)
min/max, basis entries

    P_j(t) = sqrt((2j+1)/2) * 0.5^j * sum_r (-1)^r (2j-2r)! /
             (r! (j-r)! (j-2r)!) * t^(j-2r),   r = 0..floor(j/2).
"""
from __future__ import annotations

from math import factorial

import numpy as np


def leg_coeffs(order: int) -> np.ndarray:
    """(order+1, order+1) coefficient matrix C with P_j(t) = sum_k C[j,k] t^k."""
    coef = np.zeros((order + 1, order + 1))
    for j in range(order + 1):
        norm = np.sqrt((2 * j + 1.0) / 2.0) * 0.5**j
        for r in range(j // 2 + 1):
            c = (
                (-1) ** r
                * factorial(2 * j - 2 * r)
                / (factorial(r) * factorial(j - r) * factorial(j - 2 * r))
            )
            coef[j, j - 2 * r] = norm * c
    return coef


def leg_basis(time, order: int, tmin=None, tmax=None) -> np.ndarray:
    """(len(time), order+1) Legendre design matrix.

    With tmin/tmax None they default to the observed range (reference `leg`);
    passing them gives the reference's `leg_mt` behavior.
    """
    time = np.asarray(time, dtype=float).ravel()
    tmin = np.min(time) if tmin is None else float(tmin)
    tmax = np.max(time) if tmax is None else float(tmax)
    tvec = 2.0 * (time - tmin) / (tmax - tmin) - 1.0
    powers = tvec[:, None] ** np.arange(order + 1)[None, :]
    return powers @ leg_coeffs(order).T


def leg(time, order: int) -> list:
    """Reference-name API (balance/common.py:69-87): list of (T, 1) Legendre
    columns normalized over the observed time range."""
    phi = leg_basis(time, order)
    return [phi[:, k:k + 1] for k in range(order + 1)]


def leg_mt(time, tmax, tmin, order: int) -> np.ndarray:
    """Reference-name API (balance/common.py:89-105): (T, order+1) basis over
    an explicit [tmin, tmax] range (argument order follows the reference:
    tmax before tmin)."""
    return leg_basis(time, order, tmin=tmin, tmax=tmax)
