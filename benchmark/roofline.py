"""The yardstick of the rooflines: the card's published peaks and the least
work of each kernel's call, from its inputs' shapes.

Peaks of one NVIDIA H100 SXM (80 GB HBM3) at its 700 W power limit,
dense: 495 TFLOP/s TF32 on the tensor cores, 67 TFLOP/s FP64 on the
tensor cores, 3.35 TB/s of HBM.  A share is stated against these with the
card's power limit beside it.

- K1, the effect screen (`screen_count*` and `screen_extract*`): the
  least work of one screen is 2n FLOP per pair (a multiply and an add per
  individual) over every pair of the kind's set: m(m-1)/2 for AA and DD
  (j > i), m(m-1) for AD (every i != j, which the port screens in two
  sweeps), of float32-grade precision; the kernel reaches it with three
  TF32 products per multiply-add (3xTF32), so its peak is 495 / 3 = 165
  TFLOP/s.  The least bytes: each distinct (n, m) float32 coding (one for
  AA and DD, two for AD) and py read once.
- K2, the exact scan (`exact_scan`): n² + 7n FP64 FLOP per pair tested
  (the quadratic form eᵀPe over the symmetric half of P, n² multiply-adds
  counted once each for the n(n+1)/2 terms, plus forming e, eᵀpy and the
  chi), at 67 TFLOP/s.  The least bytes: P (n² float64) and the two coded
  panels read once.
"""
from __future__ import annotations

PEAK = {
    "tf32_tensor": 495e12,
    "fp64_tensor": 67e12,
    "hbm_bytes": 3.35e12,
}
K1_PEAK = PEAK["tf32_tensor"] / 3.0
K2_PEAK = PEAK["fp64_tensor"]


def screen_pairs(m, kind="AA"):
    """Pairs of an m-SNP screen of `kind` over every anchor: j > i (AA,
    DD), every i != j (AD)."""
    half = m * (m - 1) // 2
    return 2 * half if kind == "AD" else half


def k1_least_seconds(n, m, kind="AA"):
    """Least time of one screen of `kind` of an (n, m) panel."""
    flop = 2.0 * n * screen_pairs(m, kind)
    codings = 2 if kind == "AD" else 1
    nbytes = 4.0 * n * m * codings + 4.0 * n
    return max(flop / K1_PEAK, nbytes / PEAK["hbm_bytes"])


def k2_pair_flop(n):
    """Least FP64 FLOP of one exactly tested pair."""
    return float(n) * n + 7.0 * n


def k2_least_seconds(n, m, pairs):
    """Least time of an exact scan of `pairs` pairs of an (n, m) panel."""
    flop = pairs * k2_pair_flop(n)
    nbytes = 8.0 * n * n + 2 * 8.0 * n * m
    return max(flop / K2_PEAK, nbytes / PEAK["hbm_bytes"])
