"""Genotype codings and scale factors on torch tensors.

Counterpart of `gmat_tpu/core/coding.py`, with the same reference semantics:
- additive coding: freq p = sum(g)/2n, centered g - 2p, scale = sum(2p(1-p));
- dominance coding: s = 2p(1-p); het-recode g > 1.5 -> 0, centered by s;
  scale = sum(s(1-s)).
"""
from __future__ import annotations

import torch


def allele_freq(geno):
    """Per-SNP allele frequency p = sum(g) / (2 * num_id).  geno: (n, m)."""
    return torch.sum(geno, dim=0) / (2.0 * geno.shape[0])


def additive_scale(freq):
    """sum_j 2 p_j (1 - p_j) — the additive GRM/SNP-BLUP denominator."""
    return torch.sum(2.0 * freq * (1.0 - freq))


def dominance_scale(freq):
    """sum_j s_j (1 - s_j) with s_j = 2 p_j (1 - p_j)."""
    s = 2.0 * freq * (1.0 - freq)
    return torch.sum(s * (1.0 - s))


def additive_code(geno, freq=None):
    """Centered additive coding M = g - 2p; returns (M, freq, scale)."""
    if freq is None:
        freq = allele_freq(geno)
    return geno - 2.0 * freq[None, :], freq, additive_scale(freq)


def dominance_code(geno, freq=None):
    """Centered dominance coding: het indicator minus 2p(1-p).

    Returns (D, freq, scale)."""
    if freq is None:
        freq = allele_freq(geno)
    s = 2.0 * freq * (1.0 - freq)
    het = torch.where(geno > 1.5, torch.zeros_like(geno), geno)
    return het - s[None, :], freq, dominance_scale(freq)
