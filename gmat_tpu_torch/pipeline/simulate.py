"""Phenotype simulators with known A/D/AA/AD/DD architecture (counterpart of
`gmat_tpu/pipeline/simulate.py`, the reference's `gmat/remma/simu/simu.py`).

- effect files: `snp_index effect` (A/D) or `snp0 snp1 effect` (epistasis);
- effects rescaled so that each component reaches its target variance
  ratio (default [2, 1, 0.5, 0.5, 0.5, 1] relative to the residual): the
  empirical variance for `simu_epistasis`, the theoretical 2p(1-p)-based
  one for the A/D components of `simu_epistasis_freq`;
- outputs: `<eff_file>.norm` rescaled effects, `<out>.res` residuals,
  `<out>.pheno` fam-keyed phenotype file (third column all ones);
- the reference's quirk is kept: the DD component's target ratio reuses
  ratio[3], the AD slot, in both variants.

The codings, variances and genetic values are float64 on `device`, over
only the SNP columns the effect files name.  The residual is
`np.random.default_rng(seed).normal(...)` on the host, as in `gmat_tpu`,
so one seed gives the same `.res` in both packages.
"""
from __future__ import annotations

import numpy as np
import pandas as pd
import torch

from gmat_tpu_torch.config import resolve_device
from gmat_tpu_torch.core.coding import additive_code, dominance_code
from gmat_tpu_torch.scan.common import prepare_genotypes_device

_DEFAULT_RATIO = [2.0, 1.0, 0.5, 0.5, 0.5, 1.0]


def _load_effects(path):
    return pd.read_csv(path, header=None, sep=r"\s+")


def _simulate(bed_prefix, add_file, dom_file, epiAA_file, epiAD_file,
              epiDD_file, ratio, mean, res_var, out_file, freq_based, seed,
              device):
    from gmat_tpu_torch.io.bed import read_fam

    dev = resolve_device(device)
    ratio = np.asarray(_DEFAULT_RATIO if ratio is None else ratio, float)
    files = (add_file, dom_file, epiAA_file, epiAD_file, epiDD_file)
    frames = [_load_effects(path) for path in files]
    n_idx = (1, 1, 2, 2, 2)  # SNP-index columns of each effect file
    cols = np.unique(np.concatenate(
        [df.iloc[:, :k].to_numpy(dtype=np.int64).ravel()
         for df, k in zip(frames, n_idx)]))
    g, _ = prepare_genotypes_device(bed_prefix, device=dev)
    n = g.shape[0]
    sub = g[:, torch.as_tensor(cols, device=dev)]
    mat_a, freq, _ = additive_code(sub)
    mat_d = dominance_code(sub, freq)[0]
    coded = {"a": mat_a, "d": mat_d}

    def positions(df, k):
        """Column k's SNP indexes as positions in `cols`."""
        pos = np.searchsorted(cols, df.iloc[:, k].to_numpy(dtype=np.int64))
        return torch.as_tensor(pos, device=dev)

    def values(df, codes):
        """(n, k) genetic values of the k effects of `df`, and the
        effects; the effect is the column after the SNP indexes."""
        eff = torch.tensor(df.iloc[:, len(codes)].to_numpy(dtype=float),
                           device=dev)
        val = coded[codes[0]][:, positions(df, 0)]
        for k, code in enumerate(codes[1:], 1):
            val = val * coded[code][:, positions(df, k)]
        return val * eff[None, :], eff

    def normalise(df, codes, target, theo_var=None):
        val, eff = values(df, codes)
        if theo_var is None:
            comp_var = torch.var(val, dim=0, unbiased=False)
        else:
            comp_var = theo_var(freq[positions(df, 0)]) * eff * eff
        df.iloc[:, len(codes)] = (
            eff / torch.sqrt(torch.sum(comp_var) / target)).cpu().numpy()
        return df

    het = (lambda p: 2 * p * (1 - p)) if freq_based else None
    dom_het = ((lambda p: 2 * p * (1 - p) * (1 - 2 * p * (1 - p)))
               if freq_based else None)
    scale = res_var / ratio[-1]
    specs = (("a",), ("d",), ("a", "a"), ("a", "d"), ("d", "d"))
    # reference quirk: DD reuses ratio[3]
    targets = (ratio[0], ratio[1], ratio[2], ratio[3], ratio[3])
    theo = (het, dom_het, None, None, None)
    frames = [normalise(df, codes, t * scale, tv)
              for df, codes, t, tv in zip(frames, specs, targets, theo)]
    for df, path in zip(frames, files):
        df.to_csv(path + ".norm", sep=" ", header=False, index=False)

    rng = np.random.default_rng(seed)
    res_vec = rng.normal(0, np.sqrt(res_var), n)
    np.savetxt(out_file + ".res", res_vec)

    pheno = torch.full((n,), float(mean), dtype=g.dtype, device=dev)
    for df, codes in zip(frames, specs):
        pheno = pheno + torch.sum(values(df, codes)[0], dim=1)
    pheno = pheno.cpu().numpy() + res_vec
    res_df = read_fam(bed_prefix + ".fam").iloc[:, :4].copy()
    # whole columns are replaced: the .fam's parent columns may be integer
    res_df[res_df.columns[2]] = 1
    res_df[res_df.columns[3]] = pheno
    res_df.to_csv(out_file + ".pheno", sep=" ", header=False, index=False)
    return res_df


def simu_epistasis(bed_prefix, add_file, dom_file, epiAA_file, epiAD_file,
                   epiDD_file, ratio=None, mean=1.0, res_var=1.0,
                   out_file="simu_epistasis", seed=0, device=None):
    """Empirical-variance rescaling variant (reference simu.py:78-143)."""
    return _simulate(bed_prefix, add_file, dom_file, epiAA_file, epiAD_file,
                     epiDD_file, ratio, mean, res_var, out_file, False, seed,
                     device)


def simu_epistasis_freq(bed_prefix, add_file, dom_file, epiAA_file,
                        epiAD_file, epiDD_file, ratio=None, mean=1.0,
                        res_var=1.0, out_file="simu_epistasis_freq", seed=0,
                        device=None):
    """Theoretical 2p(1-p)-variance variant for A/D (reference simu.py:8-75)."""
    return _simulate(bed_prefix, add_file, dom_file, epiAA_file, epiAD_file,
                     epiDD_file, ratio, mean, res_var, out_file, True, seed,
                     device)
