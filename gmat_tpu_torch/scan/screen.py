"""Effect-only epistasis screening and the approximate AA test pipeline.

Counterpart of the AA flat-cut path of `gmat_tpu/scan/screen.py`:
- `remma_epiAA_eff`: screen |eff(i, j)| > eff_cut = sqrt(chi2_crit·var_app)
  over all pairs j > i, write `snp_0 snp_1 eff` plus the appended
  `chi_app p_app` columns;
- `remma_epiAA_approx`: random-pair variance calibration (median) -> screen
  -> exact re-test of the survivors -> merge of approx and exact p.

The screen is S = (A ⊙ py)ᵀ A in float32 on the hand-written Hopper kernel
(`scan/kernels.py`); its FMA is full float32, so no threshold slack is
applied.  Survivors are re-tested exactly in float64.
"""
from __future__ import annotations

import logging
import os
import time

import numpy as np
import pandas as pd
import torch

from gmat_tpu_torch.config import SCREEN_DTYPE, resolve_device
from gmat_tpu_torch.core.stats import chi2_isf
from gmat_tpu_torch.scan.kernels import screen_hits

logger = logging.getLogger(__name__)

_TODO = ("ROADMAP.md queue 1, item 13 (AD/DD kinds, MAF cut panels, anchor "
         "subsets and the *_parallel screens)")


def _screen_slack() -> float:
    """Threshold slack for the screen product's precision: none, since the
    kernel accumulates in full float32 FMA, like the JAX package on the CPU."""
    return 0.0


def _run_screen(a_mat, pymat, anchors, table):
    """Screen driver: (i, j, eff) host arrays of the hits, sorted by (i, j).

    Serves the full upper triangle of the panel against itself at one flat
    cut, with every SNP but the last as an anchor; any other case raises."""
    table = np.asarray(table, dtype=np.float32) * np.float32(1.0 - _screen_slack())
    m = a_mat.shape[1]
    if not (np.ptp(table) == 0.0
            and np.array_equal(np.asarray(anchors), np.arange(m - 1))):
        raise NotImplementedError(f"this screen is not ported yet: {_TODO}")
    i, j, eff = screen_hits(a_mat, pymat, float(table.ravel()[0]), m)
    return i.cpu().numpy(), j.cpu().numpy(), eff.cpu().numpy()


def _screen_engine(kind, pheno_file, bed_prefix, gmat_lst, var_com,
                   snp_lst_0, eff_cut_table, out_file, device=None):
    """Shared driver of the *_eff screens; writes `snp_0 snp_1 eff` rows and
    returns the hit arrays."""
    from gmat_tpu_torch.scan.common import (coded_matrix, design_matrix_cached,
                                            prepare_genotypes_device,
                                            score_pieces_cached)

    if kind != "AA":
        raise NotImplementedError(f"epi{kind} screen is not ported yet: {_TODO}")
    dev = resolve_device(device)
    dm = design_matrix_cached(pheno_file, bed_prefix)
    t0 = time.perf_counter()
    pieces = score_pieces_cached(dm, gmat_lst, var_com, dev)
    g, num_snp = prepare_genotypes_device(bed_prefix, device=dev)
    a_full = coded_matrix(g, "add", SCREEN_DTYPE)
    py = pieces.pymat.to(SCREEN_DTYPE).contiguous()
    logger.info("Screen engine setup (pieces/geno/codings): %.3f s",
                time.perf_counter() - t0)
    hi_anchor = num_snp - 1
    if snp_lst_0 is None:
        snp_lst_0 = range(hi_anchor)
    elif max(snp_lst_0) >= hi_anchor or min(snp_lst_0) < 0:
        raise ValueError("snp_lst_0 is out of range!")
    t0 = time.perf_counter()
    idx0, idx1, eff = _run_screen(a_full, py, list(snp_lst_0), eff_cut_table)
    logger.info("Screen sweep incl. assembly: %.3f s, %d hits",
                time.perf_counter() - t0, len(idx0))
    t0 = time.perf_counter()
    with open(out_file, "w") as f:
        f.write("snp_0 snp_1 eff\n")
        for s in range(0, len(idx0), 1 << 22):
            pd.DataFrame({0: idx0[s:s + (1 << 22)],
                          1: idx1[s:s + (1 << 22)],
                          2: eff[s:s + (1 << 22)]}).to_csv(
                f, sep=" ", header=False, index=False, float_format="%g")
    logger.info("Screen write: %d rows in %.3f s", len(idx0),
                time.perf_counter() - t0)
    return idx0, idx1, eff


def _append_approx_p(screen_file, out_file, bins_a, bins_b, freq_deno):
    """Append chi_app/p_app columns; the denominator is indexed
    bins_a[snp_0]*10 + bins_b[snp_1] on the written row."""
    from scipy.stats import chi2 as chi2_dist

    t0 = time.perf_counter()
    with open(screen_file) as fin, open(out_file, "w") as fout:
        head = fin.readline().strip()
        fout.write(head + " chi_app p_app\n")
        lines = fin.read().splitlines()
        if lines:
            toks = [line.split() for line in lines]
            i0 = np.array([int(t[0]) for t in toks], dtype=np.int64)
            i1 = np.array([int(t[1]) for t in toks], dtype=np.int64)
            eff = np.array([float(t[-1]) for t in toks])
            deno = np.asarray(freq_deno)[
                np.asarray(bins_a)[i0] * 10 + np.asarray(bins_b)[i1]]
            chi_app = eff * eff / deno
            p_app = chi2_dist.sf(chi_app, 1)
            fout.write("\n".join(
                " ".join(t + [str(c), str(p)])
                for t, c, p in zip(toks, chi_app, p_app)) + "\n")
    logger.info("Approx p append: %d rows in %.3f s", len(lines),
                time.perf_counter() - t0)


def _remma_epi_eff(kind, pheno_file, bed_prefix, gmat_lst, var_com,
                   snp_lst_0=None, var_app=1.0, p_cut=1.0e-5,
                   out_file="epi_eff", device=None):
    from gmat_tpu_torch.io.bed import read_bim

    chi_cut = chi2_isf(p_cut, 1)
    table = np.full(111, np.sqrt(chi_cut * var_app))
    bins = np.zeros(len(read_bim(bed_prefix + ".bim")), dtype=np.int64)
    deno = np.full(111, var_app)
    tmp = out_file + ".temp"
    _screen_engine(kind, pheno_file, bed_prefix, gmat_lst, var_com,
                   snp_lst_0, table, tmp, device=device)
    _append_approx_p(tmp, out_file, bins, bins, deno)
    os.remove(tmp)
    return 0


def remma_epiAA_eff(pheno_file, bed_prefix, gmat_lst, var_com, snp_lst_0=None,
                    var_app=1.0, p_cut=1.0e-5, out_file="epiAA_eff",
                    device=None):
    return _remma_epi_eff("AA", pheno_file, bed_prefix, gmat_lst, var_com,
                          snp_lst_0, var_app, p_cut, out_file, device=device)


def _merge_approx_exact(approx_file, exact_file, out_file):
    """Insert the approx p column before the exact p."""
    p_dct = {}
    with open(approx_file) as fin:
        for line in fin:
            arr = line.split()
            p_dct[" ".join(arr[:2])] = arr[-1]
    with open(exact_file) as fin, open(out_file, "w") as fout:
        for line in fin:
            arr = line.split()
            arr.insert(-1, p_dct[" ".join(arr[:2])])
            fout.write(" ".join(arr) + "\n")


#: per-stage wall-clock seconds of the most recent approx-pipeline run
#: (keys: prep, calibrate, screen, retest, merge, total)
LAST_APPROX_STAGES: dict = {}


def _approx_prep(kind, pheno_file, bed_prefix, gmat_lst, var_com,
                 device=None):
    """Warm every cross-stage cache (design parse, score pieces, device
    genotype panel, codings) and wait for the device, so that the stage
    timers below measure each stage's own work."""
    from gmat_tpu_torch.scan.pairs import _epi_setup

    mat0, _, _, _, _ = _epi_setup(pheno_file, bed_prefix, gmat_lst, var_com,
                                  kind, device)
    if mat0.device.type == "cuda":
        torch.cuda.synchronize(mat0.device)


def _remma_epi_approx(kind, pheno_file, bed_prefix, gmat_lst, var_com,
                      p_cut=1.0e-5, num_random_pair=100000,
                      out_file="epi_approx", snp_lst_0=None, seed=0,
                      device=None):
    from gmat_tpu_torch.io.bed import read_bim
    from gmat_tpu_torch.scan.pairs import remma_epiAA_pair
    from gmat_tpu_torch.scan.random_pair import random_pair

    if kind != "AA":
        raise NotImplementedError(f"epi{kind} approx is not ported yet: {_TODO}")
    stages = {}
    t_all = time.perf_counter()
    t0 = time.perf_counter()
    _approx_prep(kind, pheno_file, bed_prefix, gmat_lst, var_com, device)
    stages["prep"] = time.perf_counter() - t0
    num_snp = len(read_bim(bed_prefix + ".bim"))
    logger.info("Random calibration: %d pairs", num_random_pair)
    rp = out_file + ".random_pair"
    random_pair(num_snp, out_file=rp, num_pair=num_random_pair, seed=seed)
    t0 = time.perf_counter()
    remma_epiAA_pair(pheno_file, bed_prefix, gmat_lst, var_com,
                     snp_pair_file=rp, p_cut=1.1,
                     out_file=out_file + ".random", device=device)
    res_df = pd.read_csv(out_file + ".random", header=0, sep=r"\s+")
    var_median = float(np.median(res_df["var"]))
    stages["calibrate"] = time.perf_counter() - t0
    os.remove(rp)
    os.remove(out_file + ".random")
    logger.info("Approximate effect variance (median): %g", var_median)
    t0 = time.perf_counter()
    _remma_epi_eff(kind, pheno_file, bed_prefix, gmat_lst, var_com,
                   snp_lst_0=snp_lst_0, var_app=var_median, p_cut=p_cut,
                   out_file=out_file + ".approx_p", device=device)
    stages["screen"] = time.perf_counter() - t0
    logger.info("Exact re-test of survivors")
    t0 = time.perf_counter()
    remma_epiAA_pair(pheno_file, bed_prefix, gmat_lst, var_com,
                     snp_pair_file=out_file + ".approx_p", p_cut=1.1,
                     out_file=out_file + ".exact_p", device=device)
    stages["retest"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    _merge_approx_exact(out_file + ".approx_p", out_file + ".exact_p", out_file)
    stages["merge"] = time.perf_counter() - t0
    os.remove(out_file + ".approx_p")
    os.remove(out_file + ".exact_p")
    stages["total"] = time.perf_counter() - t_all
    LAST_APPROX_STAGES.clear()
    LAST_APPROX_STAGES.update(stages)
    logger.info("Approx pipeline stages (s): %s",
                {k: round(v, 3) for k, v in stages.items()})
    return 0


def remma_epiAA_approx(pheno_file, bed_prefix, gmat_lst, var_com,
                       p_cut=1.0e-5, num_random_pair=100000,
                       out_file="epiAA_approx", seed=0, device=None):
    """Flagship fast pipeline: calibrate -> screen -> exact re-test -> merge."""
    return _remma_epi_approx("AA", pheno_file, bed_prefix, gmat_lst, var_com,
                             p_cut, num_random_pair, out_file, seed=seed,
                             device=device)
