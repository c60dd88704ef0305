#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (gmat_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

1. requires CUDA and prints the card's name and power limit;
2. builds the kernels from gmat_tpu_torch/csrc/*.cu (one nvcc per source,
   all started together);
3. holds the effect-screen kernels against their plain PyTorch versions and
   a float64 oracle at the yeast shape (n=4168, m=28220, ~1e5 hits), a
   ragged shape, a zero-hit cut and a near-keep-all cut, and times both;
4. holds the exact-scan kernel against its plain version for AA, AD and DD
   at a ragged shape with an unsorted anchor subset, with a threshold, a
   zero-hit threshold and keep-all;
5. runs the complete mouse exact-scan tables (tests/data/plink) through
   remma_epiAA/AD/DD and holds them against the reference's
   tests/golden/epi_full.npz at tests/test_full_table.py's tolerances;
6. runs the README's four-step REMMAX workflow through the package's entry
   points at the yeast shape on a seeded PLINK set of full-sib families:
   agmat -> wemai_multi_gmat -> remma_epiAA_approx -> annotation_snp_pos,
   and checks that the screen kernels ran and that the result table is
   right;
7. on the same set, one part of the exhaustive scan's balanced split,
   remma_epiAA_parallel(parallel=[100, 1]) (301 anchors, 3,981,889 pairs),
   held against the plain version and the approx table, and timed beside
   the plain version and torch.matmul(pvp, E) (the exact-scan kernel's
   time, rates and share of its bound are printed for the mouse AA table
   and this part; the build fails the run when the exact-scan kernel's
   SASS holds no DMMA, FP64 tensor-core, instruction);
8. remma_add and remma_dom on the same set;
9. the general screen kernels against their plain versions and the f64
   bracket: AD at the yeast shape with MAF/het bins and a varied cut table
   as its two sweeps, a ragged 1001 x 3001 AD screen of an unsorted
   300-anchor subset with a table, and keep-all on a subset (their times
   on the `general screen kernels` line);
10. on the yeast set, remma_epiAD_approx, remma_epiDD_approx,
   remma_epiAA_maf_approx and remma_epiAD_maf_approx (p_cut=1e-5, 100,000
   calibration pairs), each with its own launch counts, table checks and
   stage times, and remma_epiAD_eff_parallel([100, 1]) against
   remma_epiAD_eff: the part's rows are the full table's rows of its
   anchors, byte for byte;
11. on the yeast set, the uvlmm family (`uvlmm_phase`): the eigen REML,
   wemai_multi_gmat with one GRM and em_mme to convergence, which must
   reach the same REML maximum (rtol 1e-5); the other MME variants,
   em_mme_multi and em_vmat at maxiter=5 (times per iteration); the
   fixed-effect add/dom tests and their eigen twins over every SNP (eigen
   vs direct at rtol 1e-7, 32 SNPs against a per-SNP GLS fit at 1e-8);
   uvlmm_gwas_epiAA over 64 anchors (the planted pairs found, 16 rows
   against a direct GLS fit); lm_snp_eff against lstsq, lm_pred;
   wemai_multi_gmat_pred with 10% of the phenotypes removed and the BLUPs
   against the MME solution; ginbreedcoef, shuffle_bed and the nearest-gene
   annotation (the `uvlmm step times (s)` line);
12. the longwas family (`longwas_phase`) on tests/data/mouse_long at full
   width (1,212 ids, 11,833 SNPs, 16 time points, 19,392 unbalanced
   records), the kinship from agmat: balance_varcom (5 rounds against
   tests/golden at rtol 1e-6, then to convergence); balance_longwas_trans
   and _fixed over every SNP, cold and warm, the first 30 rows against the
   golden at the JAX tests' tolerances; the full-cohort unbalance_varcom
   (3 rounds, rtol 1e-5) and unbalance_longwas_fixed/_trans over every SNP,
   16 seeded SNPs against direct f64 fits at rtol 1e-8; the 150-id subset
   and the permutation twins against their goldens, the balance-trans
   twin's files byte for byte under one seed, two full-panel replicates of
   each trans twin timed; no hand kernel may launch (the `longwas step
   times (s)`, `longwas rates (SNPs/s)` and peak-memory lines).

The last line is {"ok": true, "device": {...}}; the line before it names
the card and its power limit, and the one before that lists each kernel
with its launches on the path that runs it, its largest deviation from the
plain version, its time, the plain version's, the library call's and the
least time the card could take.  Any failure exits nonzero before that.
Scratch files go to build/chip_smoke/ and are removed at the end.
"""
from __future__ import annotations

import json
import logging
import shutil
import subprocess
import sys
import tempfile
import time
from functools import partial
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 2026
BAND = 1e-4  # hit-set bracket around the cut: f64 oracle at cut·(1 ± BAND)
EFF_RTOL = 1e-4  # kernel eff vs the f64 oracle and vs the plain version
YEAST = (4168, 28220)  # individuals, SNPs: the reference README's yeast set
EXACT_BAND = 1e-9  # exact-scan hit sets may differ only within crit·(1 ± band)
EXACT_RTOL = 1e-9  # exact-scan eff/var/chi, kernel vs plain (both float64)
# peak rates of one H100 SXM (NVIDIA's data sheet, dense): float32 outside
# the tensor cores, float64 on the tensor cores (34e12 on the CUDA cores),
# and the HBM3 rate
FP32_PEAK, FP64_PEAK, HBM_RATE = 67e12, 67e12, 3.35e12
MOUSE = ROOT / "tests" / "data"
MOUSE_M = 1407


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond, msg):
    if not cond:
        fail(msg)


def bound(flop, nbytes, peak):
    """(ms, what bounds it): the larger of the operations at `peak` and
    the bytes at the HBM rate."""
    t_ops, t_bytes = flop / peak, nbytes / HBM_RATE
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def tile_pairs(tiles, m, tile, ids=None):
    """Pairs j > i, j < m inside the listed (anchor tile, partner tile)
    tiles, i the anchor's id: ids[position], or the position itself."""
    import torch

    ta, tb = tiles[:, 0].long(), tiles[:, 1].long()
    pos = ta[:, None] * tile + torch.arange(tile, device=tiles.device)[None, :]
    n_a = m if ids is None else len(ids)
    if ids is None:
        row = pos
    else:
        row = ids.long()[pos.clamp(max=max(n_a - 1, 0))]
    row = torch.where(pos < n_a, row, torch.full_like(row, m))
    lo = torch.maximum(tb[:, None] * tile, row + 1)
    hi = torch.clamp(tb[:, None] * tile + tile, max=m)
    return int((hi - lo).clamp(min=0).sum())


def codes_panel(n, m, seed):
    """Centered additive and dominance codes of a binomial(2, p) panel,
    its MAF and heterozygote-frequency bins (int(freq*20), folded), and a
    py vector, on the card; the codes float32."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    p = 0.05 + 0.9 * torch.rand(m, generator=g, device="cuda")
    geno = ((torch.rand(n, m, generator=g, device="cuda") < p).float()
            + (torch.rand(n, m, generator=g, device="cuda") < p).float())
    het = (geno == 1.0).float()
    maf = geno.mean(dim=0) / 2
    maf = torch.where(maf > 0.5, 1 - maf, maf)
    hf = het.mean(dim=0)
    hf = torch.where(hf > 0.5, 1 - hf, hf)
    codes = {"A": (geno - geno.mean(dim=0)).contiguous(),
             "D": (het - het.mean(dim=0)).contiguous()}
    bins = {"maf": (maf * 20).int().contiguous(),
            "het": (hf * 20).int().contiguous()}
    py = (0.1 * torch.randn(n, generator=g, device="cuda")).contiguous()
    return codes, bins, py


def panel(n, m, seed):
    """Centered additive codes of a binomial(2, p) panel and a py vector,
    float32 on the card."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    p = 0.05 + 0.9 * torch.rand(m, generator=g, device="cuda")
    geno = ((torch.rand(n, m, generator=g, device="cuda") < p).float()
            + (torch.rand(n, m, generator=g, device="cuda") < p).float())
    mat = (geno - geno.mean(dim=0)).contiguous()
    py = (0.1 * torch.randn(n, generator=g, device="cuda")).contiguous()
    return mat, py


def cut_for_hits(mat, py, target, b=None):
    """|S| quantile that leaves about `target` of the m(m-1)/2 pairs, from
    the scores of 512 random anchor rows in float64."""
    import torch

    b = mat if b is None else b
    m = mat.shape[1]
    g = torch.Generator(device="cuda").manual_seed(SEED)
    rows = torch.randperm(m, generator=g, device="cuda")[:512]
    s = ((mat[:, rows].double() * py.double()[:, None]).T @ b.double()).abs()
    s[torch.arange(len(rows), device="cuda"), rows] = 0.0  # the diagonal
    q = 1.0 - target / (m * (m - 1) / 2)
    return float(torch.quantile(s.flatten()[:1 << 24].float(), q))


def keys_in(keys, sorted_keys):
    """Membership of each of `keys` in `sorted_keys`, and its position."""
    import torch

    pos = torch.searchsorted(sorted_keys, keys).clamp(max=max(len(sorted_keys) - 1, 0))
    found = (sorted_keys[pos] == keys) if len(sorted_keys) else torch.zeros_like(keys, dtype=torch.bool)
    return found, pos


def scaled(cut, factor):
    """The cut (a float or a CutTable) times `factor`."""
    return cut * factor if isinstance(cut, float) else cut.scaled(factor)


def kernel_case(K, name, mat, py, cut, b=None, anchors=None):
    """One kernel-vs-plain comparison of the screen of the anchors
    `anchors` (SNP ids, None for all) of `mat` against the partners of b
    (mat when None) at `cut` (a float or a CutTable); returns its
    measurements."""
    import torch

    from gmat_tpu_torch.probe import cuda_ms

    n, m = mat.shape[0], (mat if b is None else b).shape[1]
    a, ids = K.anchor_panel(mat, anchors, m)
    bb = b if b is not None or ids is None else mat
    kw = {"b": bb, "ids": ids}
    a64, b64 = a.double(), None if bb is None else bb.double()
    py64 = py.double()
    kw64 = {"b": b64, "ids": ids}
    hkw = {"b": b, "anchors": anchors}
    hkw64 = {"b": None if b is None else b64, "anchors": anchors}
    mat64 = mat.double()
    # the band around a negative (keep-all) cut opens the other way
    lo, hi = (1 + BAND, 1 - BAND) if not isinstance(cut, float) or cut > 0 \
        else (1 - BAND, 1 + BAND)
    # phase 1: counts against the f64 bracket and the plain float32 version
    counts = K.screen_counts(a, py, cut, m, **kw)
    plain_counts = K.screen_tile_counts_ref(a, py, cut, m, **kw)
    core_c = K.screen_tile_counts_ref(a64, py64, scaled(cut, lo), m, **kw64)
    hull_c = K.screen_tile_counts_ref(a64, py64, scaled(cut, hi), m, **kw64)
    check(bool(torch.all(core_c <= counts)) and bool(torch.all(counts <= hull_c)),
          f"{name}: kernel tile counts outside the f64 bracket")
    check(bool(torch.all(core_c <= plain_counts))
          and bool(torch.all(plain_counts <= hull_c)),
          f"{name}: plain tile counts outside the f64 bracket")
    count_err = int((counts - plain_counts).abs().max()) if counts.numel() else 0
    # phase 2 + driver: hit set against the f64 bracket, eff against f64
    i, j, e = K.screen_hits(mat, py, cut, m, **hkw)
    torch.cuda.synchronize()
    if ids is None:
        pos = i
    else:
        order = torch.argsort(ids.long())
        pos = order[torch.searchsorted(ids.long()[order], i)]
    keys = pos * m + j
    check(bool(torch.all(keys[1:] > keys[:-1])),
          f"{name}: hits not in anchor-list order")
    hi_, hj, he = K.screen_hits_ref(mat64, py64, scaled(cut, hi), m, **hkw64)
    # (i, j) keys of the plain versions, sorted for lookups
    def ij(ii, jj):
        return ii * m + jj
    hull = ij(hi_, hj)
    hsort, hperm = torch.sort(hull)
    found, at = keys_in(ij(i, j), hsort)
    check(bool(found.all()), f"{name}: {int((~found).sum())} kernel hits "
          "below the f64 bracket")
    ci, cj, _ = K.screen_hits_ref(mat64, py64, scaled(cut, lo), m, **hkw64)
    got_sorted = torch.sort(ij(i, j)).values
    in_k, _ = keys_in(ij(ci, cj), got_sorted)
    check(bool(in_k.all()), f"{name}: {int((~in_k).sum())} f64 hits above "
          "the bracket missed")
    ref = he[hperm[at]] if len(keys) else he[:0]
    # keep-all keeps scores that cancel to about 0, where float32 rounding
    # is no relative error: there each eff may also miss by the float32
    # dot product's error bound, n·2^-24·Σ_k |a_k·py_k·b_k|
    floor = torch.zeros_like(ref)
    if isinstance(cut, float) and cut < 0 and len(keys):
        part64 = a64 if b64 is None else b64
        terms = (a64[:, :len(ids) if ids is not None else m].abs()
                 * py64.abs()[:, None]).T @ part64.abs()
        floor = n * 2.0 ** -24 * terms[pos, j] / EFF_RTOL
    rel = float(((e.double() - ref).abs() / (ref.abs() + floor)).max()) \
        if len(keys) else 0.0
    check(rel <= EFF_RTOL, f"{name}: eff off the f64 oracle by {rel:.3g}")
    # the plain float32 version: same bracket, eff on the common pairs
    pi, pj, pe = K.screen_hits_ref(mat, py, cut, m, **hkw)
    pfound, _ = keys_in(ij(pi, pj), hsort)
    check(bool(pfound.all()), f"{name}: plain hits below the f64 bracket")
    psort, pperm = torch.sort(ij(pi, pj))
    common, cpos = keys_in(ij(i, j), psort)
    pe_c = pe[pperm[cpos[common]]]
    diff = (e[common] - pe_c).abs()
    eff_err = float(diff.max()) if len(diff) else 0.0
    plain_rel = float((diff / (pe_c.abs() + floor[common])).max()) \
        if len(diff) else 0.0
    check(plain_rel <= EFF_RTOL,
          f"{name}: eff off the plain version by {plain_rel:.3g} (relative)")
    tiles = torch.nonzero(counts).to(torch.int32)
    n_a = m if ids is None else len(ids)
    pairs = (m * (m - 1) // 2 if ids is None
             else int((m - 1 - ids.long()).clamp(min=0).sum()))
    # each input read once: the panel(s), py, the bins and the table
    in_bytes = 4 * (n * m + n + (0 if b is None else n * n_a)) + (
        0 if isinstance(cut, float) else 8 * m + 4 * 111)
    count_bound = bound(2.0 * n * pairs, in_bytes + 4 * counts.numel(),
                        FP32_PEAK)
    extract_bound = bound(2.0 * n * tile_pairs(tiles, m, K.TILE, ids),
                          in_bytes + 8 * len(tiles) + 12 * len(keys),
                          FP32_PEAK)
    out = {
        "case": name, "n": n, "m": m, "anchors": n_a,
        "cut": cut if isinstance(cut, float) else "table", "hits": len(keys),
        "f64_core": len(ci), "f64_hull": len(hull), "hot_tiles": len(tiles),
        "pairs": pairs,
        "count_max_abs_err": count_err, "eff_max_abs_err": eff_err,
        "eff_max_rel_err_f64": rel,
        "count_bound_ms": count_bound[0], "count_bound_by": count_bound[1],
        "extract_bound_ms": extract_bound[0],
        "extract_bound_by": extract_bound[1],
        "count_ms": cuda_ms(lambda: K.screen_counts(a, py, cut, m, **kw)),
        "plain_count_ms": cuda_ms(lambda: K.screen_tile_counts_ref(a, py, cut, m, **kw)),
        "extract_ms": cuda_ms(lambda: K.screen_extract(a, py, cut, m, counts, **kw)),
        "plain_extract_ms": cuda_ms(lambda: K.screen_extract_ref(a, py, cut, m, tiles, **kw)),
        "screen_ms": cuda_ms(lambda: K.screen_hits(mat, py, cut, m, **hkw)),
        "plain_screen_ms": cuda_ms(lambda: K.screen_hits_ref(mat, py, cut, m, **hkw)),
    }
    print("case " + json.dumps(out), flush=True)
    torch.cuda.empty_cache()
    return out


def flat_case(K, name, n, m, seed, target=None, cut=None):
    """kernel_case of the identity AA screen of a seeded panel, at `cut` or
    at the cut that leaves about `target` hits."""
    import torch

    mat, py = panel(n, m, seed)
    if cut is None:
        cut = cut_for_hits(mat, py, target)
    out = kernel_case(K, name, mat, py, cut)
    del mat, py
    torch.cuda.empty_cache()
    return out


def varied_table(K, bins_a, bins_b, base):
    """A CutTable whose cuts vary by bin pair around `base`."""
    import torch

    table = base * (0.85 + 0.05 * (torch.arange(111, device="cuda") % 7))
    return K.CutTable(bins_a, bins_b, table.float().contiguous())


def general_cases(K):
    """The general screen against its plain version and the f64 bracket:
    AD at the yeast shape with MAF/het bins and a varied table as its two
    sweeps (A x D, then D x A), a ragged 1001 x 3001 AD screen of an
    unsorted 300-anchor subset with a table, and keep-all on a subset."""
    import torch

    out = []
    codes, bins, py = codes_panel(*YEAST, seed=6)
    a, d = codes["A"], codes["D"]
    base = cut_for_hits(a, py, 5e4, b=d)
    table = varied_table(K, bins["maf"], bins["het"], base)
    out.append(kernel_case(K, "yeast_AD_maf_sweep1", a, py, table, b=d))
    out.append(kernel_case(K, "yeast_AD_maf_sweep2", d, py, table, b=a))
    del codes, a, d
    torch.cuda.empty_cache()
    codes, bins, py = codes_panel(1001, 3001, seed=7)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    sub = torch.randperm(3000, generator=gen, device="cuda")[:300]
    table = varied_table(K, bins["maf"], bins["het"],
                         cut_for_hits(codes["A"], py, 2e4, b=codes["D"]))
    out.append(kernel_case(K, "ragged_subset_table", codes["A"], py, table,
                           b=codes["D"], anchors=sub))
    out.append(kernel_case(K, "subset_keep_all", codes["A"], py, -999.0,
                           anchors=sub[:200]))
    check(out[-1]["hits"] == out[-1]["pairs"], "subset keep-all: "
          f"{out[-1]['hits']} hits of {out[-1]['pairs']} pairs")
    check(all(c["hits"] > 1000 for c in out), "a general case found too "
          "few hits")
    return out


# the exact scan -------------------------------------------------------------

def exact_panel(n, m, seed):
    """Additive and dominance codes of a binomial(2, p) panel, py, and a
    bit-symmetric positive definite pvp, float64 on the card."""
    import torch

    from gmat_tpu_torch.core.coding import additive_code, dominance_code

    g = torch.Generator(device="cuda").manual_seed(seed)
    f64 = {"dtype": torch.float64, "device": "cuda"}
    p = 0.05 + 0.9 * torch.rand(m, generator=g, **f64)
    geno = ((torch.rand(n, m, generator=g, **f64) < p).double()
            + (torch.rand(n, m, generator=g, **f64) < p).double())
    codes = {"add": additive_code(geno)[0].contiguous(),
             "dom": dominance_code(geno)[0].contiguous()}
    py = 0.1 * torch.randn(n, generator=g, **f64)
    a = torch.randn(n, n, generator=g, **f64) / n ** 0.5
    pvp = a @ a.T + torch.eye(n, **f64)
    return codes, py, (torch.triu(pvp) + torch.triu(pvp, 1).T).contiguous()


def crit_between(chi, q):
    """A threshold halfway between two neighbouring chi values near the
    q-quantile, so that no pair lies on it."""
    import numpy as np

    s = np.sort(chi[np.isfinite(chi)])
    k = int(q * (len(s) - 1))
    return float((s[k] + s[k + 1]) / 2)


def exact_compare(name, got, want, crit, m1):
    """Kernel rows `got` against plain rows `want`, both (i, j, eff, var,
    chi): the pair sets equal outside crit·(1 ± EXACT_BAND), the common
    pairs in the same order, eff/var/chi at EXACT_RTOL (eff and chi with a
    floor of 1e-12 of their largest value, for the pairs whose eff cancels
    to nearly 0).  As tests/test_full_table.py allows, at most 5 pairs may
    miss that only in chi, by at most 5e-5.  Returns (common pairs, largest
    absolute deviation)."""
    import numpy as np

    g = [t.cpu().numpy() for t in got]
    w = [t.cpu().numpy() for t in want]
    gk, wk = g[0] * m1 + g[1], w[0] * m1 + w[1]
    check(len(np.unique(gk)) == len(gk), f"{name}: repeated kernel rows")
    _, gi, wi = np.intersect1d(gk, wk, assume_unique=True,
                               return_indices=True)
    order = np.argsort(gi)
    gi, wi = gi[order], wi[order]
    check(bool(np.all(np.diff(wi) > 0)), f"{name}: rows out of order")
    only = np.concatenate([np.delete(g[4], gi), np.delete(w[4], wi)])
    check(bool(np.all(np.abs(only - crit) <= EXACT_BAND * abs(crit))),
          f"{name}: {len(only)} pairs differ between kernel and plain, "
          "outside the band")
    err = 0.0
    for k, what in ((2, "eff"), (3, "var"), (4, "chi")):
        a, b = g[k][gi], w[k][wi]
        if not len(a):
            continue
        diff = np.abs(a - b)
        floor = 0.0 if what == "var" else 1e-12 * np.abs(b).max()
        bad = diff > EXACT_RTOL * np.abs(b) + floor
        if what == "chi":
            check(bad.sum() <= 5 and bool(np.all(diff[bad] <= 5e-5)),
                  f"{name}: {int(bad.sum())} chi values off the plain "
                  f"version, up to {diff.max():.3g}")
        else:
            check(not bad.any(), f"{name}: {int(bad.sum())} {what} values "
                  f"off the plain version, up to {diff.max():.3g}")
        err = max(err, float(diff.max()))
    return len(gi), err


EXACT_CASES = [  # name, kind, quantile of chi at the threshold (None: keep all)
    ("AA", "AA", 0.99), ("AD", "AD", 0.99), ("DD", "DD", 0.99),
    ("AA_zero_hits", "AA", 1.0), ("AD_keep_all", "AD", None),
    ("DD_keep_all", "DD", None),
]
KIND_CODES = {"AA": ("add", "add", "tri"), "AD": ("add", "dom", "rect"),
              "DD": ("dom", "dom", "tri")}


def exact_phase(K, n=1001, m=3001, n_anchors=64):
    """The exact-scan kernel against its plain version at a ragged shape
    (m not a multiple of the 128-partner tile) and an unsorted anchor
    subset; returns the largest absolute deviation."""
    import numpy as np
    import torch

    codes, py, pvp = exact_panel(n, m, seed=5)
    rng = np.random.default_rng(SEED)
    anchors = torch.as_tensor(rng.permutation(m - 1)[:n_anchors],
                              device="cuda")
    err = 0.0
    for name, kind, q in EXACT_CASES:
        k0, k1, mask = KIND_CODES[kind]
        args = (codes[k0], codes[k1], py, pvp, anchors)
        pairs = K.exact_pair_count(anchors, m, mask)
        if q is None:
            crit = -1.0
        elif q == 1.0:
            crit = 1e30
        else:
            crit = crit_between(
                K.exact_hits_ref(*args, -1.0, mask)[4].cpu().numpy(), q)
        before = K.LAUNCHES["exact_scan"]
        got = K.exact_hits(*args, crit, mask)
        torch.cuda.synchronize()
        check(K.LAUNCHES["exact_scan"] == before + 1,
              f"exact {name}: the kernel was not launched once")
        want = K.exact_hits_ref(*args, crit, mask)
        common, case_err = exact_compare(f"exact {name}", got, want, crit, m)
        err = max(err, case_err)
        if q is None:
            check(len(got[0]) == pairs, f"exact {name}: {len(got[0])} rows "
                  f"of {pairs} pairs")
        elif q == 1.0:
            check(len(got[0]) == 0, f"exact {name}: hits above 1e30")
        else:
            check(common > 0.005 * pairs, f"exact {name}: {common} hits")
        print(f"exact case {json.dumps({'case': name, 'pairs': pairs, 'crit': crit, 'hits': len(got[0]), 'common': common, 'max_abs_err': case_err})}",
              flush=True)
    return err


def library_matmul_ms(mat0, mat1, pvp, anchors, tri):
    """Device time, summed over the anchors, of the library call that does
    the bulk of the exact scan's work: torch.matmul(pvp, E) in float64 for
    the pairs' E = mat0[:, a] ⊙ mat1[:, partners of a].  The port never
    calls it."""
    import torch

    total = 0.0
    for a in anchors:
        e = mat0[:, a:a + 1] * (mat1[:, a + 1:] if tri else mat1)
        if e.shape[1] == 0:
            continue
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        torch.matmul(pvp, e)
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total


def timed(fn):
    """fn()'s result and its device time in ms, by CUDA events."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def exact_kernel_flop(K, n, m, anchors):
    """Product FLOP that the exact-scan kernel runs over `anchors` x the
    partners above them (mask tri): every column of every block that does
    not return at once, 2·rows·(n − r0) for each row tile of pvp (first
    row r0) against the tiles on and above the diagonal."""
    t = K.EXACT_TILE
    per_col = sum(2 * min(t, n - r0) * (n - r0) for r0 in range(0, n, t))
    tiles = -(-m // t)
    blocks = sum(max(tiles - (int(a) + 1) // t, 0) for a in anchors)
    return float(blocks) * t * per_col


def exact_timing(K, mat, pvp, py, anchors, crit, center):
    """exact_hits (kernel and device sort) over `anchors` x the partners
    above them: the median of 3 calls after a warm-up, beside one call of
    the plain version and of torch.matmul(pvp, E), with the least time the
    card could take, the kernel's rates and max|pvp − pvpᵀ|."""
    import torch

    from gmat_tpu_torch.probe import cuda_ms

    n, m = mat.shape
    a_t = torch.as_tensor(anchors, device="cuda")
    args = (mat, mat, py, pvp, a_t, crit, "tri", center)
    got = K.exact_hits(*args)
    ms = cuda_ms(lambda: K.exact_hits(*args))
    want, plain_ms = timed(lambda: K.exact_hits_ref(*args))
    pairs = K.exact_pair_count(a_t, m, "tri")
    # the least FLOP per pair, pvp being symmetric: e and eff (3n), the
    # strict upper triangle u = triu(pvp, 1)·e (n² − n), then
    # var = Σ e ⊙ (diag(pvp) ⊙ e + 2u) (5n)
    least = pairs * (n * n + 7.0 * n)
    done = exact_kernel_flop(K, n, m, anchors)
    ms_bound, bound_by = bound(least, 8 * (n * m + n * n + n)
                               + 4 * len(anchors) + 32 * len(got[0]),
                               FP64_PEAK)
    return got, want, {
        "n": n, "m": m, "anchors": len(anchors), "pairs": pairs,
        "hits": len(got[0]), "ms": ms, "plain_ms": plain_ms,
        "library_ms": library_matmul_ms(mat, mat, pvp, anchors, True),
        "bound_ms": ms_bound, "bound_by": bound_by,
        "bound_share": ms_bound / ms, "kernel_flop": done,
        "tflops_done": done / ms / 1e9, "tflops_least": least / ms / 1e9,
        "pvp_max_asym": float((pvp - pvp.T).abs().max())}


def assert_table(tab, gold, kind, m):
    """tests/test_full_table.py::_assert_table: a complete mouse table
    against the reference's (eff/chi/p stored float32, a float64 subset)."""
    import numpy as np

    if kind == "ad":
        want0, want1 = np.repeat(np.arange(m), m), np.tile(np.arange(m), m)
    else:
        want0, want1 = np.triu_indices(m, k=1)
    check(tab.shape[0] == len(want0), f"{kind}: {tab.shape[0]} rows")
    check(np.array_equal(tab[:, 0].astype(np.int64), want0)
          and np.array_equal(tab[:, 1].astype(np.int64), want1),
          f"{kind}: pairs differ from the reference table")
    chi_ref, p_ref = gold[f"{kind}_chi"], gold[f"{kind}_p"]
    np.testing.assert_allclose(tab[:, 2], gold[f"{kind}_eff"], rtol=2e-6,
                               atol=1e-12, err_msg=f"{kind}: eff")
    np.testing.assert_allclose(tab[:, 3], chi_ref, rtol=4e-6, atol=5e-5,
                               err_msg=f"{kind}: chi")
    noisy = np.abs(tab[:, 3] - chi_ref) > 4e-6 * np.abs(chi_ref)
    check(noisy.sum() <= 5, f"{kind}: {int(noisy.sum())} degenerate pairs")
    np.testing.assert_allclose(tab[~noisy, 4], p_ref[~noisy], rtol=1e-5,
                               atol=1e-30, err_msg=f"{kind}: p")
    np.testing.assert_allclose(tab[noisy, 4], p_ref[noisy], atol=5e-5,
                               err_msg=f"{kind}: p (degenerate)")
    rows, sub = gold[f"{kind}_sub_rows"], gold[f"{kind}_sub"]
    np.testing.assert_allclose(tab[rows, 2:4], sub[:, 2:4], rtol=1e-9,
                               err_msg=f"{kind}: f64 subset eff/chi")
    np.testing.assert_allclose(tab[rows, 4], sub[:, 4], rtol=1e-8,
                               atol=1e-300, err_msg=f"{kind}: f64 subset p")
    return int(noisy.sum())


def reference_tables(K, workdir):
    """The complete mouse AA, AD and DD tables through the port's entry
    points on the card, against the reference's; then the kernel's times
    over the AA table.  Returns those times."""
    import numpy as np
    import pandas as pd
    import torch

    from gmat_tpu_torch import agmat, remma_epiAA, remma_epiAD, remma_epiDD
    from gmat_tpu_torch.scan.common import (coded_matrix,
                                            design_matrix_cached,
                                            prepare_genotypes_device,
                                            score_pieces_cached)
    from gmat_tpu_torch.scan.pairs import _has_intercept

    for suffix in (".bed", ".bim", ".fam"):
        shutil.copy(MOUSE / f"plink{suffix}", workdir / f"plink{suffix}")
    prefix, pheno = str(workdir / "plink"), str(MOUSE / "pheno")
    ag, _ = agmat(prefix)
    gmat_lst = [ag, ag * ag]
    gold = np.load(ROOT / "tests" / "golden" / "epi_full.npz")
    var_com = gold["var_com"]
    for kind, fn in (("aa", remma_epiAA), ("ad", remma_epiAD),
                     ("dd", remma_epiDD)):
        out = str(workdir / kind)
        before = K.LAUNCHES["exact_scan"]
        t0 = time.perf_counter()
        fn(pheno, prefix, gmat_lst, var_com, p_cut=1.1, out_file=out)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = K.LAUNCHES["exact_scan"] - before
        check(launches > 0, f"remma_epi{kind.upper()}: no exact-scan launch")
        tab = pd.read_csv(out, sep=" ", header=0).to_numpy()
        noisy = assert_table(tab, gold, kind, MOUSE_M)
        print(f"mouse {kind} table: {tab.shape[0]} rows match the reference "
              f"({noisy} degenerate pairs inside chi atol 5e-5), {launches} "
              f"kernel launches, {dt:.3f} s", flush=True)
    dm = design_matrix_cached(pheno, prefix)
    pieces = score_pieces_cached(dm, gmat_lst, var_com)
    g, _ = prepare_genotypes_device(prefix)
    got, want, timing = exact_timing(
        K, coded_matrix(g, "add"), pieces.pvpmat, pieces.pymat,
        list(range(MOUSE_M - 1)), -1.0, _has_intercept(dm))
    _, timing["max_abs_err"] = exact_compare("mouse aa", got, want, -1.0,
                                             MOUSE_M)
    print(f"exact timing mouse_aa {json.dumps(timing)}", flush=True)
    return timing


class RemlLog(logging.Handler):
    """Counts the REML iterations and keeps the convergence line."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.rounds, self.status = 0, "no convergence line"

    def emit(self, record):
        msg = record.getMessage()
        if msg.startswith("Round "):
            self.rounds += 1
        elif "converged" in msg.lower():
            self.status = msg


def write_yeast_set(prefix, pheno, rng):
    """Seeded PLINK set at the yeast shape and a phenotype with an additive
    polygenic part (variance 0.5), five planted additive x additive pairs
    (0.02 each) and noise (0.4).

    Allele frequencies follow bench.py's recipe (U(0.05, 0.95)); the
    individuals are full-sib families of 8 with Mendelian transmission from
    two random parents.  With unrelated individuals ag∘ag is close to the
    identity, confounded with the residual, and REML does not converge."""
    import numpy as np
    import pandas as pd

    from gmat_tpu_torch import write_bed

    n, m = YEAST
    kids = 8
    freq = rng.uniform(0.05, 0.95, size=m)
    parents = rng.random((n // kids, 2, 2, m)) < freq  # family, parent, haplotype
    geno = np.zeros((n // kids, kids, m))
    for q in range(2):
        pick = rng.random((n // kids, kids, m)) < 0.5
        geno += np.where(pick, parents[:, None, q, 1], parents[:, None, q, 0])
    geno = geno.reshape(n, m)
    write_bed(prefix, geno)
    freq = geno.sum(axis=0) / (2 * n)
    mat = geno - 2 * freq[None, :]
    scale = np.sum(2 * freq * (1 - freq))
    y = mat @ rng.normal(0.0, np.sqrt(0.5 / scale), size=m)
    planted = set()
    while len(planted) < 5:
        a, b = sorted(rng.choice(m, size=2, replace=False).tolist())
        planted.add((a, b))
    for a, b in planted:
        z = mat[:, a] * mat[:, b]
        y += np.sqrt(0.02) * (z - z.mean()) / z.std()
    y += rng.normal(0.0, np.sqrt(0.4), size=n)
    fam = pd.read_csv(prefix + ".fam", sep=r"\s+", header=None, dtype=str)
    with open(pheno, "w") as f:
        for (f0, i0), yv in zip(fam[[0, 1]].to_numpy(), y):
            f.write(f"{f0} {i0} 1 {yv:.8f}\n")
    return sorted(planted)


FOUR_STEP_KERNELS = ("screen_count", "screen_extract")


def main_path(K, workdir):
    """The four-step workflow at the yeast shape; returns stage times, the
    kernel launches of the workflow and what the later phases reuse."""
    import numpy as np
    import pandas as pd
    import torch
    from scipy.stats import chi2

    from gmat_tpu_torch import (agmat, annotation_snp_pos, random_pair,
                                remma_epiAA_approx, remma_epiAA_pair,
                                wemai_multi_gmat)
    from gmat_tpu_torch.scan import screen as screen_mod
    from gmat_tpu_torch.scan.common import (coded_matrix,
                                            design_matrix_cached,
                                            prepare_genotypes_device,
                                            score_pieces_cached)

    n, m = YEAST
    prefix, pheno = str(workdir / "plink"), str(workdir / "pheno")
    times = {}
    t0 = time.perf_counter()
    planted = write_yeast_set(prefix, pheno, np.random.default_rng(SEED))
    times["write_plink"] = time.perf_counter() - t0

    for key in K.LAUNCHES:
        K.LAUNCHES[key] = 0
    t0 = time.perf_counter()
    ag, _ = agmat(prefix)
    times["agmat"] = time.perf_counter() - t0
    check(ag.shape == (n, n) and np.all(np.isfinite(ag)), "agmat: bad GRM")
    check(np.allclose(ag, ag.T), "agmat: GRM not symmetric")
    with open(prefix + ".agrm0") as f:
        check(sum(1 for _ in f) == n, "agmat: .agrm0 has the wrong row count")

    t0 = time.perf_counter()
    gmat_lst = [ag, ag * ag]
    reml_log = RemlLog()
    logging.getLogger("gmat_tpu_torch.reml.wemai").addHandler(reml_log)
    logging.getLogger("gmat_tpu_torch.reml.wemai").setLevel(logging.INFO)
    var_com = wemai_multi_gmat(pheno, prefix, gmat_lst,
                               out_file=str(workdir / "var.txt"))
    times["wemai_multi_gmat"] = time.perf_counter() - t0
    print(f"REML: {reml_log.rounds} iterations, {reml_log.status}", flush=True)
    check(reml_log.status == "Variances converged.", "REML did not converge")
    check(np.all(np.isfinite(var_com)) and np.all(var_com > 0),
          f"wemai_multi_gmat: variances {var_com}")
    check(np.allclose(np.loadtxt(workdir / "var.txt"), var_com),
          "wemai_multi_gmat: var.txt differs from the returned variances")
    print(f"variances (a, axa, e): {var_com.tolist()}", flush=True)

    out = str(workdir / "epiAA")
    t0 = time.perf_counter()
    remma_epiAA_approx(pheno, prefix, gmat_lst, var_com, p_cut=1e-5,
                       num_random_pair=100000, out_file=out)
    torch.cuda.synchronize()
    times["remma_epiAA_approx"] = time.perf_counter() - t0
    stages = dict(screen_mod.LAST_APPROX_STAGES)
    print(f"LAST_APPROX_STAGES {json.dumps(stages)}", flush=True)

    t0 = time.perf_counter()
    annotation_snp_pos(out, prefix, p_cut=1e-5)
    times["annotation_snp_pos"] = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    print(f"main-path launches {json.dumps(launches)}", flush=True)
    for key in FOUR_STEP_KERNELS:
        check(launches[key] > 0, f"the main path never launched kernel {key}")

    # the result table: header, exact chi, p ranges
    with open(out) as f:
        head = f.readline().split()
    check(head == ["snp_0", "snp_1", "eff", "var", "chi", "p_app", "p"],
          f"epiAA header {head}")
    rows = np.loadtxt(out, skiprows=1, ndmin=2)
    check(rows.shape[0] > 0 and rows.shape[1] == 7, f"epiAA rows {rows.shape}")
    check(bool(np.all(np.isfinite(rows))), "epiAA: non-finite values")
    np.testing.assert_allclose(rows[:, 4], rows[:, 2] ** 2 / rows[:, 3],
                               rtol=1e-6)
    check(bool(np.all((rows[:, 5:] >= 0) & (rows[:, 5:] <= 1))), "p outside [0, 1]")
    check(bool(np.all(rows[:, 0] < rows[:, 1])), "pairs not i < j")
    anno = pd.read_csv(out + ".anno", sep=" ")
    check("snp0_chr" in anno.columns and len(anno) == int(np.sum(rows[:, 6] <= 1e-5)),
          "annotation: wrong rows")
    print(f"epiAA table: {rows.shape[0]} rows at n={n}, m={m}; planted pairs "
          f"{planted}", flush=True)

    # reference 1: the planted pairs are found, with p < 1e-5 in both tests
    got = {(int(a), int(b)): (pa, p) for a, b, *_, pa, p in rows}
    found = [pp for pp in planted if pp in got and max(got[pp]) < 1e-5]
    check(len(found) >= 4, f"planted pairs found: {found} of {planted}")

    # reference 2: the table's pair set equals a plain float64 screen of the
    # same panel at the pipeline's cut, within the bracket
    rp = str(workdir / "rp")
    random_pair(m, out_file=rp, num_pair=100000, seed=0)
    remma_epiAA_pair(pheno, prefix, gmat_lst, var_com, rp, p_cut=1.1,
                     out_file=rp + ".res")
    var_median = float(np.median(np.loadtxt(rp + ".res", skiprows=1)[:, 3]))
    cut = float(np.sqrt(chi2.isf(1e-5, 1) * var_median))
    dm = design_matrix_cached(pheno, prefix)
    pieces = score_pieces_cached(dm, gmat_lst, var_com)
    g, _ = prepare_genotypes_device(prefix)
    mat64 = coded_matrix(g, "add")
    before = dict(K.LAUNCHES)
    hi, hj, he = K.screen_hits_ref(mat64, pieces.pymat, cut * (1 - BAND), m)
    hull = set(zip(hi.tolist(), hj.tolist()))
    keep = he.abs() > cut * (1 + BAND)
    core = set(zip(hi[keep].tolist(), hj[keep].tolist()))
    table = set(got)
    check(core <= table <= hull, f"epiAA pairs vs the f64 screen: "
          f"{len(core - table)} missed, {len(table - hull)} extra")
    check(K.LAUNCHES == before, "the plain screen launched a kernel")
    print(f"epiAA pairs within the f64 screen's bracket: core {len(core)}, "
          f"table {len(table)}, hull {len(hull)}", flush=True)
    ctx = {"workdir": workdir, "prefix": prefix, "pheno": pheno,
           "gmat_lst": gmat_lst, "var_com": var_com, "approx_rows": rows,
           "planted": planted}
    return times, stages, launches, ctx


def exact_slice(K, ctx):
    """One part of the exhaustive AA scan's balanced split on the yeast
    set, through remma_epiAA_parallel: its exact-scan launches (counts set
    to 0 just before, read just after), its table against the plain
    version over the same anchors and against the approx table, and the
    kernel's times.  Returns (launches, timing, max_abs_err)."""
    import numpy as np
    import torch
    from scipy.stats import chi2

    from gmat_tpu_torch import remma_epiAA_parallel
    from gmat_tpu_torch.scan.common import (coded_matrix,
                                            design_matrix_cached,
                                            prepare_genotypes_device,
                                            score_pieces_cached)
    from gmat_tpu_torch.scan.pairs import (_has_intercept,
                                           balanced_anchor_split)

    n, m = YEAST
    prefix, pheno = ctx["prefix"], ctx["pheno"]
    gmat_lst, var_com = ctx["gmat_lst"], ctx["var_com"]
    out = str(ctx["workdir"] / "epiAA_parallel")
    for key in K.LAUNCHES:
        K.LAUNCHES[key] = 0
    t0 = time.perf_counter()
    remma_epiAA_parallel(pheno, prefix, gmat_lst, var_com, parallel=[100, 1],
                         p_cut=1e-5, out_file=out)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    print(f"exhaustive-slice launches {json.dumps(launches)}", flush=True)
    check(launches["exact_scan"] > 0,
          "remma_epiAA_parallel never launched the exact-scan kernel")
    with open(out + ".1") as f:
        head = f.readline().split()
    check(head == ["snp_0", "snp_1", "eff", "chi", "p_val"],
          f"epiAA_parallel header {head}")
    tab = np.loadtxt(out + ".1", skiprows=1, ndmin=2).reshape(-1, 5)

    anchors = balanced_anchor_split(m, 100, 1)
    check(len(anchors) == 301, f"{len(anchors)} anchors in part 1 of 100")
    dm = design_matrix_cached(pheno, prefix)
    pieces = score_pieces_cached(dm, gmat_lst, var_com)
    g, _ = prepare_genotypes_device(prefix)
    crit = float(chi2.isf(1e-5, 1))
    got, want, timing = exact_timing(
        K, coded_matrix(g, "add"), pieces.pvpmat, pieces.pymat, anchors,
        crit, _has_intercept(dm))
    timing["wall_s"] = wall
    check(timing["pairs"] == 3981889, f"{timing['pairs']} pairs in the part")
    common, err = exact_compare("yeast part", got, want, crit, m)
    # the entry point's file holds the kernel's rows
    i, j, eff, var, chi = (t.cpu().numpy() for t in got)
    check(len(tab) == len(i) and np.array_equal(tab[:, 0], i)
          and np.array_equal(tab[:, 1], j), "epiAA_parallel: rows differ "
          "from the kernel's")
    np.testing.assert_allclose(tab[:, 2:4], np.stack([eff, chi], 1),
                               rtol=1e-15, err_msg="epiAA_parallel values")
    p = tab[:, 4]
    check(bool(np.all((p >= 0) & (p < 1e-5))), "epiAA_parallel: p_val")
    # the pairs it shares with the approx table: the same eff, var and chi
    rows = ctx["approx_rows"]
    keys = i * m + j
    akeys = rows[:, 0].astype(np.int64) * m + rows[:, 1].astype(np.int64)
    _, gi, ai = np.intersect1d(keys, akeys, return_indices=True)
    check(len(gi) > 0, "the part shares no pair with the approx table")
    for k, col in ((2, eff), (3, var), (4, chi)):
        np.testing.assert_allclose(col[gi], rows[ai, k], rtol=EXACT_RTOL,
                                   err_msg=f"exact vs approx column {k}")
    timing.update(common=common, max_abs_err=err, shared_with_approx=len(gi))
    print(f"exact timing yeast_part {json.dumps(timing)}", flush=True)
    return launches, timing, err


SCREEN_FAMILY = (  # entry point, screen sweeps per call
    ("remma_epiAD_approx", 2), ("remma_epiDD_approx", 1),
    ("remma_epiAA_maf_approx", 1), ("remma_epiAD_maf_approx", 2),
)


def screen_family(K, ctx):
    """The rest of the screen family on the yeast set, each entry point
    with the launch counts set to 0 just before it and read just after:
    the AD/DD approx and the AA/AD maf approx pipelines at p_cut=1e-5 with
    100,000 calibration pairs (the 7-column table, chi = eff²/var, the
    planted AxA pairs in the AA maf table), then remma_epiAD_eff against
    remma_epiAD_eff_parallel([100, 1]) at one var_app: the part's rows are
    the full table's rows of its anchors, byte for byte.  Returns
    {entry point: launches} and {entry point: stage times}."""
    import numpy as np
    import torch
    from scipy.stats import chi2

    import gmat_tpu_torch
    from gmat_tpu_torch.scan import screen as screen_mod
    from gmat_tpu_torch.scan.pairs import balanced_anchor_split

    args = (ctx["pheno"], ctx["prefix"], ctx["gmat_lst"], ctx["var_com"])
    m = YEAST[1]
    launches, stages = {}, {}
    var_app = None
    for name, sweeps in SCREEN_FAMILY:
        out = str(ctx["workdir"] / name)
        for key in K.LAUNCHES:
            K.LAUNCHES[key] = 0
        t0 = time.perf_counter()
        getattr(gmat_tpu_torch, name)(*args, p_cut=1e-5,
                                      num_random_pair=100000, out_file=out)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches[name] = dict(K.LAUNCHES)
        stages[name] = dict(screen_mod.LAST_APPROX_STAGES, wall_s=wall)
        check(launches[name] == {"screen_count": sweeps,
                                 "screen_extract": sweeps, "exact_scan": 0},
              f"{name}: launches {launches[name]}, want {sweeps} sweeps")
        with open(out) as f:
            head = f.readline().split()
        check(head == ["snp_0", "snp_1", "eff", "var", "chi", "p_app", "p"],
              f"{name}: header {head}")
        rows = np.loadtxt(out, skiprows=1, ndmin=2)
        check(rows.shape[0] > 0 and rows.shape[1] == 7,
              f"{name}: rows {rows.shape}")
        check(bool(np.all(np.isfinite(rows))), f"{name}: non-finite values")
        np.testing.assert_allclose(rows[:, 4], rows[:, 2] ** 2 / rows[:, 3],
                                   rtol=1e-6, err_msg=name)
        check(bool(np.all((rows[:, 5:] >= 0) & (rows[:, 5:] <= 1))),
              f"{name}: p outside [0, 1]")
        check(bool(np.all(rows[:, 0] != rows[:, 1])), f"{name}: i == j")
        keys = {(int(a), int(b)) for a, b in rows[:, :2]}
        if name == "remma_epiAA_maf_approx":
            planted = ctx["planted"]
            check(set(planted) <= keys, f"{name}: planted pairs "
                  f"{sorted(set(planted) - keys)} missing")
        if name == "remma_epiAD_approx":
            # the run's var_app, read back from the approx columns
            var_app = float(np.median(rows[:, 2] ** 2
                                      / chi2.isf(rows[:, 5], 1)))
        print(f"{name}: {rows.shape[0]} rows, launches "
              f"{json.dumps(launches[name])}, stages "
              f"{json.dumps(stages[name])}", flush=True)

    # the anchor subset: the same arithmetic on a gathered panel
    full = str(ctx["workdir"] / "epiAD_eff")
    part = str(ctx["workdir"] / "epiAD_eff_parallel")
    for name, call in (
            ("remma_epiAD_eff", lambda: gmat_tpu_torch.remma_epiAD_eff(
                *args, var_app=var_app, p_cut=1e-5, out_file=full)),
            ("remma_epiAD_eff_parallel",
             lambda: gmat_tpu_torch.remma_epiAD_eff_parallel(
                 *args, parallel=[100, 1], var_app=var_app, p_cut=1e-5,
                 out_file=part))):
        for key in K.LAUNCHES:
            K.LAUNCHES[key] = 0
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        stages[name] = {"wall_s": time.perf_counter() - t0}
        launches[name] = dict(K.LAUNCHES)
        check(launches[name]["screen_count"] == 2,
              f"{name}: launches {launches[name]}")
    anchors = set(balanced_anchor_split(m, 100, 1, triangular=False))
    with open(full) as f:
        head = f.readline()
        lines = f.read().splitlines()

    def anchor_of(line):
        a, b = map(int, line.split()[:2])
        return a if a < b else b  # the flipped sweep writes (partner, anchor)

    want = [ln for ln in lines if anchor_of(ln) in anchors]
    with open(part + ".1") as f:
        check(f.readline() == head, "epiAD_eff_parallel: header")
        got = f.read().splitlines()
    check(len(want) > 0 and got == want, f"epiAD_eff_parallel([100, 1]): "
          f"{len(got)} rows, the full table has {len(want)} for its anchors")
    print(f"remma_epiAD_eff: {len(lines)} rows; remma_epiAD_eff_parallel"
          f"([100, 1]): {len(got)} rows, byte-identical to the full table's "
          f"rows of its {len(anchors)} anchors; launches "
          f"{json.dumps({k: launches[k] for k in ('remma_epiAD_eff', 'remma_epiAD_eff_parallel')})}",
          flush=True)
    return launches, stages


def single_snp(ctx):
    """remma_add and remma_dom on the yeast set (the additive x additive
    variance stands in for the dominance one in remma_dom): the columns,
    finite values, p in [0, 1]."""
    import numpy as np

    from gmat_tpu_torch import remma_add, remma_dom

    cols = ["chro", "snp_ID", "pos", "allele1", "allele2", "eff_val",
            "chi_val", "eff_val_to_fixed", "p_val"]
    times = {}
    for fn in (remma_add, remma_dom):
        out = str(ctx["workdir"] / fn.__name__)
        t0 = time.perf_counter()
        res = fn(ctx["pheno"], ctx["prefix"], ctx["gmat_lst"], ctx["var_com"],
                 out_file=out)
        times[fn.__name__] = time.perf_counter() - t0
        with open(out) as f:
            head = f.readline().split()
        check(list(res.columns) == cols and head == cols,
              f"{fn.__name__}: columns {list(res.columns)} / {head}")
        check(len(res) == YEAST[1], f"{fn.__name__}: {len(res)} rows")
        vals = res[cols[5:]].to_numpy(dtype=np.float64)
        check(bool(np.all(np.isfinite(vals))), f"{fn.__name__}: non-finite")
        check(bool(np.all((vals[:, 3] >= 0) & (vals[:, 3] <= 1))),
              f"{fn.__name__}: p outside [0, 1]")
    print(f"single-SNP tests on the yeast set (s): {json.dumps(times)}",
          flush=True)
    return times


# the uvlmm family -------------------------------------------------------------

UVLMM_RTOL = 1e-8  # fixed-effect tests and BLUPs against direct f64 fits


def close(name, got, want, rtol, floor=0.0, atol=0.0):
    """got ≈ want at rtol, with an absolute floor of `floor`·max|want| for
    the values that cancel to about 0 (or `atol`, numpy's allclose rule of
    the JAX tests), and NaN at the same places (a SNP without variation
    has no test); returns the largest relative gap."""
    import numpy as np

    got, want = np.asarray(got, float), np.asarray(want, float)
    check(got.shape == want.shape, f"{name}: shape {got.shape} vs {want.shape}")
    ok = np.isfinite(want)
    check(bool(np.array_equal(np.isfinite(got), ok)) and ok.mean() > 0.99,
          f"{name}: {int((~np.isfinite(got)).sum())} non-finite values, "
          f"want {int((~ok).sum())}")
    got, want = got[ok], want[ok]
    diff = np.abs(got - want)
    tol = rtol * np.abs(want) + floor * np.abs(want).max() + atol
    rel = diff / np.maximum(np.abs(want), 1e-300)
    check(bool(np.all(diff <= tol)), f"{name}: {int((diff > tol).sum())} "
          f"values off by up to {float(rel.max()):.3g} (rtol {rtol:g})")
    return float(rel.max())


def gls_last(lu, cols, y):
    """The last coefficient of the GLS fit of y on `cols` (batch, n, k)
    under V = LU, and its variance: one (k x k) inverse per fit, the
    reference's loop (uvlmm_gwas.py:44-52 of the reference GMAT)."""
    import torch

    b, n, k = cols.shape
    vi_c = torch.linalg.lu_solve(*lu, cols.transpose(0, 1).reshape(n, b * k)
                                 ).reshape(n, b, k).transpose(0, 1)
    cinv = torch.linalg.inv(cols.transpose(1, 2) @ vi_c)
    beta = (cinv @ (vi_c.transpose(1, 2) @ y[:, None]))[..., 0]
    return beta[:, -1], cinv[:, -1, -1]


def write_gtf(path, m, genes=20):
    """A GTF of `genes` genes of 300 bp over the yeast .bim's positions
    1..m (chromosome 1), with a comment and a transcript row; returns the
    (start, end) of each gene."""
    spans = [(k * (m // genes) + 100, k * (m // genes) + 400)
             for k in range(genes)]
    with open(path, "w") as f:
        f.write("#!genome-build chip_smoke\n")
        for k, (a, b) in enumerate(spans):
            f.write(f'1\tsmoke\tgene\t{a}\t{b}\t.\t+\t.\tgene_id "G{k}"; '
                    f'gene_name "Gene{k}";\n')
            f.write(f'1\tsmoke\ttranscript\t{a}\t{b}\t.\t+\t.\t'
                    f'gene_id "G{k}"; gene_name "Gene{k}";\n')
    return spans


def run_step(times, name, fn, logger=None):
    """fn()'s result; its wall time, and for a REML loop (`logger`) its
    rounds and convergence line, go to times[name]."""
    import torch

    log, lg = RemlLog(), logging.getLogger(logger or "chip_smoke")
    lg.addHandler(log)
    lg.setLevel(logging.INFO)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        out = fn()
        torch.cuda.synchronize()
    finally:
        lg.removeHandler(log)
    dt = time.perf_counter() - t0
    times[name] = dt if logger is None else {
        "iterations": log.rounds, "s": dt,
        "s_per_iteration_setup_included": dt / max(log.rounds, 1),
        "status": log.status}
    return out


def uvlmm_phase(ctx):
    """The uvlmm family at the yeast shape: the eigen REML, wemai with one
    GRM and em_mme to convergence (the same REML maximum, rtol 1e-5), the
    other MME variants at maxiter=5, em_mme_multi and em_vmat with
    [ag, ag∘ag]; the fixed-effect add/dom tests and their eigen twins over
    every SNP (eigen vs direct at rtol 1e-7, 32 SNPs against a per-SNP GLS
    fit at 1e-8); uvlmm_gwas_epiAA over 64 anchors (the planted pairs, 16
    rows against a direct GLS fit); lm_snp_eff (32 SNPs against lstsq) and
    lm_pred; wemai_multi_gmat_pred with 10% of the phenotypes removed, and
    _blup_effects against the MME solution (Henderson's identity);
    ginbreedcoef, shuffle_bed and annotation_snp_nearest_gene.  Returns
    {entry point: seconds or per-iteration details}."""
    import numpy as np
    import pandas as pd
    import torch
    from scipy import sparse

    import gmat_tpu_torch as G
    from gmat_tpu_torch.core.coding import additive_code, dominance_code
    from gmat_tpu_torch.io.pheno import design_matrix
    from gmat_tpu_torch.reml import mme
    from gmat_tpu_torch.reml.wemai import _blup_effects, build_zgzt_stack

    n, m = YEAST
    dev = torch.device("cuda")
    wd, prefix, pheno = ctx["workdir"], ctx["prefix"], ctx["pheno"]
    ag, gmat_lst, var_com = ctx["gmat_lst"][0], ctx["gmat_lst"], ctx["var_com"]
    dm = design_matrix(pheno, prefix)
    y_d = torch.as_tensor(dm.y, device=dev)
    x_d = torch.as_tensor(dm.xmat, device=dev)
    times = {}

    run = partial(run_step, times)

    # REML: three algorithms, one maximum
    var_eig, vecs, vals = run("uvlmm_varcom_eigen", lambda: G.uvlmm_varcom_eigen(
        dm.y, dm.xmat, ag), "gmat_tpu_torch.reml.eigen")
    check(vals.shape == (n, 1) and vecs.shape == (n, n), "eigen: shapes")
    check(times["uvlmm_varcom_eigen"]["iterations"] < 100,
          "uvlmm_varcom_eigen did not converge in 100 rounds")
    ag_d = torch.as_tensor(ag, device=dev)
    u = torch.as_tensor(vecs, device=dev)
    recon = float(((u * torch.as_tensor(vals[:, 0], device=dev)) @ u.T
                   - ag_d).abs().max() / ag_d.abs().max())
    check(recon < 1e-10, f"eigen: U diag(λ) Uᵀ off G by {recon:.3g} of max|G|")
    del vecs, u
    var_w = run("wemai_multi_gmat[ag]", lambda: G.wemai_multi_gmat(
        pheno, prefix, [ag], out_file=str(wd / "var_ag.txt")),
        "gmat_tpu_torch.reml.wemai")
    ag_inv = torch.linalg.inv(ag_d).cpu().numpy()
    start = np.full(2, float(np.var(dm.y)) / 2)
    var_em = run("em_mme", lambda: G.em_mme(
        dm.y, dm.xmat, ag_inv, init=start, maxiter=3000, cc=1e-10),
        "gmat_tpu_torch.reml.mme")
    check(times["em_mme"]["status"] == "Variances converged.",
          f"em_mme did not converge in {times['em_mme']['iterations']} rounds")
    print(f"uvlmm REML (g, e): eigen {var_eig.tolist()}, wemai "
          f"{var_w.tolist()}, em_mme {var_em.tolist()}", flush=True)
    close("wemai vs eigen REML", var_w, var_eig, 1e-5)
    close("em_mme vs eigen REML", var_em, var_eig, 1e-5)
    for name in ("pxem_mme", "ai_mme", "emai_mme", "pxemai_mme"):
        got = run(name, lambda: getattr(G, name)(dm.y, dm.xmat, ag_inv,
                                                 maxiter=5),
                  "gmat_tpu_torch.reml.mme")
        times[name]["var"] = got.tolist()
        check(times[name]["iterations"] >= 1, f"{name}: no iteration")
    axa_inv = torch.linalg.inv(ag_d * ag_d).cpu().numpy()
    eye = sparse.identity(n, format="csr")
    got = run("em_mme_multi", lambda: mme.em_mme_multi(
        dm.y, dm.xmat, [eye, eye], [ag_inv, axa_inv], maxiter=5),
        "gmat_tpu_torch.reml.mme")
    times["em_mme_multi"]["var"] = got.tolist()
    check(bool(np.all(np.isfinite(got))) and len(got) == 3, "em_mme_multi")
    got = run("em_vmat", lambda: mme.em_vmat(
        dm.y, dm.xmat, [eye, eye], [ag, ag * ag], maxiter=5),
        "gmat_tpu_torch.reml.mme")
    times["em_vmat"]["var"] = got.tolist()
    check(bool(np.all(np.isfinite(got))) and len(got) == 3, "em_vmat")
    del ag_inv, axa_inv

    # fixed-effect GWAS, direct and eigen, against a per-SNP GLS fit
    tabs = {}
    for name, grms in (("uvlmm_gwas_add", [ag]), ("uvlmm_gwas_add_eigen", ag),
                       ("uvlmm_gwas_dom", [ag]), ("uvlmm_gwas_dom_eigen", ag)):
        tabs[name] = run(name, lambda: getattr(G, name)(
            dm.y, dm.xmat, grms, var_eig, prefix, out_file=str(wd / name)))
        check(len(tabs[name]) == m, f"{name}: {len(tabs[name])} rows")
        check(pd.read_csv(wd / name, sep=" ").shape == tabs[name].shape,
              f"{name}: the file differs from the table")
    g_d = torch.as_tensor(G.read_plink(prefix), device=dev)
    # a dominance effect is estimable only where all three genotypes occur
    # (with two, the het indicator is collinear with the additive code)
    full = torch.stack([(g_d == v).any(0) for v in (0.0, 1.0, 2.0)]
                       ).all(0).cpu().numpy()
    check(full.mean() > 0.99, f"{int((~full).sum())} SNPs lack a genotype")
    for kind, cols, keep in (
            ("add", ("eff_val", "scale_val", "chi_val"), slice(None)),
            ("dom", ("eff_val", "chi_val"), full)):
        for col in cols:
            close(f"{kind} eigen vs direct {col}",
                  tabs[f"uvlmm_gwas_{kind}_eigen"][col].to_numpy()[keep],
                  tabs[f"uvlmm_gwas_{kind}"][col].to_numpy()[keep], 1e-7,
                  floor=1e-12)
    times["snps_without_a_genotype"] = int((~full).sum())
    mat_a, mat_d = additive_code(g_d)[0], dominance_code(g_d)[0]
    vmat = var_eig[0] * ag_d + var_eig[1] * torch.eye(n, dtype=torch.float64,
                                                      device=dev)
    lu = torch.linalg.lu_factor(vmat)
    tested = np.flatnonzero(full)
    snps = torch.as_tensor(np.random.default_rng(SEED).choice(
        tested, 32, replace=False), device=dev)
    xb = x_d.expand(32, -1, -1)
    for kind, cols in (("add", [mat_a[:, snps].T[..., None]]),
                       ("dom", [mat_a[:, snps].T[..., None],
                                mat_d[:, snps].T[..., None]])):
        eff, var = gls_last(lu, torch.cat([xb] + cols, dim=2), y_d)
        tab = tabs[f"uvlmm_gwas_{kind}"].iloc[snps.cpu().numpy()]
        close(f"{kind} vs GLS eff", tab["eff_val"], eff.cpu(), UVLMM_RTOL)
        close(f"{kind} vs GLS chi", tab["chi_val"], (eff * eff / var).cpu(),
              UVLMM_RTOL)

    # the interaction scan over 64 anchors, the planted pairs among them
    planted = ctx["planted"]
    rng = np.random.default_rng(SEED + 1)
    first = sorted({a for a, _ in planted})
    rest = [a for a in rng.permutation(m - 1).tolist() if a not in first]
    anchors = rng.permutation(first + rest[:64 - len(first)]).tolist()
    vmat2 = (var_com[0] * ag_d + var_com[1] * ag_d * ag_d
             + var_com[2] * torch.eye(n, dtype=torch.float64, device=dev))
    epi = run("uvlmm_gwas_epiAA", lambda: G.uvlmm_gwas_epiAA(
        dm.y, dm.xmat, gmat_lst, var_com, prefix, snp_lst_0=anchors,
        p_cut=1e-5, out_file=str(wd / "uvlmm_epiAA")))
    check(list(epi.columns) == ["snpi", "snpj", "snp_eff", "p_val"],
          f"epiAA columns {list(epi.columns)}")
    ii, jj = epi["snpi"].to_numpy(), epi["snpj"].to_numpy()
    pos = {a: k for k, a in enumerate(anchors)}
    order = np.array([pos.get(int(a), -1) for a in ii])
    check(len(epi) > 0 and bool(np.all(order >= 0)) and bool(np.all(jj > ii))
          and bool(np.all((order[1:] > order[:-1])
                          | ((order[1:] == order[:-1]) & (jj[1:] > jj[:-1])))),
          "epiAA rows: not anchors in list order, partners ascending")
    check(bool(np.all(epi["p_val"].to_numpy() < 1e-5)), "epiAA: p_val")
    found = set(zip(ii.tolist(), jj.tolist()))
    check(set(planted) <= found, f"epiAA: planted pairs "
          f"{sorted(set(planted) - found)} missing")
    pick = np.sort(np.random.default_rng(SEED + 2).choice(
        len(epi), min(16, len(epi)), replace=False))
    si = mat_a[:, torch.as_tensor(ii[pick], device=dev)].T[..., None]
    sj = mat_a[:, torch.as_tensor(jj[pick], device=dev)].T[..., None]
    eff, var = gls_last(torch.linalg.lu_factor(vmat2),
                        torch.cat([x_d.expand(len(pick), -1, -1), si, sj,
                                   si * sj], dim=2), y_d)
    from scipy.stats import chi2

    p_ref = chi2.sf((eff * eff / var).cpu().numpy(), 1)
    close("epiAA vs GLS eff", epi["snp_eff"].to_numpy()[pick], eff.cpu(),
          UVLMM_RTOL)
    close("epiAA vs GLS p", epi["p_val"].to_numpy()[pick], p_ref, UVLMM_RTOL)
    times["uvlmm_gwas_epiAA_rows"] = len(epi)
    del mat_d, vmat, vmat2, lu

    # OLS
    lm = run("lm_snp_eff", lambda: G.lm_snp_eff(pheno, prefix,
                                                out_file=str(wd / "lm")))
    cols = torch.cat([x_d.expand(32, -1, -1), g_d[:, snps].T[..., None]], 2)
    ref = torch.linalg.lstsq(cols, y_d.expand(32, -1)[..., None]
                             ).solution[:, -1, 0]
    close("lm_snp_eff vs lstsq", lm["eff"].to_numpy()[snps.cpu().numpy()],
          ref.cpu(), UVLMM_RTOL)
    pred = run("lm_pred", lambda: G.lm_pred(pheno, prefix, ag,
                                            out_file=str(wd / "lm_pred")))
    check(pred.shape == (n,) and bool(np.all(np.isfinite(pred))), "lm_pred")
    del g_d, mat_a

    # prediction with 10% of the phenotypes removed
    lines = open(pheno).read().splitlines(keepends=True)
    drop = set(np.random.default_rng(SEED + 3).choice(
        n, n // 10, replace=False).tolist())
    gaps = str(wd / "pheno_gaps")
    with open(gaps, "w") as f:
        f.writelines(ln for k, ln in enumerate(lines) if k not in drop)
    run("wemai_multi_gmat_pred", lambda: G.wemai_multi_gmat_pred(
        gaps, prefix, gmat_lst, out_file=str(wd / "pred")),
        "gmat_tpu_torch.reml.wemai")
    check(times["wemai_multi_gmat_pred"]["status"] == "Variances converged.",
          "wemai_multi_gmat_pred: REML did not converge")
    rand = np.loadtxt(wd / "pred.rand_eff")
    check(rand.shape == (n, len(gmat_lst)) and bool(np.all(np.isfinite(rand))),
          f"pred.rand_eff: shape {rand.shape} or non-finite values")
    var_t = torch.as_tensor(var_eig, device=dev)
    u_blup = _blup_effects(var_t, y_d, x_d, build_zgzt_stack(dm, [ag], dev),
                           ag_d[None], dm.rec_index(dev), dm.n_col)[:, 0]
    setup = mme._mme_setup(dm.y, dm.xmat,
                           torch.linalg.inv(ag_d).cpu().numpy(), dev)
    u_mme = mme._mme_solve(var_t, *setup[:5])[1][setup[5]:]
    close("_blup_effects vs the MME solution", u_blup.cpu(), u_mme.cpu(),
          UVLMM_RTOL, floor=1e-12)
    del setup, u_mme

    # GRM, I/O and annotation parts
    inb = run("ginbreedcoef", lambda: G.ginbreedcoef(prefix))
    check(len(inb) == n and bool(np.all(np.isfinite(
        inb[["homo_F", "grm_F1", "grm_F2"]].to_numpy()))), "ginbreedcoef")
    shuf = run("shuffle_bed", lambda: G.shuffle_bed(prefix, seed=SEED))
    a = torch.as_tensor(G.read_plink(prefix), device=dev)
    b = torch.as_tensor(G.read_plink(shuf), device=dev)
    check(all(bool(torch.equal((a == v).sum(0), (b == v).sum(0)))
              for v in (0.0, 1.0, 2.0)) and not bool(torch.equal(a, b)),
          "shuffle_bed: a column is not a permutation of its input")
    del a, b
    spans = write_gtf(wd / "genes.gtf", m)
    info = run("gtf_to_gene_info",
               lambda: G.gtf_to_gene_info(str(wd / "genes.gtf")))
    near = run("annotation_snp_nearest_gene",
               lambda: G.annotation_snp_nearest_gene(prefix, info,
                                                     max_distance=2000))
    with open(info) as f:
        check(sum(1 for _ in f) == len(spans), "gene_info: row count")
    snp_pos = np.arange(1, m + 1)
    within = sum(int(((snp_pos > s) & (snp_pos < e)).sum()) for s, e in spans)
    # a SNP inside a gene is also closer than 2000 bp to its ends
    close_by = sum(int((np.minimum(np.abs(snp_pos - s), np.abs(snp_pos - e))
                        < 2000).sum()) for s, e in spans)
    with open(near) as f:
        last = [ln.split()[-1] for ln in f]
    check(last.count("within") == within and len(last) == close_by,
          f"nearby_genes: {len(last)} rows ({last.count('within')} within), "
          f"want {close_by} ({within})")
    return times


# the longwas family -----------------------------------------------------------

ML = MOUSE / "mouse_long"
GOLD = ROOT / "tests" / "golden"
ML_SHAPE = (1212, 11833, 16, 19392)  # ids, SNPs, time points, unbalanced records
LONG_RTOL = 1e-8  # unbalanced GWAS against direct f64 fits on the card
LONG_TP = [float(t) for t in range(1, 17)]
LONG_TRAIT = list(range(2, 18))


def var_frame(name):
    import numpy as np
    import pandas as pd

    g = np.load(GOLD / name)
    return pd.DataFrame({k: g[k] for k in ("vari", "varij", "varik",
                                           "var_val")})


def golden_rows(name, key, suffix=""):
    """A golden table of tests/golden/<name> as a frame."""
    import numpy as np
    import pandas as pd

    g = np.load(GOLD / name)
    return pd.DataFrame(g[key + suffix], columns=list(g[key + "_cols" + suffix]))


def whole_table(name, res, m):
    """m rows, every statistic finite, every p in [0, 1]."""
    import numpy as np

    check(len(res) == m, f"{name}: {len(res)} rows, want {m}")
    stats = [c for c in res.columns
             if c.startswith(("eff", "chi_val", "p_", "cc_"))]
    vals = res[stats].to_numpy(dtype=float)
    check(bool(np.isfinite(vals).all()), f"{name}: non-finite statistics")
    p = res[["p_val", "p_min", "p_accum"]].to_numpy()
    check(bool(((p >= 0) & (p <= 1)).all()), f"{name}: p outside [0, 1]")


def subset_files(wd, prefix, n_sub=150):
    """The first n_sub .fam ids' GRM rows and unbalanced records (the JAX
    tests' subset); returns (data file, kinship file)."""
    import pandas as pd

    fam = pd.read_csv(ML / "plink.fam", sep=r"\s+", header=None, dtype=str)
    ids = set(fam[1][:n_sub])
    kin = str(wd / "kin.sub")
    with open(prefix + ".agrm2") as fin, open(kin, "w") as fout:
        fout.writelines(ln for ln in fin
                        if ln.split()[0] in ids and ln.split()[1] in ids)
    df = pd.read_csv(ML / "phe.unbalance.txt", sep=r"\s+", dtype={"ID": str})
    data = str(wd / "phe.unbalance.sub.txt")
    df[df["ID"].isin(ids)].to_csv(data, sep=" ", index=False)
    return data, kin


def unbalance_direct(model, var_df, snp_mat, snps):
    """eff and chi of the fixed and trans tests at columns `snps` of the
    (q, m) SNP matrix, one SNP at a time from V built plainly:
    Z_a (K_a ⊗ G) Z_aᵀ + Z_p (K_p ⊗ I) Z_pᵀ + σ²I with explicit incidence
    matrices, a GLS on explicit design columns [X, Φ_f ∘ s] for fixed, and
    the reference's kron(K_a, sᵀ) Z_aᵀ P y and its variance for trans."""
    import numpy as np
    import torch

    dev = torch.device("cuda")
    f64 = {"dtype": torch.float64, "device": dev}
    rid = torch.as_tensor(model.rec_ids, device=dev)
    n_rec, q = len(rid), model.kin.shape[0]
    vals = var_df["var_val"].to_numpy()
    tril = np.tril_indices(4)
    covs = []
    for block in (vals[:10], vals[10:20]):
        c = np.zeros((4, 4))
        c[tril] = block
        covs.append(torch.as_tensor(c + np.tril(c, -1).T, **f64))
    ka, kp = covs

    def incidence(leg, cols):
        z = torch.zeros(n_rec, leg.shape[1] * cols, **f64)
        for j in range(leg.shape[1]):
            z[torch.arange(n_rec, device=dev), j * cols + rid] = leg[:, j]
        return z

    z_a = incidence(torch.as_tensor(model.leg_a, **f64), q)
    z_p = incidence(torch.as_tensor(model.leg_p, **f64), model.q_p)
    vmat = z_a @ torch.kron(ka, torch.as_tensor(model.kin, **f64)) @ z_a.T
    vmat += z_p @ torch.kron(kp, torch.eye(model.q_p, **f64)) @ z_p.T
    vmat += float(vals[-1]) * torch.eye(n_rec, **f64)
    low = torch.linalg.cholesky(vmat)
    del vmat
    x = torch.as_tensor(model.xmat, **f64)
    y = torch.as_tensor(model.y, **f64)
    leg_f = torch.as_tensor(model.leg_f, **f64)
    vx = torch.cholesky_solve(x, low)
    xvx_inv = torch.linalg.inv(x.T @ vx)

    def pmul(v):  # P v
        return torch.cholesky_solve(v, low) - vx @ (xvx_inv @ (vx.T @ v))

    py = pmul(y[:, None])[:, 0]
    out = {"fixed": [], "trans": []}
    for k in snps:
        s = torch.as_tensor(snp_mat[:, k], **f64)
        cols = torch.cat([x, leg_f * s[rid][:, None]], dim=1)
        vc = torch.cholesky_solve(cols, low)
        c_inv = torch.linalg.inv(cols.T @ vc)
        b = c_inv @ (vc.T @ y)
        eff, var = b[-4:], c_inv[-4:, -4:]
        out["fixed"].append(torch.cat([eff, (eff @ torch.linalg.solve(
            var, eff))[None]]))
        kron_s = torch.kron(ka, s[None, :])  # (cd, cd·q)
        mt = z_a @ kron_s.T  # (n_rec, cd)
        eff = mt.T @ py
        var = mt.T @ pmul(mt)
        out["trans"].append(torch.cat([eff, (eff @ torch.linalg.solve(
            var, eff))[None]]))
    return {k: torch.stack(v).cpu().numpy() for k, v in out.items()}


def longwas_phase(ctx):
    """The longwas family on tests/data/mouse_long at full width (1,212
    ids, 11,833 SNPs, 16 time points, 19,392 unbalanced records, orders
    3/3/3), the kinship from the port's agmat: balance_varcom (maxiter=5
    against the golden, then to convergence); the balanced trans and fixed
    tests over every SNP at the golden variances, cold and warm (first 30
    rows against the golden); the full-cohort unbalance_varcom (maxiter=3
    against the golden) and the unbalanced fixed and trans tests over every
    SNP at its variances, 16 seeded SNPs against direct f64 fits; the
    150-id subset's tests and the permutation twins against their goldens,
    the balance-trans twin byte for byte under one seed, and two
    full-panel replicates of each trans twin.  Returns (step times,
    SNPs/s, peak device bytes)."""
    import numpy as np
    import pandas as pd
    import torch

    import gmat_tpu_torch as G
    from gmat_tpu_torch.longwas import balance as lb
    from gmat_tpu_torch.longwas import balance_gwas as lbg
    from gmat_tpu_torch.longwas import unbalance as lu
    from gmat_tpu_torch.longwas import unbalance_gwas as lug

    n_id, m, _, n_rec = ML_SHAPE
    wd = ctx["workdir"] / "longwas"
    wd.mkdir()
    prefix = str(wd / "plink")
    for ext in (".bed", ".bim", ".fam"):
        shutil.copy(ML / f"plink{ext}", prefix + ext)
    torch.cuda.reset_peak_memory_stats()
    times, rates = {}, {}
    run = partial(run_step, times)
    run("agmat(inv=True)", lambda: G.agmat(prefix, inv=True,
                                           out_fmt="id_id_val"))
    kin, kin_inv = prefix + ".agrm2", prefix + ".agiv2"
    bal = (str(ML / "phe.balance.txt"), "ID", LONG_TP, LONG_TRAIT, kin)
    unb = (str(ML / "phe.unbalance.txt"), "ID", "weak", "trait")

    # balanced REML: five rounds against the golden, then to convergence
    gold = np.load(GOLD / "longwas_balance_var.npz")
    var = run("balance_varcom[maxiter=5]", lambda: lb.balance_varcom(
        *bal, maxiter=5, prefix_outfile=str(wd / "bvar5")),
        "gmat_tpu_torch.longwas.balance")
    close("balance_varcom maxiter=5", var["var_val"], gold["var_val"], 1e-6,
          atol=1e-10)
    var = run("balance_varcom", lambda: lb.balance_varcom(
        *bal, prefix_outfile=str(wd / "bvar")), "gmat_tpu_torch.longwas.balance")
    check(times["balance_varcom"]["status"] == "Variances Converged",
          f"balance_varcom: {times['balance_varcom']['status']}")
    times["balance_varcom"]["var"] = var["var_val"].tolist()

    # balanced GWAS over every SNP at the golden variances, cold and warm
    var_bal = var_frame("longwas_balance_var.npz")
    for name, kw, tols in (
            ("balance_longwas_trans", {},
             ((("eff0", "eff1", "eff2", "eff3", "chi_val"), 1e-5, 1e-10),
              (("p_val", "p_min", "p_accum"), 1e-4, 1e-12))),
            ("balance_longwas_fixed", {"snp_batch": 256},
             ((("eff0", "eff1", "eff2", "eff3", "chi_val"), 1e-6, 1e-10),
              (("p_val",), 1e-6, 1e-12)))):
        fn = getattr(lbg, name)
        for call in ("cold", "warm"):
            res = run(f"{name}[{call}]", lambda: fn(
                *bal, prefix, var_bal, prefix_outfile=str(wd / name), **kw))
        whole_table(name, res, m)
        want = golden_rows("longwas_balance_gwas.npz", name.split("_")[-1])
        for cols, rtol, atol in tols:
            for col in cols:
                close(f"{name} {col}", res[col][:30], want[col], rtol,
                      atol=atol)
        rates[name] = m / times[f"{name}[warm]"]

    # unbalanced REML on the full cohort (9,700 MME unknowns)
    gold = np.load(GOLD / "longwas_unbalance_var_full.npz")
    var_full = run("unbalance_varcom[full, maxiter=3]", lambda: lu.unbalance_varcom(
        *unb, kin_inv, maxiter=int(gold["maxiter"]),
        prefix_outfile=str(wd / "uvar")), "gmat_tpu_torch.longwas.unbalance")
    close("unbalance_varcom full cohort", var_full["var_val"],
          gold["var_val"], 1e-5, atol=1e-8)

    # unbalanced GWAS on the full cohort, 16 SNPs against direct fits
    tabs = {}
    for which in ("fixed", "trans"):
        name = f"unbalance_longwas_{which}"
        tabs[which] = run(name, lambda: getattr(lug, name)(
            *unb, prefix, kin, var_full, prefix_outfile=str(wd / name)))
        whole_table(name, tabs[which], m)
        rates[name] = m / times[name]
    model = lu.prepare_unbalance(*unb, kin, kin_is_inverse=False)
    check(model.q_p == n_id and len(model.y) == n_rec, "mouse_long shape")
    snp_mat = lug._load_snp_by_code_order(model, prefix, None)[0]
    snps = np.sort(np.random.default_rng(SEED).choice(m, 16, replace=False))
    direct = run("direct fits (16 SNPs)", lambda: unbalance_direct(
        model, var_full, snp_mat, snps))
    for which, got in direct.items():
        tab = tabs[which].iloc[snps]
        for k, col in enumerate(("eff0", "eff1", "eff2", "eff3", "chi_val")):
            close(f"unbalance {which} vs direct {col}", tab[col], got[:, k],
                  LONG_RTOL)
    del model, snp_mat

    # the JAX tests' 150-id subset against the goldens
    data_sub, kin_sub = subset_files(wd, prefix)
    sub = (data_sub, "ID", "weak", "trait", prefix, kin_sub,
           var_frame("longwas_unbalance_var.npz"))
    cols = ("eff0", "eff1", "eff2", "eff3", "chi_val")
    for which in ("fixed", "trans"):
        res = getattr(lug, f"unbalance_longwas_{which}")(
            *sub, snp_lst=range(30), prefix_outfile=str(wd / f"sub_{which}"))
        want = golden_rows("longwas_unbalance_gwas.npz", which)
        for col in cols:
            close(f"subset {which} {col}", res[col], want[col], 1e-6,
                  atol=1e-10)
        for col in ("p_val", "p_min", "p_accum")[:3 if which == "fixed" else 1]:
            close(f"subset {which} {col}", res[col], want[col], 1e-5,
                  atol=1e-12)

    # permutation twins: seed 42, replicates 0 and 1, the 30 golden SNPs
    perm = {"permutation_lst": [0, 1], "snp_lst": range(30), "seed": 42}
    twins = (
        ("balance_fixed", lambda out: lbg.balance_longwas_fixed_permutation(
            *bal, prefix, var_bal, prefix_outfile=out, **perm), 1e-6),
        ("unbalance_fixed", lambda out: lug.unbalance_longwas_fixed_permutation(
            *sub, prefix_outfile=out, **perm), 1e-5),
        ("unbalance_trans", lambda out: lug.unbalance_longwas_trans_permutation(
            *sub, prefix_outfile=out, **perm), 1e-5))
    for key, fn, rtol in twins:
        out = str(wd / key)
        run(f"{key}_permutation (2 x 30 SNPs)", lambda: fn(out))
        for rep in (0, 1):
            got = pd.read_csv(f"{out}.{rep}", sep=r"\s+")
            want = golden_rows("longwas_permutation.npz", key, f"_{rep}")
            for col in cols + ("p_val",):
                close(f"{key} permutation {rep} {col}", got[col], want[col],
                      rtol, atol=1e-10)
    for out in ("btp_a", "btp_b"):
        lbg.balance_longwas_trans_permutation(
            *bal, prefix, var_bal, prefix_outfile=str(wd / out), **perm)
    for rep in (0, 1):
        check((wd / f"btp_a.{rep}").read_bytes()
              == (wd / f"btp_b.{rep}").read_bytes(),
              f"balance trans permutation {rep}: files differ under one seed")

    # two full-panel replicates of each trans twin, s per replicate
    for name, fn, args in (
            ("balance_longwas_trans_permutation",
             lbg.balance_longwas_trans_permutation, bal + (prefix, var_bal)),
            ("unbalance_longwas_trans_permutation",
             lug.unbalance_longwas_trans_permutation,
             unb + (prefix, kin, var_full))):
        out = str(wd / f"{name}_full")
        run(name, lambda: fn(*args, permutation_lst=[0, 1], seed=42,
                             prefix_outfile=out))
        times[name] = {"s_per_replicate": times[name] / 2, "replicates": 2}
        whole_table(name, pd.read_csv(f"{out}.1", sep=r"\s+"), m)
    return times, rates, torch.cuda.max_memory_allocated()


def main():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    gpu_line = smi.stdout.strip().splitlines()[0]
    print(gpu_line, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    sys.path.insert(0, str(ROOT))
    from gmat_tpu_torch.probe import sass_opcodes
    from gmat_tpu_torch.scan import kernels as K

    t0 = time.perf_counter()
    lib = K.build_library()
    print(f"build: {lib.name} in {time.perf_counter() - t0:.1f} s", flush=True)
    print(lib.with_suffix(".log").read_text().strip(), flush=True)
    dmma = {op: count for fn, ops in sass_opcodes(lib, "DMMA").items()
            if "exact_scan_kernel" in fn for op, count in ops.items()}
    print(f"exact_scan_kernel SASS DMMA instructions: {json.dumps(dmma)}",
          flush=True)
    check(dmma, "exact_scan_kernel's SASS holds no DMMA (FP64 tensor-core) "
          "instruction")

    phase_s = {}
    t0 = time.perf_counter()
    cases = [
        flat_case(K, "yeast", *YEAST, seed=1, target=1e5),
        flat_case(K, "ragged", 1001, 3001, seed=2, target=2e4),
        flat_case(K, "zero_hits", 1001, 3001, seed=3, cut=1e9),
        flat_case(K, "near_keep_all", 1304, 1700, seed=4, target=1.3e6),
    ]
    check(cases[0]["hits"] > 5e4, "yeast case: too few hits")
    check(cases[2]["hits"] == 0, "zero-hit case found hits")
    check(cases[3]["hits"] > 1e6, "near-keep-all case: too few hits")
    phase_s["screen_kernels"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    general = general_cases(K)
    cases += general
    phase_s["general_screen_kernels"] = time.perf_counter() - t0
    print("general screen kernels " + json.dumps([
        {k: c[k] for k in ("case", "anchors", "pairs", "hits", "count_ms",
                           "count_bound_ms", "plain_count_ms", "extract_ms",
                           "extract_bound_ms", "plain_extract_ms",
                           "screen_ms")} for c in general]), flush=True)

    t0 = time.perf_counter()
    exact_err = exact_phase(K)
    phase_s["exact_kernel"] = time.perf_counter() - t0

    build = ROOT / "build" / "chip_smoke"
    build.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as td:
        t0 = time.perf_counter()
        mouse = reference_tables(K, Path(td))
        phase_s["mouse_tables"] = time.perf_counter() - t0
    with tempfile.TemporaryDirectory(dir=build) as td:
        t0 = time.perf_counter()
        times, stages, launches, ctx = main_path(K, Path(td))
        phase_s["four_step"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        exact_launches, part, part_err = exact_slice(K, ctx)
        phase_s["exhaustive_part"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        times.update(single_snp(ctx))
        phase_s["single_snp"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        family_launches, family_stages = screen_family(K, ctx)
        phase_s["screen_family"] = time.perf_counter() - t0
        for key in K.LAUNCHES:
            K.LAUNCHES[key] = 0
        t0 = time.perf_counter()
        uvlmm_times = uvlmm_phase(ctx)
        phase_s["uvlmm"] = time.perf_counter() - t0
        uvlmm_launches = dict(K.LAUNCHES)
        for key in K.LAUNCHES:
            K.LAUNCHES[key] = 0
        t0 = time.perf_counter()
        long_times, long_rates, long_peak = longwas_phase(ctx)
        phase_s["longwas"] = time.perf_counter() - t0
        long_launches = dict(K.LAUNCHES)
    times["remma_epiAA_parallel"] = part["wall_s"]
    times.update({k: v["wall_s"] for k, v in family_stages.items()})
    print(f"screen-family launches {json.dumps(family_launches)}", flush=True)
    print(f"main-path step times (s): {json.dumps(times)}", flush=True)
    print(f"uvlmm launches {json.dumps(uvlmm_launches)} (dense f64 "
          "linear algebra on cuBLAS/cuSOLVER: no hand kernel on this path)",
          flush=True)
    print(f"uvlmm step times (s) {json.dumps(uvlmm_times)}", flush=True)
    check(not any(long_launches.values()),
          f"the longwas phase launched a hand kernel: {long_launches}")
    print(f"longwas launches {json.dumps(long_launches)} (dense f64 linear "
          "algebra on cuBLAS/cuSOLVER: no hand kernel on this path)",
          flush=True)
    print(f"longwas step times (s) on {gpu_line}: {json.dumps(long_times)}",
          flush=True)
    print(f"longwas rates (SNPs/s) on {gpu_line}: {json.dumps(long_rates)}",
          flush=True)
    print(f"longwas peak device memory on {gpu_line}: {long_peak} B "
          f"({long_peak / 2**30:.2f} GiB, torch.cuda.max_memory_allocated)",
          flush=True)
    print(f"phase times (s): {json.dumps(phase_s)}", flush=True)

    yeast = cases[0]
    screen_src = "gmat_tpu_torch/csrc/screen.cu"
    kernels = [
        {"name": "screen_count", "route": "cuda", "source": screen_src,
         "replaces": "gmat_tpu/scan/kernels.py:116",
         "launches": launches["screen_count"],
         "max_abs_err": max(c["count_max_abs_err"] for c in cases),
         "ms": yeast["count_ms"], "plain_ms": yeast["plain_count_ms"],
         "bound_ms": yeast["count_bound_ms"],
         "bound_by": yeast["count_bound_by"], "library_ms": None},
        {"name": "screen_extract", "route": "cuda", "source": screen_src,
         "replaces": "gmat_tpu/scan/kernels.py:429",
         "launches": launches["screen_extract"],
         "max_abs_err": max(c["eff_max_abs_err"] for c in cases),
         "ms": yeast["extract_ms"], "plain_ms": yeast["plain_extract_ms"],
         "bound_ms": yeast["extract_bound_ms"],
         "bound_by": yeast["extract_bound_by"], "library_ms": None},
        {"name": "exact_scan", "route": "cuda",
         "source": "gmat_tpu_torch/csrc/exact.cu",
         "replaces": "gmat_tpu/scan/kernels.py:229",
         "launches": exact_launches["exact_scan"],
         "max_abs_err": max(exact_err, part_err, mouse["max_abs_err"]),
         "ms": part["ms"], "plain_ms": part["plain_ms"],
         "bound_ms": part["bound_ms"], "bound_by": part["bound_by"],
         "library_ms": part["library_ms"]},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(gpu_line, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
