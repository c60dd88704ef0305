#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (gmat_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

1. requires CUDA and prints the card's name and power limit;
2. builds the kernels from gmat_tpu_torch/csrc/*.cu (one nvcc per source,
   all started together); the build fails the run when the SASS of any of
   the four screen kernels holds no TF32 tensor-core instruction (HGMMA
   ... TF32: their product is 3xTF32 on wgmma);
3. holds the effect-screen kernels against their plain PyTorch versions and
   a float64 oracle at the yeast shape (n=4168, m=28220, ~1e5 hits), a
   ragged shape, a zero-hit cut and a near-keep-all cut, and times both
   (each `case` line gives the 3xTF32 bound and the float32 one); at the
   yeast shape it times the count with the earlier CUDA-core FMA product
   (`gmat_tpu_torch/probe.py`) and with the package's in turns (the
   `product turns` line);
4. holds the exact-scan kernel against its plain version for AA, AD and DD
   at a ragged shape with an unsorted anchor subset, with a threshold, a
   zero-hit threshold and keep-all; then the float64 inverse that REML and
   the scans' pieces take on a card (`inverse_phase`) at n = 4,168 and
   1,304: the leaf kernel on every 64-row diagonal block against its plain
   version, `spd_inverse_logdet` against torch.linalg.inv and torch's
   Cholesky inverse at 1e-12 relative, one launch per leaf, and its time
   beside the library's (the `inverse` line);
5. runs the complete mouse exact-scan tables (tests/data/plink) through
   remma_epiAA/AD/DD and holds them against the reference's
   tests/golden/epi_full.npz at tests/test_full_table.py's tolerances;
6. runs the README's four-step REMMAX workflow through the package's entry
   points at the yeast shape on a seeded PLINK set of full-sib families:
   agmat -> wemai_multi_gmat -> remma_epiAA_approx -> annotation_snp_pos,
   and checks that the screen kernels ran, that REML launched the
   inverse's leaves of every iteration (its graph's replays included) and
   that the result table is right;
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
   times (s)`, `longwas rates (SNPs/s)` and peak-memory lines);
13. the periphery (`periphery_phase`) on the yeast set, each call with
   its own launch counts: `gmat-tpu-torch --device cuda remmax` (its
   variances and table against the four-step workflow's, the planted
   pairs, the annotation and the timings file; K1 launched) and
   `epiaa --parallel 100 1` (byte-equal to remma_epiAA_parallel's file; K2
   launched); the array-level _wemai_multi_gmat (rtol 1e-8),
   _remma_epiAA_eff on 64 anchors and _remma_epiAD_parallel([100, 1])
   (byte-equal to their file-level twins; K1 and K2 in its full
   rectangle); the legacy keep-all remma_epiAD_eff_cpu on 16 anchors
   (every pair in both orientations, eff in the f64 bracket, two K1
   sweeps); simu_epistasis against numpy (rtol 1e-10); the five pedigree
   tools on a seeded 4,168-id pedigree (the `periphery step times (s)`
   and `periphery launches` lines);
14. the device mesh (`mesh_phase`) on the yeast set: (a) two virtual
   shards of the card, `make_mesh(devices=["cuda:0", "cuda:0"])`, and (b)
   every visible card, `make_mesh()`, each through agmat (rtol 1e-10),
   remma_epiAA_approx (the four-step table's bytes), remma_epiAD_maf_eff,
   remma_epiAA over the [100, 1] part's anchors in two runs (the part's
   file's bytes) and remma_epiAA_pair (the calibration file's bytes), the
   K1/K2 launches one per shard with work; (c) a 2-process world on the
   card, this script run twice as `--mesh-worker` and joined by
   `initialize_multihost(..., backend="gloo")`: the sharded GRM and
   remma_epiAA_eff(mesh=) against single runs (the `mesh` line);
15. the headline benchmark (`bench_phase`) at bench.py's sizes through
   `gmat-tpu-torch bench` in this process: its one JSON line (printed
   with a `bench ` prefix) of bench.py's keys, none null; K1 launched in
   the production, yeast and big-panel screens and K2 in the exact scan;
   at the production (1304 x 262,144) and big-panel (1304 x 2^20, a 5.5 GB
   panel) shapes every hit's eff within 1e-4·cut of its float64 value, the
   hit set inside the float64 bracket and equal to the plain version's
   outside it; K2 at the bench's exact inputs against its plain version
   pair by pair, at the bench's threshold and keeping every pair; K1's
   count and extract timed at both screen shapes and K2 at the exact
   shape, with their bounds (the `bench kernels` line);
16. the entry points that only CPU tests held before (`coverage_phase`),
   each call with its own launch counts and wall time: (a) the whole AA
   triangle of the yeast set through remma_epiAA (28,219 anchors,
   398,170,090 pairs; K2 once per anchor run; sorted rows with p_val below
   1e-5, the planted pairs, part 1's rows equal to the exhaustive part's
   lines, the approx table's pairs past the threshold present at
   EXACT_RTOL, the middle and last anchor runs against the plain version;
   the `epiAA whole-triangle` line gives its wall, pairs/s, hits and the
   approx pipeline's recall of it); (b) remma_epiDD_parallel([100, 1])
   byte-equal to remma_epiDD over its anchors, 16 of them against the
   plain version; (c) remma_epi{AA,AD,DD}_maf_eff_parallel([100, 1]), each
   part's lines the full table's lines of its anchors; (d)
   uvlmm_gwas_epiAA on the mouse set, against tests/golden/
   uvlmm_extras.npz and 16 direct GLS fits; (e) the legacy
   remma_epi{AA,AD,DD}_select_cpu on 32 x 2,000 seeded pairs against
   remma_epi*_pair at EXACT_RTOL; (f) simu_epistasis_freq against numpy
   (rtol 1e-10) (the `coverage` lines).

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
# TF32 on the tensor cores, and the HBM3 rate
FP32_PEAK, FP64_PEAK, TF32_PEAK, HBM_RATE = 67e12, 67e12, 495e12, 3.35e12
FP64_CORE_PEAK = 34e12  # float64 on the CUDA cores (the inverse's leaf)
INVERSE_NS = (4168, 1304)  # V's rows at the yeast and the mouse panel
INVERSE_RTOL = 1e-12  # the card's inverse vs torch.linalg.inv, relative
# the screen kernels' SASS functions, each of which must hold TF32
# tensor-core instructions (HGMMA ... TF32)
SCREEN_KERNELS = ("screen_count_kernel", "screen_extract_kernel",
                  "screen_count_general_kernel",
                  "screen_extract_general_kernel")
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
    # each input read once: the panel(s), py, the bins and the table; the
    # kernels' product is 3xTF32 (three TF32 products per multiply-add),
    # its bound beside the float32 one of the earlier CUDA-core product
    in_bytes = 4 * (n * m + n + (0 if b is None else n * n_a)) + (
        0 if isinstance(cut, float) else 8 * m + 4 * 111)
    count_flop = 2.0 * n * pairs
    count_bytes = in_bytes + 4 * counts.numel()
    extract_flop = 2.0 * n * tile_pairs(tiles, m, K.TILE, ids)
    extract_bytes = in_bytes + 8 * len(tiles) + 12 * len(keys)
    count_bound = bound(3 * count_flop, count_bytes, TF32_PEAK)
    extract_bound = bound(3 * extract_flop, extract_bytes, TF32_PEAK)
    out = {
        "case": name, "n": n, "m": m, "anchors": n_a,
        "cut": cut if isinstance(cut, float) else "table", "hits": len(keys),
        "f64_core": len(ci), "f64_hull": len(hull), "hot_tiles": len(tiles),
        "pairs": pairs,
        "count_max_abs_err": count_err, "eff_max_abs_err": eff_err,
        "eff_max_rel_err_f64": rel,
        "count_bound_ms": count_bound[0], "count_bound_by": count_bound[1],
        "count_fp32_bound_ms": bound(count_flop, count_bytes, FP32_PEAK)[0],
        "extract_bound_ms": extract_bound[0],
        "extract_bound_by": extract_bound[1],
        "extract_fp32_bound_ms": bound(extract_flop, extract_bytes,
                                       FP32_PEAK)[0],
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


def product_turns(K, yeast):
    """The identity count at the yeast case's panel and cut with the
    earlier CUDA-core FMA product (`probe.py`'s `ffma` library) and with
    the package's 3xTF32 product, in turns ffma, wgmma, wgmma, ffma; both
    counts' totals inside the case's f64 bracket."""
    import torch

    from gmat_tpu_torch.core import native
    from gmat_tpu_torch.probe import screen_product_turns

    mat, py = panel(*YEAST, seed=1)
    out_dir = native._BUILD_DIR / "probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    ms, counts = screen_product_turns(mat, py, yeast["cut"], YEAST[1],
                                      out_dir)
    for name, c in counts.items():
        total = int(c.sum())
        check(yeast["f64_core"] <= total <= yeast["f64_hull"],
              f"{name} product: {total} hits outside the f64 bracket "
              f"[{yeast['f64_core']}, {yeast['f64_hull']}]")
    check(int(counts["wgmma"].sum()) == yeast["hits"],
          "the 3xTF32 counts differ from the case's hits")
    out = {"ffma_ms": ms["ffma"], "wgmma_ms": ms["wgmma"],
           "ffma_hits": int(counts["ffma"].sum()),
           "wgmma_hits": int(counts["wgmma"].sum())}
    print("product turns (yeast count, ffma/wgmma/wgmma/ffma) "
          + json.dumps(out), flush=True)
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


def spd_matrix(n, seed):
    """A symmetric positive-definite float64 (n, n) on the card, r rᵀ/n + I
    for r standard normal."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    r = torch.randn(n, n, generator=g, dtype=torch.float64, device="cuda")
    return r @ r.T / n + torch.eye(n, dtype=torch.float64, device="cuda")


def inverse_phase():
    """The float64 inverse on the card at V's sizes (`INVERSE_NS`): the
    leaf kernel on each 64-row diagonal block of the matrix against its
    plain version (`spd_leaf_inverse_ref`, on the card), one launch per
    leaf; `spd_inverse_logdet` against torch.linalg.inv (relative to the
    largest entry, at INVERSE_RTOL), torch's Cholesky inverse and slogdet,
    one launch per leaf of the recursion; its device time beside the
    library's inverses and the parent's cholesky_solve(I).  Returns the
    `inverse` line's record and the leaf kernel's row of the kernels line
    (its time, plain and library times at one 64 x 64 leaf)."""
    import torch

    from gmat_tpu_torch.core import native
    from gmat_tpu_torch.core.linalg import spd_inverse_logdet
    from gmat_tpu_torch.probe import cuda_ms

    b, launches = native.SPD_LEAF, native.LEAF_LAUNCHES
    record, leaf_err, leaf_rel = {}, 0.0, 0.0
    for n in INVERSE_NS:
        a = spd_matrix(n, n)
        out = torch.empty_like(a)
        logdets = torch.empty(-(-n // b), dtype=a.dtype, device="cuda")
        orders = torch.empty(len(logdets), dtype=torch.int32, device="cuda")
        before = launches["spd_leaf_inverse"]
        for k, r0 in enumerate(range(0, n, b)):
            blk = slice(r0, min(r0 + b, n))
            native.spd_leaf_inverse(a[blk, blk], out[blk, blk], logdets[k],
                                    orders[k], r0)
        torch.cuda.synchronize()
        check(launches["spd_leaf_inverse"] - before == len(logdets),
              f"inverse leaves at n={n}: "
              f"{launches['spd_leaf_inverse'] - before} launches")
        check(not bool(orders.any()), f"inverse leaves at n={n}: a leaf "
              "read as not positive definite")
        for k, r0 in enumerate(range(0, n, b)):
            blk = slice(r0, min(r0 + b, n))
            inv, ld, first = native.spd_leaf_inverse_ref(a[blk, blk])
            err = float((out[blk, blk] - inv).abs().max())
            leaf_err = max(leaf_err, err)
            leaf_rel = max(leaf_rel, err / float(inv.abs().max()),
                           abs(float(logdets[k] - ld)) / max(1.0, abs(float(ld))))
            check(first == 0, f"plain leaf {k} at n={n}: order {first}")
        check(leaf_rel <= INVERSE_RTOL, f"inverse leaves at n={n}: "
              f"{leaf_rel:.3e} from their plain version")

        before = launches["spd_leaf_inverse"]
        inv, logdet, info = spd_inverse_logdet(a)
        want = torch.linalg.inv(a)
        chol = torch.linalg.cholesky(a)
        want_chol = torch.cholesky_inverse(chol)
        want_ld = float(torch.linalg.slogdet(a)[1])
        torch.cuda.synchronize()
        check(launches["spd_leaf_inverse"] - before == len(logdets),
              f"spd_inverse_logdet at n={n}: "
              f"{launches['spd_leaf_inverse'] - before} leaf launches")
        scale = float(want.abs().max())
        gap = float((inv - want).abs().max()) / scale
        gap_chol = float((inv - want_chol).abs().max()) / scale
        gap_ld = abs(float(logdet) - want_ld) / max(1.0, abs(want_ld))
        check(int(info) == 0, f"spd_inverse_logdet at n={n}: info {int(info)}")
        check(max(gap, gap_chol, gap_ld) <= INVERSE_RTOL,
              f"spd_inverse_logdet at n={n}: {gap:.3e} from inv, "
              f"{gap_chol:.3e} from cholesky_inverse, logdet {gap_ld:.3e}")
        eye = torch.eye(n, dtype=a.dtype, device="cuda")
        # the least work: ≈ n³/3 FMA of a Cholesky factorization and 2n³/3
        # of its inverse (potrf + potri), on the FP64 tensor cores
        ms_bound, bound_by = bound(2.0 * n ** 3, 16 * n * n, FP64_PEAK)
        record[n] = {
            "max_rel_err": gap, "max_rel_err_cholesky_inverse": gap_chol,
            "logdet_rel_err": gap_ld, "leaves": len(logdets),
            "ms": cuda_ms(lambda: spd_inverse_logdet(a)),
            "inv_ms": cuda_ms(lambda: torch.linalg.inv(a)),
            "cholesky_inverse_ms": cuda_ms(
                lambda: torch.cholesky_inverse(torch.linalg.cholesky(a))),
            "cholesky_solve_eye_ms": cuda_ms(
                lambda: torch.cholesky_solve(eye, torch.linalg.cholesky(a))),
            "bound_ms": ms_bound, "bound_by": bound_by}
        del a, out, inv, want, chol, want_chol, eye
        torch.cuda.empty_cache()
    record["leaf_max_rel_err"] = leaf_rel
    a = spd_matrix(b, 1)
    out = torch.empty_like(a)
    logdet = torch.empty((), dtype=a.dtype, device="cuda")
    order = torch.empty((), dtype=torch.int32, device="cuda")
    _, plain_ms = timed(lambda: native.spd_leaf_inverse_ref(a))
    # b³ FMA on the CUDA cores; b x b doubles read and written
    ms_bound, bound_by = bound(2.0 * b ** 3, 16 * b * b, FP64_CORE_PEAK)
    leaf = {"max_abs_err": leaf_err,
            "ms": cuda_ms(lambda: native.spd_leaf_inverse(a, out, logdet,
                                                          order, 0), reps=9),
            "plain_ms": plain_ms,
            "bound_ms": ms_bound, "bound_by": bound_by,
            "library_ms": cuda_ms(lambda: torch.linalg.inv(a), reps=9)}
    record["leaf_64"] = leaf
    return record, leaf


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
    from gmat_tpu_torch.core import native
    from gmat_tpu_torch.io.pheno import design_matrix
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
    native.LEAF_LAUNCHES["spd_leaf_inverse"] = 0
    var_com = wemai_multi_gmat(pheno, prefix, gmat_lst,
                               out_file=str(workdir / "var.txt"))
    times["wemai_multi_gmat"] = time.perf_counter() - t0
    reml_leaves = native.LEAF_LAUNCHES["spd_leaf_inverse"]
    print(f"REML: {reml_log.rounds} iterations, {reml_log.status}, "
          f"{reml_leaves} inverse leaves", flush=True)
    # V's leaves and XᵀV⁻¹X's, every iteration's, those that ran as a graph
    # replay too
    dm = design_matrix(pheno, prefix)
    per_step = sum(-(-k // native.SPD_LEAF) for k in dm.xmat.shape)
    check(reml_leaves == reml_log.rounds * per_step,
          f"REML launched {reml_leaves} inverse leaves in "
          f"{reml_log.rounds} iterations")
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
    launches = {**K.LAUNCHES, "spd_leaf_inverse (REML)": reml_leaves}
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
    tab = scan_table("epiAA_parallel", out + ".1")

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


def counted_step(K, times, launches, name, fn, logger=None):
    """`run_step` with the kernel launch counts set to 0 just before fn()
    and read into launches[name] just after."""
    for key in K.LAUNCHES:
        K.LAUNCHES[key] = 0
    out = run_step(times, name, fn, logger)
    launches[name] = dict(K.LAUNCHES)
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


# the periphery: CLI, remmax, array API, legacy engine, simulators, pedigree -

class MessageLog(logging.Handler):
    """Keeps the messages of one logger that start with `prefix`."""

    def __init__(self, prefix):
        super().__init__(logging.INFO)
        self.prefix, self.messages = prefix, []

    def emit(self, record):
        msg = record.getMessage()
        if msg.startswith(self.prefix):
            self.messages.append(msg)


def seeded_effects(workdir, m, rng, k=20):
    """Effect files of `simu_epistasis`: k SNPs (A, D) or pairs (AA, AD,
    DD) each, drawn without repeats, with normal effects."""
    import numpy as np

    paths = []
    for name, n_idx in (("add", 1), ("dom", 1), ("aa", 2), ("ad", 2),
                        ("dd", 2)):
        idx = rng.choice(m, size=(k, n_idx), replace=False)
        np.savetxt(workdir / f"eff_{name}",
                   np.column_stack([idx, rng.standard_normal(k)]),
                   fmt=["%d"] * n_idx + ["%.6f"])
        paths.append(str(workdir / f"eff_{name}"))
    return paths


def simulate_numpy(prefix, paths, ratio, mean, res_var, seed,
                   freq_based=False):
    """`simu_epistasis` recomputed in numpy float64 from the decoded
    `.bed`: (normalised effect tables, residuals, phenotype).  With
    `freq_based`, `simu_epistasis_freq`: the A and D components are scaled
    by their theoretical variances, 2p(1-p)·e² and
    2p(1-p)(1 - 2p(1-p))·e², p the SNP's allele frequency."""
    import numpy as np

    from gmat_tpu_torch import read_plink

    geno = read_plink(prefix)
    n = geno.shape[0]
    freq = geno.sum(axis=0) / (2 * n)

    def code(kind, idx):
        g, p = geno[:, idx], freq[idx]
        if kind == "a":
            return g - 2 * p[None, :]
        return np.where(g > 1.5, 0.0, g) - (2 * p * (1 - p))[None, :]

    tables, pheno = [], np.full(n, float(mean))
    targets = (ratio[0], ratio[1], ratio[2], ratio[3], ratio[3])
    for path, kinds, target in zip(paths, ("a", "d", "aa", "ad", "dd"),
                                   targets):
        tab = np.loadtxt(path, ndmin=2)
        val = tab[:, -1][None, :]
        for k, kind in enumerate(kinds):
            val = code(kind, tab[:, k].astype(np.int64)) * val
        if freq_based and len(kinds) == 1:
            p = freq[tab[:, 0].astype(np.int64)]
            het = 2 * p * (1 - p)
            comp = (het if kinds == "a" else het * (1 - het)) * tab[:, -1] ** 2
        else:
            comp = np.var(val, axis=0)
        scale = np.sqrt(np.sum(comp) / (target / ratio[-1] * res_var))
        tab[:, -1] /= scale
        tables.append(tab)
        pheno += np.sum(val / scale, axis=1)
    res = np.random.default_rng(seed).normal(0, np.sqrt(res_var), n)
    return tables, res, pheno + res


def simulation_checks(name, paths, sim, want, n):
    """The files of a simulator call (`<path>.norm`, `<sim>.res`,
    `<sim>.pheno`) against `simulate_numpy`'s `want` at rtol 1e-10."""
    import numpy as np
    import pandas as pd

    tables, res_vec, ph = want
    for path, tab in zip(paths, tables):
        got_tab = np.loadtxt(path + ".norm", ndmin=2)
        check(np.array_equal(got_tab[:, :-1], tab[:, :-1]),
              f"{name}: {path}.norm indexes")
        np.testing.assert_allclose(got_tab[:, -1], tab[:, -1], rtol=1e-10,
                                   err_msg=f"{name} {path}.norm")
    np.testing.assert_array_equal(np.loadtxt(sim + ".res"), res_vec)
    got_ph = pd.read_csv(sim + ".pheno", sep=" ", header=None)
    check(got_ph.shape == (n, 4) and bool(np.all(got_ph[2] == 1)),
          f"{name}: .pheno shape")
    np.testing.assert_allclose(got_ph[3].to_numpy(), ph, rtol=1e-10,
                               err_msg=f"{name} phenotype vs numpy")


def seeded_pedigree(path, n, rng):
    """n ids in a shuffled file; a parent is an earlier id, sires from the
    even and dams from the odd ids, a tenth of the ids founders, and one
    parent in ten unknown.  Returns {id: (sire, dam)}."""
    ped = {}
    for k in range(n):
        s = d = "0"
        if k >= n // 10:
            if rng.random() < 0.9:
                s = f"id{2 * rng.integers(0, k // 2 + k % 2)}"
            if rng.random() < 0.9 and k > 1:
                d = f"id{2 * rng.integers(0, k // 2) + 1}"
        ped[f"id{k}"] = (s, d)
    keys = list(ped)
    order = rng.permutation(n)
    with open(path, "w") as f:
        for q in order:
            f.write(f"{keys[q]}\t{ped[keys[q]][0]}\t{ped[keys[q]][1]}\n")
    return ped


def pedigree_checks(workdir, rng):
    """The five ped_* tools on a seeded pedigree of YEAST[0] ids."""
    import numpy as np

    from gmat_tpu_torch import (ped_completeness, ped_correct, ped_recode,
                                ped_sort, ped_trace)

    n = YEAST[0]
    path = str(workdir / "ped")
    ped = seeded_pedigree(path, n, rng)
    ids_file = str(workdir / "ped_ids")
    sample = [f"id{k}" for k in range(n - 100, n)]
    with open(ids_file, "w") as f:
        f.write("".join(f"{i}\n" for i in sample))
    known, frontier = set(sample), set(sample)
    while frontier:
        frontier = {p for i in frontier for p in ped[i] if p != "0"} - known
        known |= frontier
    check(ped_trace(ids_file, path) == len(known),
          f"ped_trace: count differs from the ancestors ({len(known)})")
    with open(ids_file + ".trace") as f:
        check({line.split()[0] for line in f} == known,
              "ped_trace: ids differ from the ancestors")
    fixed = ped_correct(path)
    check(all(tuple(fixed[i]) == ped[i] for i in ped) and len(fixed) == n,
          "ped_correct changed a consistent pedigree")
    for ext in (".error1", ".error2"):
        check(open(path + ext).read() == "", f"ped_correct: {ext} not empty")
    ped_sort(path)
    seen = {"0"}
    with open(path + ".sort") as f:
        for line in f:
            i, s, d = line.split()
            check(s in seen and d in seen, f"ped_sort: {i} before a parent")
            seen.add(i)
    check(len(seen) == n + 1, "ped_sort: ids missing")
    ped_recode(path)
    code = dict(line.split() for line in open(path + ".dct"))
    check(sorted(map(int, code.values())) == list(range(1, n + 1)),
          "ped_recode: codes are not 1..n")
    inv = {int(v): k for k, v in code.items()} | {0: "0"}
    with open(path) as fa, open(path + ".recode") as fb:
        for a, b in zip(fa, fb):
            check(a.split() == [inv[int(c)] for c in b.split()],
                  "ped_recode: a row does not decode to its input")
    ped_completeness(path, gen=5, cut=0.5)
    pec = np.array([float(line.split()[1]) for line in open(path + ".pec")])
    check(len(pec) > 0 and bool(np.all((pec >= 0.5) & (pec <= 1.0))),
          "ped_completeness: index outside [cut, 1]")
    return {"ids": n, "traced": len(known), "pec_rows": len(pec)}


def periphery_phase(K, ctx):
    """What users coming from the reference call, on the yeast set, each
    call with the launch counts set to 0 just before it and read just
    after: the command line's remmax (against the four-step workflow) and
    `epiaa --parallel 100 1` (against remma_epiAA_parallel's file), the
    array-level _wemai_multi_gmat, _remma_epiAA_eff and
    _remma_epiAD_parallel (against their file-level twins), the legacy
    keep-all remma_epiAD_eff_cpu on 16 anchors (against the f64 oracle),
    simu_epistasis (against numpy) and the pedigree tools.  Returns
    (step times, launches)."""
    import numpy as np
    import pandas as pd
    import torch

    import gmat_tpu_torch as G
    from gmat_tpu_torch import cli
    from gmat_tpu_torch.io.pheno import design_matrix
    from gmat_tpu_torch.scan.common import (coded_matrix,
                                            design_matrix_cached,
                                            prepare_genotypes_device,
                                            score_pieces_cached)
    from gmat_tpu_torch.scan.legacy import remma_epiAD_eff_cpu
    from gmat_tpu_torch.scan.pairs import balanced_anchor_split

    wd, prefix, pheno = ctx["workdir"], ctx["prefix"], ctx["pheno"]
    gmat_lst, var_com = ctx["gmat_lst"], ctx["var_com"]
    n, m = YEAST
    rng = np.random.default_rng(SEED + 7)
    times, launches = {}, {}

    step = partial(counted_step, K, times, launches)

    def screened(name, sweeps):
        check(launches[name]["screen_count"] == sweeps
              and launches[name]["screen_extract"] == sweeps,
              f"{name}: launches {launches[name]}, want {sweeps} sweep(s)")

    # the command line configures logging once (`basicConfig`): do it here
    # so that the INFO lines the phases turned on stay off stderr
    logging.basicConfig(level=logging.WARNING, format="%(message)s")
    for handler in logging.getLogger().handlers:
        handler.setLevel(logging.WARNING)

    # 1. remmax through the command line, against the four-step workflow
    rx = str(wd / "remmax")
    check(step("cli_remmax", lambda: cli.main(
        ["--device", "cuda", "remmax", pheno, prefix, "--out", rx,
         "--p-cut", "1e-5", "--num-random-pair", "100000",
         "--no-resume"])) == 0, "cli remmax: nonzero return")
    check(launches["cli_remmax"]["screen_count"] > 0
          and launches["cli_remmax"]["screen_extract"] > 0,
          f"cli remmax: screen launches {launches['cli_remmax']}")
    rx_var = np.loadtxt(rx + ".var")
    np.testing.assert_allclose(rx_var, var_com, rtol=1e-6,
                               err_msg="remmax variances vs the four-step")
    rows = ctx["approx_rows"]
    tab = np.loadtxt(rx + ".scan", skiprows=1, ndmin=2)
    with open(rx + ".scan") as f:
        check(f.readline().split() == ["snp_0", "snp_1", "eff", "var", "chi",
                                       "p_app", "p"], "remmax: .scan header")
    order = np.lexsort((tab[:, 1], tab[:, 0]))
    want = rows[np.lexsort((rows[:, 1], rows[:, 0]))]
    check(tab.shape == want.shape and np.array_equal(tab[order, :2],
                                                     want[:, :2]),
          f"remmax: {len(tab)} rows, the four-step table {len(want)}: "
          "not the same pairs")
    np.testing.assert_allclose(tab[order][:, [2, 3, 4, 6]],
                               want[:, [2, 3, 4, 6]], rtol=1e-6,
                               err_msg="remmax eff/var/chi/p vs the four-step")
    # p_app comes from the float32 screen's eff printed with %g
    np.testing.assert_allclose(tab[order, 5], want[:, 5], rtol=1e-4,
                               err_msg="remmax p_app vs the four-step")
    got = {(int(a), int(b)): max(pa, p) for a, b, *_, pa, p in tab}
    found = [pp for pp in ctx["planted"] if got.get(pp, 1.0) < 1e-5]
    check(len(found) >= 4, f"remmax: planted pairs found {found}")
    check((wd / "remmax.scan.anno").exists(), "remmax: no .scan.anno")
    with open(rx + ".timings.json") as f:
        rx_times = json.load(f)
    check(set(rx_times) == {"grm", "reml", "scan", "annotate"},
          f"remmax timings keys {sorted(rx_times)}")
    times["cli_remmax_stages"] = rx_times

    # 2. the command line's exact part, against remma_epiAA_parallel's file
    ex = str(wd / "cli_epiAA_parallel")
    check(step("cli_epiaa_parallel", lambda: cli.main(
        ["--device", "cuda", "epiaa", pheno, prefix, "--grm", "ag",
         "--grm", "ag*ag", "--var", str(wd / "var.txt"), "--p-cut", "1e-5",
         "--parallel", "100", "1", "--out", ex])) == 0,
          "cli epiaa: nonzero return")
    check(launches["cli_epiaa_parallel"]["exact_scan"] > 0,
          "cli epiaa --parallel never launched the exact-scan kernel")
    check((wd / "cli_epiAA_parallel.1").read_bytes()
          == (wd / "epiAA_parallel.1").read_bytes(),
          "cli epiaa --parallel 100 1: file differs from "
          "remma_epiAA_parallel([100, 1])'s")

    # 3. the array-level REML against the file-level one
    dm = design_matrix(pheno, prefix)
    arrays = (dm.y, dm.xmat, dm.z_dense())
    var_arr = step("array_wemai", lambda: G._wemai_multi_gmat(
        *arrays, gmat_lst), "gmat_tpu_torch.reml.wemai")
    np.testing.assert_allclose(var_arr, var_com, rtol=1e-8,
                               err_msg="_wemai_multi_gmat vs wemai_multi_gmat")
    args = arrays + (gmat_lst, var_com, prefix)

    # 4. the array-level AA screen against the file-level one, 64 anchors
    anchors = sorted(rng.choice(m - 1, size=64, replace=False).tolist())
    var_app = float(np.median(rows[:, 3]))
    arr_eff, file_eff = str(wd / "arr_epiAA_eff"), str(wd / "epiAA_eff64")
    step("array_epiAA_eff", lambda: G._remma_epiAA_eff(
        *args, snp_lst_0=anchors, var_app=var_app, p_cut=1e-3,
        out_file=arr_eff))
    step("file_epiAA_eff", lambda: G.remma_epiAA_eff(
        pheno, prefix, gmat_lst, var_com, snp_lst_0=anchors,
        var_app=var_app, p_cut=1e-3, out_file=file_eff))
    for name in ("array_epiAA_eff", "file_epiAA_eff"):
        screened(name, 1)
    eff_bytes = open(arr_eff, "rb").read()
    check(eff_bytes == open(file_eff, "rb").read(),
          "_remma_epiAA_eff: file differs from remma_epiAA_eff's")
    eff_rows = eff_bytes.count(b"\n") - 1
    check(eff_rows > 0, "_remma_epiAA_eff: no rows")

    # 5. the array-level AD part against the file-level one (rect K2)
    scan_log = MessageLog("Exact scan:")
    pairs_logger = logging.getLogger("gmat_tpu_torch.scan.pairs")
    level = pairs_logger.level
    pairs_logger.addHandler(scan_log)
    pairs_logger.setLevel(logging.INFO)
    try:
        arr_ad, file_ad = str(wd / "arr_epiAD"), str(wd / "file_epiAD")
        step("array_epiAD_parallel", lambda: G._remma_epiAD_parallel(
            *args, parallel=[100, 1], p_cut=1e-5, out_file=arr_ad))
        step("file_epiAD_parallel", lambda: G.remma_epiAD_parallel(
            pheno, prefix, gmat_lst, var_com, parallel=[100, 1], p_cut=1e-5,
            out_file=file_ad))
    finally:
        pairs_logger.removeHandler(scan_log)
        pairs_logger.setLevel(level)
    ad_anchors = balanced_anchor_split(m, 100, 1, triangular=False)
    for name in ("array_epiAD_parallel", "file_epiAD_parallel"):
        check(launches[name]["exact_scan"] > 0,
              f"{name} never launched the exact-scan kernel")
    rect = f"Exact scan: {len(ad_anchors)} anchors, {len(ad_anchors) * m} tests"
    check(len(scan_log.messages) == 2
          and all(s.startswith(rect) for s in scan_log.messages),
          f"_remma_epiAD_parallel: not the full rectangle: "
          f"{scan_log.messages}")
    ad_bytes = open(arr_ad + ".1", "rb").read()
    check(ad_bytes == open(file_ad + ".1", "rb").read(),
          "_remma_epiAD_parallel: file differs from remma_epiAD_parallel's")

    # 6. the legacy keep-all AD screen on 16 anchors against the f64 oracle
    keep = str(wd / "epiAD_eff_cpu")
    anchors16 = sorted(rng.choice(m - 1, size=16, replace=False).tolist())
    step("legacy_epiAD_eff_cpu_keep_all", lambda: remma_epiAD_eff_cpu(
        *args, snp_lst_0=anchors16, out_file=keep))
    screened("legacy_epiAD_eff_cpu_keep_all", 2)
    ka = pd.read_csv(keep, sep=" ")
    check(list(ka.columns) == ["snp_0", "snp_1", "eff"],
          f"remma_epiAD_eff_cpu: columns {list(ka.columns)}")
    dmc = design_matrix_cached(pheno, prefix)
    py = score_pieces_cached(dmc, gmat_lst, var_com).pymat
    g, _ = prepare_genotypes_device(prefix)
    a64, d64 = coded_matrix(g, "add"), coded_matrix(g, "dom")
    idx = torch.as_tensor(anchors16, device=g.device)
    # row (r0, r1) is A_r0·py·D_r1 in both sweeps: anchors on either side
    s_fwd = (a64[:, idx] * py[:, None]).T @ d64  # (16, m): rows (i, j)
    s_rev = (d64[:, idx] * py[:, None]).T @ a64  # rows (j, i)
    f_fwd = (a64[:, idx].abs() * py.abs()[:, None]).T @ d64.abs()
    f_rev = (d64[:, idx].abs() * py.abs()[:, None]).T @ a64.abs()
    r0, r1 = ka["snp_0"].to_numpy(), ka["snp_1"].to_numpy()
    fwd = np.isin(r0, anchors16) & (r1 > r0)
    rev = np.isin(r1, anchors16) & (r0 > r1)
    check(bool(np.all(fwd | rev)), "remma_epiAD_eff_cpu: a row of no anchor")
    pos = {a: k for k, a in enumerate(anchors16)}
    e64 = np.empty(len(ka))
    floor = np.empty(len(ka))
    for sel, s, f, anc, part in ((fwd, s_fwd, f_fwd, r0, r1),
                                 (rev, s_rev, f_rev, r1, r0)):
        k = np.array([pos[a] for a in anc[sel]], dtype=np.int64)
        e64[sel] = s.cpu().numpy()[k, part[sel]]
        floor[sel] = n * 2.0 ** -24 * f.cpu().numpy()[k, part[sel]]
    eff = ka["eff"].to_numpy()
    check(bool(np.all(np.abs(eff - e64) <= EFF_RTOL * np.abs(e64) + floor)),
          "remma_epiAD_eff_cpu: eff outside the f64 bracket")
    expect = {(a, j) for a in anchors16 for j in range(a + 1, m)}
    expect |= {(j, a) for a, j in expect}
    keys = list(zip(r0.tolist(), r1.tolist()))
    check(len(keys) == len(expect) and set(keys) == expect,
          f"remma_epiAD_eff_cpu: {len(keys)} rows, not the {len(expect)} "
          "pairs of its anchors in both orientations")
    keep_all = {"rows": len(ka), "anchors": len(anchors16)}

    # 7. simu_epistasis against a numpy float64 recomputation
    ratio, mean, res_var = [2.0, 1.0, 0.5, 0.5, 0.5, 1.0], 1.0, 1.0
    paths = seeded_effects(wd, m, rng)
    sim = str(wd / "sim")
    step("simu_epistasis", lambda: G.simu_epistasis(
        prefix, *paths, out_file=sim, seed=SEED))
    simulation_checks("simu_epistasis", paths, sim, simulate_numpy(
        prefix, paths, ratio, mean, res_var, SEED), n)

    # 8. the pedigree tools
    ped = step("pedigree", lambda: pedigree_checks(wd, rng))
    for name in ("array_wemai", "simu_epistasis", "pedigree"):
        check(not any(launches[name].values()),
              f"{name} launched a hand kernel: {launches[name]}")
    print(f"periphery: remmax {len(tab)} rows, _remma_epiAA_eff {eff_rows} "
          f"rows over 64 anchors, _remma_epiAD_parallel "
          f"{ad_bytes.count(bytes([10])) - 1} rows over "
          f"{len(ad_anchors)} anchors, keep-all {json.dumps(keep_all)}, "
          f"pedigree {json.dumps(ped)}", flush=True)
    return times, launches


MESH_WORKERS = 2  # processes of the gloo world in mesh_phase (c)


def same_bytes(name, path, want):
    """Fails unless the file `path` holds rows and the bytes of `want`."""
    got = Path(path).read_bytes()
    check(got.count(b"\n") > 1 and got == Path(want).read_bytes(),
          f"{name}: {path} differs from {want}")


def mesh_calls(K, ctx, mesh, single):
    """The mesh's calls on the yeast set, each with the launch counts set
    to 0 just before it and read just after: agmat (rtol 1e-10 against the
    four-step GRM), remma_epiAA_approx (the four-step table's bytes),
    remma_epiAD_maf_eff, remma_epiAA over the [100, 1] part's anchors in
    runs of at most 2^21 pairs (the part's file's bytes) and
    remma_epiAA_pair over the 100,000 calibration pairs (their file's
    bytes), each against the call without a mesh (`single`).  K1 and K2
    must launch the no-mesh count per shard (K2 once per run: two runs, on
    two shards or in two rounds of one).  Returns
    {call: {"s", "launches"}}."""
    import numpy as np
    import torch

    import gmat_tpu_torch as G
    from gmat_tpu_torch.scan import pairs as pairs_mod

    wd, shards = ctx["workdir"], mesh.size
    args = (ctx["pheno"], ctx["prefix"], ctx["gmat_lst"], ctx["var_com"])
    tag = f"mesh{shards}"
    out = {}

    def step(name, fn):
        for key in K.LAUNCHES:
            K.LAUNCHES[key] = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        out[name] = {"s": time.perf_counter() - t0,
                     "launches": dict(K.LAUNCHES)}
        return res

    kin, _ = step("agmat", lambda: G.agmat(ctx["prefix"], mesh=mesh))
    np.testing.assert_allclose(kin, ctx["gmat_lst"][0], rtol=1e-10,
                               atol=1e-12, err_msg=f"{tag} agmat")
    approx = str(wd / f"epiAA.{tag}")
    step("remma_epiAA_approx", lambda: G.remma_epiAA_approx(
        *args, p_cut=1e-5, num_random_pair=100000, out_file=approx,
        mesh=mesh))
    same_bytes(f"{tag} remma_epiAA_approx", approx, wd / "epiAA")
    ad = str(wd / f"epiAD_maf_eff.{tag}")
    step("remma_epiAD_maf_eff", lambda: G.remma_epiAD_maf_eff(
        *args, out_file=ad, mesh=mesh, **single["ad_kw"]))
    same_bytes(f"{tag} remma_epiAD_maf_eff", ad, single["ad_file"])
    scan = str(wd / f"epiAA_part.{tag}")
    budget = pairs_mod._SCAN_PAIR_BUDGET
    pairs_mod._SCAN_PAIR_BUDGET = 1 << 21  # 2 runs: one per shard
    try:
        step("remma_epiAA", lambda: G.remma_epiAA(
            *args, snp_lst_0=single["part_anchors"], p_cut=1e-5,
            out_file=scan, mesh=mesh))
    finally:
        pairs_mod._SCAN_PAIR_BUDGET = budget
    same_bytes(f"{tag} remma_epiAA", scan, wd / "epiAA_parallel.1")
    pair = str(wd / f"rp.res.{tag}")
    step("remma_epiAA_pair", lambda: G.remma_epiAA_pair(
        *args, str(wd / "rp"), p_cut=1.1, out_file=pair, mesh=mesh))
    same_bytes(f"{tag} remma_epiAA_pair", pair, wd / "rp.res")
    # K1: one count and one extract per sweep and shard; K2: one per run
    want = {"agmat": (0, 0), "remma_epiAA_approx": (shards, 0),
            "remma_epiAD_maf_eff": (2 * shards, 0), "remma_epiAA": (0, 2),
            "remma_epiAA_pair": (0, 0)}
    for name, (k1, k2) in want.items():
        got = out[name]["launches"]
        check(got == {"screen_count": k1, "screen_extract": k1,
                      "exact_scan": k2},
              f"{tag} {name}: launches {got}, want K1 {k1}, K2 {k2}")
    return out


def mesh_worker(argv):
    """One process of mesh_phase's gloo world on the one card (this script
    run as `chip_smoke.py --mesh-worker RANK WORLD PORT WORKDIR VAR_APP`):
    the sharded GRM (rank 0 saves it) and remma_epiAA_eff(mesh=) into
    WORKDIR/proc<RANK>/, with its launches and times in result.json."""
    import numpy as np
    import torch

    sys.path.insert(0, str(ROOT))
    from gmat_tpu_torch.dist import initialize_multihost, sharded_additive_grm
    from gmat_tpu_torch.scan import kernels as K
    from gmat_tpu_torch.scan.common import prepare_genotypes
    from gmat_tpu_torch.scan.screen import remma_epiAA_eff

    rank, world, port = (int(a) for a in argv[:3])
    wd, var_app = Path(argv[3]), float(argv[4])
    mesh = initialize_multihost(f"localhost:{port}", world, rank,
                                local_device_ids=["cuda:0"], backend="gloo")
    check(mesh.size == world and mesh.rank == rank, f"worker mesh {mesh}")
    out = wd / f"proc{rank}"
    out.mkdir()
    geno, _, _ = prepare_genotypes(str(wd / "plink"))
    ag = np.load(wd / "ag.npy")
    times = {}
    for key in K.LAUNCHES:
        K.LAUNCHES[key] = 0
    t0 = time.perf_counter()
    kin = sharded_additive_grm(geno, mesh)
    torch.cuda.synchronize()
    times["sharded_additive_grm"] = time.perf_counter() - t0
    if rank == 0:
        np.save(out / "kin.npy", kin.cpu().numpy())
    t0 = time.perf_counter()
    remma_epiAA_eff(str(wd / "pheno"), str(wd / "plink"), [ag, ag * ag],
                    np.loadtxt(wd / "var.txt"), var_app=var_app, p_cut=1e-5,
                    out_file=str(out / "epiAA_eff"), mesh=mesh)
    torch.cuda.synchronize()
    times["remma_epiAA_eff"] = time.perf_counter() - t0
    import torch.distributed as dist

    dist.destroy_process_group()
    (out / "result.json").write_text(json.dumps(
        {"launches": dict(K.LAUNCHES), "s": times}))


def gloo_world(K, ctx):
    """mesh_phase (c): MESH_WORKERS processes of this script, one shard
    each on the card, joined by gloo; the sharded GRM against the
    four-step GRM (rtol 1e-10) and remma_epiAA_eff(mesh=)'s file against a
    single run's bytes, one K1 sweep per process."""
    import socket

    import numpy as np
    import torch

    import gmat_tpu_torch as G

    wd = ctx["workdir"]
    np.save(wd / "ag.npy", ctx["gmat_lst"][0])
    var_app = float(np.median(ctx["approx_rows"][:, 3]))
    single = str(wd / "epiAA_eff.single")
    for key in K.LAUNCHES:
        K.LAUNCHES[key] = 0
    t0 = time.perf_counter()
    G.remma_epiAA_eff(ctx["pheno"], ctx["prefix"], ctx["gmat_lst"],
                      ctx["var_com"], var_app=var_app, p_cut=1e-5,
                      out_file=single)
    torch.cuda.synchronize()
    single_s = time.perf_counter() - t0
    check(K.LAUNCHES["screen_count"] == 1, f"single eff {K.LAUNCHES}")
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--mesh-worker",
         str(rank), str(MESH_WORKERS), str(port), str(wd), repr(var_app)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for rank in range(MESH_WORKERS)]
    deadline = time.monotonic() + 240
    try:
        logs = [p.communicate(timeout=max(1.0, deadline - time.monotonic()))[0]
                for p in procs]
    finally:
        for p in procs:
            p.kill()
            p.wait()
    wall = time.perf_counter() - t0
    for rank, (p, log) in enumerate(zip(procs, logs)):
        check(p.returncode == 0, f"gloo worker {rank} failed:\n{log}")
    kin = np.load(wd / "proc0" / "kin.npy")
    np.testing.assert_allclose(kin, ctx["gmat_lst"][0], rtol=1e-10,
                               atol=1e-12, err_msg="gloo sharded GRM")
    want = Path(single).read_bytes()
    check(want.count(b"\n") > 1, "single remma_epiAA_eff: no rows")
    res = []
    for rank in range(MESH_WORKERS):
        proc = wd / f"proc{rank}"
        check((proc / "epiAA_eff").read_bytes() == want,
              f"gloo remma_epiAA_eff (process {rank}) differs from a single "
              "run's file")
        res.append(json.loads((proc / "result.json").read_text()))
        check(res[-1]["launches"] == {"screen_count": 1, "screen_extract": 1,
                                      "exact_scan": 0},
              f"gloo process {rank}: launches {res[-1]['launches']}")
    return {"processes": MESH_WORKERS, "wall_s": wall,
            "remma_epiAA_eff_single_s": single_s,
            "rows": want.count(b"\n") - 1, "per_process": res}


def shard_kernel_ms(K, ctx):
    """K1 on the yeast set's AA screen, by CUDA events (median of 3): one
    device's identity sweep against the two halves of a 2-shard mesh, the
    anchors 0::2 and 1::2 gathered into panels (the general path)."""
    import numpy as np
    import torch
    from scipy.stats import chi2

    from gmat_tpu_torch.scan.common import (coded_matrix,
                                            design_matrix_cached,
                                            prepare_genotypes_device,
                                            score_pieces_cached)

    m = YEAST[1]
    g, _ = prepare_genotypes_device(ctx["prefix"])
    a = coded_matrix(g, "add", torch.float32)
    dm = design_matrix_cached(ctx["pheno"], ctx["prefix"])
    py = score_pieces_cached(dm, ctx["gmat_lst"], ctx["var_com"]).pymat.to(
        torch.float32).contiguous()
    cut = float(np.sqrt(chi2.isf(1e-5, 1)
                        * np.median(ctx["approx_rows"][:, 3])))
    anchors = torch.arange(m - 1)
    out = {}
    for name, anc in (("one_device", None), ("shard0", anchors[0::2]),
                      ("shard1", anchors[1::2])):
        panel, ids = K.anchor_panel(a, anc, m)
        b = None if ids is None else a
        count_ms, extract_ms = [], []
        for _ in range(3):
            counts, ms = timed(lambda: K.screen_counts(panel, py, cut, m, b=b,
                                                       ids=ids))
            count_ms.append(ms)
            _, ms = timed(lambda: K.screen_extract(panel, py, cut, m, counts,
                                                   b=b, ids=ids))
            extract_ms.append(ms)
        out[name] = {"anchors": m - 1 if ids is None else len(ids),
                     "tiles": int(torch.count_nonzero(counts)),
                     "hits": int(counts.sum()),
                     "count_ms": float(np.median(count_ms)),
                     "extract_ms": float(np.median(extract_ms))}
    check(out["shard0"]["hits"] + out["shard1"]["hits"]
          == out["one_device"]["hits"], f"K1 halves vs one device: {out}")
    return out


def mesh_phase(K, ctx):
    """The device mesh on the yeast set: (a) two virtual shards of the
    card, (b) every visible card (`make_mesh()`), each through
    `mesh_calls` against the calls without a mesh, K1's halves beside one
    device's sweep (`shard_kernel_ms`); (c) `gloo_world`.  Returns the
    `mesh` line's record."""
    import numpy as np
    import torch

    import gmat_tpu_torch as G
    from gmat_tpu_torch.dist import make_mesh
    from gmat_tpu_torch.scan.common import prepare_genotypes
    from gmat_tpu_torch.scan.pairs import balanced_anchor_split
    from gmat_tpu_torch.scan.screen import _het_bins, _maf_bins

    wd, m = ctx["workdir"], YEAST[1]
    args = (ctx["pheno"], ctx["prefix"], ctx["gmat_lst"], ctx["var_com"])
    geno, _, _ = prepare_genotypes(ctx["prefix"])
    deno = np.ones(111)
    for k1, k2, v in np.loadtxt(wd / "remma_epiAD_maf_approx"
                                ".freq_denominator", ndmin=2):
        deno[int(k1) * 10 + int(k2)] = v
    single = {"ad_kw": {"freqA": _maf_bins(geno)[1],
                        "freqD": _het_bins(geno)[1], "freq_deno": deno,
                        "p_cut": 1e-5},
              "ad_file": str(wd / "epiAD_maf_eff.single"),
              "part_anchors": balanced_anchor_split(m, 100, 1)}
    # the calls without a mesh that the four-step and the exhaustive part
    # did not already make
    no_mesh = {}
    for name, fn in (
            ("remma_epiAD_maf_eff", lambda: G.remma_epiAD_maf_eff(
                *args, out_file=single["ad_file"], **single["ad_kw"])),
            ("remma_epiAA_approx", lambda: G.remma_epiAA_approx(
                *args, p_cut=1e-5, num_random_pair=100000,
                out_file=str(wd / "epiAA.again")))):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        no_mesh[name] = time.perf_counter() - t0
    check((wd / "epiAA.again").read_bytes() == (wd / "epiAA").read_bytes(),
          "remma_epiAA_approx: a second run differs from the four-step's")
    record = {"no_mesh_s": no_mesh}
    for tag, mesh in (("two_virtual_shards",
                       make_mesh(devices=["cuda:0", "cuda:0"])),
                      ("all_devices", make_mesh())):
        t0 = time.perf_counter()
        record[tag] = {"shards": mesh.size,
                       "calls": mesh_calls(K, ctx, mesh, single)}
        record[tag]["wall_s"] = time.perf_counter() - t0
    record["k1_ms"] = shard_kernel_ms(K, ctx)
    t0 = time.perf_counter()
    record["gloo_world"] = gloo_world(K, ctx)
    record["gloo_world"]["phase_s"] = time.perf_counter() - t0
    return record


# the entry points that only CPU tests held before ----------------------------

SELECT_SHAPE = (32, 2000)  # anchors x partners of each legacy _select_cpu call
EPI_MOUSE_P = 1e-2  # p_cut of the whole mouse uvlmm_gwas_epiAA


def hold_anchors(K, name, mat, pieces, anchors, crit, center, tab, m):
    """The exact-scan kernel over `anchors` x the partners above them
    against its plain version (`exact_compare`), both timed once by CUDA
    events, and the rows of those anchors in the entry point's table `tab`
    (snp_0 snp_1 eff chi p_val, read from its file) against the kernel's:
    the same pairs in the same order, eff and chi to the last bits (each
    pair is computed alone).  Returns the comparison's record."""
    import numpy as np
    import torch

    a_t = torch.as_tensor(np.asarray(anchors), device="cuda")
    args = (mat, mat, pieces.pymat, pieces.pvpmat, a_t, crit, "tri", center)
    got, ms = timed(lambda: K.exact_hits(*args))
    want, plain_ms = timed(lambda: K.exact_hits_ref(*args))
    common, err = exact_compare(name, got, want, crit, m)
    i, j, eff, _, chi = (t.cpu().numpy() for t in got)
    rows = tab[np.isin(tab[:, 0], np.asarray(anchors))]
    check(len(rows) == len(i) and np.array_equal(rows[:, 0], i)
          and np.array_equal(rows[:, 1], j),
          f"{name}: the table's rows of its anchors are not the kernel's")
    np.testing.assert_allclose(rows[:, 2:4], np.stack([eff, chi], 1),
                               rtol=1e-15, err_msg=f"{name}: table values")
    pairs = K.exact_pair_count(a_t, m, "tri")
    return {"anchors": len(anchors), "pairs": pairs, "hits": len(i),
            "common": common, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms}


def scan_table(name, path):
    """The `snp_0 snp_1 eff chi p_val` table of an exhaustive scan's file,
    (rows, columns), after its header is checked."""
    import numpy as np

    with open(path) as f:
        head = f.readline().split()
    check(head == ["snp_0", "snp_1", "eff", "chi", "p_val"],
          f"{name}: header {head}")
    return np.loadtxt(path, skiprows=1, ndmin=2).reshape(-1, 5)


def whole_triangle(K, ctx, step):
    """remma_epiAA over every anchor of the yeast set (398,170,090 pairs):
    K2 launched once per anchor run of `_scan_anchors`; the rows sorted
    with p_val in [0, 1e-5); the planted pairs; part 1 of 100's rows equal
    to `epiAA_parallel.1`'s lines; the approx table's pairs past the
    threshold present (and those below it absent) with eff, var and chi
    at EXACT_RTOL, apart from the pairs within crit·(1 ± EXACT_BAND); the
    middle anchor run and the last (the triangle's ragged end) held
    against the plain version.  Returns the `epiAA whole-triangle` record,
    with the approx pipeline's recall of this exhaustive table."""
    import numpy as np
    import torch
    from scipy.stats import chi2

    import gmat_tpu_torch as G
    from gmat_tpu_torch.scan import pairs as pairs_mod
    from gmat_tpu_torch.scan.common import (coded_matrix,
                                            design_matrix_cached,
                                            prepare_genotypes_device,
                                            score_pieces_cached)

    m = YEAST[1]
    wd, name = ctx["workdir"], "remma_epiAA[whole triangle]"
    out = str(wd / "epiAA_whole")
    step(name, lambda: G.remma_epiAA(
        ctx["pheno"], ctx["prefix"], ctx["gmat_lst"], ctx["var_com"],
        p_cut=1e-5, out_file=out))
    anchors = np.arange(m - 1)
    per = K.pairs_per_anchor(torch.from_numpy(anchors), m, "tri").numpy()
    runs = list(pairs_mod._anchor_runs(anchors, per,
                                       pairs_mod._SCAN_PAIR_BUDGET))
    pairs = int(per.sum())
    check(pairs == 398170090, f"{pairs} pairs in the triangle")
    check(ctx["launches"][name] == {"screen_count": 0, "screen_extract": 0,
                                    "exact_scan": len(runs)},
          f"{name}: launches {ctx['launches'][name]}, want K2 {len(runs)}")
    tab = scan_table(name, out)
    i, j = tab[:, 0].astype(np.int64), tab[:, 1].astype(np.int64)
    keys = i * m + j
    check(len(tab) > 0 and bool(np.all(j > i))
          and bool(np.all(np.diff(keys) > 0)),
          f"{name}: rows not anchors ascending, partners above them")
    check(bool(np.all((tab[:, 4] >= 0) & (tab[:, 4] < 1e-5))),
          f"{name}: p_val outside [0, 1e-5)")
    found = set(zip(i.tolist(), j.tolist()))
    check(set(ctx["planted"]) <= found, f"{name}: planted pairs "
          f"{sorted(set(ctx['planted']) - found)} missing")

    # part 1 of 100, the exhaustive part's file
    part = set(pairs_mod.balanced_anchor_split(m, 100, 1))
    with open(out) as f:
        lines = f.read().splitlines()[1:]
    mine = [ln for ln, a in zip(lines, i) if a in part]
    with open(wd / "epiAA_parallel.1") as f:
        want = f.read().splitlines()[1:]
    check(len(mine) == len(want) and set(mine) == set(want),
          f"{name}: {len(mine)} rows of part 1's anchors, "
          f"epiAA_parallel.1 has {len(want)}: not the same lines")

    # the approx table: its pairs past the threshold, not those below it
    crit = float(chi2.isf(1e-5, 1))
    rows = ctx["approx_rows"]
    akeys = rows[:, 0].astype(np.int64) * m + rows[:, 1].astype(np.int64)
    pos = np.minimum(np.searchsorted(keys, akeys), len(keys) - 1)
    present = keys[pos] == akeys
    near = np.abs(rows[:, 4] - crit) <= EXACT_BAND * crit
    above, below = (rows[:, 4] > crit) & ~near, (rows[:, 4] < crit) & ~near
    check(bool(np.all(present[above])) and not present[below].any(),
          f"{name}: {int((above & ~present).sum())} approx pairs past the "
          f"threshold missing, {int((below & present).sum())} below it "
          "present")
    hit = tab[pos[above]]
    for col, got in (("eff", hit[:, 2]), ("var", hit[:, 2] ** 2 / hit[:, 3]),
                     ("chi", hit[:, 3])):
        k = {"eff": 2, "var": 3, "chi": 4}[col]
        np.testing.assert_allclose(got, rows[above, k], rtol=EXACT_RTOL,
                                   err_msg=f"{name} vs approx {col}")
    approx_hits = set(akeys[rows[:, 6] < 1e-5].tolist())
    common = len(approx_hits & set(keys.tolist()))

    # two anchor runs against the plain version
    dm = design_matrix_cached(ctx["pheno"], ctx["prefix"])
    pieces = score_pieces_cached(dm, ctx["gmat_lst"], ctx["var_com"])
    g, _ = prepare_genotypes_device(ctx["prefix"])
    mat = coded_matrix(g, "add")
    held = {tag: hold_anchors(K, f"{name} {tag} run", mat, pieces, run, crit,
                              pairs_mod._has_intercept(dm), tab, m)
            for tag, run in (("middle", runs[len(runs) // 2]),
                             ("last", runs[-1]))}
    wall = ctx["times"][name]
    return {"anchors": len(anchors), "pairs": pairs, "runs": len(runs),
            "wall_s": wall, "pairs_per_s": pairs / wall, "hits": len(tab),
            "approx_rows_past_threshold": int(above.sum()),
            "approx_hits": len(approx_hits), "approx_hits_in_table": common,
            "approx_recall": common / len(tab), "held": held}


def dd_part(K, ctx, step):
    """remma_epiDD_parallel([100, 1]) on K2: its file byte-equal to
    remma_epiDD over the part's anchors, 16 of its anchors held against
    the plain version.  Returns the comparison's record."""
    import numpy as np
    from scipy.stats import chi2

    import gmat_tpu_torch as G
    from gmat_tpu_torch.scan.common import (coded_matrix,
                                            design_matrix_cached,
                                            prepare_genotypes_device,
                                            score_pieces_cached)
    from gmat_tpu_torch.scan.pairs import (_has_intercept,
                                           balanced_anchor_split)

    m, wd = YEAST[1], ctx["workdir"]
    args = (ctx["pheno"], ctx["prefix"], ctx["gmat_lst"], ctx["var_com"])
    part, whole = str(wd / "epiDD_parallel"), str(wd / "epiDD_part")
    anchors = balanced_anchor_split(m, 100, 1)
    step("remma_epiDD_parallel", lambda: G.remma_epiDD_parallel(
        *args, parallel=[100, 1], p_cut=1e-5, out_file=part))
    step("remma_epiDD[part anchors]", lambda: G.remma_epiDD(
        *args, snp_lst_0=anchors, p_cut=1e-5, out_file=whole))
    for name in ("remma_epiDD_parallel", "remma_epiDD[part anchors]"):
        check(ctx["launches"][name] == {"screen_count": 0,
                                        "screen_extract": 0, "exact_scan": 1},
              f"{name}: launches {ctx['launches'][name]}, want K2 1")
    same_bytes("remma_epiDD_parallel([100, 1])", part + ".1", whole)
    tab = scan_table("remma_epiDD_parallel", part + ".1")
    check(bool(np.all((tab[:, 4] >= 0) & (tab[:, 4] < 1e-5))),
          "remma_epiDD_parallel: p_val outside [0, 1e-5)")
    pick = set(np.random.default_rng(SEED + 9).choice(
        anchors, 16, replace=False).tolist())
    dm = design_matrix_cached(ctx["pheno"], ctx["prefix"])
    g, _ = prepare_genotypes_device(ctx["prefix"])
    held = hold_anchors(
        K, "remma_epiDD_parallel 16 anchors", coded_matrix(g, "dom"),
        score_pieces_cached(dm, ctx["gmat_lst"], ctx["var_com"]),
        [a for a in anchors if a in pick], float(chi2.isf(1e-5, 1)),
        _has_intercept(dm), tab, m)
    return {"anchors": len(anchors), "rows": len(tab), "held": held}


def maf_eff_parts(ctx, step):
    """remma_epi{AA,AD,DD}_maf_eff_parallel([100, 1]) on K1's general path
    against the full remma_epi*_maf_eff table under the same bins and cut
    table (AA and AD: the maf approx runs' denominators; DD: the DD approx
    run's var_app in every bin): the part's lines are the full table's
    lines of its anchors, byte for byte.  Returns {kind: rows}."""
    import numpy as np
    from scipy.stats import chi2

    import gmat_tpu_torch as G
    from gmat_tpu_torch.scan.common import prepare_genotypes
    from gmat_tpu_torch.scan.screen import (_het_bins, _maf_bins,
                                            _parallel_anchor_split)

    wd = ctx["workdir"]
    args = (ctx["pheno"], ctx["prefix"], ctx["gmat_lst"], ctx["var_com"])
    geno, _, _ = prepare_genotypes(ctx["prefix"])
    maf, het = _maf_bins(geno)[1], _het_bins(geno)[1]

    def deno_of(path):
        deno = np.ones(111)
        for k1, k2, v in np.loadtxt(path, ndmin=2):
            deno[int(k1) * 10 + int(k2)] = v
        return deno

    dd = np.loadtxt(wd / "remma_epiDD_approx", skiprows=1, ndmin=2)
    var_dd = float(np.median(dd[:, 2] ** 2 / chi2.isf(dd[:, 5], 1)))
    kws = {
        "AA": ({"freq": maf}, deno_of(wd / "remma_epiAA_maf_approx"
                                            ".freq_denominator"), 1),
        "AD": ({"freqA": maf, "freqD": het},
               deno_of(wd / "remma_epiAD_maf_approx.freq_denominator"), 2),
        "DD": ({"freq": het}, np.full(111, var_dd), 1)}
    record = {}
    for kind, (bins, deno, sweeps) in kws.items():
        full = str(wd / f"epi{kind}_maf_eff")
        part = str(wd / f"epi{kind}_maf_eff_parallel")
        kw = dict(bins, freq_deno=deno, p_cut=1e-5)
        for name, call in (
                (f"remma_epi{kind}_maf_eff", lambda: getattr(
                    G, f"remma_epi{kind}_maf_eff")(*args, out_file=full,
                                                   **kw)),
                (f"remma_epi{kind}_maf_eff_parallel", lambda: getattr(
                    G, f"remma_epi{kind}_maf_eff_parallel")(
                        *args, parallel=[100, 1], out_file=part, **kw))):
            step(name, call)
            check(ctx["launches"][name] == {"screen_count": sweeps,
                                            "screen_extract": sweeps,
                                            "exact_scan": 0},
                  f"{name}: launches {ctx['launches'][name]}, want "
                  f"{sweeps} sweep(s)")
        anchors = set(_parallel_anchor_split(kind, ctx["prefix"], [100, 1],
                                             maf=True))
        with open(full) as f:
            head = f.readline()
            lines = f.read().splitlines()
        # the flipped AD sweep writes (partner, anchor): the anchor is the
        # smaller id in every row
        want = [ln for ln in lines
                if min(map(int, ln.split()[:2])) in anchors]
        with open(part + ".1") as f:
            check(f.readline() == head, f"epi{kind}_maf_eff_parallel: header")
            got = f.read().splitlines()
        check(len(want) > 0 and got == want,
              f"remma_epi{kind}_maf_eff_parallel([100, 1]): {len(got)} "
              f"rows, the full table has {len(want)} for its anchors")
        record[kind] = {"rows": len(lines), "part_rows": len(got),
                        "anchors": len(anchors)}
    return record


def mouse_epiAA(ctx, step):
    """uvlmm_gwas_epiAA on the mouse set (1304 x 1407, 989,121 pairs):
    the golden's 40 picked SNPs (tests/golden/uvlmm_extras.npz) at
    tests/test_uvlmm_extras.py's tolerances; the whole panel at p_cut
    `EPI_MOUSE_P`: rows below it, anchors ascending, the golden's pairs
    below it present with the golden's values, 16 rows against a direct
    f64 GLS fit.  Returns the comparison's record."""
    import numpy as np
    import torch
    from scipy.stats import chi2

    import gmat_tpu_torch as G
    from gmat_tpu_torch.core.coding import additive_code
    from gmat_tpu_torch.grm.grm import additive_grm
    from gmat_tpu_torch.io.bed import Bed, write_bed
    from gmat_tpu_torch.io.pheno import design_matrix

    dev, wd = torch.device("cuda"), ctx["workdir"]
    prefix = str(MOUSE / "plink")
    gold = np.load(GOLD / "uvlmm_extras.npz")
    picked, var, want = gold["picked"], gold["var_2g"], gold["epi"]
    dm = design_matrix(str(MOUSE / "pheno"), prefix)
    geno = G.read_plink(prefix)
    g_d = torch.as_tensor(geno, device=dev)
    ag_d = additive_grm(g_d)
    ag = ag_d.cpu().numpy()
    bed = Bed(prefix)
    sub = str(wd / "mouse_picked")
    write_bed(sub, geno[:, picked], bim=bed.bim.iloc[picked], fam=bed.fam)
    res = step("uvlmm_gwas_epiAA[mouse, 40 picked]", lambda: G.uvlmm_gwas_epiAA(
        dm.y, dm.xmat, [ag, ag * ag], var, sub))
    check(len(res) == len(want)
          and np.array_equal(res["snpi"].to_numpy(), want[:, 0])
          and np.array_equal(res["snpj"].to_numpy(), want[:, 1]),
          "uvlmm_gwas_epiAA on the 40 picked SNPs: not the golden's pairs")
    close("uvlmm_gwas_epiAA picked eff", res["snp_eff"], want[:, 2], 1e-6,
          atol=1e-10)
    close("uvlmm_gwas_epiAA picked p", res["p_val"], want[:, 3], 1e-5,
          atol=1e-12)

    name = "uvlmm_gwas_epiAA[mouse]"
    epi = step(name, lambda: G.uvlmm_gwas_epiAA(
        dm.y, dm.xmat, [ag, ag * ag], var, prefix, p_cut=EPI_MOUSE_P,
        out_file=str(wd / "uvlmm_epiAA_mouse")))
    m = MOUSE_M
    ii, jj = epi["snpi"].to_numpy(), epi["snpj"].to_numpy()
    p = epi["p_val"].to_numpy()
    check(len(epi) > 0 and bool(np.all(jj > ii))
          and bool(np.all(np.diff(ii * m + jj) > 0)),
          f"{name}: rows not anchors ascending, partners above them")
    check(bool(np.all((p >= 0) & (p < EPI_MOUSE_P))),
          f"{name}: p_val outside [0, {EPI_MOUSE_P:g})")
    keys = ii * m + jj
    gsel = want[:, 3] < EPI_MOUSE_P
    gkeys = (picked[want[gsel, 0].astype(np.int64)] * m
             + picked[want[gsel, 1].astype(np.int64)])
    pos = np.minimum(np.searchsorted(keys, gkeys), len(keys) - 1)
    check(bool(np.all(keys[pos] == gkeys)),
          f"{name}: the golden's pairs below p_cut missing")
    close(f"{name} golden eff", epi["snp_eff"].to_numpy()[pos],
          want[gsel, 2], 1e-6, atol=1e-10)
    close(f"{name} golden p", p[pos], want[gsel, 3], 1e-5, atol=1e-12)
    pick = np.sort(np.random.default_rng(SEED + 10).choice(
        len(epi), min(16, len(epi)), replace=False))
    mat_a = additive_code(g_d)[0]
    si = mat_a[:, torch.as_tensor(ii[pick], device=dev)].T[..., None]
    sj = mat_a[:, torch.as_tensor(jj[pick], device=dev)].T[..., None]
    n = g_d.shape[0]
    vmat = (var[0] * ag_d + var[1] * ag_d * ag_d
            + var[2] * torch.eye(n, dtype=torch.float64, device=dev))
    x_d = torch.as_tensor(dm.xmat, device=dev)
    eff, v = gls_last(torch.linalg.lu_factor(vmat),
                      torch.cat([x_d.expand(len(pick), -1, -1), si, sj,
                                 si * sj], dim=2),
                      torch.as_tensor(dm.y, device=dev))
    close(f"{name} vs GLS eff", epi["snp_eff"].to_numpy()[pick], eff.cpu(),
          UVLMM_RTOL)
    close(f"{name} vs GLS p", p[pick],
          chi2.sf((eff * eff / v).cpu().numpy(), 1), UVLMM_RTOL)
    return {"pairs": m * (m - 1) // 2, "rows": len(epi),
            "golden_rows_below_p_cut": int(gsel.sum())}


def select_calls(ctx, step):
    """The legacy remma_epi{AA,AD,DD}_select_cpu on the design's
    (y, X, Z) (`scan/legacy.py::_as_dm`), 32 seeded anchors x 2,000 seeded
    partners, each row's eff, var, chi and p against the same pair's row
    of remma_epi*_pair at EXACT_RTOL.  Returns {kind: rows}."""
    import numpy as np

    import gmat_tpu_torch as G
    from gmat_tpu_torch.io.pheno import design_matrix
    from gmat_tpu_torch.scan import legacy

    m, wd = YEAST[1], ctx["workdir"]
    dm = design_matrix(ctx["pheno"], ctx["prefix"])
    arrays = (dm.y, dm.xmat, dm.z_dense())
    rng = np.random.default_rng(SEED + 11)
    anchors = sorted(rng.choice(m, SELECT_SHAPE[0], replace=False).tolist())
    partners = sorted(rng.choice(m, SELECT_SHAPE[1], replace=False).tolist())
    pair_file = str(wd / "select_pairs")
    with open(pair_file, "w") as f:
        f.write("snp_0 snp_1\n")
        f.writelines(f"{a} {j}\n" for a in anchors for j in partners
                     if j != a)
    record = {}
    for kind in ("AA", "AD", "DD"):
        sel, ref = str(wd / f"select_{kind}"), str(wd / f"select_{kind}.pair")
        step(f"remma_epi{kind}_select_cpu", lambda: getattr(
            legacy, f"remma_epi{kind}_select_cpu")(
                *arrays, ctx["gmat_lst"], ctx["var_com"], ctx["prefix"],
                snp_lst_0=anchors, snp_lst_1=partners, out_file=sel))
        step(f"remma_epi{kind}_pair[select pairs]", lambda: getattr(
            G, f"remma_epi{kind}_pair")(
                ctx["pheno"], ctx["prefix"], ctx["gmat_lst"],
                ctx["var_com"], pair_file, p_cut=1.1, out_file=ref))
        got = np.loadtxt(sel, skiprows=1, ndmin=2)
        want = np.loadtxt(ref, skiprows=1, ndmin=2)
        gk = got[:, 0].astype(np.int64) * m + got[:, 1].astype(np.int64)
        wk = want[:, 0].astype(np.int64) * m + want[:, 1].astype(np.int64)
        # select keeps p < 1: every pair of the list but those with p = 1
        check(len(got) > 0 and set(gk.tolist()) == set(wk[want[:, 5] < 1.0]
                                                      .tolist()),
              f"remma_epi{kind}_select_cpu: {len(got)} rows, not the pairs "
              "of its lists")
        order = np.argsort(wk)
        w = want[order[np.searchsorted(wk[order], gk)]]
        for k, col in ((2, "eff"), (3, "var"), (4, "chi"), (5, "p")):
            close(f"remma_epi{kind}_select_cpu {col}", got[:, k], w[:, k],
                  EXACT_RTOL, floor=1e-12)
        record[kind] = len(got)
    return record


def coverage_phase(K, ctx):
    """The entry points that only CPU tests held before, on the yeast set
    that `main_path` wrote (and the mouse set for uvlmm_gwas_epiAA), each
    call with the launch counts set to 0 just before it and read just
    after: (a) the whole AA triangle through remma_epiAA, (b)
    remma_epiDD_parallel, (c) remma_epi{AA,AD,DD}_maf_eff_parallel, (d)
    uvlmm_gwas_epiAA on the mouse set, (e) the legacy
    remma_epi{AA,AD,DD}_select_cpu, (f) simu_epistasis_freq against
    numpy.  Returns (step times, launches, record)."""
    import numpy as np

    import gmat_tpu_torch as G

    times, launches = {}, {}
    ctx = dict(ctx, times=times, launches=launches)
    step = partial(counted_step, K, times, launches)

    record = {"whole_triangle": whole_triangle(K, ctx, step),
              "dd_part": dd_part(K, ctx, step),
              "maf_eff_parts": maf_eff_parts(ctx, step),
              "mouse_epiAA": mouse_epiAA(ctx, step),
              "select_cpu": select_calls(ctx, step)}

    n, m = YEAST
    wd = ctx["workdir"] / "freq"
    wd.mkdir()
    ratio, mean, res_var = [2.0, 1.0, 0.5, 0.5, 0.5, 1.0], 1.0, 1.0
    paths = seeded_effects(wd, m, np.random.default_rng(SEED + 12))
    sim = str(wd / "sim")
    step("simu_epistasis_freq", lambda: G.simu_epistasis_freq(
        ctx["prefix"], *paths, out_file=sim, seed=SEED))
    simulation_checks("simu_epistasis_freq", paths, sim, simulate_numpy(
        ctx["prefix"], paths, ratio, mean, res_var, SEED, freq_based=True), n)
    for name in ("simu_epistasis_freq", "uvlmm_gwas_epiAA[mouse]",
                 "uvlmm_gwas_epiAA[mouse, 40 picked]") + tuple(
                     f"remma_epi{k}_select_cpu" for k in ("AA", "AD", "DD")):
        check(not any(launches[name].values()),
              f"{name} launched a hand kernel: {launches[name]}")
    return times, launches, record


BENCH_EXTRA = (  # bench.py's `extra` keys, in its order
    "screen_hits", "screen_gemm_ceiling_pairs_per_s",
    "yeast_screen_pairs_per_s", "yeast_screen_hits",
    "exact_scan_pairs_per_s", "exact_scan_tflops", "reml_mixed_iter_s",
    "reml_cpu_f64_iter_s", "reml_mixed_speedup", "bigpanel_pairs_per_s",
    "bigpanel_hits", "bigpanel_peak_hbm_gib", "longwas_fixed_snps_per_s",
    "longwas_trans_snps_per_s", "yeast_approx_end_to_end_s",
    "yeast_approx_rows", "yeast_approx_stages", "yeast_approx_warm_s")


def screen_kernel_ms(K, mat, py, cut, reps):
    """The identity screen's count and extract kernels on `mat` at `cut`,
    timed by CUDA events (the median of `reps` calls after a warm-up; for
    reps=1 the first call's time), with their 3xTF32 bounds (kernel_case's
    counts: the panel and py read once, the grid and the hits written
    once)."""
    import torch

    from gmat_tpu_torch.probe import cuda_ms

    n, m = mat.shape
    counts, count_ms = timed(lambda: K.screen_counts(mat, py, cut, m))
    _, extract_ms = timed(lambda: K.screen_extract(mat, py, cut, m, counts))
    if reps > 1:
        count_ms = cuda_ms(lambda: K.screen_counts(mat, py, cut, m), reps)
        extract_ms = cuda_ms(lambda: K.screen_extract(mat, py, cut, m,
                                                      counts), reps)
    tiles = torch.nonzero(counts).to(torch.int32)
    hits = int(counts.sum())
    in_bytes = 4 * (n * m + n)
    count = bound(3 * 2.0 * n * (m * (m - 1) // 2),
                  in_bytes + 4 * counts.numel(), TF32_PEAK)
    extract = bound(3 * 2.0 * n * tile_pairs(tiles, m, K.TILE),
                    in_bytes + 8 * len(tiles) + 12 * hits, TF32_PEAK)
    return {"n": n, "m": m, "hits": hits, "hot_tiles": len(tiles),
            "count_ms": count_ms, "count_bound_ms": count[0],
            "count_bound_by": count[1], "extract_ms": extract_ms,
            "extract_bound_ms": extract[0], "extract_bound_by": extract[1]}


def screen_checks(K, name, mat, py, hits, reps):
    """A screen's hits from the bench's run, `hits` = {i, j, eff, cut} host
    arrays, against the card on the same panel: the hit set inside the
    float64 bracket cut·(1 ± BAND) and equal to the plain float32 version's
    outside it, and each eff within BAND·cut of its float64 value (one
    float64 pass of the plain version, whose hull holds every hit).
    Returns the kernels' times at this shape (`screen_kernel_ms`) and the
    plain version's."""
    import numpy as np
    import torch

    m, cut = mat.shape[1], hits["cut"]
    block = 1 << 28  # scores of one anchor-row block of the plain version

    def keys(a, b):
        return (a.long() * m + b.long()).cpu().numpy()

    (pi, pj, _), plain_ms = timed(
        lambda: K.screen_hits_ref(mat, py, cut, m, block))
    plain = keys(pi, pj)
    del pi, pj
    hi, hj, he = K.screen_hits_ref(mat.double(), py.double(),
                                   cut * (1 - BAND), m, block)
    hull, he = keys(hi, hj), he.cpu().numpy()
    del hi, hj
    torch.cuda.empty_cache()
    core = hull[np.abs(he) > cut * (1 + BAND)]
    got = np.asarray(hits["i"], dtype=np.int64) * m + hits["j"]
    check(np.isin(got, hull).all() and np.isin(core, got).all(),
          f"{name} screen: hits outside the float64 bracket")
    order = np.argsort(hull)
    f64 = he[order[np.searchsorted(hull, got, sorter=order)]]
    eff_err = float(np.abs(hits["eff"] - f64).max()) if len(got) else 0.0
    check(eff_err <= BAND * cut, f"{name} screen: eff off float64 by "
          f"{eff_err:.3g} > {BAND} x cut {cut:.4g}")
    bracket = np.setdiff1d(hull, core)
    outside = (np.setdiff1d(got, bracket), np.setdiff1d(plain, bracket))
    check(np.array_equal(*outside), f"{name} screen: hits differ from the "
          "plain version's outside the bracket")
    out = screen_kernel_ms(K, mat, py, cut, reps)
    out.update(plain_screen_ms=plain_ms, eff_max_abs_err=eff_err,
               plain_hits=len(plain), f64_core=len(core), f64_hull=len(hull))
    return out


def bench_phase(K):
    """The headline benchmark at bench.py's sizes through `gmat-tpu-torch
    bench`, in this process: one JSON line of bench.py's shape, every key
    set; K1 launched in the three screen sections and K2 in the exact
    scan; the production and big-panel hits against float64 and the plain
    version (`screen_checks`), with the screen kernels timed at both shapes
    (median of 3 at the production shape, one call each at the big panel);
    the exact-scan kernel at the bench's exact inputs timed
    (`exact_timing`) and held pair by pair against its plain version at
    the bench's threshold and keeping every pair.  Returns the bench's line
    and the kernels' record."""
    import contextlib
    import io

    import numpy as np
    import torch

    from gmat_tpu_torch import bench
    from gmat_tpu_torch.cli import main as cli_main

    for key in K.LAUNCHES:
        K.LAUNCHES[key] = 0
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = cli_main(["bench"])
    wall = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    lines = out.getvalue().strip().splitlines()
    check(rc == 0 and len(lines) == 1,
          f"gmat-tpu-torch bench: rc {rc}, {len(lines)} lines")
    print(f"bench {lines[0]}", flush=True)
    line = json.loads(lines[0])
    check(set(line) == {"metric", "value", "unit", "vs_baseline", "extra"}
          and list(line["extra"]) == list(BENCH_EXTRA),
          f"bench line keys: {sorted(line)}, {list(line['extra'])}")
    nulls = [k for k, v in {**line, **line["extra"]}.items() if v is None]
    check(not nulls, f"bench line has nulls: {nulls}")
    check(line["extra"]["screen_hits"] > 0, "production screen: no hits")
    sections = bench.LAST_RUN["sections"]
    for name in ("production_screen", "yeast_screen", "bigpanel"):
        got = sections[name]["launches"]
        check(got["screen_count"] > 0 and got["screen_extract"] > 0,
              f"bench {name}: the screen kernels did not launch: {got}")
    check(sections["exact_scan"]["launches"]["exact_scan"] > 0,
          "bench exact_scan: the exact-scan kernel did not launch")
    record = {"wall_s": wall, "launches": launches,
              "sections": {k: {"s": v["s"], "launches": v["launches"]}
                           for k, v in sections.items()}}
    rng = np.random.default_rng(0)  # bench.main's first draws
    mat = torch.as_tensor(bench._panel(rng, bench.N_ID, bench.N_SNP),
                          device="cuda")
    py = torch.as_tensor((rng.standard_normal(bench.N_ID) * 0.1)
                         .astype(np.float32), device="cuda")
    record["production"] = screen_checks(
        K, "production", mat, py, bench.LAST_RUN["production"], reps=3)
    del mat, py
    torch.cuda.empty_cache()
    mat, py, _ = bench.bigpanel_inputs(torch.device("cuda"),
                                       bench.BIGPANEL_LOG2, bench.N_ID)
    record["bigpanel"] = screen_checks(
        K, "big panel", mat, py, bench.LAST_RUN["bigpanel"], reps=1)
    del mat, py
    torch.cuda.empty_cache()
    rng.bit_generator.state = sections["exact_scan"]["rng_state"]
    mat, py, pvp = bench.exact_inputs(rng, *bench.EXACT, "cuda")
    anchors = np.arange(bench.EXACT[1] - 1)
    got, want, exact = exact_timing(K, mat, pvp, py, anchors, 50.0, False)
    exact_compare("bench exact shape", got, want, 50.0, bench.EXACT[1])
    # every pair's eff, var and chi at the bench's inputs (keep-all)
    args = (mat, mat, py, pvp, torch.as_tensor(anchors, device="cuda"),
            -1.0, "tri", False)
    common, exact["keep_all_max_abs_err"] = exact_compare(
        "bench exact shape, keep-all", K.exact_hits(*args),
        K.exact_hits_ref(*args), -1.0, bench.EXACT[1])
    check(common == exact["pairs"], f"bench exact shape, keep-all: "
          f"{common} rows of {exact['pairs']} pairs")
    record["exact"] = exact
    return line, record


def main():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a GPU")
    sys.path.insert(0, str(ROOT))
    from gmat_tpu_torch.bench import card_line
    from gmat_tpu_torch.core import native
    from gmat_tpu_torch.probe import sass_opcodes
    from gmat_tpu_torch.scan import kernels as K

    gpu_line = card_line(torch.device("cuda", 0))
    print(gpu_line, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)
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
    hgmma = sass_opcodes(lib, "HGMMA")
    for name in SCREEN_KERNELS:  # mangled as <length><name>
        tf32 = {op: count for fn, ops in hgmma.items()
                if f"{len(name)}{name}" in fn for op, count in ops.items()
                if "TF32" in op}
        print(f"{name} SASS TF32 tensor-core instructions: "
              f"{json.dumps(tf32)}", flush=True)
        check(tf32, f"{name}'s SASS holds no HGMMA ... TF32 (TF32 "
              "tensor-core) instruction")

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
    turns = product_turns(K, cases[0])
    phase_s["screen_kernels"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    general = general_cases(K)
    cases += general
    phase_s["general_screen_kernels"] = time.perf_counter() - t0
    print("general screen kernels " + json.dumps([
        {k: c[k] for k in ("case", "anchors", "pairs", "hits", "count_ms",
                           "count_bound_ms", "count_fp32_bound_ms",
                           "plain_count_ms", "extract_ms",
                           "extract_bound_ms", "extract_fp32_bound_ms",
                           "plain_extract_ms",
                           "screen_ms")} for c in general]), flush=True)

    t0 = time.perf_counter()
    exact_err = exact_phase(K)
    phase_s["exact_kernel"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    inverse, leaf = inverse_phase()
    phase_s["inverse"] = time.perf_counter() - t0
    print(f"inverse on {gpu_line}: {json.dumps(inverse)}", flush=True)

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
        native.LEAF_LAUNCHES["spd_leaf_inverse"] = 0
        t0 = time.perf_counter()
        uvlmm_times = uvlmm_phase(ctx)
        phase_s["uvlmm"] = time.perf_counter() - t0
        uvlmm_launches = {**K.LAUNCHES, **native.LEAF_LAUNCHES}
        for key in K.LAUNCHES:
            K.LAUNCHES[key] = 0
        t0 = time.perf_counter()
        long_times, long_rates, long_peak = longwas_phase(ctx)
        phase_s["longwas"] = time.perf_counter() - t0
        long_launches = dict(K.LAUNCHES)
        t0 = time.perf_counter()
        peri_times, peri_launches = periphery_phase(K, ctx)
        phase_s["periphery"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        mesh_record = mesh_phase(K, ctx)
        phase_s["mesh"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        cov_times, cov_launches, cov_record = coverage_phase(K, ctx)
        phase_s["coverage"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    bench_line, bench_record = bench_phase(K)
    phase_s["bench"] = time.perf_counter() - t0
    times["remma_epiAA_parallel"] = part["wall_s"]
    times.update({k: v["wall_s"] for k, v in family_stages.items()})
    print(f"screen-family launches {json.dumps(family_launches)}", flush=True)
    print(f"main-path step times (s): {json.dumps(times)}", flush=True)
    print(f"uvlmm launches {json.dumps(uvlmm_launches)} (dense f64 "
          "linear algebra on cuBLAS/cuSOLVER, and the inverse's leaves in "
          "the REMLs' V⁻¹: no scan kernel on this path)", flush=True)
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
    print(f"periphery launches {json.dumps(peri_launches)}", flush=True)
    print(f"periphery step times (s) on {gpu_line}: "
          f"{json.dumps(peri_times)}", flush=True)
    print(f"mesh on {gpu_line}: {json.dumps(mesh_record)}", flush=True)
    print(f"bench on {gpu_line}: {json.dumps(bench_line)}", flush=True)
    print(f"bench kernels on {gpu_line}: {json.dumps(bench_record)}",
          flush=True)
    print(f"coverage launches {json.dumps(cov_launches)}", flush=True)
    print(f"coverage step times (s) on {gpu_line}: {json.dumps(cov_times)}",
          flush=True)
    print(f"epiAA whole-triangle on {gpu_line}: "
          f"{json.dumps(cov_record.pop('whole_triangle'))}", flush=True)
    print(f"coverage on {gpu_line}: {json.dumps(cov_record)}", flush=True)
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
        {"name": "spd_leaf_inverse", "route": "cuda",
         "source": "gmat_tpu_torch/csrc/linalg.cu",
         "replaces": "gmat_tpu/core/linalg.py:14",
         "launches": launches["spd_leaf_inverse (REML)"], **leaf},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(gpu_line, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--mesh-worker"]:
        mesh_worker(sys.argv[2:])
    else:
        main()
