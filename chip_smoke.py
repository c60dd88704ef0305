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
   the plain version and torch.matmul(pvp, E);
8. remma_add and remma_dom on the same set.

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


def cuda_ms(fn, reps=3):
    """Median device time of fn() in ms, by CUDA events, after one warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[len(times) // 2]


def bound(flop, nbytes, peak):
    """(ms, what bounds it): the larger of the operations at `peak` and
    the bytes at the HBM rate."""
    t_ops, t_bytes = flop / peak, nbytes / HBM_RATE
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def tile_pairs(tiles, m, tile):
    """Pairs i < j < m inside the listed upper-triangle (ti, tj) tiles."""
    import torch

    ti, tj = tiles[:, 0].long(), tiles[:, 1].long()
    rows = torch.clamp(m - ti * tile, max=tile)
    cols = torch.clamp(m - tj * tile, max=tile)
    return int(torch.where(ti == tj, rows * (rows - 1) // 2, rows * cols).sum())


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


def cut_for_hits(mat, py, target):
    """|S| quantile that leaves about `target` of the m(m-1)/2 pairs, from
    the scores of 512 random anchor rows in float64."""
    import torch

    m = mat.shape[1]
    g = torch.Generator(device="cuda").manual_seed(SEED)
    rows = torch.randperm(m, generator=g, device="cuda")[:512]
    s = ((mat[:, rows].double() * py.double()[:, None]).T @ mat.double()).abs()
    s[torch.arange(len(rows), device="cuda"), rows] = 0.0  # the diagonal
    q = 1.0 - target / (m * (m - 1) / 2)
    return float(torch.quantile(s.flatten()[:1 << 24].float(), q))


def keys_in(keys, sorted_keys):
    """Membership of each of `keys` in `sorted_keys`, and its position."""
    import torch

    pos = torch.searchsorted(sorted_keys, keys).clamp(max=max(len(sorted_keys) - 1, 0))
    found = (sorted_keys[pos] == keys) if len(sorted_keys) else torch.zeros_like(keys, dtype=torch.bool)
    return found, pos


def kernel_case(K, name, n, m, seed, target=None, cut=None):
    """One kernel-vs-plain comparison; returns its measurements."""
    import torch

    mat, py = panel(n, m, seed)
    if cut is None:
        cut = cut_for_hits(mat, py, target)
    mat64, py64 = mat.double(), py.double()
    # phase 1: counts against the f64 bracket and the plain float32 version
    counts = K.screen_counts(mat, py, cut, m)
    plain_counts = K.screen_tile_counts_ref(mat, py, cut, m)
    core_c = K.screen_tile_counts_ref(mat64, py64, cut * (1 + BAND), m)
    hull_c = K.screen_tile_counts_ref(mat64, py64, cut * (1 - BAND), m)
    check(bool(torch.all(core_c <= counts)) and bool(torch.all(counts <= hull_c)),
          f"{name}: kernel tile counts outside the f64 bracket")
    check(bool(torch.all(core_c <= plain_counts))
          and bool(torch.all(plain_counts <= hull_c)),
          f"{name}: plain tile counts outside the f64 bracket")
    count_err = int((counts - plain_counts).abs().max()) if counts.numel() else 0
    # phase 2 + driver: hit set against the f64 bracket, eff against f64
    i, j, e = K.screen_hits(mat, py, cut, m)
    torch.cuda.synchronize()
    keys = i * m + j
    check(bool(torch.all(keys[1:] > keys[:-1])), f"{name}: hits not sorted")
    hi, hj, he = K.screen_hits_ref(mat64, py64, cut * (1 - BAND), m)
    hull = hi * m + hj
    found, pos = keys_in(keys, hull)
    check(bool(found.all()), f"{name}: {int((~found).sum())} kernel hits "
          "below the f64 bracket")
    core = hull[he.abs() > cut * (1 + BAND)]
    in_k, _ = keys_in(core, keys)
    check(bool(in_k.all()), f"{name}: {int((~in_k).sum())} f64 hits above "
          "the bracket missed")
    ref = he[pos] if len(keys) else he[:0]
    rel = float(((e.double() - ref).abs() / ref.abs()).max()) if len(keys) else 0.0
    check(rel <= EFF_RTOL, f"{name}: eff off the f64 oracle by {rel:.3g}")
    # the plain float32 version: same bracket, eff on the common pairs
    pi, pj, pe = K.screen_hits_ref(mat, py, cut, m)
    pfound, _ = keys_in(pi * m + pj, hull)
    check(bool(pfound.all()), f"{name}: plain hits below the f64 bracket")
    common, cpos = keys_in(keys, pi * m + pj)
    diff = (e[common] - pe[cpos[common]]).abs()
    eff_err = float(diff.max()) if len(diff) else 0.0
    plain_rel = float((diff / pe[cpos[common]].abs()).max()) if len(diff) else 0.0
    check(plain_rel <= EFF_RTOL,
          f"{name}: eff off the plain version by {plain_rel:.3g} (relative)")
    tiles = torch.nonzero(counts).to(torch.int32)
    in_bytes = 4 * (n * m + n)
    count_bound = bound(2.0 * n * (m * (m - 1) // 2),
                        in_bytes + 4 * counts.numel(), FP32_PEAK)
    extract_bound = bound(2.0 * n * tile_pairs(tiles, m, K.TILE),
                          in_bytes + 8 * len(tiles) + 12 * len(keys),
                          FP32_PEAK)
    out = {
        "case": name, "n": n, "m": m, "cut": cut, "hits": len(keys),
        "f64_core": len(core), "f64_hull": len(hull), "hot_tiles": len(tiles),
        "count_max_abs_err": count_err, "eff_max_abs_err": eff_err,
        "eff_max_rel_err_f64": rel,
        "count_bound_ms": count_bound[0], "count_bound_by": count_bound[1],
        "extract_bound_ms": extract_bound[0],
        "extract_bound_by": extract_bound[1],
        "count_ms": cuda_ms(lambda: K.screen_counts(mat, py, cut, m)),
        "plain_count_ms": cuda_ms(lambda: K.screen_tile_counts_ref(mat, py, cut, m)),
        "extract_ms": cuda_ms(lambda: K.screen_extract(mat, py, cut, m, counts)),
        "plain_extract_ms": cuda_ms(lambda: K.screen_extract_ref(mat, py, cut, m, tiles)),
        "screen_ms": cuda_ms(lambda: K.screen_hits(mat, py, cut, m)),
        "plain_screen_ms": cuda_ms(lambda: K.screen_hits_ref(mat, py, cut, m)),
    }
    print("case " + json.dumps(out), flush=True)
    del mat, py, mat64, py64
    torch.cuda.empty_cache()
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


def exact_timing(K, mat, pvp, py, anchors, crit, center):
    """One exact_hits call (kernel and device sort) over `anchors` x the
    partners above them, timed beside the plain version and
    torch.matmul(pvp, E), with the least time the card could take."""
    import torch

    n, m = mat.shape
    a_t = torch.as_tensor(anchors, device="cuda")
    args = (mat, mat, py, pvp, a_t, crit, "tri", center)
    got, ms = timed(lambda: K.exact_hits(*args))
    want, plain_ms = timed(lambda: K.exact_hits_ref(*args))
    pairs = K.exact_pair_count(a_t, m, "tri")
    # the least FLOP per pair, pvp being symmetric: e and eff (3n), the
    # strict upper triangle u = triu(pvp, 1)·e (n² − n), then
    # var = Σ e ⊙ (diag(pvp) ⊙ e + 2u) (5n)
    ms_bound, bound_by = bound(pairs * (n * n + 7.0 * n),
                               8 * (n * m + n * n + n) + 4 * len(anchors)
                               + 32 * len(got[0]), FP64_PEAK)
    return got, want, {
        "n": n, "m": m, "anchors": len(anchors), "pairs": pairs,
        "hits": len(got[0]), "ms": ms, "plain_ms": plain_ms,
        "library_ms": library_matmul_ms(mat, mat, pvp, anchors, True),
        "bound_ms": ms_bound, "bound_by": bound_by}


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
        elif "converged" in msg:
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
           "gmat_lst": gmat_lst, "var_com": var_com, "approx_rows": rows}
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
    from gmat_tpu_torch.scan import kernels as K

    t0 = time.perf_counter()
    lib = K.build_library()
    print(f"build: {lib.name} in {time.perf_counter() - t0:.1f} s", flush=True)
    print(lib.with_suffix(".log").read_text().strip(), flush=True)

    phase_s = {}
    t0 = time.perf_counter()
    cases = [
        kernel_case(K, "yeast", *YEAST, seed=1, target=1e5),
        kernel_case(K, "ragged", 1001, 3001, seed=2, target=2e4),
        kernel_case(K, "zero_hits", 1001, 3001, seed=3, cut=1e9),
        kernel_case(K, "near_keep_all", 1304, 1700, seed=4, target=1.3e6),
    ]
    check(cases[0]["hits"] > 5e4, "yeast case: too few hits")
    check(cases[2]["hits"] == 0, "zero-hit case found hits")
    check(cases[3]["hits"] > 1e6, "near-keep-all case: too few hits")
    phase_s["screen_kernels"] = time.perf_counter() - t0

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
    times["remma_epiAA_parallel"] = part["wall_s"]
    print(f"main-path step times (s): {json.dumps(times)}", flush=True)
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
