#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (gmat_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

1. requires CUDA and prints the card's name and power limit;
2. builds the effect-screen kernel from gmat_tpu_torch/csrc/screen.cu;
3. holds the kernel against its plain PyTorch version and a float64 oracle
   at the yeast shape (n=4168, m=28220, ~1e5 hits), a ragged shape, a
   zero-hit cut and a near-keep-all cut (>1e6 hits), and times both;
4. runs the README's four-step REMMAX workflow through the package's entry
   points at the yeast shape on a seeded PLINK set of full-sib families:
   agmat -> wemai_multi_gmat -> remma_epiAA_approx -> annotation_snp_pos,
   and checks that the screen kernels ran and that the result table is
   right.

The last line is {"ok": true, "device": {...}}; the line before it lists
each kernel with its launches on the main path, its largest deviation from
the plain version and both times.  Any failure exits nonzero before that.
Scratch files go to build/chip_smoke/ and are removed at the end.
"""
from __future__ import annotations

import json
import logging
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
    out = {
        "case": name, "n": n, "m": m, "cut": cut, "hits": len(keys),
        "f64_core": len(core), "f64_hull": len(hull), "hot_tiles": len(tiles),
        "count_max_abs_err": count_err, "eff_max_abs_err": eff_err,
        "eff_max_rel_err_f64": rel,
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


def main_path(K, workdir):
    """The four-step workflow at the yeast shape; returns stage times and
    the kernel launches of the main path."""
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
    for key, count in launches.items():
        check(count > 0, f"the main path never launched kernel {key}")

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
    return times, stages, launches


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
    print(f"kernel phase: {time.perf_counter() - t0:.1f} s", flush=True)

    build = ROOT / "build" / "chip_smoke"
    build.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as td:
        times, stages, launches = main_path(K, Path(td))
    print(f"main-path step times (s): {json.dumps(times)}", flush=True)

    yeast = cases[0]
    source = "gmat_tpu_torch/csrc/screen.cu"
    kernels = [
        {"name": "screen_count", "route": "cuda", "source": source,
         "replaces": "gmat_tpu/scan/kernels.py:116",
         "launches": launches["screen_count"],
         "max_abs_err": max(c["count_max_abs_err"] for c in cases),
         "ms": yeast["count_ms"], "plain_ms": yeast["plain_count_ms"]},
        {"name": "screen_extract", "route": "cuda", "source": source,
         "replaces": "gmat_tpu/scan/kernels.py:429",
         "launches": launches["screen_extract"],
         "max_abs_err": max(c["eff_max_abs_err"] for c in cases),
         "ms": yeast["extract_ms"], "plain_ms": yeast["plain_extract_ms"]},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(gpu_line, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
