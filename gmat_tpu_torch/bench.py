"""Headline benchmark of the port: the production epiAA effect screen, in
SNP pairs/s, on one CUDA device, with bench.py's sections and its one JSON
line.

Counterpart of the repository's root `bench.py` (the JAX package's
benchmark) with the same eight sections, the same shapes and the same host
random draws, in the same order:

- production screen: `scan/screen.py::_run_screen` over every pair of a
  synthetic n=1304 x m=262,144 panel (3.44e10 pairs) at a cut that ~2e-7 of
  them pass: the identity path of the screen kernels (`csrc/screen.cu`),
  one count and one extract launch per call.  Its rate is the headline;
- GEMM ceiling: a plain float32 `torch.matmul` sweep over the
  upper-triangle 4096-tiles of the same panel at a cut no pair passes (the
  JAX package computes this product outside any Pallas kernel too);
- yeast screen: the production screen at n=4168, m=28,220;
- exact scan: `scan/kernels.py::exact_hits` (the exact-scan kernel,
  `csrc/exact.cu`) over all 989,121 pairs of a 1304 x 1407 panel with a
  random pvp.  The port computes in float64; the JAX section is a float32
  XLA scan (`pairs.py::_anchor_tiles_batch`).  `exact_scan_tflops` counts
  bench.py's FLOP, n_tiles·128·(2n²m + 4nm), whatever runs them;
- REML: one `reml/wemai.py::_reml_step` at the yeast repeated-measures
  shape (6,435 records of 4,168 individuals, three 6435² matrices) on the
  device and on the host CPU, both in float64: Hopper has native FP64 and
  the port no mixed-precision step, so `reml_mixed_iter_s` is the device's
  float64 step under bench.py's key;
- bigpanel: the production screen at m=2^20 (5.5e11 pairs) on a panel
  generated on the device by `tools/stress_bigpanel.py`'s recipe from a
  torch.Generator, whose stream differs from JAX's (so do the hits); its
  peak device memory is the section's own: `torch.cuda.max_memory_allocated`
  less what was allocated when the section began;
- longwas: `balance_longwas_trans` and `_fixed` on tests/data/mouse_long
  at the golden variances, cold and warm;
- yeast approx: `remma_epiAA_approx` end to end on a written PLINK set at
  the yeast shape, cold and warm, with its `LAST_APPROX_STAGES`.

Times are host clocks around work that ends in a device synchronize or a
copy to the host.  A section that fails raises, and nothing falls back to
the CPU or to a plain version.  The sections take their shapes as keyword
arguments and `main` takes them from the module constants below (bench.py's
sizes).

    python -m gmat_tpu_torch.bench [--warm]
    gmat-tpu-torch bench

print one JSON line, {"metric": "epiAA_production_screen_pairs_per_s",
"value": N, "unit": "pairs/s", "vs_baseline": N, "extra": {...}}, where
`vs_baseline` is the headline over the reference C kernel's rate in the
root `bench_baseline.json` (null without that file).  The card's name and
power limit and each section's time and kernel launches go to stderr.
`--warm` builds the kernels and runs each section once, with no result
line.
"""
from __future__ import annotations

import argparse
import json
import logging
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from gmat_tpu_torch.config import resolve_device
from gmat_tpu_torch.core.roofline import log_phase
from gmat_tpu_torch.scan import kernels as K

ROOT = Path(__file__).resolve().parents[1]

N_ID = 1304
N_SNP = 262144
TILE = 4096  # the GEMM ceiling's tile edge
REPS = 5  # timed repetitions of a screen or scan, median-combined
REML_REPS = 3  # timed REML steps on the device (one on the host)
YEAST = (4168, 28220)  # individuals, SNPs: the reference README's yeast set
EXACT = (1304, 1407)  # individuals, SNPs: the mouse set
REML = (4168, 6435, 2048)  # individuals, records, SNPs of the GRM
BIGPANEL_LOG2 = 20  # log2 of the big panel's SNPs
BIGPANEL_HIT_FRAC = 1e-7  # share of the big panel's pairs above its cut
BIGPANEL_CHUNK = 1 << 16  # columns of the big panel generated at a time
LONGWAS_DATA = ROOT / "tests" / "data" / "mouse_long"  # plink + phenotypes
APPROX_PAIRS = 100000  # calibration pairs of the yeast approx pipeline

#: the last `main` run, per section: its seconds, its kernel launches
#: (`scan/kernels.py::LAUNCHES` differences) and the host generator's state
#: at its start; and the production and big-panel screens' hits (i, j, eff)
#: and cuts
LAST_RUN: dict = {}

log = logging.getLogger("gmat_tpu_torch.bench")


def _panel(rng, n, m):
    freqs = rng.uniform(0.05, 0.95, size=m)
    geno = rng.binomial(2, freqs[None, :], size=(n, m)).astype(np.float32)
    p_hat = geno.sum(0) / (2 * n)
    return np.asarray(geno - 2 * p_hat[None, :], dtype=np.float32)


def _screen_cut(mat, py, hit_frac):
    """|eff| threshold hitting ~hit_frac of pairs: eff_ij = sum_k m_ik m_jk
    py_k is ~normal with var ~= (sum py^2/n) * v_i * v_j; use the mean
    column moment and the normal quantile."""
    from scipy.stats import norm

    v = float(np.mean(np.mean(mat * mat, axis=0)))
    sig = np.sqrt(np.sum(py * py) / py.size) * v * np.sqrt(mat.shape[0])
    return float(norm.isf(hit_frac / 2) * sig)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _median_s(fn, reps, device):
    """Median seconds of `reps` calls of fn(), each ended by a device
    synchronize, and the last call's result."""
    times, out = [], None
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        _sync(device)
        times.append(time.perf_counter() - t0)
    return float(np.median(times)), out


def _full_screen(mat, py, cut):
    """`_run_screen` of every pair of mat at one flat cut: (i, j, eff) host
    arrays."""
    from gmat_tpu_torch.scan.screen import _run_screen

    m = mat.shape[1]
    anchors = np.arange(m - 1, dtype=np.int64)
    bins = np.zeros(m, dtype=np.int64)
    return _run_screen(mat, mat, py, anchors, bins, bins,
                       np.full(111, cut, dtype=np.float32))


def bench_production_screen(mat, py, hit_frac=2e-7, reps=REPS):
    """`_run_screen` wall clock over every pair of the float32 panel `mat`
    (n, m) on its device: the counts, the extraction and the host-side
    assembly, as remma_epiAA_eff runs them, at the cut that ~hit_frac of
    the pairs pass.  Every SNP but the last is an anchor, which takes the
    screen kernels' identity path (`kernels.py::anchor_panel`): one count
    and one extract launch per call on a CUDA device.  One warm-up call,
    then the median of `reps`.  Returns (pairs/s, n_hits, (i, j, eff, cut))
    with the last call's hits."""
    m = mat.shape[1]
    if K.anchor_panel(mat, torch.arange(m - 1), m)[1] is not None:
        raise RuntimeError("the full anchor list left the identity screen")
    cut = _screen_cut(mat.cpu().numpy(), py.cpu().numpy(), hit_frac)
    before = dict(K.LAUNCHES)
    i0, _, _ = _full_screen(mat, py, cut)
    n_hits = len(i0)
    launched = {k: K.LAUNCHES[k] - before[k] for k in before}
    if mat.is_cuda and launched != {"screen_count": 1, "screen_extract": 1,
                                    "exact_scan": 0}:
        raise RuntimeError(f"one screen call launched {launched}")
    log.info("production screen warmup at n=%d, m=%d: %d hits at cut %.4g",
             mat.shape[0], m, n_hits, cut)
    dt, (i0, j0, e0) = _median_s(lambda: _full_screen(mat, py, cut), reps,
                                 mat.device)
    if len(i0) != n_hits or n_hits == 0:
        raise RuntimeError(f"the screen found {n_hits} hits, then "
                           f"{len(i0)}")
    return m * (m - 1) // 2 / dt, n_hits, (i0, j0, e0, cut)


def ceiling_count(mat, py, cut, tile):
    """Pairs j > i of mat whose |S| = |(mat ⊙ py)ᵀ mat|[i, j] exceeds
    `cut`, from plain float32 products of the upper-triangle tile x tile
    tiles, summed on the device and read once."""
    m = mat.shape[1]
    a_scaled = mat * py[:, None]
    work = K.screen_worklist(torch.arange(m, dtype=torch.int32), m, tile)
    upper = torch.ones((tile, tile), dtype=torch.bool,
                       device=mat.device).triu(1)
    total = torch.zeros((), dtype=torch.int64, device=mat.device)
    for t, p in work.tolist():
        s = a_scaled[:, t * tile:(t + 1) * tile].T @ mat[:, p * tile:
                                                           (p + 1) * tile]
        hit = s.abs() > cut
        if t == p:
            hit &= upper[:hit.shape[0], :hit.shape[1]]
        total += hit.sum()
    return int(total)


def bench_gemm_ceiling(mat, py, tile=TILE, reps=REPS):
    """The screen's products alone: `ceiling_count` at a cut no pair
    passes (bench.py's round-1 inline sweep, the GEMM rate on this device).
    One warm-up call, then the median of `reps`.  Returns pairs/s."""
    m = mat.shape[1]
    ceiling_count(mat, py, 1.0e9, tile)
    dt, total = _median_s(lambda: ceiling_count(mat, py, 1.0e9, tile), reps,
                          mat.device)
    if total != 0:
        raise RuntimeError(f"{total} pairs passed the no-hit cut")
    return m * (m - 1) // 2 / dt


def bench_yeast_screen(rng, device, n=YEAST[0], m=YEAST[1], reps=REPS):
    """The production screen at the reference's yeast shape (n=4168,
    m=28220, 398,170,090 pairs) at hit_frac 2e-5.  Returns (pairs/s,
    n_hits)."""
    mat = torch.as_tensor(_panel(rng, n, m), device=device)
    py = torch.as_tensor((rng.standard_normal(n) * 0.1).astype(np.float32),
                         device=device)
    rate, hits, _ = bench_production_screen(mat, py, hit_frac=2e-5,
                                            reps=reps)
    return rate, hits


def exact_inputs(rng, n, m, device):
    """bench.py's exact-scan inputs, drawn in float32 and held as float64
    on `device`: (mat, py, pvp), pvp = a·aᵀ + I for a random a, made
    symmetric to the bit (the kernel reads pvp's rows as its columns)."""
    mat = _panel(rng, n, m)
    py = (rng.standard_normal(n) * 0.1).astype(np.float32)
    a = rng.standard_normal((n, n)).astype(np.float32) * 0.01
    pvp = torch.as_tensor(a @ a.T + np.eye(n, dtype=np.float32),
                          dtype=torch.float64, device=device)
    return (torch.as_tensor(mat, dtype=torch.float64, device=device),
            torch.as_tensor(py, dtype=torch.float64, device=device),
            (pvp + pvp.T) / 2)


def bench_exact_scan(rng, device, n=EXACT[0], m=EXACT[1], reps=REPS):
    """The exhaustive exact scan at the mouse shape: `exact_hits` over
    every pair j > i of a random panel at chi² > 50 (p < ~1e-12: few
    hits), in float64.  One warm-up call, then the median of `reps`.
    Returns (pairs/s, bench.py's TFLOP/s, n_hits)."""
    mat, py, pvp = exact_inputs(rng, n, m, device)
    anchors = torch.arange(m - 1, device=device)

    def run():
        return len(K.exact_hits(mat, mat, py, pvp, anchors, 50.0, "tri")[0])

    run()
    dt, hits = _median_s(run, reps, device)
    pairs = m * (m - 1) // 2
    tile = 128  # bench.py's anchor tile, whose padding its FLOP count keeps
    n_tiles = -(-(m - 1) // tile)
    flops = n_tiles * tile * (2.0 * n * n * m + 4.0 * n * m)
    log.info("exact scan: %d hits in %.2f ms", hits, 1e3 * dt)
    # the kernel's own least work, n² + 7n FLOP per pair (chip_smoke.py's
    # exact_timing), against the FP64 tensor-core peak
    log_phase("exact_scan", pairs * (n * n + 7.0 * n), dt, pairs)
    return pairs / dt, flops / dt / 1e12, hits


def bench_reml_mixed(rng, device, n_id=REML[0], n_rec=REML[1], m=REML[2],
                     reps=REML_REPS):
    """One EM+AI REML iteration (`_reml_step`) at the yeast
    repeated-measures shape, gmat_lst = [ag, ag*ag, pe] over n_rec records
    of n_id individuals, in float64 on `device` (the mean of `reps` steps)
    and on the host CPU (one step), each after a warm-up step; every step's
    variances go through the host, as `wemai_reml` iterates.  Returns
    (device s/iter, host s/iter)."""
    from gmat_tpu_torch.core.linalg import not_positive_definite
    from gmat_tpu_torch.reml.wemai import _reml_step

    geno = rng.binomial(2, rng.uniform(0.1, 0.9, size=m)[None, :],
                        size=(n_id, m)).astype(np.float32)
    extra_rec = rng.integers(0, n_id, size=n_rec - n_id)
    rec_ids = np.sort(np.concatenate([np.arange(n_id), extra_rec]))
    y = rng.standard_normal(n_rec)
    xmat = np.column_stack([np.ones(n_rec), rng.standard_normal(n_rec)])
    var0 = np.array([0.5, 0.3, 0.5, 1.0])

    def step(var, y_d, x_d, zg):
        """The next variances on the host; raises, as `wemai_reml` does,
        where V or XᵀV⁻¹X is not positive definite (a card's step only
        returns its factorizations' `info`)."""
        out = _reml_step(var, y_d, x_d, zg)
        var_new = out[0].cpu().numpy()
        if out[5] is not None:
            for order in out[5].tolist():
                if order:
                    raise not_positive_definite(order)
        return var_new

    def run(dev, steps):
        g32 = torch.as_tensor(geno, device=dev)
        p = g32.mean(dim=0) / 2.0
        mcen = g32 - 2.0 * p[None, :]
        ag = ((mcen @ mcen.T) / torch.sum(2.0 * p * (1.0 - p))).double()
        rec = torch.as_tensor(rec_ids, device=dev)
        ag = ag[rec[:, None], rec[None, :]]
        pe = (rec[:, None] == rec[None, :]).double()  # I[rec, rec]
        zg = torch.stack([ag, ag * ag, pe])
        del g32, mcen, ag, pe
        y_d = torch.as_tensor(y, device=dev)
        x_d = torch.as_tensor(xmat, device=dev)
        step(torch.as_tensor(var0, device=dev), y_d, x_d, zg)
        t0 = time.perf_counter()
        var = torch.as_tensor(var0, device=dev)
        for _ in range(steps):
            var = torch.as_tensor(step(var, y_d, x_d, zg), device=dev)
        return (time.perf_counter() - t0) / steps

    dev_iter = run(device, reps)
    log.info("reml f64 step (%s): %.3f s/iter at n_rec=%d", device,
             dev_iter, n_rec)
    cpu_iter = run(torch.device("cpu"), 1)
    log.info("reml f64 step (host CPU): %.3f s/iter", cpu_iter)
    return dev_iter, cpu_iter


def bigpanel_inputs(device, m_log2=BIGPANEL_LOG2, n=N_ID):
    """(mat, py, cut) of the big-panel screen: `tools/stress_bigpanel.py`'s
    panel made on `device` from torch.Generator seed 0 — p ~ U(0.05,
    0.95) per SNP, one uniform u per genotype, g = [u < p²] + [u < 2p − p²]
    (binomial(2, p)), centered per column — BIGPANEL_CHUNK columns at a
    time; py from numpy's default_rng(1); the cut for ~BIGPANEL_HIT_FRAC of
    the pairs from the panel's mean square, as that script computes it."""
    from scipy.stats import norm

    m = 1 << m_log2
    gen = torch.Generator(device=device).manual_seed(0)
    p = torch.empty(m, device=device).uniform_(0.05, 0.95, generator=gen)
    mat = torch.empty((n, m), device=device)
    sq = 0.0
    for c0 in range(0, m, BIGPANEL_CHUNK):
        pc = p[c0:c0 + BIGPANEL_CHUNK]
        u = torch.rand((n, len(pc)), generator=gen, device=device)
        g = (u < pc * pc).float() + (u < 2 * pc - pc * pc).float()
        g -= g.mean(dim=0)
        sq += float(torch.sum(g * g, dtype=torch.float64))
        mat[:, c0:c0 + BIGPANEL_CHUNK] = g
    py = torch.as_tensor(
        (np.random.default_rng(1).standard_normal(n) * 0.1)
        .astype(np.float32), device=device)
    sig = float(torch.sqrt(torch.sum(py * py) / n)) * (sq / (n * m)) \
        * np.sqrt(n)
    return mat, py, float(norm.isf(BIGPANEL_HIT_FRAC / 2) * sig)


def bench_bigpanel(device, m_log2=BIGPANEL_LOG2, n=N_ID):
    """The production screen at a >=1M-SNP panel (m = 2^20 x n = 1304 =
    5.497e11 pairs) made on the device (`bigpanel_inputs`): one warm-up
    call, then one timed call, as `tools/stress_bigpanel.py` runs it.
    Returns (pairs/s, n_hits, the section's own peak device memory in
    bytes, (i, j, eff, cut) with the timed call's hits).  The peak is
    `torch.cuda.max_memory_allocated` less what was allocated when the
    section began, so that it does not depend on what ran before it in the
    process; None off CUDA."""
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
        base = torch.cuda.memory_allocated(device)
    mat, py, cut = bigpanel_inputs(device, m_log2, n)
    m = mat.shape[1]
    n_hits = len(_full_screen(mat, py, cut)[0])
    log.info("bigpanel warmup at m=%d: %d hits at cut %.4g", m, n_hits, cut)
    dt, (i0, j0, e0) = _median_s(lambda: _full_screen(mat, py, cut), 1,
                                 device)
    if len(i0) != n_hits:
        raise RuntimeError(f"the big panel gave {n_hits}, then {len(i0)} "
                           "hits")
    peak = (torch.cuda.max_memory_allocated(device) - base
            if device.type == "cuda" else None)
    pairs = m * (m - 1) // 2
    log.info("bigpanel m=%d: %.4g pairs/s (%.4g pairs in %.2f s), %d hits, "
             "section peak device memory %s B", m, pairs / dt, pairs, dt,
             n_hits, peak)
    return pairs / dt, n_hits, peak, (i0, j0, e0, cut)


def bench_longwas(device, data=LONGWAS_DATA):
    """The balanced longitudinal GWAS, trans then fixed (10-iteration REML
    per SNP, 256 SNPs a batch), over every SNP of the PLINK set `data`/plink
    with `data`/phe.balance.txt (tests/data/mouse_long: 1212 ids x 11,833
    SNPs, 16 time points, forder=3) at the golden variances, each cold then
    warm.  Returns (fixed SNPs/s, trans SNPs/s), warm."""
    import pandas as pd

    from gmat_tpu_torch.grm.grm import agmat
    from gmat_tpu_torch.longwas.balance_gwas import (balance_longwas_fixed,
                                                     balance_longwas_trans)

    ml = Path(data)
    g = np.load(ROOT / "tests" / "golden" / "longwas_balance_var.npz")
    var_df = pd.DataFrame({k: g[k]
                           for k in ("vari", "varij", "varik", "var_val")})
    tp = np.arange(16) + 1.0
    trait = list(range(2, 18))
    with tempfile.TemporaryDirectory() as td:
        prefix = str(Path(td) / "plink")
        for ext in (".bed", ".bim", ".fam"):
            shutil.copy(str(ml / ("plink" + ext)), prefix + ext)
        agmat(prefix, inv=False, out_fmt="id_id_val", device=device)
        args = (str(ml / "phe.balance.txt"), "ID", tp, trait,
                prefix + ".agrm2", prefix, var_df)

        def timed(fn, label, **kw):
            t0 = time.perf_counter()
            fn(*args, device=device, **kw)
            cold = time.perf_counter() - t0
            t0 = time.perf_counter()
            res = fn(*args, device=device, **kw)
            warm = time.perf_counter() - t0
            log.info("longwas %s: %d SNPs in %.2f s warm / %.2f s cold "
                     "(%.3g SNPs/s)", label, len(res), warm, cold,
                     len(res) / warm)
            return len(res), warm

        n_trans, trans_s = timed(balance_longwas_trans, "trans",
                                 prefix_outfile=str(Path(td) / "trans"))
        n_fixed, fixed_s = timed(balance_longwas_fixed,
                                 "fixed (10-iter REML)", snp_batch=256,
                                 prefix_outfile=str(Path(td) / "fixed"))
    if n_fixed != n_trans:
        raise RuntimeError(f"fixed tested {n_fixed} SNPs, trans {n_trans}")
    return n_trans / fixed_s, n_trans / trans_s


def bench_yeast_approx(rng, device, n=YEAST[0], m=YEAST[1],
                       num_random_pair=APPROX_PAIRS):
    """The flagship pipeline end to end at the yeast shape:
    remma_epiAA_approx (calibration on random pairs -> screen of all pairs
    -> exact re-test of the survivors -> merge) on a written PLINK set
    through the file-level API, cold, then warm (the device caches of the
    panel, GRMs, codings and score pieces filled: a multi-trait analysis).
    Returns (cold s, result rows, the warm call's stages, warm s)."""
    import pandas as pd

    from gmat_tpu_torch.grm.grm import additive_grm
    from gmat_tpu_torch.io.bed import write_bed
    from gmat_tpu_torch.scan import screen as screen_mod

    geno = rng.binomial(2, rng.uniform(0.05, 0.95, size=m)[None, :],
                        size=(n, m)).astype(np.float32)
    with tempfile.TemporaryDirectory() as td:
        prefix = str(Path(td) / "plink")
        write_bed(prefix, geno.astype(np.float64))
        yvec = rng.standard_normal(n)
        fam = pd.read_csv(prefix + ".fam", sep=r"\s+", header=None,
                          dtype=str)
        pheno = str(Path(td) / "pheno")
        with open(pheno, "w") as f:
            for (f0, i0), yv in zip(fam[[0, 1]].to_numpy(), yvec):
                f.write(f"{f0} {i0} 1 {yv:.8f}\n")
        ag = additive_grm(torch.as_tensor(geno, device=device)).double() \
            .cpu().numpy()
        out = str(Path(td) / "epiAA_approx")

        def run():
            t0 = time.perf_counter()
            screen_mod.remma_epiAA_approx(
                pheno, prefix, [ag, ag * ag], [0.4, 0.1, 0.6], p_cut=1e-5,
                num_random_pair=num_random_pair, out_file=out, device=device)
            return time.perf_counter() - t0

        dt, dt_warm = run(), run()
        with open(out) as f:
            rows = sum(1 for _ in f) - 1
    stages = {k: round(v, 2) for k, v in
              screen_mod.LAST_APPROX_STAGES.items()}
    log.info("yeast approx end-to-end: %.1f s cold / %.1f s warm, %d "
             "result rows; warm stages %s", dt, dt_warm, rows, stages)
    return dt, rows, stages, dt_warm


def _log_to_stderr():
    """This module's log and the roofline lines (`core/roofline.py`) to
    stderr, prefixed."""
    handler = logging.StreamHandler(sys.stderr)
    handler.setFormatter(logging.Formatter("bench: %(message)s"))
    for logger in (log, logging.getLogger("gmat_tpu_torch.core.roofline")):
        if not logger.handlers:
            logger.addHandler(handler)
            logger.setLevel(logging.INFO)
            logger.propagate = False


def card_line(device):
    """The CUDA device's name and power limit as `nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader` gives them, for the
    host CPU a label; raises when nvidia-smi fails."""
    if device.type != "cuda":
        return f"{device} (host CPU)"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    lines = smi.stdout.strip().splitlines()
    index = device.index or 0
    if smi.returncode != 0 or index >= len(lines):
        raise RuntimeError(f"nvidia-smi: rc {smi.returncode}, "
                           f"{smi.stderr.strip()}")
    return lines[index]


def main(device=None, warm=False):
    """Run every section on `device` (None: the default, CUDA) and print
    the JSON line; with `warm`, run each once and print nothing."""
    dev = resolve_device(device)
    _log_to_stderr()
    log.info("device %s: %s", dev, card_line(dev))
    reps = 1 if warm else REPS
    LAST_RUN.clear()
    LAST_RUN["sections"] = {}

    rng = np.random.default_rng(0)
    mat = _panel(rng, N_ID, N_SNP)
    py = (rng.standard_normal(N_ID) * 0.1).astype(np.float32)
    mat_d = torch.as_tensor(mat, device=dev)
    py_d = torch.as_tensor(py, device=dev)
    del mat

    def section(name, fn):
        state = rng.bit_generator.state
        before = dict(K.LAUNCHES)
        t0 = time.perf_counter()
        out = fn()
        _sync(dev)
        secs = time.perf_counter() - t0
        launches = {k: K.LAUNCHES[k] - before[k] for k in before}
        LAST_RUN["sections"][name] = {"s": secs, "launches": launches,
                                      "rng_state": state}
        log.info("%s done in %.1f s (kernel launches %s)", name, secs,
                 launches)
        return out

    extra = {}
    prod = section("production_screen",
                   lambda: bench_production_screen(mat_d, py_d, reps=reps))
    LAST_RUN["production"] = dict(zip(("i", "j", "eff", "cut"), prod[2]))
    extra["screen_hits"] = prod[1]
    ceiling = section("gemm_ceiling",
                      lambda: bench_gemm_ceiling(mat_d, py_d, TILE, reps))
    extra["screen_gemm_ceiling_pairs_per_s"] = round(ceiling, 1)
    del mat_d, py_d
    yeast = section("yeast_screen",
                    lambda: bench_yeast_screen(rng, dev, *YEAST, reps=reps))
    extra["yeast_screen_pairs_per_s"] = round(yeast[0], 1)
    extra["yeast_screen_hits"] = yeast[1]
    exact = section("exact_scan",
                    lambda: bench_exact_scan(rng, dev, *EXACT, reps=reps))
    extra["exact_scan_pairs_per_s"] = round(exact[0], 1)
    extra["exact_scan_tflops"] = round(exact[1], 2)
    reml = section("reml_mixed", lambda: bench_reml_mixed(
        rng, dev, *REML, reps=1 if warm else REML_REPS))
    extra["reml_mixed_iter_s"] = round(reml[0], 3)
    extra["reml_cpu_f64_iter_s"] = round(reml[1], 3)
    extra["reml_mixed_speedup"] = round(reml[1] / reml[0], 1)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    bigpanel = section("bigpanel",
                       lambda: bench_bigpanel(dev, BIGPANEL_LOG2, N_ID))
    LAST_RUN["bigpanel"] = dict(zip(("i", "j", "eff", "cut"), bigpanel[3]))
    extra["bigpanel_pairs_per_s"] = round(bigpanel[0], 1)
    extra["bigpanel_hits"] = bigpanel[1]
    extra["bigpanel_peak_hbm_gib"] = (None if bigpanel[2] is None
                                      else round(bigpanel[2] / 2**30, 2))
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    longwas = section("longwas", lambda: bench_longwas(dev, LONGWAS_DATA))
    extra["longwas_fixed_snps_per_s"] = round(longwas[0], 1)
    extra["longwas_trans_snps_per_s"] = round(longwas[1], 1)
    approx = section("yeast_approx", lambda: bench_yeast_approx(
        rng, dev, *YEAST, num_random_pair=APPROX_PAIRS))
    extra["yeast_approx_end_to_end_s"] = round(approx[0], 1)
    extra["yeast_approx_rows"] = approx[1]
    extra["yeast_approx_stages"] = approx[2]
    extra["yeast_approx_warm_s"] = round(approx[3], 1)

    if warm:
        log.info("warm mode: kernels built, every section run once; no "
                 "result line")
        return
    base_file = ROOT / "bench_baseline.json"
    vs = None
    if base_file.exists():
        base = json.loads(base_file.read_text())
        vs = prod[0] / base["reference_epiAA_screen_pairs_per_s"]
    print(json.dumps({
        "metric": "epiAA_production_screen_pairs_per_s",
        "value": round(prod[0], 1),
        "unit": "pairs/s",
        "vs_baseline": round(vs, 2) if vs is not None else None,
        "extra": extra,
    }), flush=True)


if __name__ == "__main__":
    parser = argparse.ArgumentParser(
        prog="python -m gmat_tpu_torch.bench",
        description="the port's headline benchmark: one JSON line")
    parser.add_argument("--warm", action="store_true",
                        help="build the kernels and run each section once, "
                             "with no result line")
    main(warm=parser.parse_args().warm)
