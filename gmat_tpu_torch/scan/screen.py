"""Effect-only epistasis screening and the approximate test pipelines.

Counterpart of `gmat_tpu/scan/screen.py` (the reference's C/OpenMP kernel
family and its drivers):
- `remma_epi{AA,AD,DD}_eff`: screen |eff(i, j)| > eff_cut =
  sqrt(chi2_crit·var_app) over the pairs j > i of an anchor list, write
  `snp_0 snp_1 eff` plus the appended `chi_app p_app` columns;
- `remma_epi{AA,AD,DD}_maf_eff`: the same with per-bin-pair cuts
  eff_cut[bin_i*10 + bin_j], bins = int(maf*20) or int(het_freq*20);
- `remma_epi{AA,AD,DD}_approx`: random-pair variance calibration (median)
  -> screen -> exact re-test of the survivors -> merge of approx and exact p,
  the stages handing each other arrays and the one table written at the
  end;
- `remma_epi{AA,AD,DD}_maf_approx`: per-bin-pair mean variance calibration
  with a global-mean fallback, written beside the table as `.freq` /
  `.heter` / `.maf` and `.freq_denominator`;
- `*_parallel`: one part of the balanced anchor split, written to
  `f"{out_file}.{part}"`.
AD screens both orientations: anchors i against partners j > i as
(A_i, D_j) -> row (i, j), then as (D_i, A_j) -> row (j, i); the cut index
is bins_a[anchor]*10 + bins_b[partner] in both, as in the reference's C
kernel.

The screen is S = (A ⊙ py)ᵀ B in float32 on the hand-written Hopper kernel
K1 (`scan/kernels.py::screen_positions`), for every kind, anchor list and cut
table; its product keeps float32's precision (3xTF32 on the tensor
cores), so no threshold slack is applied.
Survivors are re-tested exactly in float64.  With `mesh=` (`dist/`), the
anchors of each sweep are shared round-robin over the mesh's shards, the
calibration and the re-test chunks likewise (`scan/pairs.py`).
"""
from __future__ import annotations

import io
import logging
import os

import numpy as np
import pandas as pd
import torch

from gmat_tpu_torch.config import SCREEN_DTYPE, resolve_device
from gmat_tpu_torch.core.roofline import log_phase, maybe_trace
from gmat_tpu_torch.core.spans import count, span
from gmat_tpu_torch.core.stats import chi2_isf
from gmat_tpu_torch.dist.mesh import (_any_replica, _gather_rows,
                                      _map_shards, _replica, _replicate)
from gmat_tpu_torch.scan.kernels import CutTable, screen_positions

logger = logging.getLogger(__name__)


def _screen_slack() -> float:
    """Threshold slack for the screen product's precision: none, since the
    kernel's 3xTF32 product keeps float32's precision, like the JAX package
    on the CPU."""
    return 0.0


def _run_screen(a_mat, b_mat, pymat, anchors, bins_a, bins_b, table,
                flip_output=False, mesh=None):
    """Screen driver: (i, j, eff) host arrays of the pairs of an anchor i of
    `anchors` (columns of a_mat) and a partner j > i of b_mat with
    |S| > table[bins_a[i]*10 + bins_b[j]], anchors in list order and
    partners ascending; with `flip_output` each row is written (j, i).
    The table is cast to float32; a flat table is one cut.

    With `mesh`, position k of the anchor list goes to shard k mod D and
    the shards' rows merge on (position, partner); a_mat, b_mat and pymat
    are then tensors on the shards' one device or {device: tensor} maps
    from `dist.mesh._replicate`.  Traced under "screen" (`maybe_trace`);
    a span `screen.run` whose seconds the roofline line reads.  Its
    `pairs` and `hits` count into the span that called it (`screen.sweep`,
    which sums an AD sweep's two runs)."""
    with maybe_trace("screen"), span("screen.run", timed=True) as s:
        i, j, eff, pairs = _run_screen_impl(a_mat, b_mat, pymat, anchors,
                                            bins_a, bins_b, table, mesh)
    n = _any_replica(a_mat).shape[0]
    log_phase("screen", 2.0 * n * pairs, s.seconds, items=pairs)
    count("pairs", pairs)
    count("hits", len(i))
    return (j, i, eff) if flip_output else (i, j, eff)


def _run_screen_impl(a_mat, b_mat, pymat, anchors, bins_a, bins_b, table,
                     mesh):
    """(i, j, eff, pairs screened) of `_run_screen`, unflipped."""
    table = np.asarray(table, dtype=np.float32) * np.float32(
        1.0 - _screen_slack())
    anchors = np.asarray(list(anchors), dtype=np.int64)
    n_shards = 1 if mesh is None else mesh.size
    m = _any_replica(b_mat).shape[1]

    def shard(dev, k):
        pos = np.arange(k, len(anchors), n_shards)
        if not len(pos):
            return pos, pos, np.empty(0, dtype=np.float32)
        a, b, py = (_replica(x, dev) for x in (a_mat, b_mat, pymat))
        if np.ptp(table) == 0.0:
            cut = float(table[0])
        else:
            cut = CutTable(*(torch.as_tensor(np.asarray(x, dtype=dt),
                                             device=dev)
                             for x, dt in ((bins_a, np.int32),
                                           (bins_b, np.int32),
                                           (table, np.float32))))
        p, j, eff = screen_positions(
            a, py, cut, m, b=None if b is a else b,
            anchors=torch.as_tensor(anchors[pos]))
        return pos[p.cpu().numpy()], j.cpu().numpy(), eff.cpu().numpy()

    if mesh is None:
        parts = [shard(a_mat.device, 0)]
    else:
        parts = _gather_rows(mesh, _map_shards(mesh, shard,
                                               list(mesh.shard_ids)))
    pos, j, eff = (np.concatenate(col) for col in zip(*parts))
    if mesh is not None:
        order = np.argsort(pos * m + j, kind="stable")
        pos, j, eff = pos[order], j[order], eff[order]
    return anchors[pos], j, eff, int(np.maximum(m - 1 - anchors, 0).sum())


def _maf_bins(geno):
    """int(maf*20) bins (the AD screens call this vector `freqA`)."""
    freq = 1.0 - np.sum(geno, axis=0) / (2.0 * geno.shape[0])
    freq = np.where(freq > 0.5, 1.0 - freq, freq)
    return freq, (freq * 20).astype(np.int64)


def _het_bins(geno):
    """int(het_freq*20) bins of the folded heterozygote frequency, the
    dominance-side bin variable (`freqD` of the AD screens)."""
    freq = np.sum(np.abs(geno - 1.0) < 0.001, axis=0) / geno.shape[0]
    freq = np.where(freq > 0.5, 1.0 - freq, freq)
    return freq, (freq * 20).astype(np.int64)


def _write_screen(out_file, idx0, idx1, eff):
    with span("screen.write", timed=True) as s, open(out_file, "w") as f:
        f.write("snp_0 snp_1 eff\n")
        for k in range(0, len(idx0), 1 << 22):
            pd.DataFrame({0: idx0[k:k + (1 << 22)],
                          1: idx1[k:k + (1 << 22)],
                          2: eff[k:k + (1 << 22)]}).to_csv(
                f, sep=" ", header=False, index=False, float_format="%g")
    logger.info("Screen write: %d rows in %.3f s", len(idx0), s.seconds)


def _screen_engine(kind, pheno_file, bed_prefix, gmat_lst, var_com,
                   snp_lst_0, eff_cut_table, bins_a, bins_b, maf=False,
                   dm=None, mesh=None, device=None):
    """Shared driver of the *_eff / *_maf_eff family.

    eff_cut_table: (111,) per-bin-pair |eff| cuts (flat for the non-MAF
    screens); bins_a / bins_b: (m,) bins of the anchor (table row) and the
    partner (table column), equal except for AD, whose anchor side bins by
    MAF and partner side by heterozygote frequency in BOTH orientations.
    Returns the hit arrays (idx0, idx1, eff), rows as a screen file holds
    them (`_write_screen`).  `dm`
    overrides the phenotype-file parse with a (y, xmat, zmat) design.
    With `mesh`, each sweep runs over its shards, from the per-device
    caches filled here for each of its devices."""
    from gmat_tpu_torch.scan.common import (coded_matrix, design_matrix_cached,
                                            prepare_genotypes_device,
                                            score_pieces_cached)

    if dm is None:
        dm = design_matrix_cached(pheno_file, bed_prefix)

    def setup(dev):
        pieces = score_pieces_cached(dm, gmat_lst, var_com, dev)
        g, _ = prepare_genotypes_device(bed_prefix, device=dev)
        return (coded_matrix(g, "add", SCREEN_DTYPE) if kind != "DD" else None,
                coded_matrix(g, "dom", SCREEN_DTYPE) if kind != "AA" else None,
                pieces.pymat.to(SCREEN_DTYPE).contiguous())

    with span("screen.setup", timed=True) as s:
        if mesh is None:
            a_full, d_full, py = setup(resolve_device(device))
        else:
            reps = _replicate(mesh, setup)
            a_full, d_full, py = ({dev: r[k] for dev, r in reps.items()}
                                  for k in range(3))
    num_snp = _any_replica(a_full if kind != "DD" else d_full).shape[1]
    logger.info("Screen engine setup (pieces/geno/codings): %.3f s",
                s.seconds)
    # AA/DD anchors stop at num_snp-2; the plain AD screen anchors over all
    # SNPs (the j > i mask empties the last), the AD *maf* screen stops at
    # num_snp-2 like AA
    hi_anchor = num_snp if (kind == "AD" and not maf) else num_snp - 1
    if snp_lst_0 is None:
        snp_lst_0 = range(hi_anchor)
    elif max(snp_lst_0) >= hi_anchor or min(snp_lst_0) < 0:
        raise ValueError("snp_lst_0 is out of range!")
    anchors = list(snp_lst_0)
    args = (py, anchors, bins_a, bins_b, eff_cut_table)
    kw = {"mesh": mesh}
    with span("screen.sweep", timed=True) as s:
        if kind == "AA":
            res = [_run_screen(a_full, a_full, *args, **kw)]
        elif kind == "DD":
            res = [_run_screen(d_full, d_full, *args, **kw)]
        else:
            res = [_run_screen(a_full, d_full, *args, **kw),
                   _run_screen(d_full, a_full, *args, flip_output=True, **kw)]
        idx0, idx1, eff = (np.concatenate(parts) for parts in zip(*res))
    logger.info("Screen sweep(s) incl. assembly: %.3f s, %d hits",
                s.seconds, len(idx0))
    return idx0, idx1, eff


def _g_round(eff):
    """`eff` as a screen file's `%g` text of it reads back: float() of
    each value's 6 significant digits."""
    return np.array([float("%g" % e) for e in np.asarray(eff).tolist()],
                    dtype=np.float64)


def _approx_chi_p(i0, i1, eff, bins_a, bins_b, freq_deno):
    """(chi_app, p_app) of the rows (i0, i1, eff): eff²/deno and its χ²₁
    survival.  The denominator is indexed bins_a[snp_0]*10 + bins_b[snp_1]
    on the WRITTEN row, which for AD's flipped orientation differs from the
    screen's cut index, as in the reference."""
    from scipy.stats import chi2 as chi2_dist

    deno = np.asarray(freq_deno)[
        np.asarray(bins_a)[i0] * 10 + np.asarray(bins_b)[i1]]
    chi_app = eff * eff / deno
    return chi_app, chi2_dist.sf(chi_app, 1)


def _append_approx_p(screen_file, out_file, bins_a, bins_b, freq_deno):
    """The screen file's rows with their `chi_app p_app` columns appended
    (`_approx_chi_p` of the rows as written)."""
    with span("screen.append", timed=True) as s, open(screen_file) as fin, \
            open(out_file, "w") as fout:
        head = fin.readline().strip()
        fout.write(head + " chi_app p_app\n")
        lines = fin.read().splitlines()
        if lines:
            toks = [line.split() for line in lines]
            i0 = np.array([int(t[0]) for t in toks], dtype=np.int64)
            i1 = np.array([int(t[1]) for t in toks], dtype=np.int64)
            eff = np.array([float(t[-1]) for t in toks])
            chi_app, p_app = _approx_chi_p(i0, i1, eff, bins_a, bins_b,
                                           freq_deno)
            fout.write("\n".join(
                " ".join(t + [str(c), str(p)])
                for t, c, p in zip(toks, chi_app, p_app)) + "\n")
    logger.info("Approx p append: %d rows in %.3f s", len(lines), s.seconds)


def _num_snp(bed_prefix):
    from gmat_tpu_torch.io.bed import read_bim

    return len(read_bim(bed_prefix + ".bim"))


def _flat_cuts(bed_prefix, var_app, p_cut):
    """(cut table, bins, denominators) of a screen at one approximate
    variance `var_app`: every bin 0."""
    table = np.full(111, np.sqrt(chi2_isf(p_cut, 1) * var_app))
    bins = np.zeros(_num_snp(bed_prefix), dtype=np.int64)
    return table, bins, np.full(111, var_app)


def _eff_file(kind, pheno_file, bed_prefix, gmat_lst, var_com, snp_lst_0,
              table, bins_a, bins_b, freq_deno, out_file, maf=False, dm=None,
              mesh=None, device=None):
    """The screen's hits to `out_file` as `snp_0 snp_1 eff chi_app p_app`:
    `snp_0 snp_1 eff` (`%g`) to a temporary file, then that file with the
    approx columns appended."""
    tmp = out_file + ".temp"
    with span("eff", root=True):
        hits = _screen_engine(kind, pheno_file, bed_prefix, gmat_lst, var_com,
                              snp_lst_0, table, bins_a, bins_b, maf=maf,
                              dm=dm, device=device, mesh=mesh)
        _write_screen(tmp, *hits)
        _append_approx_p(tmp, out_file, bins_a, bins_b, freq_deno)
        os.remove(tmp)
    return 0


def _screen_p_app(kind, pheno_file, bed_prefix, gmat_lst, var_com,
                  snp_lst_0, table, bins_a, bins_b, freq_deno, maf=False,
                  mesh=None, device=None):
    """`_eff_file`'s rows without its files: (idx0, idx1, p_app), p_app
    computed from eff as the `%g` text reads back."""
    idx0, idx1, eff = _screen_engine(kind, pheno_file, bed_prefix, gmat_lst,
                                     var_com, snp_lst_0, table, bins_a,
                                     bins_b, maf=maf, device=device,
                                     mesh=mesh)
    _, p_app = _approx_chi_p(idx0, idx1, _g_round(eff), bins_a, bins_b,
                             freq_deno)
    return idx0, idx1, p_app


def _remma_epi_eff(kind, pheno_file, bed_prefix, gmat_lst, var_com,
                   snp_lst_0=None, var_app=1.0, p_cut=1.0e-5,
                   out_file="epi_eff", dm=None, mesh=None, device=None):
    table, bins, deno = _flat_cuts(bed_prefix, var_app, p_cut)
    return _eff_file(kind, pheno_file, bed_prefix, gmat_lst, var_com,
                     snp_lst_0, table, bins, bins, deno, out_file, dm=dm,
                     device=device, mesh=mesh)


def _remma_epi_maf_eff(kind, pheno_file, bed_prefix, gmat_lst, var_com,
                       snp_lst_0=None, bins_a=None, bins_b=None,
                       freq_deno=None, p_cut=1.0e-5, out_file="epi_maf_eff",
                       dm=None, mesh=None, device=None):
    chi_cut = chi2_isf(p_cut, 1)
    num_snp = _num_snp(bed_prefix)
    if bins_a is None:
        bins_a = np.zeros(num_snp, dtype=np.int64)
    if bins_b is None:
        bins_b = np.zeros(num_snp, dtype=np.int64)
    if freq_deno is None:
        freq_deno = np.ones(111)
    freq_deno = np.asarray(freq_deno)
    return _eff_file(kind, pheno_file, bed_prefix, gmat_lst, var_com,
                     snp_lst_0, np.sqrt(chi_cut * freq_deno), bins_a, bins_b,
                     freq_deno, out_file, maf=True, dm=dm, device=device,
                     mesh=mesh)


# public *_eff screens ----------------------------------------------------------

def remma_epiAA_eff(pheno_file, bed_prefix, gmat_lst, var_com, snp_lst_0=None,
                    var_app=1.0, p_cut=1.0e-5, out_file="epiAA_eff",
                    mesh=None, device=None):
    return _remma_epi_eff("AA", pheno_file, bed_prefix, gmat_lst, var_com,
                          snp_lst_0, var_app, p_cut, out_file, device=device,
                          mesh=mesh)


def remma_epiAD_eff(pheno_file, bed_prefix, gmat_lst, var_com, snp_lst_0=None,
                    var_app=1.0, p_cut=1.0e-5, out_file="epiAD_eff",
                    mesh=None, device=None):
    return _remma_epi_eff("AD", pheno_file, bed_prefix, gmat_lst, var_com,
                          snp_lst_0, var_app, p_cut, out_file, device=device,
                          mesh=mesh)


def remma_epiDD_eff(pheno_file, bed_prefix, gmat_lst, var_com, snp_lst_0=None,
                    var_app=1.0, p_cut=1.0e-5, out_file="epiDD_eff",
                    mesh=None, device=None):
    return _remma_epi_eff("DD", pheno_file, bed_prefix, gmat_lst, var_com,
                          snp_lst_0, var_app, p_cut, out_file, device=device,
                          mesh=mesh)


def remma_epiAA_maf_eff(pheno_file, bed_prefix, gmat_lst, var_com,
                        snp_lst_0=None, freq=None, freq_deno=None,
                        p_cut=1.0e-5, out_file="epiAA_maf_eff", mesh=None,
                        device=None):
    """MAF-binned AA screen; `freq` = int(maf*20) bins for both SNPs."""
    return _remma_epi_maf_eff("AA", pheno_file, bed_prefix, gmat_lst, var_com,
                              snp_lst_0, freq, freq, freq_deno, p_cut,
                              out_file, device=device, mesh=mesh)


def remma_epiAD_maf_eff(pheno_file, bed_prefix, gmat_lst, var_com,
                        snp_lst_0=None, freqA=None, freqD=None,
                        freq_deno=None, p_cut=1.0e-5,
                        out_file="epiAD_maf_eff", mesh=None, device=None):
    """Binned AD screen; `freqA` = int(maf*20) bins of the A-coded side,
    `freqD` = int(het_freq*20) bins of the D-coded side."""
    return _remma_epi_maf_eff("AD", pheno_file, bed_prefix, gmat_lst, var_com,
                              snp_lst_0, freqA, freqD, freq_deno, p_cut,
                              out_file, device=device, mesh=mesh)


def remma_epiDD_maf_eff(pheno_file, bed_prefix, gmat_lst, var_com,
                        snp_lst_0=None, freq=None, freq_deno=None,
                        p_cut=1.0e-5, out_file="epiDD_maf_eff", mesh=None,
                        device=None):
    """Binned DD screen; `freq` = int(het_freq*20) heterozygote-frequency
    bins for both SNPs."""
    return _remma_epi_maf_eff("DD", pheno_file, bed_prefix, gmat_lst, var_com,
                              snp_lst_0, freq, freq, freq_deno, p_cut,
                              out_file, device=device, mesh=mesh)


# approximate pipelines -------------------------------------------------------

#: the pair tests' chunk width (`remma_epi*_pair`'s max_test_pair): one
#: canonical width fixes the last ulp of var and chi
_PAIR_WIDTH = 50000
#: the pair tests' p_cut: every row whose p is not NaN
_KEEP_ALL = 1.1
_TABLE_HEADER = "snp_0 snp_1 eff var chi p_app p\n"


def _csv_text(col):
    """The text `DataFrame.to_csv` writes for each value of a numpy column,
    as a list: `astype(str)`, NaN as the empty field."""
    text = col.astype(str)
    if col.dtype.kind == "f":
        text[np.isnan(col)] = ""
    return text.tolist()


def _csv_round_trip(x):
    """float64 `x` as `DataFrame.to_csv` writes it and `read_csv(sep=r"\\s+")`
    reads it back: the values a pair test's file hands over, which pandas'
    parser does not always return to the last ulp.  NaN stays NaN (the
    empty field `to_csv` writes reads back as NaN)."""
    x = np.asarray(x, dtype=np.float64)
    out = np.full_like(x, np.nan)
    ok = ~np.isnan(x)
    text = "\n".join(["x", *_csv_text(x[ok])])
    out[ok] = pd.read_csv(io.StringIO(text), header=0, sep=r"\s+")[
        "x"].to_numpy(dtype=np.float64)
    return out


def _write_approx_table(out_file, rows, p_app):
    """The merged table `snp_0 snp_1 eff var chi p_app p`: the re-test's
    columns `rows` (i, j, eff, var, chi, p) as `DataFrame.to_csv` writes
    them, p_app as str() of each float64."""
    i, j, eff, var, chi, p = (_csv_text(c) for c in rows)
    with open(out_file, "w") as f:
        f.write(_TABLE_HEADER)
        if len(i):
            f.write("\n".join(map(" ".join, zip(
                i, j, eff, var, chi, p_app.astype(str).tolist(), p))) + "\n")


def _p_app_of(idx0, idx1, p_app, i, j):
    """p_app of each re-tested pair (i, j): that of the last screen row
    (idx0, idx1) of the pair."""
    key = idx0 * (1 << 32) + idx1
    order = np.argsort(key, kind="stable")
    last = np.searchsorted(key[order], i * (1 << 32) + j, side="right") - 1
    return p_app[order[last]]


#: per-stage wall-clock seconds of the most recent approx-pipeline run
#: (keys: prep, draw, calibrate, screen, retest, merge, total), each the
#: seconds of its span `approx.<key>` (`approx` for the total)
LAST_APPROX_STAGES: dict = {}


def _approx_prep(kind, pheno_file, bed_prefix, gmat_lst, var_com,
                 mesh=None, device=None):
    """Warm every cross-stage cache (design parse, score pieces, device
    genotype panel, codings; on each device of `mesh`) and wait for the
    devices, so that the stage timers below measure each stage's own
    work.  Returns the pair tests' (mat0, mat1, pieces, num_snp)."""
    from gmat_tpu_torch.scan.pairs import _epi_setup

    devices = ((resolve_device(device),) if mesh is None
               else mesh.distinct_devices)
    for dev in devices:
        _epi_setup(pheno_file, bed_prefix, gmat_lst, var_com, kind, device=dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    return _epi_setup(pheno_file, bed_prefix, gmat_lst, var_com, kind,
                      mesh=mesh, device=device)[:4]


def _approx_pipeline(kind, pheno_file, bed_prefix, gmat_lst, var_com,
                     num_random_pair, out_file, seed, screen, device,
                     mesh=None):
    """prep -> draw (the `num_random_pair` random pairs) -> calibrate
    (their exact test) -> screen (`screen(calib)`: the hits and their
    p_app) -> exact re-test of the hits -> merge (the one table written,
    to `out_file`), each stage a span `approx.<stage>` whose seconds go to
    `LAST_APPROX_STAGES`.  The stages hand each other arrays; the table's
    bytes are those of the file pipeline (`remma_epi*_pair` files, the
    `*_eff` screen file, a line-by-line merge).  With `mesh`, all three
    device stages run over it (the screen through the `screen` callback)."""
    from gmat_tpu_torch.scan.pairs import _HEADER_PAIR, _pair_test
    from gmat_tpu_torch.scan.random_pair import _sample_pairs

    stages = {}
    with span("approx", root=True, timed=True) as whole:
        with span("approx.prep", timed=True) as s:
            mat0, mat1, pieces, num_snp = _approx_prep(
                kind, pheno_file, bed_prefix, gmat_lst, var_com, mesh=mesh,
                device=device)
        stages["prep"] = s.seconds

        def pair_test(pairs):
            return _pair_test(mat0, mat1, pieces, num_snp, pairs, _PAIR_WIDTH,
                              _KEEP_ALL, mesh)

        logger.info("Random calibration: %d pairs", num_random_pair)
        with span("approx.draw", timed=True) as s:
            # 5000: random_pair*'s num_each_pair
            drawn = _sample_pairs(num_snp, num_random_pair, 5000, kind == "AD",
                                  seed)
        stages["draw"] = s.seconds
        with span("approx.calibrate", timed=True) as s:
            calib = pd.DataFrame(dict(zip(_HEADER_PAIR.split(),
                                          pair_test(drawn))))
            with span("calibrate.var"):
                calib["var"] = _csv_round_trip(calib["var"])
        stages["calibrate"] = s.seconds
        with span("approx.screen", timed=True) as s:
            idx0, idx1, p_app = screen(calib)
        stages["screen"] = s.seconds
        logger.info("Exact re-test of survivors")
        with span("approx.retest", timed=True) as s:
            rows = pair_test(np.stack((idx0, idx1), axis=1).astype(np.int64))
        stages["retest"] = s.seconds
        with span("approx.merge", timed=True, rows=len(rows[0])) as s:
            _write_approx_table(out_file, rows,
                                _p_app_of(idx0, idx1, p_app, *rows[:2]))
        logger.info("Approx table: %d rows in %.3f s", len(rows[0]),
                    s.seconds)
        stages["merge"] = s.seconds
    stages["total"] = whole.seconds
    LAST_APPROX_STAGES.clear()
    LAST_APPROX_STAGES.update(stages)
    logger.info("Approx pipeline stages (s): %s",
                {k: round(v, 3) for k, v in stages.items()})
    return 0


def _remma_epi_approx(kind, pheno_file, bed_prefix, gmat_lst, var_com,
                      p_cut=1.0e-5, num_random_pair=100000,
                      out_file="epi_approx", snp_lst_0=None, seed=0,
                      mesh=None, device=None):
    def screen(calib):
        var_median = float(np.median(calib["var"]))
        logger.info("Approximate effect variance (median): %g", var_median)
        table, bins, deno = _flat_cuts(bed_prefix, var_median, p_cut)
        return _screen_p_app(kind, pheno_file, bed_prefix, gmat_lst, var_com,
                             snp_lst_0, table, bins, bins, deno,
                             device=device, mesh=mesh)

    return _approx_pipeline(kind, pheno_file, bed_prefix, gmat_lst, var_com,
                            num_random_pair, out_file, seed, screen, device,
                            mesh)


def _bin_denominators(calib, bins_a, bins_b, symmetric, out_file):
    """Per-bin-pair mean calibration variance, with the global mean for a
    bin pair no calibration pair fell in and 1 for the bin pairs that no
    SNP pair has; written as `k1 k2 value` lines over set(bins_a) x
    set(bins_b).  `symmetric` counts each pair under both keys."""
    b0 = bins_a[calib["snp_0"].to_numpy(dtype=np.int64)]
    b1 = bins_b[calib["snp_1"].to_numpy(dtype=np.int64)]
    v = calib["var"].to_numpy()
    sums = np.zeros(111)
    counts = np.zeros(111)
    for bb0, bb1, vv in zip(b0, b1, v):
        keys = (bb0 * 10 + bb1, bb1 * 10 + bb0) if symmetric \
            else (bb0 * 10 + bb1,)
        for key in keys:
            sums[key] += vv
            counts[key] += 1
    global_mean = sums.sum() / counts.sum()
    freq_deno = np.ones(111)
    with open(out_file, "w") as fout:
        for k1 in np.unique(bins_a):
            for k2 in np.unique(bins_b):
                key = k1 * 10 + k2
                freq_deno[key] = (sums[key] / counts[key]) if counts[key] \
                    else global_mean
                fout.write(f"{k1} {k2} {freq_deno[key]}\n")
    return freq_deno


def _remma_epi_maf_approx(kind, pheno_file, bed_prefix, gmat_lst, var_com,
                          p_cut=1.0e-5, num_random_pair=100000,
                          out_file="epi_maf_approx", snp_lst_0=None, seed=0,
                          mesh=None, device=None):
    from gmat_tpu_torch.scan.common import prepare_genotypes

    def screen(calib):
        geno, _, _ = prepare_genotypes(bed_prefix)
        # AA bins both sides by MAF (.freq); DD both by heterozygote
        # frequency (.heter); AD the A side by MAF (.maf) and the D side by
        # het frequency (.heter), with no key symmetrisation
        if kind == "AA":
            freq, bins_a = _maf_bins(geno)
            np.savetxt(out_file + ".freq", freq)
            bins_b = bins_a
        elif kind == "DD":
            freq, bins_a = _het_bins(geno)
            np.savetxt(out_file + ".heter", freq)
            bins_b = bins_a
        else:
            freq_a, bins_a = _maf_bins(geno)
            freq_d, bins_b = _het_bins(geno)
            np.savetxt(out_file + ".maf", freq_a)
            np.savetxt(out_file + ".heter", freq_d)
        freq_deno = _bin_denominators(calib, bins_a, bins_b, kind != "AD",
                                      out_file + ".freq_denominator")
        table = np.sqrt(chi2_isf(p_cut, 1) * freq_deno)
        return _screen_p_app(kind, pheno_file, bed_prefix, gmat_lst, var_com,
                             snp_lst_0, table, bins_a, bins_b, freq_deno,
                             maf=True, device=device, mesh=mesh)

    return _approx_pipeline(kind, pheno_file, bed_prefix, gmat_lst, var_com,
                            num_random_pair, out_file, seed, screen, device,
                            mesh)


def remma_epiAA_approx(pheno_file, bed_prefix, gmat_lst, var_com,
                       p_cut=1.0e-5, num_random_pair=100000,
                       out_file="epiAA_approx", seed=0, mesh=None,
                       device=None):
    """Flagship fast pipeline: calibrate -> screen -> exact re-test -> merge."""
    return _remma_epi_approx("AA", pheno_file, bed_prefix, gmat_lst, var_com,
                             p_cut, num_random_pair, out_file, seed=seed,
                             device=device, mesh=mesh)


def remma_epiAD_approx(pheno_file, bed_prefix, gmat_lst, var_com,
                       p_cut=1.0e-5, num_random_pair=100000,
                       out_file="epiAD_approx", seed=0, mesh=None,
                       device=None):
    return _remma_epi_approx("AD", pheno_file, bed_prefix, gmat_lst, var_com,
                             p_cut, num_random_pair, out_file, seed=seed,
                             device=device, mesh=mesh)


def remma_epiDD_approx(pheno_file, bed_prefix, gmat_lst, var_com,
                       p_cut=1.0e-5, num_random_pair=100000,
                       out_file="epiDD_approx", seed=0, mesh=None,
                       device=None):
    return _remma_epi_approx("DD", pheno_file, bed_prefix, gmat_lst, var_com,
                             p_cut, num_random_pair, out_file, seed=seed,
                             device=device, mesh=mesh)


def remma_epiAA_maf_approx(pheno_file, bed_prefix, gmat_lst, var_com,
                           p_cut=1.0e-5, num_random_pair=100000,
                           out_file="epiAA_maf_approx", seed=0, mesh=None,
                           device=None):
    return _remma_epi_maf_approx("AA", pheno_file, bed_prefix, gmat_lst,
                                 var_com, p_cut, num_random_pair, out_file,
                                 seed=seed, device=device, mesh=mesh)


def remma_epiAD_maf_approx(pheno_file, bed_prefix, gmat_lst, var_com,
                           p_cut=1.0e-5, num_random_pair=100000,
                           out_file="epiAD_maf_approx", seed=0, mesh=None,
                           device=None):
    return _remma_epi_maf_approx("AD", pheno_file, bed_prefix, gmat_lst,
                                 var_com, p_cut, num_random_pair, out_file,
                                 seed=seed, device=device, mesh=mesh)


def remma_epiDD_maf_approx(pheno_file, bed_prefix, gmat_lst, var_com,
                           p_cut=1.0e-5, num_random_pair=100000,
                           out_file="epiDD_maf_approx", seed=0, mesh=None,
                           device=None):
    return _remma_epi_maf_approx("DD", pheno_file, bed_prefix, gmat_lst,
                                 var_com, p_cut, num_random_pair, out_file,
                                 seed=seed, device=device, mesh=mesh)


# the *_parallel parts ------------------------------------------------------------

def _parallel_anchor_split(kind, bed_prefix, parallel, maf=False):
    """Balanced anchor split of one part: triangular (up to num_snp-2),
    except for the plain AD screens, whose anchors range over all SNPs."""
    from gmat_tpu_torch.scan.pairs import balanced_anchor_split

    return balanced_anchor_split(_num_snp(bed_prefix), parallel[0],
                                 parallel[1],
                                 triangular=(kind != "AD" or maf))


def _remma_epi_eff_parallel(kind, pheno_file, bed_prefix, gmat_lst, var_com,
                            parallel, var_app, p_cut, out_file, device):
    snp_lst_0 = _parallel_anchor_split(kind, bed_prefix, parallel)
    return _remma_epi_eff(kind, pheno_file, bed_prefix, gmat_lst, var_com,
                          snp_lst_0, var_app, p_cut,
                          f"{out_file}.{parallel[1]}", device=device)


def remma_epiAA_eff_parallel(pheno_file, bed_prefix, gmat_lst, var_com,
                             parallel, var_app=1.0, p_cut=1.0e-5,
                             out_file="epiAA_eff_parallel", device=None):
    return _remma_epi_eff_parallel("AA", pheno_file, bed_prefix, gmat_lst,
                                   var_com, parallel, var_app, p_cut, out_file,
                                   device)


def remma_epiAD_eff_parallel(pheno_file, bed_prefix, gmat_lst, var_com,
                             parallel, var_app=1.0, p_cut=1.0e-5,
                             out_file="epiAD_eff_parallel", device=None):
    return _remma_epi_eff_parallel("AD", pheno_file, bed_prefix, gmat_lst,
                                   var_com, parallel, var_app, p_cut, out_file,
                                   device)


def remma_epiDD_eff_parallel(pheno_file, bed_prefix, gmat_lst, var_com,
                             parallel, var_app=1.0, p_cut=1.0e-5,
                             out_file="epiDD_eff_parallel", device=None):
    return _remma_epi_eff_parallel("DD", pheno_file, bed_prefix, gmat_lst,
                                   var_com, parallel, var_app, p_cut, out_file,
                                   device)


def _remma_epi_approx_parallel(kind, pheno_file, bed_prefix, gmat_lst,
                               var_com, parallel, p_cut, num_random_pair,
                               out_file, seed, device):
    """One part's approx pipeline: it calibrates on its own random pairs
    (seed + part), screens its anchors and re-tests its survivors; the
    parts' `<out>.<part>` tables concatenate into the full table."""
    snp_lst_0 = _parallel_anchor_split(kind, bed_prefix, parallel)
    return _remma_epi_approx(
        kind, pheno_file, bed_prefix, gmat_lst, var_com, p_cut,
        num_random_pair, f"{out_file}.{parallel[1]}", snp_lst_0=snp_lst_0,
        seed=seed + parallel[1], device=device)


def remma_epiAA_approx_parallel(pheno_file, bed_prefix, gmat_lst, var_com,
                                parallel, p_cut=1.0e-5,
                                num_random_pair=100000,
                                out_file="epiAA_approx", seed=0, device=None):
    return _remma_epi_approx_parallel("AA", pheno_file, bed_prefix, gmat_lst,
                                      var_com, parallel, p_cut,
                                      num_random_pair, out_file, seed, device)


def remma_epiAD_approx_parallel(pheno_file, bed_prefix, gmat_lst, var_com,
                                parallel, p_cut=1.0e-5,
                                num_random_pair=100000,
                                out_file="epiAD_approx", seed=0, device=None):
    return _remma_epi_approx_parallel("AD", pheno_file, bed_prefix, gmat_lst,
                                      var_com, parallel, p_cut,
                                      num_random_pair, out_file, seed, device)


def remma_epiDD_approx_parallel(pheno_file, bed_prefix, gmat_lst, var_com,
                                parallel, p_cut=1.0e-5,
                                num_random_pair=100000,
                                out_file="epiDD_approx", seed=0, device=None):
    return _remma_epi_approx_parallel("DD", pheno_file, bed_prefix, gmat_lst,
                                      var_com, parallel, p_cut,
                                      num_random_pair, out_file, seed, device)


def _remma_epi_maf_eff_parallel(kind, pheno_file, bed_prefix, gmat_lst,
                                var_com, parallel, bins_a, bins_b, freq_deno,
                                p_cut, out_file, device):
    snp_lst_0 = _parallel_anchor_split(kind, bed_prefix, parallel, maf=True)
    return _remma_epi_maf_eff(kind, pheno_file, bed_prefix, gmat_lst, var_com,
                              snp_lst_0, bins_a, bins_b, freq_deno, p_cut,
                              f"{out_file}.{parallel[1]}", device=device)


def remma_epiAA_maf_eff_parallel(pheno_file, bed_prefix, gmat_lst, var_com,
                                 parallel, freq=None, freq_deno=None,
                                 p_cut=1.0e-5,
                                 out_file="epiAA_maf_eff_parallel",
                                 device=None):
    return _remma_epi_maf_eff_parallel("AA", pheno_file, bed_prefix, gmat_lst,
                                       var_com, parallel, freq, freq,
                                       freq_deno, p_cut, out_file, device)


def remma_epiAD_maf_eff_parallel(pheno_file, bed_prefix, gmat_lst, var_com,
                                 parallel, freqA=None, freqD=None,
                                 freq_deno=None, p_cut=1.0e-5,
                                 out_file="epiAD_maf_eff_parallel",
                                 device=None):
    """AD part screen; `freqA`/`freqD` as in `remma_epiAD_maf_eff`."""
    return _remma_epi_maf_eff_parallel("AD", pheno_file, bed_prefix, gmat_lst,
                                       var_com, parallel, freqA, freqD,
                                       freq_deno, p_cut, out_file, device)


def remma_epiDD_maf_eff_parallel(pheno_file, bed_prefix, gmat_lst, var_com,
                                 parallel, freq=None, freq_deno=None,
                                 p_cut=1.0e-5,
                                 out_file="epiDD_maf_eff_parallel",
                                 device=None):
    return _remma_epi_maf_eff_parallel("DD", pheno_file, bed_prefix, gmat_lst,
                                       var_com, parallel, freq, freq,
                                       freq_deno, p_cut, out_file, device)


def _remma_epi_maf_approx_parallel(kind, pheno_file, bed_prefix, gmat_lst,
                                   var_com, parallel, p_cut, num_random_pair,
                                   out_file, seed, device):
    snp_lst_0 = _parallel_anchor_split(kind, bed_prefix, parallel, maf=True)
    return _remma_epi_maf_approx(
        kind, pheno_file, bed_prefix, gmat_lst, var_com, p_cut,
        num_random_pair, f"{out_file}.{parallel[1]}", snp_lst_0=snp_lst_0,
        seed=seed + parallel[1], device=device)


def remma_epiAA_maf_approx_parallel(pheno_file, bed_prefix, gmat_lst, var_com,
                                    parallel, p_cut=1.0e-5,
                                    num_random_pair=100000,
                                    out_file="epiAA_maf_approx_parallel",
                                    seed=0, device=None):
    return _remma_epi_maf_approx_parallel("AA", pheno_file, bed_prefix,
                                          gmat_lst, var_com, parallel, p_cut,
                                          num_random_pair, out_file, seed,
                                          device)


def remma_epiAD_maf_approx_parallel(pheno_file, bed_prefix, gmat_lst, var_com,
                                    parallel, p_cut=1.0e-5,
                                    num_random_pair=100000,
                                    out_file="epiAD_maf_approx_parallel",
                                    seed=0, device=None):
    return _remma_epi_maf_approx_parallel("AD", pheno_file, bed_prefix,
                                          gmat_lst, var_com, parallel, p_cut,
                                          num_random_pair, out_file, seed,
                                          device)


def remma_epiDD_maf_approx_parallel(pheno_file, bed_prefix, gmat_lst, var_com,
                                    parallel, p_cut=1.0e-5,
                                    num_random_pair=100000,
                                    out_file="epiDD_maf_approx_parallel",
                                    seed=0, device=None):
    return _remma_epi_maf_approx_parallel("DD", pheno_file, bed_prefix,
                                          gmat_lst, var_com, parallel, p_cut,
                                          num_random_pair, out_file, seed,
                                          device)
