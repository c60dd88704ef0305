"""Exact epistasis score tests (counterpart of `gmat_tpu/scan/pairs.py`).

Per pair (i, j) with epistasis covariate e = m_i ⊙ m_j (elementwise over
individuals):   eff = eᵀ·pymat,   var = eᵀ·pvpmat·e,   chi = eff²/var,
p = P[χ²₁ > chi], all in float64 on the pieces' device.

- `remma_epiAA` / `remma_epiDD`: the strict upper triangle j > i of an
  anchor list against every partner; `remma_epiAD`: the full ordered
  rectangle, i == j included, anchor additive- and partner
  dominance-coded.  Rows `snp_0 snp_1 eff chi p_val` with p < p_cut, in the
  reference's order (anchors in list order, partners ascending), through
  the exact-scan kernel K2 (`scan/kernels.py::exact_hits`).
- `*_parallel`: one part of the balanced triangular anchor split, written
  to `f"{out_file}.{part}"`.
- `remma_epi*_pair`: an explicit pair list, `max_test_pair` pairs at a
  time in chunks padded to one canonical width, written as
  `snp_0 snp_1 eff var chi p` rows with p < p_cut; `_pair_test` is its
  array core, which the approx pipelines call without a file.

With `mesh=` (`dist/`), each round of an exhaustive scan hands one anchor
run to each shard, and each step of a pair test one chunk of the same
canonical width to each shard; the rows are written in the order of one
device's run, so the files are the same bytes.
"""
from __future__ import annotations

import logging

import numpy as np
import pandas as pd
import torch

from gmat_tpu_torch.config import resolve_device
from gmat_tpu_torch.core.coding import additive_code, dominance_code
from gmat_tpu_torch.core.roofline import log_phase, maybe_trace
from gmat_tpu_torch.core.spans import span
from gmat_tpu_torch.core.stats import chi2_isf, chi2_sf
from gmat_tpu_torch.dist.mesh import (_gather_rows, _map_shards, _replica,
                                      _replicate)

logger = logging.getLogger(__name__)

_HEADER_SCAN = "snp_0 snp_1 eff chi p_val"
_HEADER_PAIR = "snp_0 snp_1 eff var chi p"
_SCAN_PAIR_BUDGET = 1 << 24  # pairs per kernel call: bounds a keep-all buffer

_CODINGS = {
    "AA": (additive_code, additive_code, True),
    "AD": (additive_code, dominance_code, False),
    "DD": (dominance_code, dominance_code, True),
}

_CODING_KINDS = {"AA": ("add", "add"), "AD": ("add", "dom"),
                 "DD": ("dom", "dom")}


def _coded_panels(bed_prefix, kind, device=None):
    """The cached device panel of `bed_prefix` coded for `kind`:
    (mat0, mat1, num_snp, triangular)."""
    from gmat_tpu_torch.scan.common import (coded_matrix,
                                            prepare_genotypes_device)

    k0, k1 = _CODING_KINDS[kind]
    g, num_snp = prepare_genotypes_device(bed_prefix, device=device)
    return coded_matrix(g, k0), coded_matrix(g, k1), num_snp, _CODINGS[kind][2]


def _epi_setup(pheno_file, bed_prefix, gmat_lst, var_com, kind, mesh=None,
               device=None):
    """Pipeline-stage setup through the identity caches: the design parse,
    the O(n³) score pieces and the (n, m) coded panels are computed once
    and shared by the calibrate, screen and re-test stages.  With `mesh`,
    mat0, mat1 and the pieces are {device: value} maps over its devices."""
    from gmat_tpu_torch.scan.common import (design_matrix_cached,
                                            score_pieces_cached)

    def setup(dev):
        dm = design_matrix_cached(pheno_file, bed_prefix)
        pieces = score_pieces_cached(dm, gmat_lst, var_com, dev)
        mat0, mat1, num_snp, triangular = _coded_panels(bed_prefix, kind, dev)
        return mat0, mat1, pieces, num_snp, triangular

    if mesh is None:
        return setup(resolve_device(device))
    reps = _replicate(mesh, setup)
    first = next(iter(reps.values()))
    return tuple({dev: r[k] for dev, r in reps.items()}
                 for k in range(3)) + first[3:]


def _pair_kernel(cols0, cols1, mat0, mat1, pymat, pvpmat):
    e = mat0[:, cols0] * mat1[:, cols1]  # (n, B)
    eff = e.T @ pymat
    var = torch.sum(e * (pvpmat @ e), dim=0)
    chi = eff * eff / var
    return eff, var, chi, chi2_sf(chi, 1)


def _remma_epi_pair(kind, pheno_file, bed_prefix, gmat_lst, var_com,
                    snp_pair_file, max_test_pair, p_cut, out_file,
                    mesh=None, device=None):
    """Exact test for an explicit pair list, chunked max_test_pair at a time."""
    with span("pair", root=True):
        mat0, mat1, pieces, num_snp, _ = _epi_setup(
            pheno_file, bed_prefix, gmat_lst, var_com, kind, mesh=mesh,
            device=device)
        return _pair_test_file(mat0, mat1, pieces, num_snp, snp_pair_file,
                               max_test_pair, p_cut, out_file, mesh)


def _pair_test_file(mat0, mat1, pieces, num_snp, snp_pair_file,
                    max_test_pair, p_cut, out_file, mesh=None):
    """`_pair_test` from a pair file (header line, then `snp_0 snp_1 ...`)
    to a `snp_0 snp_1 eff var chi p` file.  Spans `pairs.read` and
    `pairs.write`."""
    with span("pairs.read"):
        try:
            pairs = pd.read_csv(snp_pair_file, sep=r"\s+", usecols=[0, 1],
                                skiprows=1,
                                header=None).to_numpy(dtype=np.int64)
        except pd.errors.EmptyDataError:
            # header-only pair file: a screen with zero survivors gives an
            # empty (header-only) result
            pairs = np.empty((0, 2), dtype=np.int64)
    rows = _pair_test(mat0, mat1, pieces, num_snp, pairs, max_test_pair,
                      p_cut, mesh)
    with span("pairs.write"), open(out_file, "w") as fout:
        fout.write(_HEADER_PAIR + "\n")
        pd.DataFrame(dict(enumerate(rows))).to_csv(
            fout, sep=" ", header=False, index=False)
    return 0


def _pair_test(mat0, mat1, pieces, num_snp, pairs, max_test_pair, p_cut,
               mesh=None):
    """The (k, 2) int64 `pairs` through `_pair_kernel`: the columns (i, j,
    eff, var, chi, p) of the rows with p < p_cut, in the pairs' order.
    With `mesh` (mat0, mat1 and pieces then as `_epi_setup` gives them),
    each step hands one chunk to each shard and the rows come in the order
    of one device's run.  Span `pairs.test`: a chunk through the kernel and
    back to the host, counting `pairs`."""
    if pairs.size and (pairs.max() > num_snp - 1 or pairs.min() < 0):
        raise ValueError("snp_pair is out of range!")
    # one canonical chunk width for every chunk of a call: the batch width
    # changes the BLAS accumulation order and hence the last ulp of var/chi
    width = max_test_pair
    if len(pairs):
        width = min(max_test_pair,
                    max(8, 1 << int(len(pairs) - 1).bit_length()))
    n_shards = 1 if mesh is None else mesh.size

    def shard(dev, chunk):
        if not len(chunk):
            empty = np.empty(0)
            return chunk[:, 0], chunk[:, 1], empty, empty, empty, empty
        with span("pairs.test", pairs=len(chunk)):
            cpad = np.concatenate(
                [chunk, np.repeat(chunk[-1:], width - len(chunk), 0)])
            cpad_d = torch.as_tensor(cpad, device=dev)
            pc = _replica(pieces, dev)
            outs = _pair_kernel(cpad_d[:, 0], cpad_d[:, 1],
                                _replica(mat0, dev), _replica(mat1, dev),
                                pc.pymat, pc.pvpmat)
            eff, var, chi, p = (a[: len(chunk)].cpu().numpy() for a in outs)
        keep = p < p_cut
        return (chunk[keep, 0], chunk[keep, 1], eff[keep], var[keep],
                chi[keep], p[keep])

    rows = [shard(None, pairs[:0])]  # the columns' dtypes when no step runs
    for start in range(0, len(pairs), width * n_shards):
        chunks = [pairs[start + k * width:start + (k + 1) * width]
                  for k in range(n_shards)]
        if mesh is None:
            rows.append(shard(mat0.device, chunks[0]))
        else:
            rows += _gather_rows(mesh, _map_shards(
                mesh, shard, [chunks[k] for k in mesh.shard_ids]))
    return tuple(np.concatenate(col) for col in zip(*rows))


def remma_epiAA_pair(pheno_file, bed_prefix, gmat_lst, var_com, snp_pair_file,
                     max_test_pair=50000, p_cut=1.0e-4, out_file="epiAA_pair",
                     mesh=None, device=None):
    return _remma_epi_pair("AA", pheno_file, bed_prefix, gmat_lst, var_com,
                           snp_pair_file, max_test_pair, p_cut, out_file,
                           mesh=mesh, device=device)


def remma_epiAD_pair(pheno_file, bed_prefix, gmat_lst, var_com, snp_pair_file,
                     max_test_pair=50000, p_cut=1.0e-4, out_file="epiAD_pair",
                     mesh=None, device=None):
    return _remma_epi_pair("AD", pheno_file, bed_prefix, gmat_lst, var_com,
                           snp_pair_file, max_test_pair, p_cut, out_file,
                           mesh=mesh, device=device)


def remma_epiDD_pair(pheno_file, bed_prefix, gmat_lst, var_com, snp_pair_file,
                     max_test_pair=50000, p_cut=1.0e-4, out_file="epiDD_pair",
                     mesh=None, device=None):
    return _remma_epi_pair("DD", pheno_file, bed_prefix, gmat_lst, var_com,
                           snp_pair_file, max_test_pair, p_cut, out_file,
                           mesh=mesh, device=device)


# the exhaustive scans ---------------------------------------------------------

def _chi2_sf_host(chi):
    """df=1 survival function on the host, the erfc identity of
    `core.stats.chi2_sf`."""
    from scipy.special import erfc

    return erfc(np.sqrt(np.maximum(chi, 0.0) / 2.0))


def _anchor_runs(anchors, per, budget):
    """Consecutive runs of the anchor list whose pair counts `per` sum to
    at most `budget` (an anchor with more pairs than that is a run of its
    own)."""
    start, acc = 0, 0
    for k, count in enumerate(per.tolist()):
        if acc + count > budget and k > start:
            yield anchors[start:k]
            start, acc = k, 0
        acc += count
    if start < len(anchors):
        yield anchors[start:]


def _has_intercept(dm) -> bool:
    """Whether X holds a constant column.  Then P·1 = 0, and so
    pvpmat·1 = ZᵀPZ·1 = 0 (Z maps each record to one individual)."""
    x = dm.xmat
    return bool(np.any(np.all(x == x[:1], axis=0) & (x[0] != 0)))


def _scan_anchors(mat0, mat1, pieces, snp_lst_0, num_snp, triangular, p_cut,
                  out_file, center=False, mesh=None):
    """Every anchor of `snp_lst_0` against every partner (j > anchor when
    `triangular`) through the exact-scan kernel, rows with p < p_cut
    written as `snp_0 snp_1 eff chi p_val`, anchors in list order and
    partners ascending.  chi > chi2.isf(p_cut, 1) on the device is the
    reference's p < p_cut; a p_cut of 1 or more keeps every pair whose chi
    is not NaN.  `center`: see `kernels.exact_hits`.

    The anchors go in runs of at most `_SCAN_PAIR_BUDGET` pairs, one run
    per shard and round with `mesh` (mat0, mat1 and pieces then as
    `_epi_setup` gives them), written in list order.  Traced under
    "exact_scan" (`maybe_trace`).  Spans: `exact.scan` around the runs,
    whose seconds the log lines read, and under it `exact.kernel` (a run
    through K2 and its hits to the host, counting `pairs` and `hits`) and
    `exact.write` (a round's rows and their p).  The roofline line counts
    the least FLOP of a pair, n² + 7n for a symmetric pvpmat (the JAX
    package's counts 2n² + 4n, the whole product P·e)."""
    with maybe_trace("exact_scan"):
        return _scan_anchors_impl(mat0, mat1, pieces, snp_lst_0, num_snp,
                                  triangular, p_cut, out_file, center, mesh)


def _scan_anchors_impl(mat0, mat1, pieces, snp_lst_0, num_snp, triangular,
                       p_cut, out_file, center, mesh):
    from gmat_tpu_torch.dist.mesh import _any_replica
    from gmat_tpu_torch.scan.kernels import exact_hits, pairs_per_anchor

    np.savetxt(out_file, [_HEADER_SCAN], fmt="%s")
    anchors = np.asarray(list(snp_lst_0), dtype=np.int64)
    chi_crit = chi2_isf(p_cut, 1) if p_cut < 1.0 else -1.0
    mask = "tri" if triangular else "rect"
    per = pairs_per_anchor(torch.from_numpy(anchors), num_snp, mask).numpy()
    runs = list(_anchor_runs(anchors, per, _SCAN_PAIR_BUDGET))
    cuts = np.cumsum([0] + [len(run) for run in runs])
    runs = [(run, int(per[a:b].sum()))
            for run, a, b in zip(runs, cuts, cuts[1:])]
    n_shards = 1 if mesh is None else mesh.size

    def shard(dev, share):
        run, n_run = share
        if not len(run):
            empty = np.empty(0)
            return run, run, empty, empty
        with span("exact.kernel", pairs=n_run) as s:
            pc = _replica(pieces, dev)
            i, j, eff, _, chi = (t.cpu().numpy() for t in exact_hits(
                _replica(mat0, dev), _replica(mat1, dev), pc.pymat,
                pc.pvpmat, torch.as_tensor(run, device=dev), chi_crit, mask,
                center))
            s.count("hits", len(i))
        return i, j, eff, chi

    n_hits = 0
    with span("exact.scan", timed=True) as scan, open(out_file, "a") as fout:
        for r0 in range(0, len(runs), n_shards):
            group = runs[r0:r0 + n_shards]
            group += [(anchors[:0], 0)] * (n_shards - len(group))
            if mesh is None:
                parts = [shard(mat0.device, group[0])]
            else:
                parts = _gather_rows(mesh, _map_shards(
                    mesh, shard, [group[k] for k in mesh.shard_ids]))
            with span("exact.write"):
                for i, j, eff, chi in parts:
                    n_hits += len(i)
                    pd.DataFrame({0: i, 1: j, 2: eff, 3: chi,
                                  4: _chi2_sf_host(chi)}
                                 ).to_csv(fout, sep=" ", header=False,
                                          index=False)
    dt = scan.seconds
    n_pairs = int(per.sum())
    logger.info("Exact scan: %d anchors, %d tests, %d hits in %.3f s "
                "(%.3g pairs/s)", len(anchors), n_pairs, n_hits, dt,
                n_pairs / max(dt, 1e-9))
    n = _any_replica(mat0).shape[0]
    log_phase("exact_scan", float(n_pairs) * (n * n + 7.0 * n), dt,
              items=n_pairs)
    return 0


def _validate_anchors(snp_lst_0, num_snp, triangular):
    hi = num_snp - 1 if triangular else num_snp
    if snp_lst_0 is None:
        return range(hi)
    if max(snp_lst_0) >= hi or min(snp_lst_0) < 0:
        raise ValueError("snp_lst_0 is out of range!")
    return snp_lst_0


def _remma_epi(kind, pheno_file, bed_prefix, gmat_lst, var_com, snp_lst_0,
               p_cut, out_file, mesh=None, device=None):
    from gmat_tpu_torch.scan.common import design_matrix_cached

    with span("exact", root=True):
        with span("exact.setup"):
            mat0, mat1, pieces, num_snp, triangular = _epi_setup(
                pheno_file, bed_prefix, gmat_lst, var_com, kind, mesh=mesh,
                device=device)
        snp_lst_0 = _validate_anchors(snp_lst_0, num_snp, triangular)
        # the design is cached: this is the object _epi_setup parsed
        dm = design_matrix_cached(pheno_file, bed_prefix)
        return _scan_anchors(mat0, mat1, pieces, snp_lst_0, num_snp,
                             triangular, p_cut, out_file,
                             center=_has_intercept(dm), mesh=mesh)


def remma_epiAA(pheno_file, bed_prefix, gmat_lst, var_com, snp_lst_0=None,
                p_cut=1.0e-5, out_file="epiAA", mesh=None, device=None):
    """Exhaustive additive x additive scan (strict upper triangle)."""
    return _remma_epi("AA", pheno_file, bed_prefix, gmat_lst, var_com,
                      snp_lst_0, p_cut, out_file, mesh=mesh, device=device)


def remma_epiAD(pheno_file, bed_prefix, gmat_lst, var_com, snp_lst_0=None,
                p_cut=1.0e-5, out_file="epiAD", mesh=None, device=None):
    """Exhaustive additive x dominance scan (full ordered rectangle)."""
    return _remma_epi("AD", pheno_file, bed_prefix, gmat_lst, var_com,
                      snp_lst_0, p_cut, out_file, mesh=mesh, device=device)


def remma_epiDD(pheno_file, bed_prefix, gmat_lst, var_com, snp_lst_0=None,
                p_cut=1.0e-5, out_file="epiDD", mesh=None, device=None):
    """Exhaustive dominance x dominance scan (strict upper triangle)."""
    return _remma_epi("DD", pheno_file, bed_prefix, gmat_lst, var_com,
                      snp_lst_0, p_cut, out_file, mesh=mesh, device=device)


def balanced_anchor_split(num_snp: int, n_parts: int, part: int,
                          triangular: bool = True) -> list[int]:
    """Balanced triangular anchor split for manual multi-machine sharding.

    Pairs block (part-1) with block (2*n_parts - part) so every worker sees
    the same pair count; the first part takes the remainder, up to
    num_snp - 1 (triangular) or num_snp (AD)."""
    num_snp_part = num_snp // (2 * n_parts)
    p0 = (part - 1) * num_snp_part
    p1 = part * num_snp_part
    p2 = (2 * n_parts - part) * num_snp_part
    p3 = (2 * n_parts - part + 1) * num_snp_part
    if part == 1:
        p3 = num_snp - 1 if triangular else num_snp
    return list(range(p0, p1)) + list(range(p2, p3))


def _remma_epi_parallel(kind, pheno_file, bed_prefix, gmat_lst, var_com,
                        parallel, p_cut, out_file, device=None):
    from gmat_tpu_torch.io.bed import read_bim

    num_snp = len(read_bim(bed_prefix + ".bim"))
    snp_lst_0 = balanced_anchor_split(num_snp, parallel[0], parallel[1],
                                      triangular=_CODINGS[kind][2])
    logger.info("Parallel part %d/%d: %d anchors", parallel[1], parallel[0],
                len(snp_lst_0))
    return _remma_epi(kind, pheno_file, bed_prefix, gmat_lst, var_com,
                      snp_lst_0, p_cut, f"{out_file}.{parallel[1]}",
                      device=device)


def remma_epiAA_parallel(pheno_file, bed_prefix, gmat_lst, var_com, parallel,
                         p_cut=1.0e-5, out_file="epiAA_parallel", device=None):
    return _remma_epi_parallel("AA", pheno_file, bed_prefix, gmat_lst,
                               var_com, parallel, p_cut, out_file, device)


def remma_epiAD_parallel(pheno_file, bed_prefix, gmat_lst, var_com, parallel,
                         p_cut=1.0e-5, out_file="epiAD_parallel", device=None):
    return _remma_epi_parallel("AD", pheno_file, bed_prefix, gmat_lst,
                               var_com, parallel, p_cut, out_file, device)


def remma_epiDD_parallel(pheno_file, bed_prefix, gmat_lst, var_com, parallel,
                         p_cut=1.0e-5, out_file="epiDD_parallel", device=None):
    return _remma_epi_parallel("DD", pheno_file, bed_prefix, gmat_lst,
                               var_com, parallel, p_cut, out_file, device)
