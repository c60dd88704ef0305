"""Legacy array-level REMMA API (counterpart of `gmat_tpu/scan/legacy.py`,
the reference's `gmat.remma.remma_cpu`).

These take (y, xmat, zmat) directly instead of a phenotype file:
`remma_add_cpu`/`remma_dom_cpu` and the per-epistasis-type
`{_cpu, _select_cpu, _pair_cpu, _eff_cpu}` family with its `_parallel` and
`_cpu_c` twins.  The "_cpu" suffix is historical: each runs on `device`
(default CUDA) through the same engines as the file-level API:
- `remma_epi*_cpu[_parallel]`: the exact-scan kernel K2
  (`pairs._scan_anchors`);
- `remma_epi*_eff_cpu[_c][_parallel]`: the screen kernels K1
  (`screen._screen_engine`), AD in both orientations;
- `remma_epi*_select_cpu` and `remma_epi*_pair_cpu`: the float64 pair test
  (`pairs._pair_kernel`).

`zmat` may be a scipy-sparse or dense 0/1 incidence matrix (one 1 per
record), or a `DesignMatrices`, which passes through unchanged.
"""
from __future__ import annotations

import numpy as np
import pandas as pd
import torch

from gmat_tpu_torch.config import resolve_device
from gmat_tpu_torch.core.coding import additive_code, dominance_code
from gmat_tpu_torch.io.pheno import DesignMatrices
from gmat_tpu_torch.scan.common import score_pieces
from gmat_tpu_torch.scan.pairs import (_HEADER_PAIR, _coded_panels,
                                       _has_intercept, _pair_kernel,
                                       _pair_test_file, _scan_anchors,
                                       _validate_anchors,
                                       balanced_anchor_split)
from gmat_tpu_torch.scan.screen import (_num_snp, _screen_engine,
                                        _write_screen)
from gmat_tpu_torch.scan.single import _run_single

_BAD_Z = "zmat must be a 0/1 incidence matrix with one 1 per row"


def _rec_ids_sparse(z):
    """Record -> column map of a scipy-sparse incidence matrix, checked
    without making it dense."""
    from scipy import sparse

    csr = sparse.csr_matrix(z, dtype=np.float64)
    csr.sum_duplicates()
    csr.eliminate_zeros()
    if not (np.all(csr.data == 1.0) and np.all(np.diff(csr.indptr) == 1)):
        raise ValueError(_BAD_Z)
    return csr.indices


def _as_dm(y, xmat, zmat) -> DesignMatrices:
    """(y, xmat, zmat) as a `DesignMatrices` on the host; only the
    record -> column map of `zmat` is kept."""
    if isinstance(zmat, DesignMatrices):
        return zmat
    y = np.asarray(y, float).reshape(-1)
    xmat = np.asarray(xmat, float).reshape(len(y), -1)
    if hasattr(zmat, "tocsr"):
        rec_ids, n_col = _rec_ids_sparse(zmat), zmat.shape[1]
    else:
        z = np.asarray(zmat)
        if z.ndim != 2 or not np.all((z == 0) | (z == 1)) or not np.all(
                z.sum(axis=1) == 1):
            raise ValueError(_BAD_Z)
        rec_ids, n_col = np.argmax(z, axis=1), z.shape[1]
    if len(rec_ids) != len(y):
        raise ValueError(_BAD_Z)
    return DesignMatrices(y=y, xmat=xmat, rec_ids=rec_ids.astype(np.int32),
                          n_col=n_col)


def remma_add_cpu(y, xmat, zmat, gmat_lst, var_com, bed_file,
                  out_file="remma_add_cpu", device=None):
    return _run_single(_as_dm(y, xmat, zmat), bed_file, gmat_lst, var_com,
                       additive_code, var_com[0], out_file, device)


def remma_dom_cpu(y, xmat, zmat, gmat_lst, var_com, bed_file,
                  out_file="remma_dom_cpu", device=None):
    return _run_single(_as_dm(y, xmat, zmat), bed_file, gmat_lst, var_com,
                       dominance_code, var_com[1], out_file, device)


def _dm_setup(kind, y, xmat, zmat, gmat_lst, var_com, bed_file, device):
    """The design, the score pieces and the coded device panels of an
    array-level call: (dm, pieces, mat0, mat1, num_snp, triangular)."""
    dev = resolve_device(device)
    dm = _as_dm(y, xmat, zmat)
    pieces = score_pieces(dm, gmat_lst, var_com, dev)
    return (dm, pieces) + _coded_panels(bed_file, kind, dev)


def _epi_cpu(kind, y, xmat, zmat, gmat_lst, var_com, bed_file, snp_lst_0,
             p_cut, out_file, device=None):
    dm, pieces, mat0, mat1, m, triangular = _dm_setup(
        kind, y, xmat, zmat, gmat_lst, var_com, bed_file, device)
    snp_lst_0 = _validate_anchors(snp_lst_0, m, triangular)
    return _scan_anchors(mat0, mat1, pieces, snp_lst_0, m, triangular, p_cut,
                         out_file, center=_has_intercept(dm))


def remma_epiAA_cpu(y, xmat, zmat, gmat_lst, var_com, bed_file,
                    snp_lst_0=None, p_cut=0.0001, out_file="remma_epiAA_cpu",
                    device=None):
    return _epi_cpu("AA", y, xmat, zmat, gmat_lst, var_com, bed_file,
                    snp_lst_0, p_cut, out_file, device)


def remma_epiAD_cpu(y, xmat, zmat, gmat_lst, var_com, bed_file,
                    snp_lst_0=None, p_cut=0.0001, out_file="remma_epiAD_cpu",
                    device=None):
    return _epi_cpu("AD", y, xmat, zmat, gmat_lst, var_com, bed_file,
                    snp_lst_0, p_cut, out_file, device)


def remma_epiDD_cpu(y, xmat, zmat, gmat_lst, var_com, bed_file,
                    snp_lst_0=None, p_cut=0.0001, out_file="remma_epiDD_cpu",
                    device=None):
    return _epi_cpu("DD", y, xmat, zmat, gmat_lst, var_com, bed_file,
                    snp_lst_0, p_cut, out_file, device)


def remma_epiAA_cpu_parallel(y, xmat, zmat, gmat_lst, var_com, bed_file,
                             parallel, p_cut=0.0001,
                             out_file="remma_epiAA_cpu_parallel", device=None):
    """Balanced-split part of the exact AA scan; writes `<out>.<i>`."""
    snp_lst_0 = balanced_anchor_split(_num_snp(bed_file), parallel[0],
                                      parallel[1])
    return _epi_cpu("AA", y, xmat, zmat, gmat_lst, var_com, bed_file,
                    snp_lst_0, p_cut, f"{out_file}.{parallel[1]}", device)


def _epi_select_cpu(kind, y, xmat, zmat, gmat_lst, var_com, bed_file,
                    snp_lst_0, snp_lst_1, p_cut, out_file, device=None):
    """Rectangular test of the ordered pairs snp_lst_0 x snp_lst_1, j != i,
    anchors additive- (AA, AD) or dominance-coded (DD), partners additive-
    (AA) or dominance-coded (AD, DD); one float64 pair-test call per
    anchor."""
    _, pieces, mat0, mat1, m, _ = _dm_setup(
        kind, y, xmat, zmat, gmat_lst, var_com, bed_file, device)
    lst0 = np.asarray(list(range(m)) if snp_lst_0 is None else snp_lst_0)
    lst1 = np.asarray(list(range(m)) if snp_lst_1 is None else snp_lst_1)
    if lst0.max() >= m or lst0.min() < 0 or lst1.max() >= m or lst1.min() < 0:
        raise ValueError("snp list is out of range!")
    cols1 = torch.as_tensor(lst1, device=mat0.device)
    np.savetxt(out_file, [_HEADER_PAIR], fmt="%s")
    with open(out_file, "a") as fout:
        for i in lst0:
            eff, var, chi, p = (t.cpu().numpy() for t in _pair_kernel(
                torch.full_like(cols1, int(i)), cols1, mat0, mat1,
                pieces.pymat, pieces.pvpmat))
            keep = (p < p_cut) & (lst1 != i)
            pd.DataFrame(
                {0: np.full(keep.sum(), i), 1: lst1[keep], 2: eff[keep],
                 3: var[keep], 4: chi[keep], 5: p[keep]}
            ).to_csv(fout, sep=" ", header=False, index=False)
    return 0


def remma_epiAA_select_cpu(y, xmat, zmat, gmat_lst, var_com, bed_file,
                           snp_lst_0=None, snp_lst_1=None, p_cut=1.0,
                           out_file="remma_epiAA_select_cpu", device=None):
    return _epi_select_cpu("AA", y, xmat, zmat, gmat_lst, var_com, bed_file,
                           snp_lst_0, snp_lst_1, p_cut, out_file, device)


def remma_epiAD_select_cpu(y, xmat, zmat, gmat_lst, var_com, bed_file,
                           snp_lst_0=None, snp_lst_1=None, p_cut=1.0,
                           out_file="remma_epiAD_select_cpu", device=None):
    return _epi_select_cpu("AD", y, xmat, zmat, gmat_lst, var_com, bed_file,
                           snp_lst_0, snp_lst_1, p_cut, out_file, device)


def remma_epiDD_select_cpu(y, xmat, zmat, gmat_lst, var_com, bed_file,
                           snp_lst_0=None, snp_lst_1=None, p_cut=1.0,
                           out_file="remma_epiDD_select_cpu", device=None):
    return _epi_select_cpu("DD", y, xmat, zmat, gmat_lst, var_com, bed_file,
                           snp_lst_0, snp_lst_1, p_cut, out_file, device)


def _epi_pair_cpu(kind, y, xmat, zmat, gmat_lst, var_com, bed_file,
                  snp_pair_file, max_test_pair, p_cut, out_file, device=None):
    _, pieces, mat0, mat1, m, _ = _dm_setup(
        kind, y, xmat, zmat, gmat_lst, var_com, bed_file, device)
    return _pair_test_file(mat0, mat1, pieces, m, snp_pair_file,
                           max_test_pair, p_cut, out_file)


def remma_epiAA_pair_cpu(y, xmat, zmat, gmat_lst, var_com, bed_file,
                         snp_pair_file, max_test_pair=50000, p_cut=1.0e-4,
                         out_file="remma_epiAA_pair_cpu", device=None):
    return _epi_pair_cpu("AA", y, xmat, zmat, gmat_lst, var_com, bed_file,
                         snp_pair_file, max_test_pair, p_cut, out_file,
                         device)


def remma_epiAD_pair_cpu(y, xmat, zmat, gmat_lst, var_com, bed_file,
                         snp_pair_file, max_test_pair=50000, p_cut=1.0e-4,
                         out_file="remma_epiAD_pair_cpu", device=None):
    return _epi_pair_cpu("AD", y, xmat, zmat, gmat_lst, var_com, bed_file,
                         snp_pair_file, max_test_pair, p_cut, out_file,
                         device)


def remma_epiDD_pair_cpu(y, xmat, zmat, gmat_lst, var_com, bed_file,
                         snp_pair_file, max_test_pair=50000, p_cut=1.0e-4,
                         out_file="remma_epiDD_pair_cpu", device=None):
    return _epi_pair_cpu("DD", y, xmat, zmat, gmat_lst, var_com, bed_file,
                         snp_pair_file, max_test_pair, p_cut, out_file,
                         device)


def _epi_eff_cpu(kind, y, xmat, zmat, gmat_lst, var_com, bed_file, snp_lst_0,
                 eff_cut, out_file, device=None):
    """Effect-only screen at one |eff| cut, written as `snp_0 snp_1 eff`
    (`%g`).  The reference's keep-everything eff_cut=-999 is cut 0: every
    pair with eff != 0.  AD screens both orientations.  Anchors default to
    0 .. m-2 for every kind (the last SNP has no partner j > i)."""
    num_snp = _num_snp(bed_file)
    if snp_lst_0 is None:
        snp_lst_0 = range(num_snp - 1)
    table = np.full(111, max(float(eff_cut), 0.0))
    bins = np.zeros(num_snp, dtype=np.int64)
    _write_screen(out_file, *_screen_engine(
        kind, None, bed_file, gmat_lst, var_com, snp_lst_0, table, bins, bins,
        dm=_as_dm(y, xmat, zmat), device=device))
    return 0


def remma_epiAA_eff_cpu(y, xmat, zmat, gmat_lst, var_com, bed_file,
                        snp_lst_0=None, eff_cut=-999.0,
                        out_file="remma_epiAA_eff_cpu", device=None):
    return _epi_eff_cpu("AA", y, xmat, zmat, gmat_lst, var_com, bed_file,
                        snp_lst_0, eff_cut, out_file, device)


def remma_epiAD_eff_cpu(y, xmat, zmat, gmat_lst, var_com, bed_file,
                        snp_lst_0=None, eff_cut=-999.0,
                        out_file="remma_epiAD_eff_cpu", device=None):
    return _epi_eff_cpu("AD", y, xmat, zmat, gmat_lst, var_com, bed_file,
                        snp_lst_0, eff_cut, out_file, device)


def remma_epiDD_eff_cpu(y, xmat, zmat, gmat_lst, var_com, bed_file,
                        snp_lst_0=None, eff_cut=-999.0,
                        out_file="remma_epiDD_eff_cpu", device=None):
    return _epi_eff_cpu("DD", y, xmat, zmat, gmat_lst, var_com, bed_file,
                        snp_lst_0, eff_cut, out_file, device)


# the reference's `_eff_cpu_c` twins differ from `_eff_cpu` only in being
# C-accelerated; here both names run the same screen kernels
remma_epiAA_eff_cpu_c = remma_epiAA_eff_cpu
remma_epiAD_eff_cpu_c = remma_epiAD_eff_cpu
remma_epiDD_eff_cpu_c = remma_epiDD_eff_cpu


def remma_epiAA_eff_cpu_c_parallel(y, xmat, zmat, gmat_lst, var_com, bed_file,
                                   parallel, eff_cut=-999.0,
                                   out_file="remma_epiAA_eff_cpu_c_parallel",
                                   device=None):
    snp_lst_0 = balanced_anchor_split(_num_snp(bed_file), parallel[0],
                                      parallel[1])
    return _epi_eff_cpu("AA", y, xmat, zmat, gmat_lst, var_com, bed_file,
                        snp_lst_0, eff_cut, f"{out_file}.{parallel[1]}",
                        device)
