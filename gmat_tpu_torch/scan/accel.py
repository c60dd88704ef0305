"""The reference's accelerator effect-screen API (`gmat.remma.remma_gpu`).

Counterpart of `gmat_tpu/scan/accel.py`: `remma_epiAA_eff_gpu(y, xmat,
gmat_lst, var_com, bed_file, ...)` keeps the additive x additive pairs
(i, j > i) of an anchor list with |eff| > eff_cut, writes them with
`np.savetxt(header='snp_0 snp_1 eff')` and returns them as a float array.
The whole scan is one call of the screen kernel K1
(`scan/kernels.py::screen_positions`), so the reference's `max_test_pair` column
streaming has no counterpart (accepted and ignored).  The default
`eff_cut=-999.0` keeps every tested pair, exact zeros included.

The reference's GPU signature has no `zmat`: one record per individual.
"""
from __future__ import annotations

import numpy as np
import torch

from gmat_tpu_torch.config import SCREEN_DTYPE, resolve_device


def remma_epiAA_eff_gpu(y, xmat, gmat_lst, var_com, bed_file, snp_lst_0=None,
                        max_test_pair=50000, eff_cut=-999.0,
                        out_file="remma_epiAA_eff_gpu", device=None):
    """Additive-by-additive effect-only screen on the GPU.

    Returns the kept rows as a float array with columns (snp_0, snp_1,
    eff), and writes them to `out_file` via `np.savetxt` with the
    reference's `snp_0 snp_1 eff` header."""
    from gmat_tpu_torch.core.coding import additive_code
    from gmat_tpu_torch.io.pheno import DesignMatrices
    from gmat_tpu_torch.scan.common import prepare_genotypes, score_pieces
    from gmat_tpu_torch.scan.screen import _run_screen

    del max_test_pair  # the reference's column-block streaming knob
    dev = resolve_device(device)
    y = np.asarray(y, float).reshape(-1)
    n = y.shape[0]
    xmat = np.asarray(xmat, float).reshape(n, -1)
    dm = DesignMatrices(y=y, xmat=xmat,
                        rec_ids=np.arange(n, dtype=np.int32), n_col=n)
    pieces = score_pieces(dm, gmat_lst, var_com, dev)
    geno, _, _ = prepare_genotypes(bed_file)
    m = geno.shape[1]
    mat = additive_code(torch.as_tensor(geno, device=dev))[0].to(
        SCREEN_DTYPE).contiguous()
    py = pieces.pymat.to(SCREEN_DTYPE).contiguous()
    anchors = list(snp_lst_0) if snp_lst_0 is not None else list(range(m - 1))
    if snp_lst_0 is not None and (max(anchors) >= m - 1 or min(anchors) < 0):
        raise ValueError("snp_lst_0 is out of range!")
    # the raw cut flows through: |eff| > -999 keeps every pair, exact zeros
    # of monomorphic SNPs included
    bins = np.zeros(m, dtype=np.int64)
    table = np.full(111, float(eff_cut), dtype=np.float32)
    idx0, idx1, eff = _run_screen(mat, mat, py, anchors, bins, bins, table)
    res = np.column_stack([idx0.astype(float), idx1.astype(float), eff])
    np.savetxt(out_file, res, header="snp_0 snp_1 eff", comments="")
    return res
