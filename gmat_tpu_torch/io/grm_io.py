"""GRM file formats, byte-identical to `gmat_tpu/io/grm_io.py`.

- 'mat'         -> `<out>0`: dense matrix via np.savetxt
- 'row_col_val' -> `<out>1`: 1-based lower-triangle "row col val" rows
- 'id_id_val'   -> `<out>2`: "id0 id1 val" rows keyed by .fam individual ids
"""
from __future__ import annotations

import numpy as np
import pandas as pd


def write_grm(mat: np.ndarray, ids: np.ndarray, out_prefix: str, out_fmt: str = "mat") -> str:
    mat = np.asarray(mat)
    if out_fmt == "mat":
        np.savetxt(out_prefix + "0", mat)
        return out_prefix + "0"
    ind = np.tril_indices_from(mat)
    if out_fmt == "row_col_val":
        df = pd.DataFrame({"row": ind[0] + 1, "col": ind[1] + 1, "val": mat[ind]})
        df.to_csv(out_prefix + "1", sep=" ", index=False, header=False)
        return out_prefix + "1"
    if out_fmt == "id_id_val":
        ids = np.asarray(ids)
        df = pd.DataFrame({"id0": ids[ind[0]], "id1": ids[ind[1]], "val": mat[ind]})
        df.to_csv(out_prefix + "2", sep=" ", index=False, header=False)
        return out_prefix + "2"
    raise ValueError(f"unrecognized GRM output format: {out_fmt!r}")


def read_grm_mat(path: str) -> np.ndarray:
    """Read the dense 'mat' format (`*.agrm0` / `*.dgrm_as0`)."""
    return np.loadtxt(path)
