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


def read_grm_id_id_val(path: str, ids) -> np.ndarray:
    """Read the id-id-val format into a dense symmetric matrix: ids not in
    `ids` are ignored, missing pairs are zero."""
    ids = [str(i) for i in ids]
    pos = {v: k for k, v in enumerate(ids)}
    n = len(ids)
    mat = np.zeros((n, n))
    df = pd.read_csv(path, sep=r"\s+", header=None, dtype=str)
    for id0, id1, val in df.itertuples(index=False):
        if id0 in pos and id1 in pos:
            i, j = pos[id0], pos[id1]
            mat[i, j] = mat[j, i] = float(val)
    return mat


def output_mat(mat, id, out_file, out_fmt):  # noqa: A002 - reference name
    """Reference-name API: returns 1 on success, 0 on an unrecognized
    format (the reference does nothing then, and does not raise)."""
    try:
        write_grm(mat, np.asarray(id), out_file, out_fmt)
    except ValueError:
        return 0
    return 1
