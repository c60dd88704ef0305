"""Longitudinal data parsing shared by the balance/unbalance pipelines.

A copy of `gmat_tpu/longwas/data.py` (host code): the port imports
nothing of the JAX package.

Conventions pinned to the reference GMAT (gmat/longwas/common.py:5-23,
balance/balance_varcom.py:49-126, unbalance/unbalance_varcom.py:50-122):
- data file: whitespace-separated with a header row; column names must start
  with a letter; an initial CAPITAL letter marks a categorical factor, an
  initial lowercase letter a continuous covariate;
- factors are integer-coded 1..K in order of first appearance;
- `na_method`: 'omit' drops rows with missing values, 'include' forward/
  backward-fills;
- kinship files are `id0 id1 value` lower-triangle rows keyed by the raw
  (pre-coding) id strings; ids in the data but not the kinship are an error;
- unbalance data must be sorted by individual id (blocks of consecutive rows).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import pandas as pd


@dataclass
class LongData:
    df: pd.DataFrame
    class_vec: list
    code_dct: dict  # factor -> raw value -> 1-based code
    id_col: str

    @property
    def n_records(self) -> int:
        return len(self.df)

    def id_codes(self) -> np.ndarray:
        """1-based integer codes of the id column, per record."""
        return self.df[self.id_col].to_numpy(dtype=np.int64)

    def raw_ids_in_code_order(self) -> list:
        inv = {v: k for k, v in self.code_dct[self.id_col].items()}
        return [inv[i + 1] for i in range(len(inv))]


def parse_long_data(data_file: str, id_col: str, na_method: str = "omit") -> LongData:
    df = pd.read_csv(data_file, sep=r"\s+", header=0)
    if na_method == "omit":
        df = df.dropna().reset_index(drop=True)
    elif na_method == "include":
        df = df.ffill().bfill().reset_index(drop=True)
    else:
        raise ValueError(f"na_method does not exist: {na_method}")
    class_vec = []
    for col in df.columns:
        if not col[0].isalpha():
            raise ValueError("The first character of column names must be a letter")
        if col[0].isupper():
            class_vec.append(col)
            df[col] = df[col].astype(str)
        else:
            df[col] = df[col].astype(float)
    if id_col not in df.columns:
        raise ValueError(f"{id_col} is not in the data file")
    if id_col not in class_vec:
        raise ValueError(f"The initial letter of {id_col} should be capital")
    code_dct: dict = {}
    for col in class_vec:
        codes: dict = {}
        out = np.empty(len(df), dtype=np.int64)
        for i, v in enumerate(df[col]):
            if v not in codes:
                codes[v] = len(codes) + 1
            out[i] = codes[v]
        code_dct[col] = codes
        df[col] = out
    return LongData(df=df, class_vec=class_vec, code_dct=code_dct, id_col=id_col)


def check_sorted_by_id(data: LongData) -> None:
    """Unbalance contract: records grouped by consecutive id blocks
    (reference unbalance_varcom.py:85-94)."""
    ids = data.df[data.id_col].to_numpy()
    firsts = np.concatenate([[True], ids[1:] != ids[:-1]])
    if len(set(ids[firsts])) != firsts.sum():
        raise ValueError("The data is not sorted by individual ID!")


def read_kin_by_codes(kin_file: str, data: LongData, add_missing: bool = False):
    """Dense symmetric kinship (or inverse) in id-code order.

    `add_missing=False` (balance, balance_varcom.py:108-131): file ids not in
    the data are skipped; data ids missing from the file raise.
    `add_missing=True` (unbalance, unbalance_varcom.py:171-198): unknown file
    ids get fresh codes so the MME carries them (matches the reference,
    which extends the id coding while reading the inverse kinship).
    """
    codes = data.code_dct[data.id_col]
    rows, cols, vals = [], [], []
    seen = set()
    with open(kin_file) as fin:
        for line in fin:
            arr = line.split()
            if arr[0] not in codes or arr[1] not in codes:
                if not add_missing:
                    continue
                for key in (arr[0], arr[1]):
                    if key not in codes:
                        codes[key] = len(codes) + 1
            seen.add(arr[0])
            seen.add(arr[1])
            rows.append(codes[arr[0]] - 1)
            cols.append(codes[arr[1]] - 1)
            vals.append(float(arr[2]))
    data_ids = set(data.df[data.id_col].map({v: k for k, v in codes.items()}))
    missing = data_ids - seen
    if missing:
        raise ValueError(
            "ids in the data file are not in the kinship file: "
            + " ".join(sorted(missing)[:5])
        )
    n = len(codes)
    kin = np.zeros((n, n))
    kin[rows, cols] = np.array(vals)
    kin = kin + kin.T
    np.fill_diagonal(kin, 0.5 * np.diag(kin))
    # the reference adds duplicate (i,j)+(j,i) entries if the file holds the
    # full matrix; ours assumes the documented lower-triangle format
    return kin


def build_fixed_formula(data: LongData, fix: str | None):
    """Treatment-coded design columns for a '+'-separated fixed-effect formula.

    Replaces the reference's patsy dependency (unbalance_varcom.py:148-162):
    categorical terms expand to K-1 dummy columns (first level reference),
    covariates enter as-is; the intercept column patsy would add is dropped,
    matching the reference's `xmat_nt[:, 1:]`.
    """
    if fix is None:
        return None
    cols = []
    for term in fix.split("+"):
        name = term.strip()
        if not name:
            continue
        if name not in data.df.columns:
            raise ValueError(f"fixed-effect term {name!r} not in the data file")
        if name in data.class_vec:
            codes = data.df[name].to_numpy(dtype=np.int64)
            for level in range(2, codes.max() + 1):
                cols.append((codes == level).astype(float))
        else:
            cols.append(data.df[name].to_numpy(dtype=float))
    if not cols:
        return None
    return np.column_stack(cols)


def longwas_lm(y, xmat):
    """OLS helper, reference contract (balance/common.py:128-138): returns
    (eff, eff_var, sigma) with sigma the residual variance estimate."""
    y = np.asarray(y, dtype=float).reshape(-1, 1)
    xmat = np.asarray(xmat, dtype=float).reshape(y.shape[0], -1)
    n, r = xmat.shape
    xx = np.linalg.inv(xmat.T @ xmat)
    yx = y.T @ xmat
    sigma = float((y.T @ y - yx @ xx @ yx.T) / (n - r))
    eff = xx @ yx.T
    return eff, xx * sigma, sigma
