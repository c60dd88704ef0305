"""Phenotype parsing and mixed-model design structures.

Counterpart of `gmat_tpu/io/pheno.py`: phenotype files keyed by (family id,
individual id), covariates between the ids and the phenotype, repeated
records per individual allowed, records ordered by the .fam file,
'NA'/'NaN'/'nan'/'na' phenotypes dropped.

Z is an integer record->column index vector (`rec_ids`):
Z G Zᵀ == G[rec_ids][:, rec_ids] (two `index_select`s) and
Zᵀ b == zeros(n_col).index_add_(0, rec_ids, b).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from gmat_tpu_torch.config import EXACT_DTYPE, resolve_device
from gmat_tpu_torch.core.spans import count

_NA = {"NA", "NaN", "nan", "na"}


@dataclass(frozen=True)
class DesignMatrices:
    """y (n_rec,), X (n_rec, p), and the incidence map for Z (n_rec x n_col).

    `rec_ids[r]` is the Z column (individual slot) of record r.  The fields
    are host numpy arrays; the methods move what they need to `device`."""

    y: np.ndarray
    xmat: np.ndarray
    rec_ids: np.ndarray
    n_col: int

    @property
    def n_rec(self) -> int:
        return self.y.shape[0]

    def rec_index(self, device=None) -> torch.Tensor:
        return torch.as_tensor(self.rec_ids, dtype=torch.int64,
                               device=resolve_device(device))

    def zdot(self, a, device=None):
        """Z @ a — gather rows of a per record."""
        dev = resolve_device(device)
        return torch.as_tensor(a, device=dev).index_select(
            0, self.rec_index(dev))

    def ztdot(self, b, device=None):
        """Zᵀ @ b — sum records into individual slots."""
        dev = resolve_device(device)
        b = torch.as_tensor(b, device=dev)
        out = torch.zeros((self.n_col,) + tuple(b.shape[1:]), dtype=b.dtype,
                          device=dev)
        return out.index_add_(0, self.rec_index(dev), b)

    def zgzt(self, gmat, device=None):
        """Z G Zᵀ as a dense (n_rec, n_rec) float64 tensor.  A host GRM
        (not a tensor) crosses to `device` here: its bytes count in
        `h2d_bytes` (`core.spans`), on the CPU device too."""
        dev = resolve_device(device)
        idx = self.rec_index(dev)
        if not isinstance(gmat, torch.Tensor):
            count("h2d_bytes", np.asarray(gmat).nbytes)
        g = torch.as_tensor(gmat, dtype=EXACT_DTYPE, device=dev)
        return g.index_select(0, idx).index_select(1, idx)

    def z_dense(self):
        z = np.zeros((self.n_rec, self.n_col))
        z[np.arange(self.n_rec), self.rec_ids] = 1.0
        return z


def _parse_pheno(pheno_file: str):
    """-> dict '(fid iid)' -> list of token-rows (filtered for NA pheno)."""
    recs: dict[str, list[list[str]]] = {}
    with open(pheno_file) as fin:
        for line in fin:
            arr = line.split()
            if not arr or arr[-1] in _NA:
                continue
            recs.setdefault(" ".join(arr[:2]), []).append(arr)
    return recs


def _fam_keys(bed_prefix: str):
    keys = []
    with open(bed_prefix + ".fam") as fin:
        for line in fin:
            arr = line.split()
            keys.append((" ".join(arr[:2]), arr[1]))
    return keys


def design_matrix(pheno_file: str, bed_prefix: str) -> DesignMatrices:
    """All genotyped individuals must be phenotyped (raises otherwise)."""
    recs = _parse_pheno(pheno_file)
    keys = _fam_keys(bed_prefix)
    missing = [k for k, _ in keys if k not in recs]
    if missing:
        raise ValueError(
            "genotyped ids missing from the phenotype file: "
            + ", ".join(missing[:5])
            + ("..." if len(missing) > 5 else "")
        )
    y, xmat, rec_ids = [], [], []
    id_slot: dict[str, int] = {}
    for key, iid in keys:
        for arr in recs[key]:
            y.append(float(arr[-1]))
            xmat.append([float(v) for v in arr[2:-1]])
            if iid not in id_slot:
                id_slot[iid] = len(id_slot)
            rec_ids.append(id_slot[iid])
    return DesignMatrices(
        y=np.asarray(y),
        xmat=np.asarray(xmat, dtype=float).reshape(len(y), -1),
        rec_ids=np.asarray(rec_ids, dtype=np.int32),
        n_col=len(id_slot),
    )


def design_matrix_pred(pheno_file: str, bed_prefix: str) -> DesignMatrices:
    """Prediction variant: un-phenotyped individuals keep (empty) Z columns,
    in .fam order, so that BLUPs are produced for them."""
    recs = _parse_pheno(pheno_file)
    keys = _fam_keys(bed_prefix)
    y, xmat, rec_ids = [], [], []
    id_slot: dict[str, int] = {}
    n_col = 0
    for key, iid in keys:
        if key in recs:
            for arr in recs[key]:
                y.append(float(arr[-1]))
                xmat.append([float(v) for v in arr[2:-1]])
                if iid not in id_slot:
                    id_slot[iid] = n_col
                    n_col += 1
                rec_ids.append(id_slot[iid])
        else:
            n_col += 1
    return DesignMatrices(
        y=np.asarray(y),
        xmat=np.asarray(xmat, dtype=float).reshape(len(y), -1),
        rec_ids=np.asarray(rec_ids, dtype=np.int32),
        n_col=n_col,
    )


def _dm_to_tuple(dm: DesignMatrices):
    from scipy import sparse

    n_rec = len(dm.rec_ids)
    zmat = sparse.csr_matrix(
        (np.ones(n_rec), (np.arange(n_rec), dm.rec_ids)),
        shape=(n_rec, dm.n_col),
    )
    return dm.y.reshape(-1, 1), dm.xmat, zmat


def design_matrix_wemai_multi_gmat(pheno_file: str, bed_prefix: str):
    """Reference-name API: (y (n, 1), X dense, Z a scipy CSR
    record->individual incidence)."""
    return _dm_to_tuple(design_matrix(pheno_file, bed_prefix))


def design_matrix_wemai_multi_gmat_pred(pheno_file: str, bed_prefix: str):
    """Reference-name API of the prediction variant: empty Z columns for
    un-phenotyped individuals."""
    return _dm_to_tuple(design_matrix_pred(pheno_file, bed_prefix))
