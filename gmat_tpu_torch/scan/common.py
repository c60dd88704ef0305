"""Shared score-test machinery for the REMMA engine.

Counterpart of `gmat_tpu/scan/common.py`.  Every REMMA test needs two
projections of the phenotype under the null model:

    pymat  = Zᵀ P y          (n_id,)
    pvpmat = Zᵀ P Z          (n_id, n_id)

with P = V⁻¹ − V⁻¹X(XᵀV⁻¹X)⁻¹XᵀV⁻¹ and V = Σ_i σ²_i Z G_i Zᵀ + σ²_e I,
computed once per (model, variance) pair in float64 and reused by every
stage of a pipeline through the identity caches below.  Each cache holds
one entry per device, so that the shards of a mesh (`dist/`) on several
devices keep their own copies between calls.
"""
from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch

from gmat_tpu_torch.config import EXACT_DTYPE, resolve_device
from gmat_tpu_torch.core.linalg import chol_inv_logdet, projection_pieces
from gmat_tpu_torch.core.spans import count, span
from gmat_tpu_torch.io.pheno import DesignMatrices
from gmat_tpu_torch.reml.wemai import _vmat, build_zgzt_stack


@dataclass(frozen=True)
class ScorePieces:
    pymat: torch.Tensor  # (n_id,)
    pvpmat: torch.Tensor  # (n_id, n_id)


def _pieces_kernel(var_com, y, xmat, zg_stack, rec_ids, n_col):
    vinv, _ = chol_inv_logdet(_vmat(var_com, zg_stack))
    pmat, _ = projection_pieces(vinv, xmat)
    py = pmat @ y
    n = y.shape[0]
    pymat = torch.zeros(n_col, dtype=py.dtype, device=py.device).index_add_(
        0, rec_ids, py)
    zp = torch.zeros((n_col, n), dtype=py.dtype, device=py.device).index_add_(
        0, rec_ids, pmat)  # Zᵀ P
    pvpmat = torch.zeros((n_col, n_col), dtype=py.dtype,
                         device=py.device).index_add_(0, rec_ids, zp.T)
    return pymat, pvpmat


def score_pieces(dm: DesignMatrices, gmat_lst, var_com, device=None) -> ScorePieces:
    dev = resolve_device(device)
    pymat, pvpmat = _pieces_kernel(
        torch.as_tensor(np.asarray(var_com, dtype=np.float64), device=dev),
        torch.as_tensor(dm.y, dtype=EXACT_DTYPE, device=dev),
        torch.as_tensor(dm.xmat, dtype=EXACT_DTYPE, device=dev),
        build_zgzt_stack(dm, gmat_lst, dev),
        dm.rec_index(dev),
        dm.n_col,
    )
    return ScorePieces(pymat=pymat, pvpmat=pvpmat)


def score_pieces_from_numpy(pymat, pvpmat, device=None) -> ScorePieces:
    """ScorePieces from host arrays, e.g. the JAX package's pieces."""
    dev = resolve_device(device)
    return ScorePieces(
        pymat=torch.as_tensor(np.asarray(pymat), dtype=EXACT_DTYPE, device=dev),
        pvpmat=torch.as_tensor(np.asarray(pvpmat), dtype=EXACT_DTYPE,
                               device=dev))


def _slot(device) -> torch.device:
    """The cache slot of a device: the device itself, with a CUDA device
    that names no index taken as the current one (a tensor's device always
    names its index)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


_PIECES_CACHE: dict = {}  # device -> (key, (dm, GRMs), ScorePieces)


def score_pieces_cached(dm: DesignMatrices, gmat_lst, var_com,
                        device=None) -> ScorePieces:
    """`score_pieces` with one entry per device, keyed by the identities of
    the inputs (dm, each GRM) and the variance values.

    The approx pipeline's calibrate, screen and re-test stages all ask for
    the same pieces; entries hold strong references, so an id is never
    recycled while cached, and any fresh object is a miss.  A device that
    misses copies the pieces of another device of its type that holds the
    same key, so that a mesh's replicas are the same numbers."""
    dev = _slot(device)
    key = (id(dm), tuple(id(g) for g in gmat_lst),
           np.asarray(var_com, dtype=np.float64).tobytes())

    def same(ent):
        return (ent[0] == key and ent[1][0] is dm
                and all(a is b for a, b in zip(ent[1][1], gmat_lst)))

    ent = _PIECES_CACHE.get(dev)
    if ent is not None and same(ent):
        return ent[2]
    src = next((e[2] for d, e in _PIECES_CACHE.items()
                if d.type == dev.type and same(e)), None)
    with span("pieces"):
        if src is None:
            pieces = score_pieces(dm, gmat_lst, var_com, dev)
        else:
            pieces = ScorePieces(pymat=src.pymat.to(dev),
                                 pvpmat=src.pvpmat.to(dev))
    _PIECES_CACHE[dev] = (key, (dm, tuple(gmat_lst)), pieces)
    return pieces


_DM_CACHE: dict = {}


def design_matrix_cached(pheno_file: str, bed_prefix: str) -> DesignMatrices:
    """`design_matrix` with a size-1 cache keyed by file paths + mtimes,
    returning one stable DesignMatrices object across pipeline stages."""
    from gmat_tpu_torch.io.pheno import design_matrix

    key = (str(pheno_file), os.path.getmtime(str(pheno_file)),
           str(bed_prefix), os.path.getmtime(str(bed_prefix) + ".fam"))
    ent = _DM_CACHE.get("ent")
    if ent is not None and ent[0] == key:
        return ent[1]
    with span("design.parse"):
        dm = design_matrix(pheno_file, bed_prefix)
    _DM_CACHE["ent"] = (key, dm)
    return dm


def prepare_genotypes(bed_prefix: str, impute_seed: int = 0):
    """Read + (deterministically) impute genotypes; returns (geno, bim, fam)."""
    from gmat_tpu_torch.io.bed import Bed, impute_geno

    bed = Bed(bed_prefix)
    geno = bed.read()
    if np.any(np.isnan(geno)):
        geno = impute_geno(geno, seed=impute_seed)
    return geno, bed.bim, bed.fam


_DEVICE_GENO_CACHE: dict = {}  # device -> (key, (n, m) float64 panel)
_MISSING_BYTE_LUT = np.array(
    [any(((b >> s) & 3) == 1 for s in (0, 2, 4, 6)) for b in range(256)],
    dtype=bool,
)


def _unpack_f64_device(raw, num_id):
    """Unpack packed 2-bit codes (num_snp, bytes_per_snp) uint8 to a
    (num_id, num_snp) float64 tensor on raw's device.

    Codes {0, 2, 3} map to dosages {0, 1, 2} as (c² + c)/6 in float32, the
    arithmetic of the JAX package's `_unpack_f64_device`, so both give the
    same bits.  The caller guarantees there are no missing codes."""
    shifts = torch.tensor([0, 2, 4, 6], dtype=torch.uint8, device=raw.device)
    codes = (raw[..., None] >> shifts) & 3
    codes = codes.reshape(raw.shape[0], -1)[:, :num_id]
    c = codes.to(torch.float32)
    return ((c * c + c) * (1.0 / 6.0)).T.to(torch.float64).contiguous()


def prepare_genotypes_device(bed_prefix: str, impute_seed: int = 0,
                             device=None):
    """Device-resident (n, m) float64 genotype panel, one cached per
    device, keyed by (path, .bed mtime, seed).

    A panel without missing genotypes (checked from the packed bytes with a
    256-entry table) crosses to the device as packed 2-bit codes and is
    unpacked there; one with missing genotypes is imputed on the host and
    uploaded dense; a miss is a span `geno.upload` that counts the bytes
    sent in `h2d_bytes`.  Returns (geno_device (n, m) float64, num_snp)."""
    dev = _slot(device)
    key = (str(bed_prefix), os.path.getmtime(str(bed_prefix) + ".bed"),
           impute_seed)
    ent = _DEVICE_GENO_CACHE.get(dev)
    if ent is None or ent[0] != key:
        with span("geno.upload"):
            ent = _DEVICE_GENO_CACHE[dev] = (key, _upload_panel(
                bed_prefix, impute_seed, dev))
        _CODING_CACHE.pop(dev, None)
    return ent[1], ent[1].shape[1]


def _upload_panel(bed_prefix, impute_seed, dev):
    """The (n, m) float64 panel of `bed_prefix` on `dev`: packed codes
    unpacked there, or, with missing genotypes, imputed on the host."""
    from gmat_tpu_torch.io.bed import Bed

    bed = Bed(bed_prefix)
    raw = bed.read_raw()
    # trailing pad bits in the last byte per SNP can read as the
    # missing code in foreign files; check full bytes by table and the
    # tail explicitly
    n_full = bed.num_id // 4
    has_missing = bool(_MISSING_BYTE_LUT[raw[:, :n_full]].any())
    if not has_missing and n_full < raw.shape[1]:
        tail = raw[:, n_full]
        for s in range(0, 2 * (bed.num_id - 4 * n_full), 2):
            has_missing |= bool((((tail >> s) & 3) == 1).any())
    if has_missing:
        geno, _, _ = prepare_genotypes(bed_prefix, impute_seed)
        count("h2d_bytes", geno.nbytes)
        return torch.as_tensor(geno, dtype=EXACT_DTYPE, device=dev)
    count("h2d_bytes", raw.nbytes)
    return _unpack_f64_device(torch.as_tensor(raw, device=dev),
                              bed.num_id)


_CODING_CACHE: dict = {}  # device -> (panel, {(kind, dtype): coding})


def coded_matrix(g, kind: str, dtype=None):
    """Cached genotype coding of the device panel `g`: `kind` in
    ('add', 'dom'), with an optional dtype cast.

    One panel per device: the entry holds a strong reference to `g` and
    starts afresh for another panel, so the calibrate, screen and re-test
    stages share one coded copy each."""
    from gmat_tpu_torch.core.coding import additive_code, dominance_code

    ent = _CODING_CACHE.get(g.device)
    if ent is None or ent[0] is not g:
        ent = _CODING_CACHE[g.device] = (g, {})
    codings = ent[1]
    if (kind, dtype) in codings:
        return codings[(kind, dtype)]
    mat = codings.get((kind, None))
    if mat is None:
        mat = (additive_code(g) if kind == "add" else dominance_code(g))[0]
        codings[(kind, None)] = mat
    if dtype is not None:
        mat = mat.to(dtype).contiguous()
        codings[(kind, dtype)] = mat
    return mat
