"""PLINK binary genotype IO (host side).

Counterpart of `gmat_tpu/io/bed.py`.  PLINK 2-bit codes {0b00, 0b01, 0b10,
0b11} map to {0, missing, 1, 2}.  Two host decoders:

1. the native C++/OpenMP decoder `csrc/bed_reader.cpp` of the repository,
   loaded by path through ctypes (built with its Makefile on first use);
2. a pure-numpy decoder, used when the native library cannot be built.

`unpack_codes_device` unpacks the packed bytes on a torch device with the
same code table.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import pandas as pd
import torch

from gmat_tpu_torch.config import resolve_device

_CSRC = Path(__file__).resolve().parents[2] / "csrc"
_LIB_PATH = _CSRC / "libgmat_native.so"
_MAGIC = b"\x6c\x1b\x01"

_lib = None
_lib_tried = False


def _load_native():
    """Load (building if needed) the native decoder; None when unavailable."""
    global _lib, _lib_tried
    if _lib_tried:
        return _lib
    _lib_tried = True
    try:
        if not _LIB_PATH.exists():
            subprocess.run(["make", "-s", "-C", str(_CSRC)], check=True,
                           capture_output=True)
        lib = ctypes.CDLL(str(_LIB_PATH))
    except (OSError, subprocess.CalledProcessError):
        return None
    for name, ctype in (("gmat_read_bed_f64", ctypes.c_double),
                        ("gmat_read_bed_f32", ctypes.c_float),
                        ("gmat_read_bed_raw", ctypes.c_ubyte)):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
                       ctypes.POINTER(ctype)]
    _lib = lib
    return _lib


def count_lines(path: str | os.PathLike) -> int:
    with open(path, "rb") as f:
        return sum(chunk.count(b"\n") for chunk in iter(lambda: f.read(1 << 20), b""))


@dataclass
class Bed:
    """PLINK fileset handle: `<prefix>.bed/.bim/.fam`."""

    prefix: str

    def __post_init__(self):
        self.bim = read_bim(self.prefix + ".bim")
        self.fam = read_fam(self.prefix + ".fam")
        self.num_snp = len(self.bim)
        self.num_id = len(self.fam)

    def read(self, dtype=np.float64) -> np.ndarray:
        """Decode to a dense (num_id, num_snp) array, NaN for missing."""
        return _decode(self.prefix + ".bed", self.num_id, self.num_snp, dtype)

    def read_raw(self) -> np.ndarray:
        """Raw packed codes, shape (num_snp, bytes_per_snp) uint8."""
        return read_bed_raw(self.prefix + ".bed", self.num_id, self.num_snp)


def read_bim(path: str) -> pd.DataFrame:
    df = pd.read_csv(path, sep=r"\s+", header=None)
    df.columns = ["chro", "snp_ID", "cm", "pos", "allele1", "allele2"][: df.shape[1]]
    return df


def read_fam(path: str) -> pd.DataFrame:
    df = pd.read_csv(path, sep=r"\s+", header=None)
    cols = ["fid", "iid", "father", "mother", "sex", "pheno"]
    df.columns = cols[: df.shape[1]] + list(df.columns[len(cols):])
    return df


def read_plink(bed_prefix: str, dtype=np.float64) -> np.ndarray:
    """(num_id, num_snp) genotype dosage array with NaN for missing."""
    return Bed(bed_prefix).read(dtype=dtype)


def _decode(bed_path: str, num_id: int, num_snp: int, dtype) -> np.ndarray:
    lib = _load_native()
    dtype = np.dtype(dtype)
    if lib is not None and dtype in (np.float64, np.float32):
        out = np.empty((num_id, num_snp), dtype=dtype)
        fn = lib.gmat_read_bed_f64 if dtype == np.float64 else lib.gmat_read_bed_f32
        ptr_t = ctypes.c_double if dtype == np.float64 else ctypes.c_float
        rc = fn(bed_path.encode(), num_id, num_snp,
                out.ctypes.data_as(ctypes.POINTER(ptr_t)))
        if rc != 0:
            raise IOError(f"native bed decode failed (rc={rc}) for {bed_path}")
        return out
    return _decode_numpy(bed_path, num_id, num_snp).astype(dtype, copy=False)


def _decode_numpy(bed_path: str, num_id: int, num_snp: int) -> np.ndarray:
    raw = read_bed_raw(bed_path, num_id, num_snp)
    codes = np.stack(
        [(raw >> shift) & 3 for shift in (0, 2, 4, 6)], axis=-1
    ).reshape(num_snp, -1)[:, :num_id]
    lut = np.array([0.0, np.nan, 1.0, 2.0])
    return lut[codes].T.copy()


def read_bed_raw(bed_path: str, num_id: int, num_snp: int) -> np.ndarray:
    """Packed 2-bit codes as uint8, shape (num_snp, bytes_per_snp)."""
    bytes_per_snp = (num_id + 3) // 4
    with open(bed_path, "rb") as f:
        if f.read(3) != _MAGIC:
            raise IOError(f"{bed_path}: not a SNP-major PLINK .bed file")
        raw = np.fromfile(f, dtype=np.uint8)
    expect = bytes_per_snp * num_snp
    if raw.size != expect:
        raise IOError(f"{bed_path}: expected {expect} payload bytes, got {raw.size}")
    return raw.reshape(num_snp, bytes_per_snp)


def unpack_codes_device(raw, num_id: int, missing_value: float = float("nan")):
    """Packed 2-bit codes, (num_snp, bytes_per_snp) uint8, to the
    (num_id, num_snp) float64 dosage tensor on `raw`'s device, through the
    table {0: 0.0, 1: missing_value, 2: 1.0, 3: 2.0}.

    `raw` is a uint8 tensor, or an array that goes to the default device.
    The screen's own unpack (`scan/common.py::_unpack_f64_device`) assumes
    no missing codes and computes the dosage arithmetically."""
    if not isinstance(raw, torch.Tensor):
        raw = torch.as_tensor(np.asarray(raw, dtype=np.uint8),
                              device=resolve_device())
    shifts = torch.tensor([0, 2, 4, 6], dtype=torch.uint8, device=raw.device)
    codes = (raw[..., None] >> shifts) & 3
    codes = codes.reshape(raw.shape[0], -1)[:, :num_id]
    lut = torch.tensor([0.0, missing_value, 1.0, 2.0], dtype=torch.float64,
                       device=raw.device)
    return lut[codes.long()].T


def impute_geno(snp_mat: np.ndarray, seed: int = 0) -> np.ndarray:
    """Fill missing genotypes by sampling {0,1,2} with the observed per-SNP
    genotype-class frequencies, from a seeded numpy generator (the same
    draws as the JAX package)."""
    rng = np.random.default_rng(seed)
    snp_mat = np.array(snp_mat, copy=True)
    for j in np.unique(np.where(np.isnan(snp_mat))[1]):
        col = snp_mat[:, j]
        missing = np.isnan(col)
        counts = np.array(
            [np.sum(col[~missing] == v) for v in (0.0, 1.0, 2.0)], dtype=np.float64
        )
        total = counts.sum()
        if total == 0:
            raise ValueError(f"SNP column {j} has no observed genotypes")
        col[missing] = rng.choice([0.0, 1.0, 2.0], size=missing.sum(), p=counts / total)
        snp_mat[:, j] = col
    return snp_mat


def write_bed(prefix: str, geno: np.ndarray, bim: pd.DataFrame | None = None,
              fam: pd.DataFrame | None = None) -> None:
    """Write a (num_id, num_snp) {0,1,2,NaN} genotype array as a PLINK fileset."""
    num_id, num_snp = geno.shape
    codes = np.full(geno.shape, 1, dtype=np.uint8)  # missing
    for val, code in ((0.0, 0), (1.0, 2), (2.0, 3)):
        codes[geno == val] = code
    pad = (-num_id) % 4
    if pad:
        codes = np.concatenate(
            [codes, np.zeros((pad, num_snp), dtype=np.uint8)], axis=0
        )
    by_snp = codes.T.reshape(num_snp, -1, 4)
    packed = (
        by_snp[:, :, 0]
        | (by_snp[:, :, 1] << 2)
        | (by_snp[:, :, 2] << 4)
        | (by_snp[:, :, 3] << 6)
    ).astype(np.uint8)
    with open(prefix + ".bed", "wb") as f:
        f.write(_MAGIC)
        packed.tofile(f)
    if bim is None:
        bim = pd.DataFrame(
            {
                "chro": np.ones(num_snp, dtype=int),
                "snp_ID": [f"snp{i}" for i in range(num_snp)],
                "cm": np.zeros(num_snp, dtype=int),
                "pos": np.arange(1, num_snp + 1),
                "allele1": ["A"] * num_snp,
                "allele2": ["B"] * num_snp,
            }
        )
    bim.to_csv(prefix + ".bim", sep="\t", header=False, index=False)
    if fam is None:
        fam = pd.DataFrame(
            {
                "fid": [f"f{i}" for i in range(num_id)],
                "iid": [f"i{i}" for i in range(num_id)],
                "father": [0] * num_id,
                "mother": [0] * num_id,
                "sex": [0] * num_id,
                "pheno": [-9] * num_id,
            }
        )
    fam.to_csv(prefix + ".fam", sep="\t", header=False, index=False)


def shuffle_bed(bed_prefix: str, seed: int = 0) -> str:
    """Permute genotypes independently per SNP with a seeded numpy generator
    (the JAX package's draws, so the files are byte-identical), writing
    `<prefix>_shuffle.*`; returns that prefix."""
    bed = Bed(bed_prefix)
    geno = bed.read()
    rng = np.random.default_rng(seed)
    for j in range(geno.shape[1]):
        rng.shuffle(geno[:, j])
    out_prefix = bed_prefix + "_shuffle"
    write_bed(out_prefix, geno, bim=bed.bim, fam=bed.fam)
    return out_prefix
