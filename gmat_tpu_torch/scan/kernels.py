"""Epistasis effect screen: the Hopper kernel, its plain twin, the driver.

The screen keeps the pairs (i, j), j > i, j < m, whose effect
S[i, j] = Σ_k A[k, i]·py[k]·A[k, j] passes |S| > cut, for A the (n, m)
float32 coded genotype panel.  It replaces the two Pallas kernels of
`gmat_tpu/scan/kernels.py`:

- `screen_counts`  (kernel `gmat_screen_count`, `csrc/screen.cu`) counts the
  hits of every upper-triangle TILE x TILE tile — the counterpart of
  `_count_kernel` / `pallas_screen_counts`;
- `screen_extract` (kernel `gmat_screen_extract`) recomputes the tiles with a
  nonzero count and appends their hits to buffers sized exactly from the
  counts — the counterpart of `_screen_extract_factory` /
  `pallas_extract_hot_tiles`;
- `screen_hits` drives both and sorts the hits by (i, j) on the device — the
  counterpart of `pallas_screen`.

Each wrapper takes its plain PyTorch version (`screen_tile_counts_ref`,
`screen_extract_ref`) for a tensor on the CPU; for a CUDA tensor it launches
the kernel or raises.  `screen_hits_ref` is the plain version of the whole
screen.  The kernel is built from `csrc/screen.cu` by nvcc at first use, into
`build/gmat_tpu_torch/`, and loaded through ctypes.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

TILE = 128  # the kernel's tile edge; checked against the library at load

#: kernel launches by this process, by kernel
LAUNCHES = {"screen_count": 0, "screen_extract": 0}

_SRC = Path(__file__).resolve().parents[1] / "csrc" / "screen.cu"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "gmat_tpu_torch"
_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lib = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return str(Path(home) / "bin" / "nvcc")


def build_library() -> Path:
    """Compile `csrc/screen.cu` into a shared library named by the hash of
    its source and flags (a no-op when that library exists).  The compiler's
    output, with ptxas's register and shared-memory report, goes to the
    `.log` file beside it."""
    src = _SRC.read_bytes()
    digest = hashlib.sha256(src + " ".join(_NVCC_FLAGS).encode()).hexdigest()
    out = _BUILD_DIR / f"libgmat_screen_{digest[:16]}.so"
    if out.exists():
        return out
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run([_nvcc(), *_NVCC_FLAGS, "-o", str(tmp), str(_SRC)],
                          capture_output=True, text=True)
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {_SRC}:\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def _library():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build_library()))
        vp, i32, i64, f32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                             ctypes.c_float)
        lib.gmat_screen_tile_edge.restype = i32
        lib.gmat_screen_tile_edge.argtypes = []
        lib.gmat_screen_count.restype = i32
        lib.gmat_screen_count.argtypes = [vp, vp, i32, i64, i32, f32, vp, i32,
                                          i32, vp]
        lib.gmat_screen_extract.restype = i32
        lib.gmat_screen_extract.argtypes = [vp, vp, i32, i64, i32, f32, vp,
                                            i32, vp, vp, vp, i32, vp, i32, vp]
        edge = lib.gmat_screen_tile_edge()
        if edge != TILE:
            raise RuntimeError(f"screen library tile edge {edge} != {TILE}")
        _lib = lib
    return _lib


def _check(mat, py, m):
    if mat.dtype != torch.float32 or py.dtype != torch.float32:
        raise TypeError("the screen takes float32 mat and py")
    if mat.dim() != 2 or tuple(py.shape) != (mat.shape[0],):
        raise ValueError(f"shapes {tuple(mat.shape)} / {tuple(py.shape)}: "
                         "want mat (n, ld) and py (n,)")
    if not 0 <= m <= mat.shape[1] or m >= 2 ** 31 - TILE:
        raise ValueError(f"m={m} out of range for a panel of "
                         f"{mat.shape[1]} columns")
    if mat.device != py.device:
        raise ValueError("mat and py lie on different devices")
    if not (mat.is_contiguous() and py.is_contiguous()):
        raise ValueError("the screen takes contiguous tensors")
    if mat.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no screen for device {mat.device}")


def _n_tiles(m, tile=TILE):
    return -(-m // tile)


def _launch_args(t):
    return t.device.index, torch.cuda.current_stream(t.device).cuda_stream


def _raise_on(rc, name):
    if rc != 0:
        raise RuntimeError(f"{name} launch failed with CUDA error {rc}")


# plain PyTorch versions ------------------------------------------------------

def _score_rows(mat, py, r0, r1, m):
    """S[r0:r1, r0:m] as one matrix product in mat's dtype."""
    return (mat[:, r0:r1] * py[:, None]).T @ mat[:, r0:m]


def _row_hits(s, r0, cut):
    """Hit mask of S[r0:r1, r0:m]: |S| > cut on the strict upper triangle."""
    rows = torch.arange(r0, r0 + s.shape[0], device=s.device)[:, None]
    cols = torch.arange(r0, r0 + s.shape[1], device=s.device)[None, :]
    return (torch.abs(s) > cut) & (cols > rows)


def screen_tile_counts_ref(mat, py, cut, m, tile=TILE):
    """Plain version of `screen_counts` at tile edge `tile`: the
    (T, T) int32 hit-count grid, computed one row of tiles at a time."""
    n_t = _n_tiles(m, tile)
    counts = torch.zeros((n_t, n_t), dtype=torch.int32, device=mat.device)
    for ti in range(n_t):
        r0, r1 = ti * tile, min((ti + 1) * tile, m)
        hit = _row_hits(_score_rows(mat, py, r0, r1, m), r0, cut)
        pad = (n_t - ti) * tile - hit.shape[1]
        hit = torch.nn.functional.pad(hit, (0, pad))
        counts[ti, ti:] = hit.reshape(hit.shape[0], n_t - ti, tile).sum(
            dim=(0, 2)).to(torch.int32)
    return counts


def screen_extract_ref(mat, py, cut, m, tiles):
    """Plain version of `screen_extract`: the hits of the listed (ti, tj)
    tiles as (i int32, j int32, eff), in tile-list order."""
    out_i, out_j, out_e = [], [], []
    row = None
    for ti, tj in tiles.cpu().tolist():
        if row is None or row[0] != ti:  # one row of tiles at a time
            r0, r1 = ti * TILE, min((ti + 1) * TILE, m)
            s = _score_rows(mat, py, r0, r1, m)
            row = (ti, s, _row_hits(s, r0, cut))
        _, s, hit = row
        c0 = tj * TILE - ti * TILE
        ii, jj = torch.nonzero(hit[:, c0:c0 + TILE], as_tuple=True)
        out_i.append(ii + ti * TILE)
        out_j.append(jj + tj * TILE)
        out_e.append(s[ii, jj + c0])
    if not out_i:
        return _empty_hits(mat.device, mat.dtype)
    return (torch.cat(out_i).to(torch.int32), torch.cat(out_j).to(torch.int32),
            torch.cat(out_e))


def screen_hits_ref(mat, py, cut, m, block_elems=1 << 26):
    """Plain version of the whole screen, in mat's dtype: (i int64, j int64,
    eff) sorted by (i, j), computed in anchor-row blocks of at most
    `block_elems` scores so that the (m, m) matrix is never held."""
    out_i, out_j, out_e = [], [], []
    rows = max(1, block_elems // max(m, 1))
    for r0 in range(0, max(m - 1, 0), rows):
        r1 = min(r0 + rows, m)
        s = _score_rows(mat, py, r0, r1, m)
        ii, jj = torch.nonzero(_row_hits(s, r0, cut), as_tuple=True)
        out_i.append(ii + r0)
        out_j.append(jj + r0)
        out_e.append(s[ii, jj])
    if not out_i:
        return _empty_hits(mat.device, mat.dtype, torch.int64)
    return torch.cat(out_i), torch.cat(out_j), torch.cat(out_e)


def _empty_hits(device, dtype, index_dtype=torch.int32):
    return (torch.empty(0, dtype=index_dtype, device=device),
            torch.empty(0, dtype=index_dtype, device=device),
            torch.empty(0, dtype=dtype, device=device))


# kernel wrappers -------------------------------------------------------------

def screen_counts(mat, py, cut, m):
    """(T, T) int32 grid of per-tile hit counts, T = ceil(m / TILE); cells
    below the diagonal are zero."""
    _check(mat, py, m)
    if mat.device.type == "cpu":
        return screen_tile_counts_ref(mat, py, cut, m)
    n_t = _n_tiles(m)
    counts = torch.zeros((n_t, n_t), dtype=torch.int32, device=mat.device)
    rc = _library().gmat_screen_count(
        mat.data_ptr(), py.data_ptr(), mat.shape[0], mat.shape[1], m,
        float(cut), counts.data_ptr(), n_t, *_launch_args(mat))
    _raise_on(rc, "gmat_screen_count")
    LAUNCHES["screen_count"] += 1
    return counts


def screen_extract(mat, py, cut, m, counts):
    """Hits of every tile with a nonzero count in `counts` (from
    `screen_counts` with the same arguments), unordered: (i int32, j int32,
    eff float32)."""
    _check(mat, py, m)
    tiles = torch.nonzero(counts).to(torch.int32).contiguous()
    if mat.device.type == "cpu":
        return screen_extract_ref(mat, py, cut, m, tiles)
    total = int(counts.sum())
    if total == 0:
        return _empty_hits(mat.device, mat.dtype)
    if total >= 2 ** 31:
        raise ValueError(f"{total} hits exceed the int32 hit buffer")
    dev = mat.device
    out_i = torch.empty(total, dtype=torch.int32, device=dev)
    out_j = torch.empty(total, dtype=torch.int32, device=dev)
    out_e = torch.empty(total, dtype=torch.float32, device=dev)
    state = torch.zeros(2, dtype=torch.int32, device=dev)  # cursor, overflow
    rc = _library().gmat_screen_extract(
        mat.data_ptr(), py.data_ptr(), mat.shape[0], mat.shape[1], m,
        float(cut), tiles.data_ptr(), tiles.shape[0], out_i.data_ptr(),
        out_j.data_ptr(), out_e.data_ptr(), total, state.data_ptr(),
        *_launch_args(mat))
    _raise_on(rc, "gmat_screen_extract")
    LAUNCHES["screen_extract"] += 1
    cursor, overflow = state.tolist()
    if overflow or cursor != total:
        raise RuntimeError(f"screen extraction found {cursor} hits "
                           f"({overflow} past the buffer) where the counts "
                           f"gave {total}")
    return out_i, out_j, out_e


def screen_hits(mat, py, cut, m):
    """The two-phase screen: (i int64, j int64, eff float32) of every pair
    j > i, j < m with |S[i, j]| > cut, sorted by (i, j) on mat's device."""
    counts = screen_counts(mat, py, cut, m)
    i, j, eff = screen_extract(mat, py, cut, m, counts)
    i, j = i.to(torch.int64), j.to(torch.int64)
    order = torch.argsort(i * m + j)
    return i[order], j[order], eff[order]
