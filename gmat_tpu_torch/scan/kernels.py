"""The Hopper kernels of the port, their plain twins and their drivers.

The effect screen keeps the pairs (i, j), j > i, j < m, whose effect
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

The exact scan (`exact_hits`, kernel `gmat_exact_scan`, `csrc/exact.cu`)
tests every (anchor, partner) pair of an anchor list in float64 —
eff = eᵀpy, var = eᵀPe, chi = eff²/var for e = m0[:, a] ⊙ m1[:, j] — and
keeps chi > crit under the triangular or rectangular mask: the counterpart
of `_exact_kernel_factory` / `pallas_exact_hits`.

Each wrapper takes its plain PyTorch version (`screen_tile_counts_ref`,
`screen_extract_ref`, `exact_hits_ref`) for a tensor on the CPU; for a CUDA
tensor it launches the kernel or raises.  `screen_hits_ref` is the plain
version of the whole screen.  The kernels are built from `csrc/*.cu` at
first use (one nvcc process per source, all started together, then one
link) into one library under `build/gmat_tpu_torch/`, loaded through
ctypes.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

TILE = 128  # the screen's tile edge; checked against the library at load
EXACT_TILE = 128  # partners per exact-scan block; checked likewise
EXACT_CAPACITY = 1 << 20  # first hit buffer of a thresholded exact scan
_REF_BLOCK_ELEMS = 1 << 25  # elements of E per step of `exact_hits_ref`

#: kernel launches by this process, by kernel
LAUNCHES = {"screen_count": 0, "screen_extract": 0, "exact_scan": 0}

_CSRC = Path(__file__).resolve().parents[1] / "csrc"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "gmat_tpu_torch"
_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lib = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return str(Path(home) / "bin" / "nvcc")


def compile_sources(srcs, out: Path) -> str:
    """Build the sources `srcs` into the shared library `out`: one nvcc per
    source, all started together, then one link.  Returns the compilers'
    output; raises with it when a step fails."""
    tag = f"{out.name}.{os.getpid()}"
    objs = [out.parent / f"{p.stem}.{tag}.o" for p in srcs]
    procs = [subprocess.Popen([_nvcc(), *_NVCC_FLAGS, "-c", "-o", str(o),
                               str(p)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for p, o in zip(srcs, objs)]
    logs = [f"== {p.name}\n{proc.communicate()[0]}"
            for p, proc in zip(srcs, procs)]
    link = None
    if all(proc.returncode == 0 for proc in procs):
        link = subprocess.run([_nvcc(), *_NVCC_FLAGS[:2], "-shared", "-o",
                               str(out), *map(str, objs)],
                              capture_output=True, text=True)
        logs.append(f"== link\n{link.stdout}{link.stderr}")
    for o in objs:
        o.unlink(missing_ok=True)
    if link is None or link.returncode != 0:
        raise RuntimeError("nvcc failed:\n" + "".join(logs))
    return "".join(logs)


def build_library() -> Path:
    """Compile every `csrc/*.cu` into one shared library named by the hash
    of the sources and flags (a no-op when that library exists), by
    `compile_sources`.  The compilers' output, with ptxas's register and
    shared-memory report, goes to the `.log` file beside it."""
    srcs = sorted(_CSRC.glob("*.cu"))
    digest = hashlib.sha256(b"".join(
        [p.name.encode() + p.read_bytes() for p in srcs]
        + [" ".join(_NVCC_FLAGS).encode()])).hexdigest()
    out = _BUILD_DIR / f"libgmat_kernels_{digest[:16]}.so"
    if out.exists():
        return out
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    out.with_suffix(".log").write_text(compile_sources(srcs, tmp))
    os.replace(tmp, out)
    return out


def _library():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build_library()))
        vp, i32, i64, f32, f64 = (ctypes.c_void_p, ctypes.c_int,
                                  ctypes.c_int64, ctypes.c_float,
                                  ctypes.c_double)
        lib.gmat_screen_tile_edge.restype = i32
        lib.gmat_screen_tile_edge.argtypes = []
        lib.gmat_screen_count.restype = i32
        lib.gmat_screen_count.argtypes = [vp, vp, i32, i64, i32, f32, vp, i32,
                                          i32, vp]
        lib.gmat_screen_extract.restype = i32
        lib.gmat_screen_extract.argtypes = [vp, vp, i32, i64, i32, f32, vp,
                                            i32, vp, vp, vp, i32, vp, i32, vp]
        lib.gmat_exact_tile.restype = i32
        lib.gmat_exact_tile.argtypes = []
        lib.gmat_exact_scan.restype = i32
        lib.gmat_exact_scan.argtypes = [vp, i64, vp, i64, i32, vp, vp, i32,
                                        vp, i32, f64, i32, i32, vp, vp, vp,
                                        vp, vp, i32, vp, i32, vp]
        edge = lib.gmat_screen_tile_edge()
        if edge != TILE:
            raise RuntimeError(f"screen library tile edge {edge} != {TILE}")
        edge = lib.gmat_exact_tile()
        if edge != EXACT_TILE:
            raise RuntimeError(f"exact-scan tile {edge} != {EXACT_TILE}")
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


# the exact scan ---------------------------------------------------------------

_MASKS = ("tri", "rect")


def _check_exact(mat0, mat1, py, pvp, anchors, mask):
    if mask not in _MASKS:
        raise ValueError(f"mask {mask!r}: want one of {_MASKS}")
    if any(t.dtype != torch.float64 for t in (mat0, mat1, py, pvp)):
        raise TypeError("the exact scan takes float64 mat0, mat1, py and pvp")
    if anchors.dtype not in (torch.int32, torch.int64) or anchors.dim() != 1:
        raise TypeError("anchors: want a 1-d int32 or int64 tensor")
    n = mat0.shape[0] if mat0.dim() == 2 else -1
    if (mat1.dim() != 2 or mat1.shape[0] != n or tuple(py.shape) != (n,)
            or tuple(pvp.shape) != (n, n)):
        raise ValueError(
            f"shapes {tuple(mat0.shape)} / {tuple(mat1.shape)} / "
            f"{tuple(py.shape)} / {tuple(pvp.shape)}: want mat0 (n, m0), "
            "mat1 (n, m1), py (n,) and pvp (n, n)")
    if any(t.device != mat0.device for t in (mat1, py, pvp, anchors)):
        raise ValueError("the exact scan's tensors lie on different devices")
    if not all(t.is_contiguous() for t in (mat0, mat1, py, pvp)):
        raise ValueError("the exact scan takes contiguous tensors")
    if mat0.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no exact scan for device {mat0.device}")
    if len(anchors) and (int(anchors.min()) < 0
                         or int(anchors.max()) >= mat0.shape[1]):
        raise ValueError("anchors out of range of mat0's columns")


def _partners(anchors, m1, mask):
    """(count, first partner) of every anchor: j > a for `tri`, every j
    for `rect`."""
    if mask == "tri":
        return (m1 - 1 - anchors).clamp(min=0), anchors + 1
    return torch.full_like(anchors, m1), torch.zeros_like(anchors)


def pairs_per_anchor(anchors, m1, mask):
    """Number of partners that a scan tests for each of `anchors`, int64."""
    return _partners(anchors.to(torch.int64), m1, mask)[0]


def exact_pair_count(anchors, m1, mask):
    """Number of (anchor, partner) pairs that a scan of `anchors` tests."""
    return int(pairs_per_anchor(anchors, m1, mask).sum())


def _no_exact_hits(device, dtype):
    idx = torch.empty(0, dtype=torch.int64, device=device)
    val = torch.empty(0, dtype=dtype, device=device)
    return idx, idx.clone(), val, val.clone(), val.clone()


def exact_hits_ref(mat0, mat1, py, pvp, anchors, chi_crit, mask,
                   center=False):
    """Plain version of `exact_hits`, in the tensors' dtype.

    The pairs are enumerated in the reference's order (anchors in list
    order, partners ascending) and tested `_REF_BLOCK_ELEMS // n` at a
    time as `_one_anchor_chunk` of the JAX package tests them:
    e = m0[:, a] ⊙ m1[:, j], eff = eᵀpy, var = Σ e ⊙ (pvp·e), chi = eff²/var
    (with `center`, var on e − mean(e)).  Returns (i int64, j int64, eff,
    var, chi) of the pairs with chi > chi_crit."""
    dev = mat0.device
    anchors = anchors.to(device=dev, dtype=torch.int64)
    count, first = _partners(anchors, mat1.shape[1], mask)
    ends = torch.cumsum(count, 0)
    total = int(ends[-1]) if len(ends) else 0
    step = max(1, _REF_BLOCK_ELEMS // max(mat0.shape[0], 1))
    outs = []
    for p0 in range(0, total, step):
        p = torch.arange(p0, min(p0 + step, total), device=dev)
        pos = torch.searchsorted(ends, p, right=True)
        i = anchors[pos]
        j = p - (ends[pos] - count[pos]) + first[pos]
        e = mat0[:, i] * mat1[:, j]
        eff = e.T @ py
        if center:
            e = e - e.mean(dim=0)
        var = torch.sum(e * (pvp @ e), dim=0)
        chi = eff * eff / var  # 0/0 -> NaN -> never a hit
        hit = chi > chi_crit
        outs.append((i[hit], j[hit], eff[hit], var[hit], chi[hit]))
    if not outs:
        return _no_exact_hits(dev, mat0.dtype)
    return tuple(torch.cat(parts) for parts in zip(*outs))


def exact_hits(mat0, mat1, py, pvp, anchors, chi_crit, mask, center=False):
    """Every pair (a, j) of the anchor list `anchors` (columns of mat0)
    against the partners j of mat1 (j > a for mask `tri`, every j for
    `rect`) with chi > chi_crit, in float64: (i int64, j int64, eff, var,
    chi) on mat0's device, anchors in list order and partners ascending.
    `pvp` must be symmetric (the kernel reads its rows as its columns).

    `center` takes var on e − mean(e).  Where pvp·1 = 0 (the score pieces
    of a design with an intercept) that is the same number in exact
    arithmetic, and it drops the rounding of pvp along 1, which decides var
    when e is nearly constant.

    A chi_crit below 0 keeps every pair whose chi is not NaN; its hit
    buffer is the pair count.  Otherwise the buffer starts at
    `EXACT_CAPACITY` hits and the kernel is launched once more with the
    exact count when it overflowed."""
    _check_exact(mat0, mat1, py, pvp, anchors, mask)
    if mat0.device.type == "cpu":
        return exact_hits_ref(mat0, mat1, py, pvp, anchors, chi_crit, mask,
                              center)
    n, m1 = mat0.shape[0], mat1.shape[1]
    if m1 > 65535 * EXACT_TILE or len(anchors) >= 2 ** 31:
        raise ValueError(f"{len(anchors)} anchors x {m1} partners exceed "
                         "the exact scan's launch grid")
    total = exact_pair_count(anchors, m1, mask)
    if total >= 2 ** 31:
        raise ValueError(f"{total} pairs exceed the int32 hit cursor: "
                         "split the anchor list")
    dev = mat0.device
    if total == 0:
        return _no_exact_hits(dev, torch.float64)
    anchors32 = anchors.to(torch.int32).contiguous()
    cap = total if chi_crit < 0 else min(total, EXACT_CAPACITY)
    for _ in range(2):
        out_a = torch.empty(max(cap, 1), dtype=torch.int32, device=dev)
        out_j = torch.empty_like(out_a)
        vals = torch.empty((3, max(cap, 1)), dtype=torch.float64, device=dev)
        state = torch.zeros(2, dtype=torch.int32, device=dev)  # cursor, overflow
        rc = _library().gmat_exact_scan(
            mat0.data_ptr(), mat0.shape[1], mat1.data_ptr(), m1, m1,
            py.data_ptr(), pvp.data_ptr(), n, anchors32.data_ptr(),
            len(anchors32), float(chi_crit), int(mask == "tri"), int(center),
            out_a.data_ptr(), out_j.data_ptr(), vals[0].data_ptr(),
            vals[1].data_ptr(), vals[2].data_ptr(), cap, state.data_ptr(),
            *_launch_args(mat0))
        _raise_on(rc, "gmat_exact_scan")
        LAUNCHES["exact_scan"] += 1
        cursor, overflow = state.tolist()
        if overflow != max(cursor - cap, 0):
            raise RuntimeError(f"exact scan: cursor {cursor}, capacity {cap}, "
                               f"{overflow} past the buffer")
        if not overflow:
            break
        cap = cursor
    else:
        raise RuntimeError("exact scan overflowed a buffer of its own count")
    pos = out_a[:cursor].to(torch.int64)
    j = out_j[:cursor].to(torch.int64)
    order = torch.argsort(pos * m1 + j)
    i = anchors.to(torch.int64)[pos[order]]
    eff, var, chi = vals[:, :cursor][:, order]
    return i, j[order], eff, var, chi
