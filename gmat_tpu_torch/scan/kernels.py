"""The Hopper kernels of the port, their plain twins and their drivers.

The effect screen keeps the pairs (i, j), j > i, j < m, of an anchor i and
a partner j whose effect S[i, j] = Σ_k A[k, i]·py[k]·B[k, j] passes
|S| > cut, for A and B (n, m) float32 coded genotype panels (B = A for the
AA and DD screens), a list of anchors (every SNP by default) and a flat
cut or a per-pair `CutTable` (the MAF/het-binned screens).  It replaces the
two Pallas kernels of `gmat_tpu/scan/kernels.py`, and serves the general
screen that the JAX package runs on its XLA engine (`screen.py::
_fused_visit`):

- `screen_counts`  (kernel `gmat_screen_count[_general]`, `csrc/screen.cu`)
  counts the hits of every (anchor tile, partner tile) TILE x TILE tile
  that can hold a pair j > i — the counterpart of `_count_kernel` /
  `pallas_screen_counts`;
- `screen_extract` (kernel `gmat_screen_extract[_general]`) recomputes the
  tiles with a nonzero count and appends their hits to buffers sized
  exactly from the counts — the counterpart of `_screen_extract_factory` /
  `pallas_extract_hot_tiles`;
- `screen_positions` / `screen_hits` gather an anchor subset into one
  panel, drive both and sort the hits by (position in the anchor list, j)
  on the device — the counterpart of `pallas_screen` and of
  `screen.py::_run_screen_impl`.

The identity screen (every SNP an anchor of one panel, one flat cut) runs
the kernels' identity instantiation over the upper-triangle tiles; every
other screen runs their general instantiation over `screen_worklist`.
Both run the product on the TF32 tensor cores as three TF32 products
(3xTF32), which keeps float32's precision: `tf32_split_ref` and
`tile_product_3xtf32_ref` emulate the scheme for the tests.

The exact scan (`exact_hits`, kernel `gmat_exact_scan`, `csrc/exact.cu`)
tests every (anchor, partner) pair of an anchor list in float64 —
eff = eᵀpy, var = eᵀPe, chi = eff²/var for e = m0[:, a] ⊙ m1[:, j] — and
keeps chi > crit under the triangular or rectangular mask: the counterpart
of `gmat_tpu/scan/kernels.py::_exact_kernel_factory` / `pallas_exact_hits`.
It is bound by FP64 tensor-core operations: the function needs n² + 7n
FLOP per pair, and the kernel runs n² + 128n of them on the DMMA units
(`mma.sync` m16n8k8 f64) by reading only the tiles of the symmetric P on or
above the diagonal, staged through a `cp.async` ring in shared memory.

Each wrapper takes its plain PyTorch version (`screen_tile_counts_ref`,
`screen_extract_ref`, `exact_hits_ref`) for a tensor on the CPU; for a CUDA
tensor it launches the kernel or raises.  `screen_hits_ref` is the plain
version of the whole screen.  The kernels are built from `csrc/*.cu` at
first use into one library (`core.native`), loaded through ctypes.
"""
from __future__ import annotations

import ctypes
import threading
from dataclasses import dataclass

import torch

from gmat_tpu_torch.core.native import (build_library,  # noqa: F401
                                        compile_sources, declare)
from gmat_tpu_torch.core.native import launch_args as _launch_args
from gmat_tpu_torch.core.native import library as _library
from gmat_tpu_torch.core.native import raise_on as _raise_on

TILE = 128  # the screen's tile edge; checked against the library at load
TILE_BAND = 8  # partner tiles per band of a screen launch's tile order
EXACT_TILE = 128  # partners per exact-scan block; checked likewise
EXACT_CAPACITY = 1 << 20  # first hit buffer of a thresholded exact scan
_REF_BLOCK_ELEMS = 1 << 25  # elements of E per step of `exact_hits_ref`

#: kernel launches by this process, by kernel (the shards of a mesh
#: launch from several threads: `_count_launch` holds the lock)
LAUNCHES = {"screen_count": 0, "screen_extract": 0, "exact_scan": 0}
_LOCK = threading.Lock()


def _count_launch(name):
    with _LOCK:
        LAUNCHES[name] += 1


@declare
def _declare_scans(lib):
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
    general = [vp, i64, i32, vp, i64, vp, i32, i32, vp, i32, vp, vp, vp,
               f32]
    lib.gmat_screen_count_general.restype = i32
    lib.gmat_screen_count_general.argtypes = general + [vp, i32, vp, i32,
                                                        i32, vp]
    lib.gmat_screen_extract_general.restype = i32
    lib.gmat_screen_extract_general.argtypes = general + [
        vp, i32, vp, vp, vp, i32, vp, i32, vp]
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


@dataclass(frozen=True)
class CutTable:
    """The per-pair cut of the binned screens: pair (i, j) is a hit when
    |S| > table[bins_a[i]*10 + bins_b[j]], i the anchor's SNP id and j the
    partner's (the reference's `eff_cut[bin_i*10 + bin_j]`).  bins_a and
    bins_b are int32 (m,) in [0, 10]; table is float32 (111,)."""

    bins_a: torch.Tensor
    bins_b: torch.Tensor
    table: torch.Tensor

    def scaled(self, factor):
        """The same bins with every cut times `factor`."""
        return CutTable(self.bins_a, self.bins_b, self.table * factor)

    def at(self, rows, cols):
        """Cuts of the pairs rows[:, None] x cols[None, :] (SNP ids)."""
        return self.table[self.bins_a[rows].long()[:, None] * 10
                          + self.bins_b[cols].long()[None, :]]


def _check_panel(t, n, name):
    if t.dtype != torch.float32:
        raise TypeError(f"the screen takes a float32 {name}")
    if t.dim() != 2 or t.shape[0] != n:
        raise ValueError(f"{name} {tuple(t.shape)}: want ({n}, ld)")


def _check(mat, py, m, cut, b, ids):
    if mat.dtype != torch.float32 or py.dtype != torch.float32:
        raise TypeError("the screen takes float32 mat and py")
    if mat.dim() != 2 or tuple(py.shape) != (mat.shape[0],):
        raise ValueError(f"shapes {tuple(mat.shape)} / {tuple(py.shape)}: "
                         "want mat (n, ld) and py (n,)")
    width = mat.shape[1] if b is None else b.shape[1]
    if not 0 <= m <= width or m >= 2 ** 31 - TILE:
        raise ValueError(f"m={m} out of range for a panel of {width} columns")
    if not (mat.is_contiguous() and py.is_contiguous()):
        raise ValueError("the screen takes contiguous tensors")
    if mat.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no screen for device {mat.device}")
    others = [py]
    if b is not None:
        _check_panel(b, mat.shape[0], "partner panel b")
        others.append(b)
    n_a = m if ids is None else len(ids)
    if mat.shape[1] < n_a:
        raise ValueError(f"{n_a} anchor positions but {mat.shape[1]} columns")
    if ids is not None:
        if ids.dtype != torch.int32 or ids.dim() != 1:
            raise TypeError("ids: want a 1-d int32 tensor")
        if len(ids) and (int(ids.min()) < 0 or int(ids.max()) >= m):
            raise ValueError("anchor ids out of range of the partners")
        others.append(ids)
    if isinstance(cut, CutTable):
        for bins in (cut.bins_a, cut.bins_b):
            if bins.dtype != torch.int32 or tuple(bins.shape) != (m,):
                raise TypeError(f"bins: want int32 ({m},)")
            if m and (int(bins.min()) < 0 or int(bins.max()) > 10):
                raise ValueError("bins: want values in [0, 10]")
        if cut.table.dtype != torch.float32 or tuple(cut.table.shape) != (111,):
            raise TypeError("table: want float32 (111,)")
        others += [cut.bins_a, cut.bins_b, cut.table]
    if any(t.device != mat.device for t in others):
        raise ValueError("the screen's tensors lie on different devices")
    if not all(t.is_contiguous() for t in others):
        raise ValueError("the screen takes contiguous tensors")


def _n_tiles(m, tile=TILE):
    return -(-m // tile)


def _n_anchors(m, ids):
    """Anchor positions of a screen: len(ids), or m for the identity."""
    return m if ids is None else len(ids)


def _row_ids(ids, p0, p1, device):
    """SNP ids of the anchor positions p0..p1-1."""
    if ids is None:
        return torch.arange(p0, p1, device=device)
    return ids[p0:p1].long()


def screen_worklist(ids, m, tile=TILE):
    """(n_work, 2) int32 (anchor tile, partner tile) pairs of a screen
    whose anchor position p has SNP id ids[p]: every partner tile that can
    hold a pair j > i, i.e. not wholly at or left of the anchor tile's
    smallest id (the JAX package's `_tile_worklist` rule)."""
    dev = ids.device
    t_a, t_b = _n_tiles(len(ids), tile), _n_tiles(m, tile)
    padded = torch.nn.functional.pad(ids.long(), (0, t_a * tile - len(ids)),
                                     value=m)
    first = ((padded.view(t_a, tile).amin(dim=1) + 1) // tile).clamp(max=t_b)
    per = t_b - first
    ta = torch.repeat_interleave(torch.arange(t_a, device=dev), per)
    start = torch.cumsum(per, 0) - per
    tb = torch.arange(len(ta), device=dev) - start[ta] + first[ta]
    return torch.stack([ta, tb], dim=1).to(torch.int32).contiguous()


# plain PyTorch versions ------------------------------------------------------

def _score_rows(a, b, py, p0, p1, c0, m):
    """S[p0:p1, c0:m] = (a[:, p0:p1] ⊙ py)ᵀ b[:, c0:m], one matrix product
    in a's dtype."""
    return (a[:, p0:p1] * py[:, None]).T @ b[:, c0:m]


def _row_hits(s, rows, c0, cut):
    """Hit mask of S[rows, c0:c0+w]: |S| above the pair's cut and j > i,
    for `rows` the anchors' SNP ids."""
    cols = torch.arange(c0, c0 + s.shape[1], device=s.device)
    thr = cut.at(rows, cols) if isinstance(cut, CutTable) else cut
    return (torch.abs(s) > thr) & (cols[None, :] > rows[:, None])


def _first_tile(rows, tile):
    """First partner tile that can hold a pair j > min(rows)."""
    return (int(rows.min()) + 1) // tile


def screen_tile_counts_ref(mat, py, cut, m, tile=TILE, *, b=None, ids=None):
    """Plain version of `screen_counts` at tile edge `tile`: the
    (ceil(n_a / tile), ceil(m / tile)) int32 hit-count grid, computed one
    row of tiles at a time."""
    b = mat if b is None else b
    n_a = _n_anchors(m, ids)
    t_a, t_b = _n_tiles(n_a, tile), _n_tiles(m, tile)
    counts = torch.zeros((t_a, t_b), dtype=torch.int32, device=mat.device)
    for ta in range(t_a):
        p0, p1 = ta * tile, min((ta + 1) * tile, n_a)
        rows = _row_ids(ids, p0, p1, mat.device)
        tb0 = _first_tile(rows, tile)
        if tb0 >= t_b:
            continue
        hit = _row_hits(_score_rows(mat, b, py, p0, p1, tb0 * tile, m), rows,
                        tb0 * tile, cut)
        pad = (t_b - tb0) * tile - hit.shape[1]
        hit = torch.nn.functional.pad(hit, (0, pad))
        counts[ta, tb0:] = hit.reshape(hit.shape[0], t_b - tb0, tile).sum(
            dim=(0, 2)).to(torch.int32)
    return counts


def screen_extract_ref(mat, py, cut, m, tiles, *, b=None, ids=None):
    """Plain version of `screen_extract`: the hits of the listed (anchor
    tile, partner tile) tiles as (position int32, j int32, eff), in
    tile-list order."""
    b = mat if b is None else b
    n_a = _n_anchors(m, ids)
    out_p, out_j, out_e = [], [], []
    row = None
    for ta, tb in tiles.cpu().tolist():
        if row is None or row[0] != ta:  # one row of tiles at a time
            p0, p1 = ta * TILE, min((ta + 1) * TILE, n_a)
            rows = _row_ids(ids, p0, p1, mat.device)
            c0 = _first_tile(rows, TILE) * TILE
            s = _score_rows(mat, b, py, p0, p1, c0, m)
            row = (ta, c0, s, _row_hits(s, rows, c0, cut))
        _, c0, s, hit = row
        off = tb * TILE - c0
        pp, jj = torch.nonzero(hit[:, off:off + TILE], as_tuple=True)
        out_p.append(pp + ta * TILE)
        out_j.append(jj + tb * TILE)
        out_e.append(s[pp, jj + off])
    if not out_p:
        return _empty_hits(mat.device, mat.dtype)
    return (torch.cat(out_p).to(torch.int32), torch.cat(out_j).to(torch.int32),
            torch.cat(out_e))


# the screen kernels' precision scheme, emulated for the tests ------------

def tf32_round_ref(x):
    """float32 x rounded to TF32 (10 explicit mantissa bits) to nearest,
    ties away from zero: the bits of `cvt.rna.tf32.f32`, the low 13 zero."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_split_ref(x):
    """(hi, lo) of float32 x as the screen kernels split it: hi = x rounded
    to TF32, lo = x − hi rounded likewise, so |x − hi − lo| ≤ 2⁻²²·|x|."""
    hi = tf32_round_ref(x)
    return hi, tf32_round_ref(x - hi)


def tile_product_3xtf32_ref(a, b, py):
    """S = (a ⊙ py)ᵀ b as the screen kernels form it, emulated: py folded
    into a in float32, both operands split by `tf32_split_ref`, and
    S = lo_a·hi_b + hi_a·lo_b + hi_a·hi_b as three float32 products (each
    product of two TF32 values is exact in float32).  The kernels sum the
    same products in another order on the tensor cores, so the two agree
    to float32 rounding, not bit for bit."""
    a_hi, a_lo = tf32_split_ref(a * py[:, None])
    b_hi, b_lo = tf32_split_ref(b)
    return a_lo.T @ b_hi + a_hi.T @ b_lo + a_hi.T @ b_hi


def anchor_panel(mat, anchors, m):
    """(panel, ids) of a screen of the anchors `anchors` (SNP ids, columns
    of mat; None for every SNP): mat itself and None when the list is
    0, 1, ..., m-2 or m-1 (the pairs of anchor m-1 are none), else the
    anchors' columns gathered by one index_select into a contiguous panel
    of ceil(|anchors| / TILE)·TILE columns (the last anchor repeated) and
    the ids as int32."""
    if anchors is None:
        return mat, None
    anchors = anchors.to(device=mat.device, dtype=torch.int64)
    k = len(anchors)
    if k >= m - 1 and k <= m and bool(torch.equal(
            anchors, torch.arange(k, device=mat.device))):
        return mat, None
    if k == 0:
        return mat[:, :0].contiguous(), anchors.to(torch.int32)
    pad = _n_tiles(k) * TILE - k
    idx = torch.cat([anchors, anchors[-1:].expand(pad)])
    return mat.index_select(1, idx), anchors.to(torch.int32)


def screen_hits_ref(mat, py, cut, m, block_elems=1 << 26, *, b=None,
                    anchors=None):
    """Plain version of the whole screen, in mat's dtype: (i int64, j int64,
    eff) of every pair of an anchor i of `anchors` (SNP ids, columns of
    mat; None for every SNP) and a partner j of b (mat when None), j > i,
    j < m, above `cut` (a float or a `CutTable`), in anchor-list order and
    partners ascending.  Computed in anchor-row blocks of at most
    `block_elems` scores, so that the (m, m) matrix is never held."""
    a, ids = anchor_panel(mat, anchors, m)
    b = mat if b is None else b
    out_i, out_j, out_e = [], [], []
    step = max(1, block_elems // max(m, 1))
    for p0 in range(0, _n_anchors(m, ids), step):
        p1 = min(p0 + step, _n_anchors(m, ids))
        rows = _row_ids(ids, p0, p1, mat.device)
        c0 = int(rows.min()) + 1
        if c0 >= m:
            continue
        s = _score_rows(a, b, py, p0, p1, c0, m)
        pp, jj = torch.nonzero(_row_hits(s, rows, c0, cut), as_tuple=True)
        out_i.append(rows[pp])
        out_j.append(jj + c0)
        out_e.append(s[pp, jj])
    if not out_i:
        return _empty_hits(mat.device, mat.dtype, torch.int64)
    return torch.cat(out_i), torch.cat(out_j), torch.cat(out_e)


def _empty_hits(device, dtype, index_dtype=torch.int32):
    return (torch.empty(0, dtype=index_dtype, device=device),
            torch.empty(0, dtype=index_dtype, device=device),
            torch.empty(0, dtype=dtype, device=device))


# kernel wrappers -------------------------------------------------------------

def banded(tiles):
    """(anchor tile, partner tile) rows of `tiles` in the order the screen
    kernels run a list best: in bands of TILE_BAND partner tiles, and in a
    band anchor tile by anchor tile, so that the blocks in flight at once
    share a few tiles of each panel in L2 (the identity count orders its
    own blocks so, in bands of the same width)."""
    if len(tiles) == 0:
        return tiles
    ta, tb = tiles[:, 0].long(), tiles[:, 1].long()
    n_a, n_b = int(ta.max()) + 1, int(tb.max()) + 1
    key = ((tb // TILE_BAND) * n_a + ta) * n_b + tb
    return tiles[torch.argsort(key)].contiguous()


def _is_identity(cut, b, ids):
    return not isinstance(cut, CutTable) and b is None and ids is None


def _general_args(mat, py, cut, m, b, ids):
    """The leading arguments of the general entry points."""
    b = mat if b is None else b
    if isinstance(cut, CutTable):
        bins = (cut.bins_a.data_ptr(), cut.bins_b.data_ptr(),
                cut.table.data_ptr(), 0.0)
    else:
        bins = (None, None, None, float(cut))
    return (mat.data_ptr(), mat.shape[1], mat.shape[1], b.data_ptr(),
            b.shape[1], py.data_ptr(), mat.shape[0], m,
            None if ids is None else ids.data_ptr(), _n_anchors(m, ids),
            *bins)


def screen_counts(mat, py, cut, m, *, b=None, ids=None):
    """(T_a, T_b) int32 grid of per-tile hit counts, T_a = ceil(n_a / TILE)
    anchor tiles (n_a = len(ids), or m), T_b = ceil(m / TILE) partner
    tiles; a tile with no pair j > i counts zero.

    Column p of `mat` is anchor position p with SNP id ids[p] (p itself
    when ids is None); b is the partner panel (mat when None); cut is a
    float or a `CutTable`.  The identity screen (no b, ids or table) runs
    over the upper-triangle tiles, any other over `screen_worklist`."""
    _check(mat, py, m, cut, b, ids)
    if mat.device.type == "cpu":
        return screen_tile_counts_ref(mat, py, cut, m, b=b, ids=ids)
    n_a = _n_anchors(m, ids)
    t_a, t_b = _n_tiles(n_a), _n_tiles(m)
    counts = torch.zeros((t_a, t_b), dtype=torch.int32, device=mat.device)
    if _is_identity(cut, b, ids):
        rc = _library().gmat_screen_count(
            mat.data_ptr(), py.data_ptr(), mat.shape[0], mat.shape[1], m,
            float(cut), counts.data_ptr(), t_a, *_launch_args(mat))
    else:
        pos_ids = (ids if ids is not None
                   else torch.arange(m, dtype=torch.int32, device=mat.device))
        work = banded(screen_worklist(pos_ids, m))
        if len(work) == 0:  # no anchor has a partner: nothing to launch
            return counts
        rc = _library().gmat_screen_count_general(
            *_general_args(mat, py, cut, m, b, ids), work.data_ptr(),
            len(work), counts.data_ptr(), t_b, *_launch_args(mat))
    _raise_on(rc, "gmat_screen_count")
    _count_launch("screen_count")
    return counts


def screen_extract(mat, py, cut, m, counts, *, b=None, ids=None):
    """Hits of every tile with a nonzero count in `counts` (from
    `screen_counts` with the same arguments), unordered: (anchor position
    int32, j int32, eff float32)."""
    _check(mat, py, m, cut, b, ids)
    tiles = torch.nonzero(counts).to(torch.int32).contiguous()
    if mat.device.type == "cpu":
        return screen_extract_ref(mat, py, cut, m, tiles, b=b, ids=ids)
    total = int(counts.sum())
    if total == 0:
        return _empty_hits(mat.device, mat.dtype)
    if total >= 2 ** 31:
        raise ValueError(f"{total} hits exceed the int32 hit buffer")
    dev = mat.device
    out_p = torch.empty(total, dtype=torch.int32, device=dev)
    out_j = torch.empty(total, dtype=torch.int32, device=dev)
    out_e = torch.empty(total, dtype=torch.float32, device=dev)
    state = torch.zeros(2, dtype=torch.int32, device=dev)  # cursor, overflow
    tiles = banded(tiles)
    tail = (tiles.data_ptr(), tiles.shape[0], out_p.data_ptr(),
            out_j.data_ptr(), out_e.data_ptr(), total, state.data_ptr(),
            *_launch_args(mat))
    if _is_identity(cut, b, ids):
        rc = _library().gmat_screen_extract(
            mat.data_ptr(), py.data_ptr(), mat.shape[0], mat.shape[1], m,
            float(cut), *tail)
    else:
        rc = _library().gmat_screen_extract_general(
            *_general_args(mat, py, cut, m, b, ids), *tail)
    _raise_on(rc, "gmat_screen_extract")
    _count_launch("screen_extract")
    cursor, overflow = state.tolist()
    if overflow or cursor != total:
        raise RuntimeError(f"screen extraction found {cursor} hits "
                           f"({overflow} past the buffer) where the counts "
                           f"gave {total}")
    return out_p, out_j, out_e


def screen_positions(mat, py, cut, m, *, b=None, anchors=None):
    """The two-phase screen: (p int64, j int64, eff float32) of every pair
    of the anchor at position p of `anchors` (SNP ids, columns of mat;
    None for every SNP, p then being the SNP id) and a partner j of b (mat
    when None), j > anchor, j < m, with |S| above `cut` (a float or a
    `CutTable`), sorted on mat's device by (p, j)."""
    a, ids = anchor_panel(mat, anchors, m)
    if b is None and ids is not None:
        b = mat
    counts = screen_counts(a, py, cut, m, b=b, ids=ids)
    p, j, eff = screen_extract(a, py, cut, m, counts, b=b, ids=ids)
    p, j = p.to(torch.int64), j.to(torch.int64)
    order = torch.argsort(p * m + j)
    return p[order], j[order], eff[order]


def screen_hits(mat, py, cut, m, *, b=None, anchors=None):
    """`screen_positions` with each position replaced by its anchor's SNP
    id: (i int64, j int64, eff float32), (i, j)-sorted for an ascending
    anchor list."""
    p, j, eff = screen_positions(mat, py, cut, m, b=b, anchors=anchors)
    if anchors is None:
        return p, j, eff
    return anchors.to(device=p.device, dtype=torch.int64)[p], j, eff


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
        _count_launch("exact_scan")
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
