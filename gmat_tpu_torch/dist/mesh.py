"""Sharding over several devices: the device mesh, the sharded GRM, the
sharded screen and the sharded exact scan (counterpart of
`gmat_tpu/dist/mesh.py`).

The reference scales by hand: one process per machine with
`parallel=[N, i]`, then the output files are concatenated.  Here one call
spreads its work over a `Mesh`:

- a process drives its local devices, one host thread per local shard
  (`_map_shards`), each thread on its device's current stream;
- several processes join through `torch.distributed` (`dist/init.py`):
  rows of hits are merged by a padded `all_gather` (`_gather_rows`), the
  GRM's partial Gram by an `all_reduce` (`_allreduce_sum`);
- every process ends with the merged result, so every process can write
  the output file, as the JAX package does.

`torch.distributed.device_mesh.DeviceMesh` assumes one process per device,
so it cannot drive several devices from one process; hence this small
mesh of its own.  A device may repeat in the list, which gives virtual
shards on one device (the JAX tests' 8 virtual CPU devices).

The split rules are the JAX package's:
- GRM: SNP columns in contiguous blocks; each shard centres its own
  columns (frequencies are per column) and forms a partial Gram in f64;
- screens: anchors round-robin (position k of the anchor list to shard
  k mod D), so that the triangular pair counts even out;
- exact scan: one anchor run of at most 2²⁴ pairs per shard and round;
- pair tests: one chunk of the canonical width per shard and step.
Each pair is computed alone by the kernels K1 and K2, so a mesh's output
files are the same bytes as the call's without a mesh on the card.
"""
from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor, wait
from dataclasses import dataclass

import numpy as np
import torch

from gmat_tpu_torch.core import spans


@dataclass(frozen=True)
class Mesh:
    """The devices of one call.

    `devices`: this process's devices, in shard order (repeats make
    virtual shards); `group`: the `torch.distributed` process group, None
    in a single process; `rank`, `world`: this process's rank and the
    number of processes.  Global shard k is local device k mod L of rank
    k div L, for L = len(devices)."""

    devices: tuple
    group: object = None
    rank: int = 0
    world: int = 1

    @property
    def size(self) -> int:
        """The global shard count: local devices x processes."""
        return len(self.devices) * self.world

    @property
    def shard_ids(self) -> range:
        """The global ids of this process's shards, in local order."""
        local = len(self.devices)
        return range(self.rank * local, (self.rank + 1) * local)

    @property
    def distinct_devices(self) -> tuple:
        """This process's devices, each once, in first-use order."""
        return tuple(dict.fromkeys(self.devices))


def make_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """A mesh of this process's devices.

    By default every visible CUDA device, or the first `n_devices` of them;
    raises when fewer exist, and never falls back to the CPU.  `devices`
    lists the devices explicitly (torch devices, names such as "cuda:0" or
    "cpu", or CUDA ordinals); a device may repeat."""
    if devices is None:
        count = torch.cuda.device_count()
        want = count if n_devices is None else n_devices
        if count == 0 or want > count:
            raise RuntimeError(f"a mesh of {want or 'all'} CUDA devices: "
                               f"{count} visible")
        devices = [torch.device("cuda", k) for k in range(want)]
    else:
        devices = [torch.device(d) for d in devices]
        if n_devices is not None:
            if n_devices > len(devices):
                raise ValueError(f"a mesh of {n_devices} devices from a "
                                 f"list of {len(devices)}")
            devices = devices[:n_devices]
    if not devices:
        raise ValueError("a mesh needs at least one device")
    for dev in devices:
        if dev.type == "cuda" and (dev.index is None
                                   or dev.index >= torch.cuda.device_count()):
            raise RuntimeError(f"{dev}: not a visible CUDA device "
                               f"({torch.cuda.device_count()} visible)")
    return Mesh(devices=tuple(devices))


def _replicate(mesh: Mesh, make) -> dict:
    """{device: make(device)} over the mesh's distinct local devices,
    computed in this thread before any shard thread starts."""
    return {dev: make(dev) for dev in mesh.distinct_devices}


def _replica(x, device):
    """x's replica on `device`: x[device] for a map from `_replicate`,
    else x itself, which must then lie on that device."""
    if isinstance(x, dict):
        return x[device]
    return x


def _any_replica(x):
    """x, or one of its replicas for a map from `_replicate`."""
    return next(iter(x.values())) if isinstance(x, dict) else x


def _map_shards(mesh: Mesh, fn, shares):
    """[fn(device, share) for each local shard], one host thread per shard
    (none for a single shard), each thread under its CUDA device and with
    the caller's open span as the parent of its spans.  Every shard runs
    to its end; the first exception, in shard order, is raised."""
    if len(shares) != len(mesh.devices):
        raise ValueError(f"{len(shares)} shares for {len(mesh.devices)} "
                         "local shards")
    parent = spans.current()

    def run(dev, share):
        with spans.inherit(parent):
            if dev.type == "cuda":
                with torch.cuda.device(dev):
                    return fn(dev, share)
            return fn(dev, share)

    if len(shares) == 1:
        return [run(mesh.devices[0], shares[0])]
    with ThreadPoolExecutor(max_workers=len(shares),
                            thread_name_prefix="gmat-shard") as pool:
        futures = [pool.submit(run, dev, share)
                   for dev, share in zip(mesh.devices, shares)]
        wait(futures)
    for fut in futures:
        if fut.exception() is not None:
            raise fut.exception()
    return [fut.result() for fut in futures]


def _collective_device(mesh: Mesh) -> torch.device:
    """Where the collectives' tensors live: the first local device for
    NCCL, the host for any other backend (gloo stages through it)."""
    import torch.distributed as dist

    if dist.get_backend(mesh.group) == "nccl":
        return mesh.devices[0]
    return torch.device("cpu")


def _gather_rows(mesh: Mesh, parts):
    """The rows of every global shard, on every process.

    `parts`: per local shard, a tuple of 1-d numpy columns of equal
    length (the same column dtypes on every shard).  Returns the list over
    all `mesh.size` shards, in global order, of such tuples.  Across
    processes: the row counts first, then each column through one
    `all_gather` padded to the largest process's rows."""
    parts = [tuple(np.asarray(c) for c in p) for p in parts]
    if mesh.world == 1:
        return parts
    import torch.distributed as dist

    dev = _collective_device(mesh)
    local = len(mesh.devices)
    sizes = torch.tensor([len(p[0]) for p in parts], dtype=torch.int64,
                         device=dev)
    got = [torch.empty_like(sizes) for _ in range(mesh.world)]
    dist.all_gather(got, sizes, group=mesh.group)
    sizes = torch.stack(got).cpu().numpy()  # (world, local)
    cap = int(sizes.sum(axis=1).max())
    columns = []
    for c in range(len(parts[0])):
        mine = torch.as_tensor(np.concatenate([p[c] for p in parts]))
        padded = torch.zeros(cap, dtype=mine.dtype, device=dev)
        padded[:len(mine)] = mine.to(dev)
        gathered = [torch.empty_like(padded) for _ in range(mesh.world)]
        if cap:
            dist.all_gather(gathered, padded, group=mesh.group)
        columns.append([t.cpu().numpy() for t in gathered])
    out = []
    for rank in range(mesh.world):
        ends = np.cumsum(sizes[rank])
        for k in range(local):
            lo, hi = ends[k] - sizes[rank, k], ends[k]
            out.append(tuple(col[rank][lo:hi] for col in columns))
    return out


def _allreduce_sum(mesh: Mesh, parts):
    """The sum over every global shard of `parts` (one tensor per local
    shard), on the first local device: the local shards in shard order,
    then one `all_reduce` across processes."""
    dev = mesh.devices[0]
    total = parts[0].to(dev)
    for t in parts[1:]:
        total = total + t.to(dev)
    if mesh.world == 1:
        return total
    import torch.distributed as dist

    buf = total.to(_collective_device(mesh))
    dist.all_reduce(buf, group=mesh.group)
    return buf.to(dev)


# the sharded GRM -------------------------------------------------------------

def _grm_shard(geno, cols, kind, dev):
    """(partial Gram, partial scale) of the SNP columns `cols` on `dev`,
    float64: frequencies and centering are per column, hence local."""
    from gmat_tpu_torch.core.coding import additive_code, dominance_code

    g = torch.as_tensor(np.ascontiguousarray(geno[:, cols]),
                        dtype=torch.float64, device=dev)
    mat, _, scale = (additive_code if kind == "add" else dominance_code)(g)
    return mat @ mat.T, scale


def _sharded_grm(geno, mesh: Mesh, small_val, kind):
    """K = Σ_shards M_s M_sᵀ / Σ_shards scale_s, diagonal times
    (1 + small_val): `grm.{additive,dominance}_grm` with the SNP columns
    split in contiguous blocks over the shards."""
    geno = np.asarray(geno, dtype=np.float64)
    blocks = np.array_split(np.arange(geno.shape[1]), mesh.size)
    shares = [blocks[k] for k in mesh.shard_ids]
    parts = _map_shards(mesh, lambda dev, cols: _grm_shard(geno, cols, kind,
                                                           dev), shares)
    gram = _allreduce_sum(mesh, [p[0] for p in parts])
    scale = _allreduce_sum(mesh, [p[1].reshape(1) for p in parts])[0]
    kin = gram / scale
    kin.diagonal().mul_(1.0 + small_val)
    return kin


def sharded_additive_grm(geno, mesh: Mesh, small_val: float = 0.001):
    """Additive GRM over the mesh; a float64 tensor on its first device."""
    return _sharded_grm(geno, mesh, small_val, "add")


def sharded_dominance_grm(geno, mesh: Mesh, small_val: float = 0.001):
    """Dominance GRM over the mesh; a float64 tensor on its first device."""
    return _sharded_grm(geno, mesh, small_val, "dom")


# the sharded screen and exact scan -------------------------------------------

def interleaved_anchor_split(num_snp: int, ndev: int) -> np.ndarray:
    """(ndev, ceil((num_snp-1)/ndev)) anchor assignment: device d gets
    anchors d::ndev.

    Interleaving balances the triangular partner counts to within one row,
    the mesh's analog of the reference's block-paired split.  Padded
    entries repeat the last anchor and are masked out by the caller."""
    anchors = np.arange(num_snp - 1)
    per = -(-len(anchors) // ndev)
    out = np.full((ndev, per), anchors[-1], dtype=np.int32)
    for d in range(ndev):
        chunk = anchors[d::ndev]
        out[d, : len(chunk)] = chunk
    return out


def sharded_screen_hits(mat, pymat, cut: float, mesh: Mesh, tile: int = 256):
    """The AA screen |(A ⊙ py)ᵀA| > cut over the pairs j > i of the anchors
    0 … m-2, shared round-robin over the mesh (K1 on each shard's anchor
    subset): (i int64, j int64, eff float32) host arrays sorted by (i, j).

    `tile` is the JAX engine's tile edge, accepted for the same calls; the
    kernel tiles at `kernels.TILE`."""
    from gmat_tpu_torch.scan.screen import _run_screen

    del tile
    panels = _replicate(mesh, lambda dev: tuple(
        torch.as_tensor(np.asarray(x), dtype=torch.float32,
                        device=dev).contiguous() for x in (mat, pymat)))
    a, py = ({dev: p[k] for dev, p in panels.items()} for k in range(2))
    m = np.shape(mat)[1]
    bins = np.zeros(m, dtype=np.int64)
    return _run_screen(a, a, py, range(m - 1), bins, bins,
                       np.full(111, cut, dtype=np.float32), mesh=mesh)


def sharded_screen_counts(mat, pymat, cut: float, mesh: Mesh,
                          tile: int = 256) -> np.ndarray:
    """Per-anchor hit counts (num_snp-1,) of the AA screen over the
    interleaved anchor split: K1 on each shard's anchors, then a bincount
    of the hits' anchors."""
    i, _, _ = sharded_screen_hits(mat, pymat, cut, mesh, tile)
    return np.bincount(i, minlength=np.shape(mat)[1] - 1).astype(np.int64)


def sharded_exact_scan_tile(anchor_block, mat, pymat, pvpmat,
                            mesh: Mesh) -> np.ndarray:
    """p of every (anchor, partner) pair, e = m[:, a] ⊙ m[:, j], as a
    (TA, m) float64 host array: the anchor block split in contiguous
    parts over the mesh, K2 keeping every pair of the full rectangle.  A
    pair whose chi is NaN (var = 0) stays NaN."""
    from gmat_tpu_torch.core.stats import chi2_sf
    from gmat_tpu_torch.scan.kernels import exact_hits

    anchors = np.asarray(anchor_block, dtype=np.int64)
    m = np.shape(mat)[1]
    inputs = _replicate(mesh, lambda dev: tuple(
        torch.as_tensor(np.asarray(x), dtype=torch.float64,
                        device=dev).contiguous()
        for x in (mat, pymat, pvpmat)))
    blocks = np.array_split(np.arange(len(anchors)), mesh.size)

    def shard(dev, rows):
        ids = anchors[rows]
        mt, py, pvp = inputs[dev]
        i, j, _, _, chi = exact_hits(mt, mt, py, pvp,
                                     torch.as_tensor(ids, device=dev), -1.0,
                                     "rect")
        # the kernel names a pair by its anchor's SNP id; a repeated
        # anchor's rows are the same
        uniq, inv = np.unique(ids, return_inverse=True)
        table = np.full((len(uniq), m), np.nan)
        table[np.searchsorted(uniq, i.cpu().numpy()), j.cpu().numpy()] = \
            chi2_sf(chi, 1).cpu().numpy()
        r, c = np.nonzero(~np.isnan(table[inv]))
        return rows[r], c, table[inv[r], c]

    out = np.full((len(anchors), m), np.nan)
    parts = _map_shards(mesh, shard, [blocks[k] for k in mesh.shard_ids])
    for r, c, p in _gather_rows(mesh, parts):
        out[r, c] = p
    return out
