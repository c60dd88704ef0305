"""Sharding over several devices and processes (counterpart of
`gmat_tpu/dist/`).

`make_mesh()` builds a mesh over this process's devices;
`initialize_multihost()` joins a `torch.distributed` process group and
returns the mesh over every process's devices.  Every file-level entry
point that sweeps SNPs or pairs takes the mesh as `mesh=`.
"""
from gmat_tpu_torch.dist.init import initialize_multihost
from gmat_tpu_torch.dist.mesh import (
    interleaved_anchor_split,
    make_mesh,
    sharded_additive_grm,
    sharded_dominance_grm,
    sharded_exact_scan_tile,
    sharded_screen_counts,
    sharded_screen_hits,
)

__all__ = [
    "initialize_multihost",
    "interleaved_anchor_split",
    "make_mesh",
    "sharded_additive_grm",
    "sharded_dominance_grm",
    "sharded_exact_scan_tile",
    "sharded_screen_counts",
    "sharded_screen_hits",
]
