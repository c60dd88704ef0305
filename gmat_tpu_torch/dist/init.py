"""Several processes as one mesh (counterpart of `gmat_tpu/dist/init.py`).

The reference scales across machines by hand: one process per machine
with `parallel=[N, i]`, then the output files are concatenated.  Here every
process calls `initialize_multihost(...)` once and passes the mesh it
returns as the `mesh=` argument of any file-level entry point (agmat,
remma_epi*, remma_epi*_eff, remma_epi*_approx, ...): the work is shared
over every process's devices, the rows are merged on every process, and
the output files are the same bytes as a single-device run's.

In one process build a mesh directly with `dist.mesh.make_mesh()`.
"""
from __future__ import annotations

import logging

import torch

logger = logging.getLogger(__name__)


def initialize_multihost(coordinator_address: str | None = None,
                         num_processes: int | None = None,
                         process_id: int | None = None,
                         local_device_ids=None, backend: str | None = None):
    """Join the process group and return the mesh over every process's
    devices.

    `coordinator_address` ("host:port"), `num_processes` and `process_id`
    are given together (`tcp://` rendezvous), or all None, when
    `torchrun`'s environment names them (`env://`).  `local_device_ids`
    lists this process's devices as `make_mesh(devices=...)` takes them
    (None: every visible CUDA device); every process must list as many.
    The backend is "nccl" when every local device is a CUDA device, else
    "gloo"; `backend` overrides it.  Raises on any failure."""
    import torch.distributed as dist

    from gmat_tpu_torch.dist.mesh import Mesh, make_mesh

    given = [a is not None for a in (coordinator_address, num_processes,
                                     process_id)]
    if any(given) and not all(given):
        raise ValueError("give coordinator_address, num_processes and "
                         "process_id together, or none of them")
    local = make_mesh(devices=local_device_ids)
    if backend is None:
        backend = ("nccl" if all(d.type == "cuda" for d in local.devices)
                   else "gloo")
    if all(given):
        dist.init_process_group(backend,
                                init_method=f"tcp://{coordinator_address}",
                                world_size=num_processes, rank=process_id)
    else:
        dist.init_process_group(backend, init_method="env://")
    rank, world = dist.get_rank(), dist.get_world_size()
    if backend == "nccl":
        torch.cuda.set_device(local.devices[0])
    counts = [None] * world
    dist.all_gather_object(counts, len(local.devices))
    if len(set(counts)) != 1:
        dist.destroy_process_group()
        raise RuntimeError(f"local device counts differ across processes: "
                           f"{counts}")
    mesh = Mesh(devices=local.devices, group=dist.group.WORLD, rank=rank,
                world=world)
    logger.info("Process group up (%s): process %d/%d, %d local / %d "
                "global shards", backend, rank, world, len(local.devices),
                mesh.size)
    return mesh
