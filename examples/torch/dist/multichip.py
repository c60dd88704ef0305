"""Sharding over a device mesh.

Twin of examples/dist/multichip.py on the PyTorch port.  The reference's
only multi-machine story is manual `parallel=[N, i]` runs merged by file
concatenation; here the three hot phases run sharded over a
`gmat_tpu_torch.dist.Mesh`:

  - additive GRM: genotype columns sharded, partial M·Mᵀ summed
  - effect screen: interleaved anchors per shard, deterministic hit merge
  - exact-scan tile: anchors split over the mesh

With CUDA and two or more visible cards the mesh holds one shard per card;
otherwise two virtual shards of `--device` (threads on one device).

    python examples/torch/dist/multichip.py [--device cuda|cpu]
"""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from _common import out_dir, parse_device, stage_mouse  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

from gmat_tpu_torch.dist.mesh import (  # noqa: E402
    make_mesh,
    sharded_additive_grm,
    sharded_exact_scan_tile,
    sharded_screen_hits,
)
from gmat_tpu_torch.grm.grm import agmat  # noqa: E402
from gmat_tpu_torch.io.bed import read_plink  # noqa: E402
from gmat_tpu_torch.scan.screen import remma_epiAA_approx  # noqa: E402

dev = parse_device(__doc__)
out = out_dir(__file__)
bed = stage_mouse(out)

if dev.type == "cuda" and torch.cuda.device_count() > 1:
    mesh = make_mesh()
else:
    # a mesh names each CUDA device by its ordinal
    shard = (torch.device("cuda", torch.cuda.current_device())
             if dev.type == "cuda" and dev.index is None else dev)
    mesh = make_mesh(devices=[shard, shard])
print("mesh:", mesh.size, "shards on", [str(d) for d in mesh.devices])

geno = np.asarray(read_plink(bed), dtype=np.float64)
n, m = geno.shape

# 1) sharded GRM == single-device GRM
kin_sharded = sharded_additive_grm(geno, mesh).cpu().numpy()
kin_single, _ = agmat(bed, out_fmt="mat", device=dev)
print("sharded GRM max |delta| vs single device:",
      float(np.abs(kin_sharded - kin_single).max()))

# 2) sharded effect screen with deterministic hit merge
p_hat = geno.sum(0) / (2 * n)
mat = (geno - 2 * p_hat[None, :]).astype(np.float32)
py = np.random.default_rng(0).standard_normal(n).astype(np.float32) * 0.1
row = np.abs((mat[:, :64] * py[:, None]).T @ mat)
cut = float(np.quantile(row, 1 - 1e-4))
i0, i1, eff = sharded_screen_hits(mat, py, cut, mesh)
print(f"sharded screen: {len(i0)} hits above |eff|={cut:.3f}")

# 3) exact-scan tile, anchors split over the mesh (pvp must be symmetric)
rng = np.random.default_rng(1)
a = rng.standard_normal((n, n))
pvp = a @ a.T / n + np.eye(n)
pvp = (pvp + pvp.T) / 2
anchors = np.arange(16, dtype=np.int32)
p = sharded_exact_scan_tile(anchors, mat.astype(np.float64),
                            py.astype(np.float64), pvp, mesh)
print("exact tile p-matrix:", p.shape, "finite:", bool(np.isfinite(p).all()))

# 4) the file-level pipeline on the mesh: every scan, screen, approx
# pipeline and GRM entry point takes `mesh=`, and the command line takes
# `gmat-tpu-torch --devices N ...`; the files equal the single-device ones
var_com = np.array([0.06289206, 0.07641075, 0.08121168])
pheno = str(Path(bed).parent / "pheno")
remma_epiAA_approx(pheno, bed, [kin_single, kin_single * kin_single],
                   var_com, p_cut=1e-4, num_random_pair=5000,
                   out_file=str(out / "epiAA_meshed"), mesh=mesh, device=dev)
print("meshed approx pipeline rows:",
      sum(1 for _ in open(out / "epiAA_meshed")) - 1)

# 5) several processes: each calls
#     mesh = gmat_tpu_torch.dist.initialize_multihost(
#         "localhost:<port>", world, rank)
# once at startup and passes the returned mesh exactly as above
# (tests/test_torch_dist.py runs a 2-process gloo world this way).
