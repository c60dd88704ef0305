"""One-call REMMAX orchestration.

Twin of examples/pipeline/remmax_one_call.py on the PyTorch port: the
whole 4-step workflow (GRM, REML, scan, annotation) through
`gmat_tpu_torch.pipeline.remmax.remmax()`, with stage artifacts on disk so
that a rerun resumes from the finished stages.

    python examples/torch/pipeline/remmax_one_call.py [--device cuda|cpu]
"""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from _common import out_dir, parse_device, stage_mouse  # noqa: E402

import numpy as np  # noqa: E402

from gmat_tpu_torch.pipeline.remmax import remmax  # noqa: E402

dev = parse_device(__doc__)
out = out_dir(__file__)
bed = stage_mouse(out)
pheno = str(out / "pheno")

kw = dict(out_prefix=str(out / "remmax"), model="a_axa", scan="epiAA_approx",
          p_cut=1e-4, num_random_pair=20000, dis=5_000_000, device=dev)
res = remmax(pheno, bed, **kw)
print("variance components:", np.round(res.var_com, 5))
print("phase timings (s):", {k: round(v, 2) for k, v in res.timings.items()})

# the second call resumes from the stage artifacts (var file on disk)
res2 = remmax(pheno, bed, **kw)
assert np.allclose(res.var_com, res2.var_com)
print("resume OK; outputs:",
      sorted(p.name for p in out.glob("remmax*"))[:8])
