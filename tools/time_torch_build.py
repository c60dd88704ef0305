#!/usr/bin/env python3
"""Time two ways of building the port's kernels from gmat_tpu_torch/csrc.

    python3 tools/time_torch_build.py [--reps 2]

"one_call": a single `nvcc -shared -o lib.so csrc/*.cu`;
"parallel": `native.compile_sources`, one nvcc per source, all started
together, then one link (what `build_library` runs).  Both use the
package's flags and build cold into a scratch directory under build/, in
the order one_call, parallel, parallel, one_call per repetition.  Prints
the card's name and power limit, then one JSON line of wall times in s.
Needs nvcc.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from gmat_tpu_torch.core import native  # noqa: E402


def one_call(srcs, out):
    run = subprocess.run([native._nvcc(), *native._NVCC_FLAGS, "-shared", "-o",
                          str(out), *map(str, srcs)],
                         capture_output=True, text=True)
    if run.returncode != 0:
        raise RuntimeError("nvcc failed:\n" + run.stdout + run.stderr)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=2)
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip() or "no nvidia-smi", flush=True)
    srcs = sorted(native._CSRC.glob("*.cu"))
    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    times = {"one_call": [], "parallel": []}
    with tempfile.TemporaryDirectory(dir=build) as td:
        for rep in range(args.reps):
            for k, name in enumerate(("one_call", "parallel", "parallel",
                                      "one_call")):
                out = Path(td) / f"lib_{rep}_{k}.so"
                t0 = time.perf_counter()
                if name == "one_call":
                    one_call(srcs, out)
                else:
                    native.compile_sources(srcs, out)
                times[name].append(time.perf_counter() - t0)
    print(json.dumps({"sources": [p.name for p in srcs], "seconds": times}),
          flush=True)


if __name__ == "__main__":
    main()
