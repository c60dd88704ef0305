#!/usr/bin/env python3
"""Run every script of examples/torch/ once and time it.

    python3 tools/run_torch_examples.py [--device cuda|cpu]

Each script runs in its own process with `--device`, from the repository
root, its output under build/torch_examples/<script>.log.  Prints the
device (for CUDA, the card's name and power limit as nvidia-smi gives
them), one line per script with its exit status and wall time, then one
JSON line of the same; exits nonzero when any script failed.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SCRIPTS = ("grm/cal_agmat.py", "grm/cal_dgmat.py", "uvlmm/uvlmm_varcom.py",
           "remma/remma_workflow.py", "remma/remma_approx.py",
           "longwas/balance_test.py", "longwas/unbalance_test.py",
           "longwas/test.py", "pipeline/remmax_one_call.py",
           "dist/multichip.py")


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch

    from gmat_tpu_torch.bench import card_line

    print(card_line(torch.device(args.device)), flush=True)
    logs = ROOT / "build" / "torch_examples"
    logs.mkdir(parents=True, exist_ok=True)
    runs = {}
    for script in SCRIPTS:
        log = logs / (script.replace("/", "_")[:-3] + ".log")
        t0 = time.perf_counter()
        with open(log, "w") as f:
            rc = subprocess.run(
                [sys.executable, str(ROOT / "examples" / "torch" / script),
                 "--device", args.device], cwd=ROOT, stdout=f,
                stderr=subprocess.STDOUT).returncode
        runs[script] = {"rc": rc, "wall_s": time.perf_counter() - t0}
        print(f"{script}: exit {rc}, {runs[script]['wall_s']:.2f} s "
              f"(log {log.relative_to(ROOT)})", flush=True)
        if rc:
            print(log.read_text()[-3000:], flush=True)
    print(json.dumps({"device": args.device, "examples": runs}), flush=True)
    sys.exit(int(any(r["rc"] for r in runs.values())))


if __name__ == "__main__":
    main()
