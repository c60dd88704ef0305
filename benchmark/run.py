"""The benchmark of gmat_tpu_torch on one NVIDIA GPU.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Runs one cell of BENCHMARK.json (at the checkout's root) and prints, as
the last line of standard output, one JSON object: `correct`,
`attempted`, `failed`, `metrics`, `device`, with `--trace 1` also
`breakdown`; each compared number and its limit end standard error.
Exits non-zero, printing no result, without a
CUDA device, with fewer devices than the cell asks for, or when a module
of JAX or of the JAX package `gmat_tpu` is loaded.
"""
import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# the checkout's own program and harness, before anything installed
sys.path.insert(0, str(ROOT))


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None):
    args = parse(argv)
    import torch

    from benchmark import harness

    bench = harness.load_json(ROOT / "BENCHMARK.json")
    cell, _ = harness.find(bench, args.workload)
    chips = int(cell.get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    import gmat_tpu_torch

    if ROOT not in Path(gmat_tpu_torch.__file__).resolve().parents:
        print(f"gmat_tpu_torch comes from {gmat_tpu_torch.__file__}, not "
              f"from this checkout", file=sys.stderr)
        return 2
    result, _ = harness.run_cell(bench, args.workload, args.seed,
                                 args.seconds, bool(args.trace),
                                 t_process=T_PROCESS)
    sys.stdout.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
