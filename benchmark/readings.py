"""The readings that the limits of the check are set from.

    python3 benchmark/readings.py --workload <cell> --seeds 1,2,3 --seconds 12 [--control]

For each seed, one run of the cell with a short window (long enough to
finish as many units as a run checks), then, with `--control`, the same
run with the plain reference computed one precision lower put in the
program's place (`program.Control`).  One JSON line per seed and side,
with each compared number, on standard output.  The benchmark's own runs
never run this.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--control", action="store_true")
    args = ap.parse_args(argv)

    from benchmark import harness
    from benchmark.program import Control, Program

    bench = harness.load_json(ROOT / "BENCHMARK.json")
    sides = [("program", Program)] + ([("control", Control)]
                                      if args.control else [])
    for seed in (int(s) for s in args.seeds.split(",")):
        for side, cls in sides:
            t0 = time.perf_counter()
            res, checks = harness.run_cell(bench, args.workload, seed,
                                           args.seconds, False,
                                           program_cls=cls,
                                           t_process=time.perf_counter())
            line = {"workload": args.workload, "seed": seed, "side": side,
                    "correct": res["correct"], "attempted": res["attempted"],
                    "checks": {k: v["value"] for k, v in checks.items()},
                    "metrics": {k: v["value"] for k, v in res["metrics"].items()},
                    "seconds": time.perf_counter() - t0}
            print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
