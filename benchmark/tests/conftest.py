"""Small configurations of the benchmark's cells for CPU runs."""
import copy
import json
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
HERE = ROOT / "benchmark"


def load(path):
    with open(path) as f:
        return json.load(f)


@pytest.fixture(scope="session")
def bench():
    return load(ROOT / "BENCHMARK.json")


def small(cell_name, bench):
    """(config, traffic) of `cell_name` cut to a CPU run: the yeast recipe
    at 800 x 1000, 5,000 calibration pairs, 4 parts, pools of 4 traits,
    and exhaustive scans at p 1e-3, so that every unit writes rows."""
    cell = next(c for c in bench["workloads"] if c["name"] == cell_name)
    config = load(HERE / "configs" / "yeast.json")
    config.update(n_id=800, n_snp=1000)
    traffic = copy.deepcopy(load(HERE / "traffic" / f"{cell['traffic']}.json"))
    if "num_random_pair" in traffic["args"]:
        traffic["args"]["num_random_pair"] = 5000
    if traffic["family"] == "exhaustive":
        traffic["args"]["p_cut"] = 1e-3
    if traffic["unit"] == "part":
        traffic["parts"] = 4
    else:
        traffic["pool"] = 4
    return config, traffic
