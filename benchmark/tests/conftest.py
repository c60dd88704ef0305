"""Small configurations of the benchmark's cells for CPU runs."""
import copy
import json
import os
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
HERE = ROOT / "benchmark"


def load(path):
    with open(path) as f:
        return json.load(f)


def worker_threads():
    """The cores over the test processes (pytest-xdist's workers): the
    threads each may use, so that workers do not oversubscribe the cores
    and stall each other's BLAS."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    return max(1, (os.cpu_count() or 1) // workers)


@pytest.fixture(scope="session", autouse=True)
def share_the_cores():
    before = torch.get_num_threads()
    torch.set_num_threads(worker_threads())
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="session")
def bench():
    return load(ROOT / "BENCHMARK.json")


def small(cell_name, bench):
    """(config, traffic) of `cell_name` cut to a CPU run: the yeast recipe
    at 800 x 1000, 5,000 calibration pairs, 4 parts, pools of 4 traits,
    and exhaustive scans at p 1e-3, so that every unit writes rows; a
    full table (p_cut 1) keeps its p_cut over 300 SNPs (44,850 rows)."""
    cell = next(c for c in bench["workloads"] if c["name"] == cell_name)
    config = load(HERE / "configs" / "yeast.json")
    config.update(n_id=800, n_snp=1000)
    traffic = copy.deepcopy(load(HERE / "traffic" / f"{cell['traffic']}.json"))
    if "num_random_pair" in traffic["args"]:
        traffic["args"]["num_random_pair"] = 5000
    if traffic["family"] == "exhaustive":
        if traffic["args"]["p_cut"] < 1.0:
            traffic["args"]["p_cut"] = 1e-3
        else:
            config["n_snp"] = 300
    if traffic["unit"] == "part":
        traffic["parts"] = 4
    else:
        traffic["pool"] = 4
    return config, traffic
