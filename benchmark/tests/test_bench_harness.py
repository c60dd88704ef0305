"""The harness on the CPU: BENCHMARK.json against the contract, cells,
configurations, mixes and metrics found by name (and added as files
alone), the result line, the rooflines' counts and the imports."""
import ast
import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from benchmark import harness, roofline
from benchmark.tests.conftest import HERE, ROOT, load, small, worker_threads

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
FORBIDDEN = {"jax", "jaxlib", "flax", "gmat_tpu"}


def test_benchmark_json_names_its_files(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["benchmark"]
    assert 1 <= bench["run_seconds"] <= 51
    configs = {c["name"]: c for c in bench["configs"]}
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/")
        assert load(ROOT / c["file"])["name"] == c["name"]
    used = set()
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] == 1
        assert (HERE / "traffic" / f"{w['traffic']}.json").is_file()
        assert len(w["why"]) <= 200
        used.add(w["config"])
    assert used == set(configs)
    cells = {w["name"] for w in bench["workloads"]}
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert (HERE / "metrics" / f"{m['name']}.py").is_file()
        assert set(m.get("workloads", cells)) <= cells
    for m in bench["per_layer"]:
        moved = e2e[m["moves"]]
        assert set(m["workloads"]) <= set(moved.get("workloads", cells))
    for cell in cells:
        reported = [m for m in bench["end_to_end"]
                    if cell in m.get("workloads", cells)]
        assert len(reported) >= 2
        assert any(cell in m["workloads"] for m in bench["per_layer"])


def test_flop_counts_at_the_cells_shapes():
    # yeast screen: 2n FLOP over 398,170,090 pairs at 495/3 TFLOP/s
    assert roofline.screen_pairs(28220) == 398170090
    assert roofline.k1_least_seconds(4168, 28220) == pytest.approx(
        2 * 4168 * 398170090 / 165e12)
    # DD as AA; AD: every ordered pair i != j, 2n FLOP each
    assert roofline.screen_pairs(28220, "DD") == 398170090
    assert roofline.screen_pairs(28220, "AD") == 796340180
    assert roofline.k1_least_seconds(4168, 28220, "AD") == pytest.approx(
        2 * 4168 * 796340180 / 165e12)
    # K2: n² + 7n FLOP a pair at 67 TFLOP/s; the [100, k] part of yeast
    assert roofline.k2_pair_flop(4168) == 4168 ** 2 + 7 * 4168
    assert roofline.k2_pair_flop(1304) == 1304 ** 2 + 7 * 1304
    part = 3981889
    assert roofline.k2_least_seconds(4168, 28220, part) == pytest.approx(
        part * (4168 ** 2 + 7 * 4168) / 67e12)


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_nothing_imports_jax_and_the_reference_nothing_of_the_port():
    for path in HERE.rglob("*.py"):
        tops = {name.split(".")[0] for name in _imports(path)}
        assert not tops & FORBIDDEN, path
        if "reference" in path.parts:
            assert "gmat_tpu_torch" not in tops, path


def test_result_line_and_new_files_alone(tmp_path, bench):
    """A copy of the benchmark gains a configuration, a mix, a metric and
    a cell by new files and entries alone, and a CPU run of that cell
    prints the result line's keys in order, traced and not."""
    shutil.copytree(HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    config, traffic = small("mouse.exact_aa", bench)
    config["name"] = "tiny"
    (tmp_path / "benchmark" / "configs" / "tiny.json").write_text(
        json.dumps(config))
    (tmp_path / "benchmark" / "traffic" / "tiny_exact.json").write_text(
        json.dumps(traffic))
    (tmp_path / "benchmark" / "metrics" / "units_done.py").write_text(
        "def read(ctx):\n    return float(len(ctx.done))\n")
    new = json.loads(json.dumps(bench))
    new["configs"].append({"name": "tiny", "source": "https://example.org",
                           "file": "benchmark/configs/tiny.json",
                           "reduced": [], "why": "a CPU test"})
    new["workloads"].append({"name": "tiny.exact", "config": "tiny",
                             "traffic": "tiny_exact", "chips": 1,
                             "why": "a CPU test"})
    new["per_layer"].append({"name": "units_done", "unit": "traits",
                             "better": "higher", "source": "host_clock",
                             "layer": "harness", "moves": "trait_s",
                             "workloads": ["tiny.exact"]})
    new["end_to_end"][0]["workloads"].append("tiny.exact")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(new))
    code = (
        "import json, sys\n"
        "sys.path.insert(0, '.')\n"
        "from benchmark import harness\n"
        "bench = harness.load_json('BENCHMARK.json')\n"
        "for t in (0, 1):\n"
        "    r, checks = harness.run_cell(bench, 'tiny.exact', 2**33 + 5,\n"
        "                                 1.0, bool(t), device='cpu')\n"
        "    print(json.dumps(list(checks)))\n"
        "    print(json.dumps(r))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT),
               OMP_NUM_THREADS=str(worker_threads()))
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True, env=env,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    names, plain, _, traced = (json.loads(line) for line in
                               out.stdout.strip().splitlines()[-4:])
    assert list(plain) == ["correct", "attempted", "failed", "metrics",
                           "device"]
    assert list(traced) == ["correct", "attempted", "failed", "metrics",
                            "device", "breakdown"]
    assert plain["correct"] and traced["correct"]
    assert set(plain["metrics"]) == {"trait_s", "setup_s"}
    assert "units_done" in traced["metrics"]
    assert set(traced["breakdown"]) == {"device_ops", "idle_gaps"}
    assert names == ["var_gap", "row_gap"]
    assert "check var_gap:" in out.stderr and "check row_gap:" in out.stderr


#: mixes of the other kinds over a configuration with the model [ag, dg]
NEW_KINDS = {
    "AD": {"unit": "part", "family": "exhaustive", "kind": "AD",
           "scan": "remma_epiAD_parallel", "args": {"p_cut": 0.01},
           "parts": 4, "pool": 1,
           "check": {"units": 2, "limits": {"var_gap": 1e-08,
                                            "row_gap": 1e-08}}},
    "DD": {"unit": "trait", "family": "approx", "kind": "DD",
           "scan": "remma_epiDD_approx",
           "args": {"p_cut": 0.001, "num_random_pair": 5000, "seed": 0},
           "pool": 4,
           "check": {"units": 2, "limits": {"var_gap": 1e-08,
                                            "stat_gap": 1e-08,
                                            "screen_gap": 3e-05}}},
}


@pytest.mark.parametrize("kind", sorted(NEW_KINDS))
def test_other_kinds_and_dominance_grms_are_files_alone(tmp_path, bench,
                                                        kind):
    """A cell of another epistasis kind, over a configuration whose model
    has the dominance GRM, is a configuration file, a mix file and
    entries: a CPU run of it is correct, and the control in the
    program's place is not."""
    shutil.copytree(HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    config, _ = small("yeast.approx_aa", bench)
    config.update(name="tiny_dg", n_snp=400,
                  model={"name": "a_d", "grms": ["ag", "dg"]})
    (tmp_path / "benchmark" / "configs" / "tiny_dg.json").write_text(
        json.dumps(config))
    (tmp_path / "benchmark" / "traffic" / "tiny_kind.json").write_text(
        json.dumps(NEW_KINDS[kind]))
    new = json.loads(json.dumps(bench))
    new["configs"].append({"name": "tiny_dg", "source": "https://example.org",
                           "file": "benchmark/configs/tiny_dg.json",
                           "reduced": [], "why": "a CPU test"})
    new["workloads"].append({"name": "tiny_dg.kind", "config": "tiny_dg",
                             "traffic": "tiny_kind", "chips": 1,
                             "why": "a CPU test"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(new))
    code = (
        "import json, sys\n"
        "sys.path.insert(0, '.')\n"
        "from benchmark import harness\n"
        "from benchmark.program import Control, Program\n"
        "bench = harness.load_json('BENCHMARK.json')\n"
        "for cls in (Program, Control):\n"
        "    r, checks = harness.run_cell(bench, 'tiny_dg.kind', 2**33 + 7,\n"
        "                                 1.0, False, device='cpu',\n"
        "                                 program_cls=cls)\n"
        "    print(json.dumps([r['correct'], r['attempted'],\n"
        "                      {k: v['value'] for k, v in checks.items()}]))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT),
               OMP_NUM_THREADS=str(worker_threads()))
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True, env=env,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    (sound, n, checks), (control, _, controls) = (
        json.loads(line) for line in out.stdout.strip().splitlines()[-2:])
    assert sound and n >= 1, checks
    assert not control, controls
    assert set(checks) == set(NEW_KINDS[kind]["check"]["limits"])


def test_cli_without_a_card_exits_nonzero_and_prints_no_result():
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          "mouse.exact_aa", "--seed", str(2**33), "--seconds",
                          "1", "--trace", "0"], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    if out.returncode == 0:
        pytest.skip("this machine has a CUDA device")
    assert out.stdout.strip() == ""


def test_cells_and_metrics_are_found_by_name(bench):
    for w in bench["workloads"]:
        cell, cfg = harness.find(bench, w["name"])
        assert cell is w and cfg["name"] == w["config"]
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(harness.load_reader(m["name"]))
    with pytest.raises(SystemExit):
        harness.find(bench, "no.such.cell")


def test_boundary_traits_sit_where_the_mix_puts_them(bench):
    """`at_boundary` names the traits on which the reference REML runs to
    its iteration limit, and `trait_order` puts them at the mix's
    positions of each block, the warm-up trait interior."""
    import numpy as np
    import torch

    from benchmark import generate
    from benchmark.reference import remma as R

    config, traffic = small("yeast.approx_aa", bench)
    config.update(n_id=600, n_snp=2000)
    traffic["pool"] = 12
    ctx = harness.Context(cell={}, config=config, traffic=traffic,
                          seed=12345, device=torch.device("cpu"),
                          work=ROOT)
    ctx.geno = generate.synthetic_panel(600, 2000, 8, [0.05, 0.95],
                                        ctx.seed, ctx.device)
    ctx.xmat = np.ones((600, 1))
    ctx.traits = generate.phenotypes(ctx.geno, ctx.xmat,
                                     config["phenotype"], ctx.seed, 12)
    flags = generate.at_boundary(ctx.geno, ctx.xmat, ctx.traits,
                                 config["model"]["grms"])
    grm = R.grms(ctx.geno, config["model"]["grms"], torch.float64)
    x = torch.ones((600, 1), dtype=torch.float64)
    for t in range(12):
        _, converged = R.reml(torch.as_tensor(ctx.traits[t]), x, grm)
        assert converged != bool(flags[t]), t
    assert 0 < flags.sum() < 11
    harness.trait_order(ctx)
    spec = traffic["boundary"]
    assert not flags[ctx.warm_trait]
    assert ctx.warm_trait not in ctx.order
    for k, t in enumerate(ctx.order):
        assert bool(flags[t]) == (k % spec["of"] in spec["at"]), k
