"""One run of one cell: set-up, the measured window, the trace, the metrics
and the check of what the window produced.

Everything is found by name from `BENCHMARK.json`: the cell's
configuration file, its traffic mix `traffic/<mix>.json`, the mix's scan
family `families/<family>.py` (`"family"`) and a reader
`metrics/<metric>.py` for each metric.  The harness holds the panel, the
closed loop, the window, the trace, the metrics and the result line; the
family holds everything of its scans: the traits, each unit's input
files, the set-up product, the calls of both sides (`program.py`), the
tables read back, the pairs a unit counts and the numbers of the check.
A mix names the unit of work:

- `"unit": "trait"`: one trait after another in a closed loop, each
  written to input files of its own name, then its variance components
  (REML) and the mix's scan on it.  A mix with
  `"boundary": {"of": b, "at": [..]}` fixes which of each block of b
  traits are traits that the family flags (`boundary(ctx)`: for REMMA,
  those whose REML maximum of the last variance lies at its boundary 0,
  where REML runs to its iteration limit): those at the positions `at`,
  the others not, so that every seed sends the same share of both in the
  same order;
- `"unit": "part"`: one trait whose REML is set-up, then one part after
  another of the mix's split scan (`"parts"`), from a part drawn from the
  seed.

The window runs units until `seconds` have passed and finishes the unit
in flight.  Set-up builds the inputs, the set-up product and one unit of
the same work, so that nothing is built or compiled in the window.
"""
from __future__ import annotations

import importlib.util
import itertools
import json
import sys
import tempfile
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from benchmark import check, generate, trace
from benchmark.program import Program

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "gmat_tpu")


@dataclass
class Unit:
    index: int
    trait: int
    part: int | None
    start: float
    end: float = 0.0
    spans: dict = field(default_factory=dict)  # label -> (start, end)
    stages: dict = field(default_factory=dict)
    pairs: int = 0
    var: np.ndarray | None = None
    out: object = None
    error: str | None = None

    def seconds(self, label):
        start, end = self.spans[label]
        return end - start


@dataclass
class Context:
    """What one run has: its cell, the panel, the traits, the set-up
    product and the units.  A family keeps what else its units need as
    attributes of its own (the REMMA families: `xmat`, `heads`)."""

    cell: dict
    config: dict
    traffic: dict
    seed: int
    device: torch.device
    work: Path
    prefix: str = ""
    geno: torch.Tensor | None = None
    fam_ids: list = field(default_factory=list)
    traits: object = None  # the pool, one entry a trait
    product: object = None  # the side's set-up product (REMMA: the GRMs)
    part_inputs: object = None  # a `part` mix's trait's input files
    units: list = field(default_factory=list)
    setup: dict = field(default_factory=dict)
    setup_s: float = 0.0
    window: tuple = (0.0, 0.0)
    clock: tuple = (0.0, 0)  # (perf_counter, time_ns) at one instant
    trace: object = None
    part0: int = 0  # the first part of a `part` mix's window
    warm_trait: int = 0  # the trait of a `trait` mix's warm-up unit
    order: list = field(default_factory=list)  # the window's traits

    @property
    def n_id(self):
        return self.geno.shape[0]

    @property
    def n_snp(self):
        return self.geno.shape[1]

    @property
    def kind(self):
        """The mix's epistasis kind (`reference.remma.KINDS`), AA unless
        it names one."""
        return self.traffic.get("kind", "AA")

    @property
    def family(self):
        """The mix's scan family, the module `families/<family>.py`."""
        return load_family(self.traffic["family"])

    @property
    def done(self):
        return [u for u in self.units if u.error is None]

    def ns(self, t):
        """A perf_counter reading on the profiler's clock (epoch ns)."""
        return self.clock[1] + int((t - self.clock[0]) * 1e9)


def load_json(path):
    with open(path) as f:
        return json.load(f)


def find(bench, cell_name):
    """(cell, configuration entry) of `cell_name` in BENCHMARK.json."""
    cells = {c["name"]: c for c in bench["workloads"]}
    if cell_name not in cells:
        raise SystemExit(f"no workload {cell_name!r} in BENCHMARK.json")
    cell = cells[cell_name]
    configs = {c["name"]: c for c in bench["configs"]}
    return cell, configs[cell["config"]]


def load_family(name):
    """The module `families/<name>.py`."""
    return importlib.import_module(f"benchmark.families.{name}")


def load_reader(name):
    """The `read(ctx)` function of `metrics/<name>.py`."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark.metrics.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _timed(split, key, fn, device):
    t0 = time.perf_counter()
    out = fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    split[key] = time.perf_counter() - t0
    return out


def make_inputs(ctx):
    """The panel and its PLINK files, then the family's traits
    (`inputs(ctx)`), from the seed."""
    cfg, dev = ctx.config, ctx.device
    panel = cfg["panel"]
    ctx.prefix = str(ctx.work / "panel")
    if "synthetic" in panel:
        syn = panel["synthetic"]
        n, m = cfg["n_id"], cfg["n_snp"]
        ctx.geno = generate.synthetic_panel(n, m, syn["family"],
                                            syn["freq_range"], ctx.seed, dev)
        ctx.fam_ids = [(f"f{k // syn['family']}", f"i{k}") for k in range(n)]
        generate.write_plink(ctx.prefix, ctx.geno, ctx.fam_ids)
    else:
        geno, ctx.fam_ids = generate.read_plink(str(HERE / panel["plink"]))
        ctx.geno = torch.as_tensor(geno, device=dev)
        generate.write_plink(ctx.prefix, ctx.geno, ctx.fam_ids)
    if (ctx.n_id, ctx.n_snp) != (cfg["n_id"], cfg["n_snp"]):
        raise ValueError("the panel's shape is not the configuration's")
    ctx.family.inputs(ctx)


def trait_order(ctx, log=sys.stderr):
    """The warm-up trait and the window's traits of a `trait` mix: the
    pool's last trait, then the others in turn; under `"boundary"` a trait
    that the family does not flag, then per block of `of` traits one of
    the pool's flagged traits at each position in `at` and one of the
    others at the rest, each kind in pool order and cycled."""
    pool = ctx.traffic["pool"]
    ctx.warm_trait, ctx.order = pool - 1, list(range(pool - 1))
    spec = ctx.traffic.get("boundary")
    if spec is None:
        return
    flags = ctx.family.boundary(ctx)
    inner = [t for t in range(pool) if not flags[t]]
    outer = [t for t in range(pool) if flags[t]]
    print(f"traits at the boundary: {len(outer)} of {pool}", file=log)
    if len(inner) < 2 or not outer:
        print("too few of one kind: the window takes the pool in turn",
              file=log)
        return
    ctx.warm_trait = inner.pop()
    kinds = {True: itertools.cycle(outer), False: itertools.cycle(inner)}
    ctx.order = [next(kinds[k % spec["of"] in spec["at"]])
                 for k in range(pool - 1)]


def run_unit(ctx, program, index, trait, part, var=None):
    """One unit of the mix: (the trait's input files and REML, or the
    set-up's variances) and the scan, timed by spans ("pheno", "reml" and
    the family's name)."""
    unit = Unit(index=index, trait=trait, part=part,
                start=time.perf_counter())
    tag = f"u{index}" if index >= 0 else "warm"
    family = ctx.family
    try:
        if part is None:
            t0 = time.perf_counter()
            inputs = family.write_inputs(ctx, trait, str(ctx.work / tag))
            t1 = time.perf_counter()
            var = program.reml(ctx, trait, inputs,
                               str(ctx.work / f"{tag}.var"))
            t2 = time.perf_counter()
            unit.spans["pheno"] = (t0, t1)
            unit.spans["reml"] = (t1, t2)
        else:
            inputs = ctx.part_inputs
        t0 = time.perf_counter()
        unit.out, unit.stages = program.scan(ctx, trait, inputs, var,
                                             str(ctx.work / f"{tag}.scan"),
                                             part)
        unit.spans[ctx.traffic["family"]] = (t0, time.perf_counter())
        unit.var = np.asarray(var)
    except Exception as exc:  # a unit that fails is counted, not fatal
        unit.error = f"{type(exc).__name__}: {exc}"
        print(f"unit {index} failed: {unit.error}", file=sys.stderr)
    unit.end = time.perf_counter()
    unit.pairs = family.pairs(ctx, part)
    return unit


def setup(ctx, program, t_process):
    """Everything before the window; returns the set-up variances of a
    `part` mix (None otherwise)."""
    split, dev = ctx.setup, ctx.device
    split["import"] = time.perf_counter() - t_process
    _timed(split, "library", program.build, dev)
    _timed(split, "inputs", lambda: make_inputs(ctx), dev)
    ctx.product = _timed(split, "product", lambda: program.setup(ctx), dev)
    if ctx.traffic["unit"] == "trait":
        _timed(split, "order", lambda: trait_order(ctx), dev)
    var = None
    if ctx.traffic["unit"] == "part":
        ctx.part_inputs = ctx.family.write_inputs(ctx, 0,
                                                  str(ctx.work / "trait"))
        var = _timed(split, "reml", lambda: program.reml(
            ctx, 0, ctx.part_inputs, str(ctx.work / "trait.var")), dev)
        rng = np.random.default_rng([ctx.seed, 2])
        ctx.part0 = int(rng.integers(0, ctx.traffic["parts"]))
        warm = (ctx.part0 - 1) % ctx.traffic["parts"] + 1  # the part before
        unit = _timed(split, "warm", lambda: run_unit(
            ctx, program, -1, 0, warm, var), dev)
    else:
        unit = _timed(split, "warm", lambda: run_unit(
            ctx, program, -1, ctx.warm_trait, None), dev)
    if unit.error is not None:
        raise RuntimeError(f"the warm-up unit failed: {unit.error}")
    ctx.geno = ctx.geno.cpu()  # the reference's copy; off the card
    ctx.setup_s = time.perf_counter() - t_process
    return var


def window(ctx, program, seconds, var):
    """Units in a closed loop until `seconds` have passed; the unit in
    flight then finishes.  The window ends at the end of the last unit."""
    dev = ctx.device
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    ctx.clock = (t0, time.time_ns())
    k = 0
    while time.perf_counter() - t0 < seconds:
        if ctx.traffic["unit"] == "part":
            part = (ctx.part0 + k) % ctx.traffic["parts"] + 1
            unit = run_unit(ctx, program, k, 0, part, var)
        else:
            unit = run_unit(ctx, program, k, ctx.order[k % len(ctx.order)],
                            None)
        ctx.units.append(unit)
        k += 1
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    ctx.window = (t0, time.perf_counter())


def mean(values):
    """The mean of `values`, None when there are none."""
    values = list(values)
    return float(np.mean(values)) if values else None


def forbidden_modules():
    """Top-level names of loaded modules that the port must not load."""
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def device_info(ctx, bench_cell):
    dev = ctx.device
    if dev.type != "cuda":
        return {"platform": dev.type, "kind": dev.type, "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
            "count": int(bench_cell.get("chips", 1)),
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(dev)),
            "power_limit": trace.power_limit()}


def metric_entries(bench, cell_name, trace_on):
    """The metrics of `BENCHMARK.json` that this cell reports in this kind
    of run, in file order."""
    group = bench["per_layer"] if trace_on else bench["end_to_end"]
    return [m for m in group
            if "workloads" not in m or cell_name in m["workloads"]]


def run_cell(bench, cell_name, seed, seconds, trace_on, device="cuda",
             program_cls=Program, t_process=None, log=sys.stderr,
             config=None, traffic=None):
    """One run; returns (the result line's object, the checks: each
    compared number with its limit).  `config` and `traffic` replace the
    cell's files (the tests run small ones on the CPU)."""
    t_process = time.perf_counter() if t_process is None else t_process
    cell, cfg_entry = find(bench, cell_name)
    config = config or load_json(ROOT / cfg_entry["file"])
    traffic = traffic or load_json(HERE / "traffic" / f"{cell['traffic']}.json")
    dev = torch.device(device)
    with tempfile.TemporaryDirectory(prefix="gmat_bench_") as work:
        ctx = Context(cell=cell, config=config, traffic=traffic, seed=seed,
                      device=dev, work=Path(work))
        program = program_cls.make(ctx.family, dev)
        var = setup(ctx, program, t_process)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        prof = trace.start(dev) if trace_on else None
        window(ctx, program, seconds, var)
        if prof is not None:
            ctx.trace = trace.collect(prof, ctx)
        info = device_info(ctx, cell)
        work_bytes = sum(f.stat().st_size for f in ctx.work.iterdir())
        for unit in ctx.done:
            if isinstance(unit.out, str):
                unit.out = ctx.family.read(unit.out)
    found = forbidden_modules()
    if found:
        raise SystemExit("modules loaded that the port must not load: "
                         + ", ".join(found))
    metrics = {}
    for entry in metric_entries(bench, cell_name, trace_on):
        value = load_reader(entry["name"])(ctx)
        if value is not None:
            metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}
    checks = check.run(ctx, log)
    failed = sum(u.error is not None for u in ctx.units)
    result = {"correct": bool(ctx.units) and not failed
              and check.passed(checks),
              "attempted": len(ctx.units), "failed": failed,
              "metrics": metrics, "device": info}
    if trace_on and ctx.trace is not None:
        info["busy_s"] = ctx.trace.busy_s
        info["window_s"] = ctx.trace.window_s
        result["breakdown"] = ctx.trace.breakdown(ctx)
    print(f"setup split (s): {json.dumps(ctx.setup)}", file=log)
    print(f"work dir bytes at the window's end: {work_bytes}", file=log)
    print("unit seconds: " + " ".join(f"{u.end - u.start:.3f}"
                                      for u in ctx.units), file=log)
    spans = {}
    for u in ctx.done:
        for label in u.spans:
            spans[label] = spans.get(label, 0.0) + u.seconds(label)
        for label, sec in u.stages.items():
            spans[f"stage.{label}"] = spans.get(f"stage.{label}", 0.0) + sec
    print(f"span sums (s): {json.dumps(spans)}", file=log)
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=log)
    return result, checks
