"""Scan families as files: the REMMA families read as the harness read
them before it found them by name, and a family of another shape (a
balanced longitudinal GWAS) is added to a copy of the benchmark as new
files alone."""
import filecmp
import hashlib
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark import check, generate, harness
from benchmark.tests.conftest import HERE, ROOT, small, worker_threads

#: One-unit runs (a window of 1 ms holds exactly one unit) of the small
#: cells at seed 2**33 + 11 and 4 threads, as the harness read them before
#: the families moved to `families/`: the unit, its variances, its rows
#: (count, a digest of the (i, j) pairs, sums of eff and chi) and the check
#: numbers.  The harness after the move read the same bits on the machine
#: that recorded them; the floats are held to BLAS rounding here, so that
#: another CPU's BLAS does not fail the test.
PARENT = {
    "yeast.approx_aa": {
        "trait": 0, "part": None, "n_rows": 113,
        "pairs_sha": "98f97fd68ff09fef",
        "eff_sum": 5984.833185312312, "chi_sum": 1485.069487127594,
        "var": [0.5753396413993357, 0.2035427699825717, 0.26966694818008613],
        "checks": {"var_gap": 1.0292538927348752e-14,
                   "stat_gap": 2.6467911670351353e-15,
                   "screen_gap": 0.0}},
    "yeast.exact_aa_parts": {
        "trait": 0, "part": 1, "n_rows": 114,
        "pairs_sha": "620cb2d05db97109",
        "eff_sum": 4309.523396828135, "chi_sum": 1500.7571779091056,
        "var": [0.6464522889829877, 0.010752014286923748, 0.43201514403601904],
        "checks": {"var_gap": 5.15222721094444e-16,
                   "row_gap": 4.457066416593136e-15}},
    "mouse.exact_aa": {
        "trait": 0, "part": None, "n_rows": 493,
        "pairs_sha": "37835a6bc57bd986",
        "eff_sum": 19354.921589722588, "chi_sum": 6291.230310306622,
        "var": [0.5753396413993357, 0.2035427699825717, 0.26966694818008613],
        "checks": {"var_gap": 1.0292538927348752e-14,
                   "row_gap": 5.435178660265102e-15}},
    "yeast.approx_ad": {
        "trait": 0, "part": None, "n_rows": 91,
        "pairs_sha": "bee33f2c69b77f3d",
        "eff_sum": 3936.4507116737045, "chi_sum": 1380.809709269635,
        "var": [0.5753396413993357, 0.2035427699825717, 0.26966694818008613],
        "checks": {"var_gap": 1.0292538927348752e-14,
                   "stat_gap": 2.883792432025209e-15,
                   "screen_gap": 0.0}},
}


def one_unit(bench, cell, monkeypatch):
    """(the run's context, its check numbers) of a one-unit run of the
    small cell on 4 threads."""
    config, traffic = small(cell, bench)
    seen = {}
    real = check.run

    def spy(ctx, log):
        seen["ctx"] = ctx
        return real(ctx, log)

    monkeypatch.setattr(check, "run", spy)
    threads = torch.get_num_threads()
    torch.set_num_threads(4)
    try:
        _, checks = harness.run_cell(bench, cell, 2**33 + 11, 1e-3, False,
                                     device="cpu", config=config,
                                     traffic=traffic)
    finally:
        torch.set_num_threads(threads)
    return seen["ctx"], {k: v["value"] for k, v in checks.items()}


def reading(ctx, checks):
    (unit,) = ctx.units
    rows = unit.out
    pairs = np.stack([rows["i"], rows["j"]]).astype(np.int64)
    return {"trait": unit.trait, "part": unit.part,
            "n_rows": int(len(rows["i"])),
            "pairs_sha": hashlib.sha256(pairs.tobytes()).hexdigest()[:16],
            "eff_sum": float(np.sum(np.abs(rows["eff"]))),
            "chi_sum": float(np.sum(rows["chi"])),
            "var": [float(v) for v in unit.var], "checks": checks}


@pytest.mark.parametrize("cell", sorted(PARENT))
def test_moved_families_keep_the_parents_readings(bench, monkeypatch, cell):
    got = reading(*one_unit(bench, cell, monkeypatch))
    want = PARENT[cell]
    for key in ("trait", "part", "n_rows", "pairs_sha"):
        assert got[key] == want[key], key
    for key in ("eff_sum", "chi_sum"):
        assert got[key] == pytest.approx(want[key], rel=1e-12), key
    assert got["var"] == pytest.approx(want["var"], rel=1e-12)
    assert list(got["checks"]) == list(want["checks"])
    for key, value in want["checks"].items():
        assert got["checks"][key] == pytest.approx(value, rel=0.5,
                                                   abs=1e-14), key


def test_the_harness_names_no_family_and_no_entry_point():
    """harness.py, program.py and check.py find the family by the mix's
    name and call nothing of the port by name."""
    names = {"approx", "exhaustive", "longwas", "wemai_multi_gmat",
             "grm_products", "build_library", "remma_epi", "balance_"}
    for name in ("harness.py", "program.py", "check.py"):
        text = (HERE / name).read_text()
        code = "\n".join(line for line in text.splitlines()
                         if not line.lstrip().startswith("#"))
        body = code.split('"""', 2)[-1]  # past the module's docstring
        for word in names:
            assert f'"{word}"' not in body and f"'{word}'" not in body, \
                (name, word)
        assert "gmat_tpu_torch" not in body.replace(
            "gmat_tpu_torch.core", ""), name


LONGWAS_FAMILY = '''"""A balanced longitudinal GWAS family: per trait the
random-regression REML `balance_varcom` on a kinship file made in set-up,
then the retransformation test `balance_longwas_trans`; its table's
`eff0..eff3 chi_val p_val p_min p_accum` are checked against a plain
float64 retransformation at the program's variances (`trans_gap`)."""
from pathlib import Path

import numpy as np
import pandas as pd
import torch

from benchmark import check, generate
from benchmark.reference import remma as R

HERE = Path(__file__).resolve().parents[1]
COLS = ("eff0", "eff1", "eff2", "eff3", "chi_val", "p_val", "p_min",
        "p_accum")


def tpoint(ctx):
    return np.arange(1.0, ctx.config["model"]["tpoints"] + 1.0)


def trait_cols(ctx):
    return list(range(2, 2 + ctx.config["model"]["tpoints"]))


def inputs(ctx):
    """The pool: the real records of the panel's ids, each trait with
    noise from the seed (the phenotype's `noise` times each time point's
    sd)."""
    spec = ctx.config["phenotype"]
    df = pd.read_csv(HERE / spec["records"], sep=r"\\s+", dtype={"ID": str})
    df = df.set_index("ID").loc[[iid for _, iid in ctx.fam_ids]]
    ctx.sex = df["Sex"].to_numpy()
    y = df.iloc[:, 1:].to_numpy(dtype=float)
    gen = generate.generator(ctx.seed, 1, ctx.device)
    noise = torch.randn((ctx.traffic["pool"],) + y.shape, generator=gen,
                        device=ctx.device, dtype=torch.float64)
    ctx.traits = y[None] + spec["noise"] * y.std(axis=0) * noise.cpu().numpy()


def write_inputs(ctx, trait, stem):
    path = f"{stem}.data"
    y = ctx.traits[trait]
    head = "ID Sex " + " ".join(f"trait{t + 1}" for t in range(y.shape[1]))
    with open(path, "w") as f:
        f.write(head + "\\n" + "".join(
            f"{iid} {sex} " + " ".join(f"{v:.17g}" for v in row) + "\\n"
            for (_, iid), sex, row in zip(ctx.fam_ids, ctx.sex, y)))
    return path


def read(path):
    df = pd.read_csv(path, sep=" ")
    return {k: df[k].to_numpy() for k in ("order",) + COLS}


def pairs(ctx, part):
    return 0


class Program:
    def __init__(self, device):
        self.device = device

    def build(self):
        pass

    def setup(self, ctx):
        from gmat_tpu_torch.grm.grm import agmat

        agmat(ctx.prefix, inv=False, out_fmt="id_id_val", device=self.device)
        return ctx.prefix + ".agrm2"

    def reml(self, ctx, trait, data, out):
        from gmat_tpu_torch.longwas.balance import balance_varcom

        return balance_varcom(data, "ID", tpoint(ctx), trait_cols(ctx),
                              ctx.product, prefix_outfile=out,
                              device=self.device)

    def scan(self, ctx, trait, data, var, out, part=None):
        from gmat_tpu_torch.longwas.balance_gwas import balance_longwas_trans

        balance_longwas_trans(data, "ID", tpoint(ctx), trait_cols(ctx),
                              ctx.product, ctx.prefix, var,
                              prefix_outfile=out, device=self.device)
        return out + ".res", {}


def legendre(t, order):
    """Normalised Legendre polynomials on t rescaled to [-1, 1]."""
    x = 2.0 * (t - t.min()) / (t.max() - t.min()) - 1.0
    norm = np.sqrt((2.0 * np.arange(order + 1) + 1.0) / 2.0)
    return np.polynomial.legendre.legvander(x, order) * norm


def covariance(frame, block):
    sub = frame[frame[:, 0] == block]
    dim = int(sub[:, 1].max())
    mat = np.zeros((dim, dim))
    mat[sub[:, 1].astype(int) - 1, sub[:, 2].astype(int) - 1] = sub[:, 3]
    return mat + np.tril(mat, -1).T


def plain_trans(ctx, trait, frame):
    """(eff (m, 4), chi (m,)) of every SNP in the original basis:
    V = K x Phi Ca Phi' + I x (Phi Cp Phi' + e I), P y, and per SNP s
    with S = s x I: eff = Ca Phi' S'Py, cov = Ca Phi' S'PS Phi Ca."""
    geno = ctx.geno.to(torch.float64)
    kin = R.grms(geno, ["ag"], torch.float64)[0].numpy()
    mat = R.centered(geno, torch.float64)[0].numpy()
    n, t = kin.shape[0], ctx.config["model"]["tpoints"]
    phi = legendre(tpoint(ctx), 3)
    cov_a, cov_p = covariance(frame, 1), covariance(frame, 2)
    vmat = (np.kron(kin, phi @ cov_a @ phi.T)
            + np.kron(np.eye(n), phi @ cov_p @ phi.T)
            + frame[-1, 3] * np.eye(n * t))
    xmat = np.kron(np.ones((n, 1)), phi)
    vinv = np.linalg.inv(vmat)
    vx = vinv @ xmat
    pmat = vinv - vx @ np.linalg.solve(xmat.T @ vx, vx.T)
    py = (pmat @ ctx.traits[trait].reshape(-1)).reshape(n, t)
    gt = cov_a @ phi.T
    eff = (gt @ (py.T @ mat)).T
    p4 = pmat.reshape(n, t, n, t)
    cov = np.einsum("ct,stu,du->scd", gt,
                    np.einsum("is,itku,ks->stu", mat, p4, mat), gt)
    chi = np.einsum("sc,scd,sd->s", eff, np.linalg.inv(cov), eff)
    return eff, chi


def check_numbers(ctx, units, log):
    gap = 0.0
    for unit in units:
        eff, chi = plain_trans(ctx, unit.trait, unit.var)
        rows = unit.out
        got = np.stack([rows[f"eff{k}"] for k in range(4)], axis=1)
        gap = check.worst(gap, check.var_gap(got.ravel(), eff.ravel()))
        gap = check.worst(gap, check.rel_gap(rows["chi_val"], chi))
    return {"trans_gap": gap}
'''


def write_long_subset(dest, n_id=150, n_snp=300):
    """The first `n_id` ids and `n_snp` SNPs of the upstream mouse_long
    panel, and the balanced records of those ids, under `dest`."""
    src = ROOT / "tests" / "data" / "mouse_long"
    geno, fam = generate.read_plink(str(src / "plink"))
    dest.mkdir(parents=True)
    generate.write_plink(str(dest / "plink"),
                         torch.as_tensor(geno[:n_id, :n_snp]), fam[:n_id])
    ids = {iid for _, iid in fam[:n_id]}
    lines = (src / "phe.balance.txt").read_text().splitlines()
    (dest / "phe.balance.txt").write_text("\n".join(
        [lines[0]] + [ln for ln in lines[1:] if ln.split()[0] in ids]) + "\n")


def test_a_longwas_family_is_files_alone(tmp_path, bench):
    """A copy of the benchmark gains a longitudinal GWAS cell by new files
    (a family, a configuration over a subset of the mouse_long data, a
    mix, a metric) and entries alone: a CPU run of it prints a result
    line, correct, with the family's own check number, and no file of the
    copy's harness changes."""
    copy = tmp_path / "benchmark"
    shutil.copytree(HERE, copy, ignore=shutil.ignore_patterns("__pycache__"))
    write_long_subset(copy / "data" / "tiny_long")
    (copy / "families" / "longwas.py").write_text(LONGWAS_FAMILY)
    config = {"name": "tiny_long", "n_id": 150, "n_snp": 300,
              "panel": {"plink": "data/tiny_long/plink"},
              "model": {"name": "balance_trans", "tpoints": 16},
              "phenotype": {"records": "data/tiny_long/phe.balance.txt",
                            "noise": 0.1},
              "reduced": ["n_id", "n_snp"]}
    (copy / "configs" / "tiny_long.json").write_text(json.dumps(config))
    mix = {"unit": "trait", "family": "longwas", "pool": 4,
           "check": {"units": 2, "limits": {"trans_gap": 1e-6}}}
    (copy / "traffic" / "balance_trans.json").write_text(json.dumps(mix))
    (copy / "metrics" / "longwas_s.py").write_text(
        "from benchmark.harness import mean\n\n\n"
        "def read(ctx):\n"
        "    return mean(u.seconds('longwas') for u in ctx.done)\n")
    new = json.loads(json.dumps(bench))
    new["configs"].append({"name": "tiny_long",
                           "source": "https://example.org",
                           "file": "benchmark/configs/tiny_long.json",
                           "reduced": ["n_id", "n_snp"], "why": "a CPU test"})
    new["workloads"].append({"name": "tiny_long.trans", "config": "tiny_long",
                             "traffic": "balance_trans", "chips": 1,
                             "why": "a CPU test"})
    new["end_to_end"][0]["workloads"].append("tiny_long.trans")
    new["per_layer"].append({"name": "longwas_s", "unit": "s",
                             "better": "lower", "source": "host_clock",
                             "layer": "longwas", "moves": "trait_s",
                             "workloads": ["tiny_long.trans"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(new))
    code = (
        "import json, sys\n"
        "sys.path.insert(0, '.')\n"
        "from benchmark import harness\n"
        "bench = harness.load_json('BENCHMARK.json')\n"
        "for t in (0, 1):\n"
        "    r, checks = harness.run_cell(bench, 'tiny_long.trans',\n"
        "                                 2**33 + 9, 1.0, bool(t),\n"
        "                                 device='cpu')\n"
        "    print(json.dumps({k: v['value'] for k, v in checks.items()}))\n"
        "    print(json.dumps(r))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT),
               OMP_NUM_THREADS=str(worker_threads()))
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True, env=env,
                         timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    checks, plain, _, traced = (json.loads(line) for line in
                                out.stdout.strip().splitlines()[-4:])
    assert list(plain) == ["correct", "attempted", "failed", "metrics",
                           "device"]
    assert plain["correct"] and traced["correct"], (checks, out.stderr[-2000:])
    assert set(checks) == {"trans_gap"} and checks["trans_gap"] < 1e-6
    assert set(plain["metrics"]) == {"trait_s", "setup_s"}
    assert traced["metrics"]["longwas_s"]["value"] > 0
    assert "check trans_gap:" in out.stderr
    cmp = filecmp.dircmp(HERE, copy, ignore=["__pycache__"])

    def changed(d):
        return d.diff_files + d.left_only + [
            f for sub in d.subdirs.values() for f in changed(sub)]

    assert changed(cmp) == []
