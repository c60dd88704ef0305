"""The command line of gmat_tpu_torch (cli.py) and the one-call pipeline
(pipeline/remmax.py): every subcommand with `--device cpu` on the mouse
fixture, its files equal to the port's library calls (as tests/test_cli.py
does for the JAX package), the longwas subcommands on the first 150 ids of
tests/data/mouse_long; `remmax` against the JAX package's (variances at
rtol 1e-6, the approx table as a row set) and resuming from a `.var` that
the JAX package wrote.

The JAX package and the conftest fixtures are reached only inside the
tests that use them, so that the `cuda` case also runs on a machine
without JAX:
    python -m pytest --noconftest -m cuda tests/test_torch_cli.py
"""
import filecmp
import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch

from gmat_tpu_torch.cli import main
from gmat_tpu_torch.pipeline.remmax import grm_products, remmax

ROOT = Path(__file__).resolve().parents[1]
DATA = ROOT / "tests" / "data"
ML = DATA / "mouse_long"
GRM_FLAGS = ["--grm", "ag", "--grm", "ag*ag"]
N_SUB = 150


def cli(*args):
    return main(["--device", "cpu", *map(str, args)])


def same(a, b):
    return filecmp.cmp(str(a), str(b), shallow=False)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread per pytest-xdist worker."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _copy_plink(src, dst):
    for ext in (".bed", ".bim", ".fam"):
        shutil.copy(str(src) + ext, str(dst) + ext)
    return str(dst)


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    """A copy of the mouse fixture, its GRMs and the CLI's REML."""
    tmp = tmp_path_factory.mktemp("tcli")
    prefix = _copy_plink(DATA / "plink", tmp / "plink")
    pheno = str(tmp / "pheno")
    shutil.copy(str(DATA / "pheno"), pheno)
    var_file = tmp / "var.txt"
    assert cli("reml", pheno, prefix, *GRM_FLAGS, "--out", var_file) == 0
    gmat_lst = grm_products(["ag", "ag*ag"], prefix, "cpu")
    return {"tmp": tmp, "prefix": prefix, "pheno": pheno,
            "var_file": var_file, "gmat": gmat_lst,
            "var": np.loadtxt(var_file)}


def test_grm_subcommands_match_library(work):
    from gmat_tpu_torch.grm.grm import agmat, dgmat_as, ginbreedcoef

    tmp, prefix = work["tmp"], work["prefix"]
    lib = _copy_plink(DATA / "plink", tmp / "lib")
    assert cli("agmat", prefix, "--inv", "--out-fmt", "id_id_val") == 0
    assert cli("dgmat", prefix) == 0
    assert cli("inbreed", prefix) == 0
    agmat(lib, inv=True, out_fmt="id_id_val", device="cpu")
    dgmat_as(lib, device="cpu")
    ginbreedcoef(lib, device="cpu")
    for ext in (".agrm2", ".agiv2", ".dgrm_as0", ".ginbreedcoef"):
        assert same(prefix + ext, lib + ext), ext


def test_reml_matches_library(work):
    from gmat_tpu_torch.reml.wemai import wemai_multi_gmat

    out = work["tmp"] / "var_lib.txt"
    wemai_multi_gmat(work["pheno"], work["prefix"], work["gmat"],
                     out_file=str(out), device="cpu")
    assert same(work["var_file"], out)
    with pytest.raises(SystemExit, match="unknown GRM term"):
        cli("reml", work["pheno"], work["prefix"], "--grm", "ag*xg")


@pytest.mark.parametrize("cmd", ["remma-add", "remma-dom"])
def test_single_snp_subcommands_match_library(work, cmd):
    from gmat_tpu_torch.scan import single

    tmp = work["tmp"]
    out, lib = tmp / cmd, tmp / f"{cmd}.lib"
    assert cli(cmd, work["pheno"], work["prefix"], *GRM_FLAGS, "--var",
               work["var_file"], "--out", out) == 0
    getattr(single, cmd.replace("-", "_"))(
        work["pheno"], work["prefix"], work["gmat"], work["var"],
        out_file=str(lib), device="cpu")
    assert same(out, lib)


@pytest.mark.parametrize("kind", ["aa", "ad", "dd"])
def test_exact_subcommands_match_library(work, kind):
    """`epi{aa,ad,dd} --parallel 100 1` (the whole mouse triangle is
    tests/test_torch_exact.py's slow case)."""
    from gmat_tpu_torch.scan import pairs

    tmp = work["tmp"]
    out, lib = tmp / f"epi{kind}", tmp / f"epi{kind}.lib"
    assert cli(f"epi{kind}", work["pheno"], work["prefix"], *GRM_FLAGS,
               "--var", work["var_file"], "--p-cut", "0.05",
               "--parallel", "100", "1", "--out", out) == 0
    getattr(pairs, f"remma_epi{kind.upper()}_parallel")(
        work["pheno"], work["prefix"], work["gmat"], work["var"], [100, 1],
        p_cut=0.05, out_file=str(lib), device="cpu")
    assert same(f"{out}.1", f"{lib}.1")
    assert len(pd.read_csv(f"{out}.1", sep=" ")) > 20


@pytest.mark.parametrize("kind,maf", [("aa", False), ("ad", False),
                                      ("dd", False), ("aa", True)])
def test_approx_subcommands_and_annotate_match_library(work, kind, maf):
    from gmat_tpu_torch.scan import screen
    from gmat_tpu_torch.scan.annotation import annotation_snp_pos

    tmp = work["tmp"]
    name = f"epi{kind}_{'maf_' if maf else ''}approx"
    out, lib = tmp / name, tmp / f"{name}.lib"
    assert cli(f"epi{kind}-approx", work["pheno"], work["prefix"],
               *GRM_FLAGS, "--var", work["var_file"], "--p-cut", "1e-4",
               "--num-random-pair", "5000", *(["--maf"] if maf else []),
               "--out", out) == 0
    getattr(screen, f"remma_epi{kind.upper()}_{'maf_' if maf else ''}approx")(
        work["pheno"], work["prefix"], work["gmat"], work["var"], p_cut=1e-4,
        num_random_pair=5000, out_file=str(lib), device="cpu")
    assert same(out, lib)
    assert len(pd.read_csv(out, sep=" ")) > 0
    if kind == "aa" and not maf:
        assert cli("annotate", out, work["prefix"], "--p-cut", "1e-3",
                   "--dis", "1000") == 0
        annotation_snp_pos(str(lib), work["prefix"], p_cut=1e-3, dis=1000)
        assert same(f"{out}.anno", f"{lib}.anno")


@pytest.fixture(scope="module")
def long_subset(tmp_path_factory):
    """The first 150 ids of mouse_long: both phenotype files and the
    port's kinship (id_id_val) and its inverse over those ids."""
    from gmat_tpu_torch.grm.grm import agmat

    tmp = tmp_path_factory.mktemp("tcli_long")
    prefix = _copy_plink(ML / "plink", tmp / "plink")
    agmat(prefix, inv=True, out_fmt="id_id_val", device="cpu")
    fam = pd.read_csv(ML / "plink.fam", sep=r"\s+", header=None, dtype=str)
    sub_ids = set(fam[1][:N_SUB])
    for src, dst in ((prefix + ".agrm2", tmp / "kin.sub"),
                     (prefix + ".agiv2", tmp / "kininv.sub")):
        with open(src) as fin, open(dst, "w") as fout:
            for line in fin:
                a = line.split()
                if a[0] in sub_ids and a[1] in sub_ids:
                    fout.write(line)
    for name in ("phe.balance.txt", "phe.unbalance.txt"):
        df = pd.read_csv(ML / name, sep=r"\s+", header=0, dtype={"ID": str})
        df[df["ID"].isin(sub_ids)].to_csv(tmp / name, sep=" ", index=False)
    return tmp


def test_longwas_balance_varcom_matches_library(long_subset):
    from gmat_tpu_torch.longwas.balance import balance_varcom

    tmp = long_subset
    tp = ",".join(str(float(v)) for v in range(1, 17))
    traits = ",".join(str(v) for v in range(2, 18))
    assert cli("longwas-balance-varcom", tmp / "phe.balance.txt", "--id",
               "ID", "--tpoints", tp, "--traits", traits, "--kin-file",
               tmp / "kin.sub", "--maxiter", "3", "--out", tmp / "b_cli") == 0
    balance_varcom(str(tmp / "phe.balance.txt"), "ID",
                   np.arange(1, 17, dtype=float), list(range(2, 18)),
                   str(tmp / "kin.sub"), maxiter=3,
                   prefix_outfile=str(tmp / "b_lib"), device="cpu")
    assert same(tmp / "b_cli.var", tmp / "b_lib.var")


def test_longwas_unbalance_varcom_matches_library(long_subset):
    from gmat_tpu_torch.longwas.unbalance import unbalance_varcom

    tmp = long_subset
    assert cli("longwas-unbalance-varcom", tmp / "phe.unbalance.txt",
               "--id", "ID", "--tpoint", "weak", "--trait", "trait",
               "--kin-inv-file", tmp / "kininv.sub", "--maxiter", "3",
               "--out", tmp / "u_cli") == 0
    unbalance_varcom(str(tmp / "phe.unbalance.txt"), "ID", "weak", "trait",
                     str(tmp / "kininv.sub"), maxiter=3,
                     prefix_outfile=str(tmp / "u_lib"), device="cpu")
    assert same(tmp / "u_cli.var", tmp / "u_lib.var")


# remmax ---------------------------------------------------------------------------

RX = {"p_cut": 1e-4, "num_random_pair": 5000, "maxiter": 50}


@pytest.fixture(scope="module")
def jax_remmax(work):
    from gmat_tpu.pipeline.remmax import remmax as j_remmax

    out = str(work["tmp"] / "rx_jax")
    return j_remmax(work["pheno"], work["prefix"], out_prefix=out, **RX)


def test_remmax_subcommand_matches_library(work):
    tmp = work["tmp"]
    out, lib = tmp / "rx_cli", tmp / "rx_lib"
    assert cli("remmax", work["pheno"], work["prefix"], "--out", out,
               "--p-cut", "1e-4", "--num-random-pair", "5000",
               "--no-resume") == 0
    res = remmax(work["pheno"], work["prefix"], out_prefix=str(lib),
                 p_cut=1e-4, num_random_pair=5000, device="cpu")
    for ext in (".var", ".scan", ".scan.anno"):
        assert same(f"{out}{ext}", f"{lib}{ext}"), ext
    with open(f"{out}.timings.json") as f:
        assert set(json.load(f)) == {"grm", "reml", "scan", "annotate"}
    assert set(res.timings) == {"grm", "reml", "scan", "annotate"}
    assert res.scan_file == f"{lib}.scan"
    assert res.anno_file == f"{lib}.scan.anno"


def test_remmax_matches_jax(work, jax_remmax):
    """The same pipeline in both packages: the variances at rtol 1e-6, the
    approx table's pairs equal, its exact columns at rtol 1e-6 and p_app at
    rtol 1e-3 (the float32 screen's eff printed with `%g`)."""
    out = str(work["tmp"] / "rx_port")
    res = remmax(work["pheno"], work["prefix"], out_prefix=out,
                 device="cpu", **RX)
    np.testing.assert_allclose(res.var_com, jax_remmax.var_com, rtol=1e-6)
    np.testing.assert_allclose(
        res.var_com, [0.06289206, 0.07641075, 0.08121168], rtol=1e-4)
    got = pd.read_csv(res.scan_file, sep=" ")
    want = pd.read_csv(jax_remmax.scan_file, sep=" ")
    assert list(got.columns) == list(want.columns)
    assert len(got) > 0
    got, want = (t.sort_values(["snp_0", "snp_1"]).reset_index(drop=True)
                 for t in (got, want))
    pd.testing.assert_frame_equal(got[["snp_0", "snp_1"]],
                                  want[["snp_0", "snp_1"]])
    np.testing.assert_allclose(got[["eff", "var", "chi", "p"]],
                               want[["eff", "var", "chi", "p"]], rtol=1e-6)
    np.testing.assert_allclose(got["p_app"], want["p_app"], rtol=1e-3)
    assert len(open(res.anno_file).readlines()) == \
        len(open(jax_remmax.anno_file).readlines())


def test_remmax_resumes_from_jax_var(work, jax_remmax):
    """The port's remmax reuses the `.var` the JAX package wrote."""
    from gmat_tpu_torch.scan.single import remma_add

    out = str(work["tmp"] / "rx_resume")
    shutil.copy(jax_remmax.out_prefix + ".var", out + ".var")
    res = remmax(work["pheno"], work["prefix"], out_prefix=out, scan="add",
                 device="cpu", **RX)
    assert res.timings["reml"] == 0.0
    np.testing.assert_array_equal(res.var_com,
                                  np.loadtxt(jax_remmax.out_prefix + ".var"))
    lib = str(work["tmp"] / "rx_resume.lib")
    remma_add(work["pheno"], work["prefix"], work["gmat"], res.var_com,
              out_file=lib, device="cpu")
    assert same(res.scan_file, lib)


def test_cli_rejects_mesh_and_bench(work):
    """`--devices N` exits as a usage error when fewer than N CUDA devices
    are visible, and `bench` takes no argument of its own (bench.py's
    `--warm` is `python -m gmat_tpu_torch.bench --warm`)."""
    too_many = str(torch.cuda.device_count() + 1)
    for argv in (["--devices", too_many, "agmat", work["prefix"]],
                 ["bench", "--warm"]):
        with pytest.raises(SystemExit) as err:
            main(argv)
        assert err.value.code == 2


def test_cli_bench_runs_bench_main(monkeypatch):
    """`bench` calls gmat_tpu_torch.bench.main with the global --device,
    and with --devices (checked, then ignored: the bench takes no mesh)."""
    from gmat_tpu_torch import bench

    calls = []
    monkeypatch.setattr(bench, "main", lambda **kw: calls.append(kw))
    assert main(["--device", "cpu", "bench"]) == 0
    assert main(["--device", "cpu", "--devices", "2", "bench"]) == 0
    assert calls == [{"device": "cpu"}, {"device": "cpu"}]


def test_cli_and_array_api_import_no_jax():
    code = ("import sys, gmat_tpu_torch.cli, gmat_tpu_torch.scan.array_api, "
            "gmat_tpu_torch.pipeline.remmax, gmat_tpu_torch.bench; "
            "bad = [m for m in sys.modules if m in ('jax', 'bench') or "
            "m.startswith(('jax.', 'gmat_tpu.')) or m == 'gmat_tpu']; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=120)


# the card ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_remmax_subcommand_on_the_card(cuda, tmp_path):
    """`gmat-tpu-torch --device cuda remmax` launches the screen kernels
    and agrees with the CPU run: variances at rtol 1e-9, the same pairs."""
    from gmat_tpu_torch.scan import kernels as K

    prefix = _copy_plink(DATA / "plink", tmp_path / "plink")
    pheno = str(DATA / "pheno")
    runs = {}
    for dev in ("cpu", "cuda"):
        out = str(tmp_path / f"rx_{dev}")
        before = dict(K.LAUNCHES)
        assert main(["--device", dev, "remmax", pheno, prefix, "--out", out,
                     "--p-cut", "1e-4", "--num-random-pair", "5000"]) == 0
        runs[dev] = ({k: K.LAUNCHES[k] - before[k] for k in before},
                     np.loadtxt(out + ".var"),
                     pd.read_csv(out + ".scan", sep=" "))
    (launched, var, tab), (plain, var_cpu, tab_cpu) = runs["cuda"], runs["cpu"]
    assert launched["screen_count"] > 0 and launched["screen_extract"] > 0
    assert not any(plain.values())
    np.testing.assert_allclose(var, var_cpu, rtol=1e-9)
    assert len(tab) > 0
    assert set(zip(tab.snp_0, tab.snp_1)) == set(zip(tab_cpu.snp_0,
                                                     tab_cpu.snp_1))
