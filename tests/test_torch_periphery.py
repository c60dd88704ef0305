"""The host-side periphery of gmat_tpu_torch against the JAX package: the
pedigree tools (byte-equal files), the phenotype simulators (the same
effect files and seed: `.norm`, `.res`, `.pheno` at rtol 1e-10), the
low-depth simulator (equal arrays) and `common`'s helpers on numpy and
torch inputs (rtol 1e-12).

The JAX package and the conftest fixtures are reached only inside the
tests that use them, so that the `cuda` case also runs on a machine
without JAX:
    python -m pytest --noconftest -m cuda tests/test_torch_periphery.py
"""
import filecmp
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch

from gmat_tpu_torch import common as TC
from gmat_tpu_torch.pedigree import pedigree as TP

ROOT = Path(__file__).resolve().parents[1]
DATA = ROOT / "tests" / "data"
PED_FUNCS = ["ped_trace", "ped_correct", "ped_sort", "ped_recode",
             "ped_completeness"]


# pedigree -----------------------------------------------------------------------

def _seeded_pedigree(path, n, seed, cycles=False):
    """Founders, then animals whose parents are earlier animals (or "0"),
    with a few ids in both parent roles and, with `cycles`, loops."""
    rng = np.random.default_rng(seed)
    ids = [f"id{k}" for k in range(n)]
    rows = []
    for k, i in enumerate(ids):
        if k < n // 10:
            rows.append((i, "0", "0"))
            continue
        s = ids[rng.integers(0, k)] if rng.random() < 0.9 else "0"
        d = ids[rng.integers(0, k)] if rng.random() < 0.8 else "0"
        rows.append((i, s, d))
    if cycles:
        rows[3] = (rows[3][0], ids[n - 1], rows[3][2])
        rows[5] = (rows[5][0], rows[5][1], ids[n - 2])
    order = rng.permutation(n)
    path.write_text("".join("\t".join(rows[k]) + "\n" for k in order))
    return ids


PEDIGREES = {
    # tests/test_periphery.py's fixtures
    "small": "a\t0\t0\nb\t0\t0\nc\ta\tb\nd\ta\t0\ne\tc\td\n",
    "conflict": "k\tx\t0\nl\tx\t0\nm\t0\tx\nu\tw\t0\nw\tu\t0\n",
}


@pytest.mark.parametrize("case", ["small", "conflict", "seeded",
                                  "seeded_cycles"])
def test_pedigree_files_equal_jax(tmp_path, case):
    import gmat_tpu.pedigree.pedigree as JP

    outputs = {}
    for pkg, mod in (("j", JP), ("t", TP)):
        d = tmp_path / pkg
        d.mkdir()
        ped = d / "ped"
        if case.startswith("seeded"):
            ids = _seeded_pedigree(ped, 400, 7, cycles=case.endswith("cycles"))
            (d / "ids").write_text("".join(f"{i}\n" for i in ids[-20:]))
        else:
            ped.write_text(PEDIGREES[case])
            (d / "ids").write_text("e\n" if case == "small" else "m\n")
        res = [mod.ped_trace(str(d / "ids"), str(ped), gen=3),
               mod.ped_correct(str(ped)),
               mod.ped_recode(str(ped)),
               mod.ped_completeness(str(ped), gen=3, cut=0.1)]
        try:
            res.append(mod.ped_sort(str(ped)))
        except ValueError as err:  # a cycle
            res.append(str(err))
        outputs[pkg] = res
    assert outputs["t"] == outputs["j"]
    names = sorted(p.name for p in (tmp_path / "j").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "t").iterdir())
    assert {"ids.trace", "ped.correct", "ped.recode", "ped.dct", "ped.pec",
            "ped.prune"} <= set(names)
    for name in names:
        assert filecmp.cmp(tmp_path / "j" / name, tmp_path / "t" / name,
                           shallow=False), name


# simulators ---------------------------------------------------------------------

def _effect_files(d, m, seed):
    rng = np.random.default_rng(seed)
    paths = []
    for name, n_col in (("add", 2), ("dom", 2), ("aa", 3), ("ad", 3),
                        ("dd", 3)):
        k = 10
        idx = rng.choice(m, size=(k, n_col - 1), replace=False)
        eff = rng.standard_normal(k)
        np.savetxt(str(d / name), np.column_stack([idx, eff]),
                   fmt=["%d"] * (n_col - 1) + ["%.6f"])
        paths.append(str(d / name))
    return paths


def _simulate_both(tmp_path, name, mouse_prefix, **kw):
    import gmat_tpu.pipeline.simulate as JS
    from gmat_tpu_torch.pipeline import simulate as TS

    out = {}
    for pkg, fn in (("j", getattr(JS, name)),
                    ("t", getattr(TS, name))):
        d = tmp_path / pkg
        d.mkdir()
        effs = _effect_files(d, 1407, seed=11)
        extra = {"device": "cpu"} if pkg == "t" else {}
        fn(mouse_prefix, *effs, out_file=str(d / "sim"), seed=3, **kw,
           **extra)
        out[pkg] = d
    return out["t"], out["j"]


@pytest.mark.parametrize("name", ["simu_epistasis", "simu_epistasis_freq"])
def test_simulators_match_jax(tmp_path, mouse_prefix, name):
    kw = {"ratio": [1.0, 0.5, 0.3, 0.2, 0.4, 1.0], "mean": 2.0,
          "res_var": 1.5} if name.endswith("freq") else {}
    t, j = _simulate_both(tmp_path, name, mouse_prefix, **kw)
    assert (t / "sim.res").read_bytes() == (j / "sim.res").read_bytes()
    for eff in ("add", "dom", "aa", "ad", "dd"):
        got = np.loadtxt(t / f"{eff}.norm")
        want = np.loadtxt(j / f"{eff}.norm")
        np.testing.assert_array_equal(got[:, :-1], want[:, :-1])
        np.testing.assert_allclose(got[:, -1], want[:, -1], rtol=1e-10)
    got = pd.read_csv(t / "sim.pheno", sep=" ", header=None)
    want = pd.read_csv(j / "sim.pheno", sep=" ", header=None)
    assert got.shape == want.shape == (1304, 4)
    pd.testing.assert_frame_equal(got.iloc[:, :3], want.iloc[:, :3])
    np.testing.assert_allclose(got[3], want[3], rtol=1e-10)


# low-depth simulator and common ---------------------------------------------

def test_simu_lds_equal_jax():
    from gmat_tpu.omics import simu_lds as J

    from gmat_tpu_torch.omics import simu_lds as T

    np.testing.assert_array_equal(T.simu(500, 2.0, 4), J.simu(500, 2.0, 4))
    np.testing.assert_array_equal(T.simu_lds(300, 1.5, 3),
                                  J.simu_lds(300, 1.5, 3))
    np.testing.assert_array_equal(T.simu_LDS(100, 1.5, 3),
                                  J.simu_LDS(100, 1.5, 3))
    assert T.simu_LDS is T.simu_lds


def test_common_helpers_match_jax():
    import gmat_tpu.common as J

    for v in ("3", "3.5", "x", None, 4, "1e3"):
        assert TC.is_int(v) == J.is_int(v)
        assert TC.is_float(v) == J.is_float(v)
    d3 = TC.dct_3D()
    d3["a"]["b"]["c"] = 1
    d2 = TC.dct_2D()
    d2["a"]["b"] = 2
    d1 = TC.dct_1D()
    d1["a"] = 3
    assert (d3["a"]["b"]["c"], d2["a"]["b"], d1["a"]) == (1, 2, 3)
    assert TC.get_logger("x").name == J.get_logger("x").name == "x"
    rng = np.random.default_rng(5)
    a, b, c = (rng.standard_normal((6, 6)) for _ in range(3))
    row = rng.standard_normal(6)
    cases = (("tri_matT", (a, b)), ("tri_mat", (a, b, c)),
             ("Dtri_matT", (a, row)), ("Dtri_mat", (a, row, c)))
    for name, args in cases:
        want = np.asarray(getattr(J, name)(*args))
        got_np = getattr(TC, name)(*args)
        got_t = getattr(TC, name)(*(torch.as_tensor(x) for x in args))
        assert isinstance(got_np, np.ndarray)
        assert isinstance(got_t, torch.Tensor)
        np.testing.assert_allclose(got_np, want, rtol=1e-12)
        np.testing.assert_allclose(got_t.numpy(), want, rtol=1e-12)


def test_new_modules_import_no_jax():
    code = ("import sys, gmat_tpu_torch.common, "
            "gmat_tpu_torch.pedigree.pedigree, "
            "gmat_tpu_torch.pipeline.simulate, "
            "gmat_tpu_torch.omics.simu_lds; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'gmat_tpu.')) or m == 'gmat_tpu']; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=120)


# the card -----------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_simulator_on_the_card(cuda, tmp_path):
    """`simu_epistasis` on the card writes the CPU run's files."""
    from gmat_tpu_torch import simu_epistasis

    prefix = str(tmp_path / "plink")
    for ext in (".bed", ".bim", ".fam"):
        shutil.copy(str(DATA / ("plink" + ext)), prefix + ext)
    out = {}
    for dev in ("cpu", cuda):
        d = tmp_path / str(dev)
        d.mkdir()
        effs = _effect_files(d, 1407, seed=11)
        simu_epistasis(prefix, *effs, out_file=str(d / "sim"), seed=3,
                       device=dev)
        out[str(dev)] = d
    t, c = out[str(cuda)], out["cpu"]
    assert (t / "sim.res").read_bytes() == (c / "sim.res").read_bytes()
    for name in ("add.norm", "dd.norm", "sim.pheno"):
        got = pd.read_csv(t / name, sep=" ", header=None)
        want = pd.read_csv(c / name, sep=" ", header=None)
        np.testing.assert_allclose(got.iloc[:, -1], want.iloc[:, -1],
                                   rtol=1e-10)
