"""The device mesh of gmat_tpu_torch (dist/, the `mesh=` arguments, the
command line's `--devices`) and core/roofline.py.

On the CPU the mesh is `make_mesh(devices=["cpu"] * 8)`, eight virtual
shards, against the JAX package's virtual 8-device mesh (tests/conftest.py
sets it):
- the sharded GRMs at rtol 1e-10, atol 1e-12 (the partial sums change
  the summation order);
- the screen's hit counts equal where no |S| lies within 1e-4·cut, its
  hits the same pairs with eff at rtol 1e-4; the exact-scan tile at rtol
  1e-8;
- the exhaustive scans and the pair tests with a mesh against the port
  without one: the same rows, values at rtol 1e-12 (the same runs and
  chunks, computed in the same shapes); the screens within the float64
  band of tests/test_torch_screen.py (a shard's plain float32 product
  rounds by its shape; on the card K1 computes each pair alone and the
  bytes are equal, which chip_smoke.py checks);
- against the JAX package with its mesh at the tolerances of
  tests/test_torch_exact.py and tests/test_torch_screen.py.

A 2-process gloo world (this file run as a script: the worker, which
imports nothing of JAX) holds the sharded GRM and `remma_epiAA_eff(mesh=)`
against single-process runs.  The JAX package and the conftest fixtures
are reached only inside the tests that use them, so that the `cuda` case
runs on a machine without JAX:
    python -m pytest --noconftest -m cuda tests/test_torch_dist.py
"""
import filecmp
import inspect
import json
import os
import shutil
import socket
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
DATA = ROOT / "tests" / "data"
GOLDEN = ROOT / "tests" / "golden"
BAND = 1e-4


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread per pytest-xdist worker."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def mesh():
    from gmat_tpu_torch.dist import make_mesh

    return make_mesh(devices=["cpu"] * 8)


@pytest.fixture(scope="module")
def jmesh():
    import jax

    from gmat_tpu.dist import make_mesh

    assert jax.device_count() >= 8, "conftest should expose 8 CPU devices"
    return make_mesh(8)


@pytest.fixture(scope="module")
def mouse(mouse_geno, mouse_pheno, mouse_prefix):
    """GRMs and variances of the mouse fixture, the codings and pymat."""
    import jax.numpy as jnp

    from gmat_tpu.core.coding import additive_code, dominance_code
    from gmat_tpu.grm.grm import additive_grm
    from gmat_tpu.io.pheno import design_matrix
    from gmat_tpu.scan.common import score_pieces

    ag = np.asarray(additive_grm(jnp.asarray(mouse_geno)))
    var_com = np.load(GOLDEN / "epi_scans.npz")["var_com"]
    pieces = score_pieces(design_matrix(mouse_pheno, mouse_prefix),
                          [ag, ag * ag], var_com)
    codes = {"A": np.asarray(additive_code(jnp.asarray(mouse_geno))[0]),
             "D": np.asarray(dominance_code(jnp.asarray(mouse_geno))[0])}
    return {"args": (mouse_pheno, mouse_prefix, [ag, ag * ag], var_com),
            "py": np.asarray(pieces.pymat), "codes": codes,
            "geno": mouse_geno}


@pytest.fixture(scope="module")
def small(tmp_path_factory, mouse):
    """The first 200 SNPs of the mouse panel as a PLINK set, with the
    fixture's phenotype, GRMs and variances."""
    from gmat_tpu_torch.io.bed import write_bed

    prefix = str(tmp_path_factory.mktemp("small") / "small")
    fam = pd.read_csv(DATA / "plink.fam", sep=r"\s+", header=None, dtype=str)
    write_bed(prefix, np.nan_to_num(mouse["geno"][:, :200], nan=1.0),
              fam=fam)
    pheno, _, gmat_lst, var_com = mouse["args"]
    return prefix, (pheno, prefix, gmat_lst, var_com)


def _rows(path):
    return np.loadtxt(path, skiprows=1, ndmin=2)


def _panel(n, m, seed):
    """A centred seeded panel, py, and a cut halfway across the widest gap
    between neighbouring |S| near the 0.98 quantile, so that no |S| lies
    within 1e-4 of it."""
    rng = np.random.default_rng(seed)
    geno = rng.choice([0.0, 1.0, 2.0], size=(n, m))
    mat = geno - geno.mean(axis=0)
    py = rng.standard_normal(n) * 0.1
    s = (mat * py[:, None]).T @ mat
    vals = np.sort(np.abs(s[np.triu_indices(m, 1)]))
    k0 = int(0.97 * len(vals))
    k = k0 + int(np.argmax(np.diff(vals[k0:int(0.99 * len(vals))])))
    cut = float((vals[k] + vals[k + 1]) / 2)
    assert np.min(np.abs(vals - cut)) > 1e-4 * cut
    return mat, py, s, cut, rng


# the primitives of dist/mesh.py ----------------------------------------------

@pytest.mark.parametrize("kind", ["add", "dom"])
@pytest.mark.parametrize("m", [37, 64], ids=["uneven", "even"])
def test_sharded_grm_matches_jax_and_port(mesh, jmesh, kind, m):
    import jax.numpy as jnp

    import gmat_tpu.dist.mesh as JM
    import gmat_tpu.grm.grm as JG
    from gmat_tpu_torch.dist import mesh as TM
    from gmat_tpu_torch.grm import grm as TG

    geno = np.random.default_rng(m).choice([0.0, 1.0, 2.0], size=(40, m))
    got = getattr(TM, f"sharded_{'additive' if kind == 'add' else 'dominance'}"
                      "_grm")(geno, mesh).numpy()
    name = "additive" if kind == "add" else "dominance"
    want_j = np.asarray(getattr(JM, f"sharded_{name}_grm")(geno, jmesh))
    want_t = getattr(TG, f"{name}_grm")(torch.as_tensor(geno)).numpy()
    want_p = np.asarray(getattr(JG, f"{name}_grm")(jnp.asarray(geno)))
    for want in (want_j, want_t, want_p):
        np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("num_snp,ndev", [(1407, 8), (10, 3), (97, 4),
                                          (5, 8)])
def test_interleaved_split_equals_jax(num_snp, ndev):
    from gmat_tpu.dist.mesh import interleaved_anchor_split as j_split
    from gmat_tpu_torch.dist import interleaved_anchor_split

    got = interleaved_anchor_split(num_snp, ndev)
    want = j_split(num_snp, ndev)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_sharded_screen_counts_equal_jax(mesh, jmesh):
    from gmat_tpu.dist.mesh import sharded_screen_counts as j_counts
    from gmat_tpu_torch.dist import sharded_screen_counts

    mat, py, s, cut, _ = _panel(64, 97, 5)
    got = sharded_screen_counts(mat, py, cut, mesh)
    want = np.array([np.sum(np.abs(s[i, i + 1:]) > cut) for i in range(96)])
    assert want.sum() > 50
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, j_counts(mat, py, cut, jmesh, tile=8))


def test_sharded_screen_hits_match_jax(mesh, jmesh):
    from gmat_tpu.dist.mesh import sharded_screen_hits as j_hits
    from gmat_tpu_torch.dist import sharded_screen_hits

    mat, py, s, cut, _ = _panel(64, 97, 6)
    i, j, eff = sharded_screen_hits(mat, py, cut, mesh)
    ji, jj, je = j_hits(mat, py, cut, jmesh, tile=8)
    assert len(i) > 50 and eff.dtype == np.float32
    np.testing.assert_array_equal(i, ji)
    np.testing.assert_array_equal(j, jj)
    np.testing.assert_allclose(eff, je, rtol=1e-4)
    np.testing.assert_allclose(eff, s[i, j], rtol=1e-4)


def test_sharded_exact_scan_tile_matches_jax(mesh, jmesh):
    from gmat_tpu.dist.mesh import sharded_exact_scan_tile as j_tile
    from gmat_tpu_torch.dist import sharded_exact_scan_tile

    n, m = 48, 64
    mat, py, _, _, rng = _panel(n, m, 7)
    mat[:, 9] = 0.0  # a monomorphic SNP: var 0, chi NaN on its row
    a = rng.standard_normal((n, n))
    pvp = a @ a.T / n
    anchors = np.array([3, 0, 9, 63, 17, 3, 40, 41, 12, 5, 60, 1, 2, 30, 31,
                        32], dtype=np.int32)  # 2 per device, 3 repeated
    got = sharded_exact_scan_tile(anchors, mat, py, pvp, mesh)
    want = np.asarray(j_tile(anchors, mat, py, pvp, jmesh))
    assert got.shape == want.shape == (16, m)
    assert np.isnan(got[2]).all() and np.isnan(got[:, 9]).all()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=1e-8, atol=1e-300)
    np.testing.assert_array_equal(got[0], got[5])


def test_map_shards_raises_the_first_error_after_every_shard(mesh):
    from gmat_tpu_torch.dist.mesh import _map_shards

    ran = []
    lock = threading.Lock()

    def fn(dev, k):
        with lock:
            ran.append(k)
        if k in (5, 2):
            raise ValueError(f"shard {k}")
        return k * k

    assert _map_shards(mesh, lambda d, k: k * k, list(range(8))) == \
        [k * k for k in range(8)]
    with pytest.raises(ValueError, match="shard 2"):
        _map_shards(mesh, fn, list(range(8)))
    assert sorted(ran) == list(range(8))


def test_launch_counter_is_exact_under_threads():
    """More threads than cores bump one counter, the interpreter switching
    threads every microsecond: no increment is lost."""
    from gmat_tpu_torch.scan import kernels as K

    before = K.LAUNCHES["exact_scan"]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [
            K._count_launch("exact_scan") for _ in range(2000)])
            for _ in range(4 * (os.cpu_count() or 1))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert K.LAUNCHES["exact_scan"] - before == 2000 * len(threads)
    K.LAUNCHES["exact_scan"] = before


def test_make_mesh_takes_no_missing_device():
    from gmat_tpu_torch.dist import make_mesh

    count = torch.cuda.device_count()
    if count >= 2:
        assert len(make_mesh(2).devices) == 2
    else:
        with pytest.raises(RuntimeError, match="CUDA devices"):
            make_mesh(2)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh(devices=[f"cuda:{count}"])
    shards = make_mesh(devices=["cpu", "cpu", "cpu"])
    assert shards.size == 3 and shards.distinct_devices == (
        torch.device("cpu"),)
    assert list(shards.shard_ids) == [0, 1, 2]


def test_mesh_signature_parity():
    """Every function of the JAX package that takes `mesh` has a twin in
    the port that takes it, and the dist packages export the same names."""
    import gmat_tpu.dist
    import gmat_tpu_torch.dist

    assert sorted(gmat_tpu.dist.__all__) == sorted(gmat_tpu_torch.dist.__all__)
    names = []
    for mod in ("grm.grm", "scan.pairs", "scan.screen", "dist.mesh",
                "dist.init"):
        jmod = __import__(f"gmat_tpu.{mod}", fromlist=["_"])
        tmod = __import__(f"gmat_tpu_torch.{mod}", fromlist=["_"])
        for name, fn in vars(jmod).items():
            if (inspect.isfunction(fn) and fn.__module__ == jmod.__name__
                    and not name.startswith("_")
                    and "mesh" in inspect.signature(fn).parameters):
                names.append(name)
                assert "mesh" in inspect.signature(
                    getattr(tmod, name)).parameters, f"{mod}.{name}"
    # agmat, dgmat_as, 3 scans, 3 pair tests, 12 screens, 5 sharded_*
    assert len(names) == 25


# the file-level entry points -------------------------------------------------

def test_agmat_mesh(tmp_path, mesh, jmesh, mouse_prefix):
    from gmat_tpu.grm.grm import agmat as j_agmat
    from gmat_tpu_torch.grm.grm import agmat

    for ext in ("bed", "bim", "fam"):
        shutil.copy(f"{mouse_prefix}.{ext}", tmp_path / f"plink.{ext}")
    prefix = str(tmp_path / "plink")
    single, _ = agmat(prefix, device="cpu")
    meshed, _ = agmat(prefix, device="cpu", mesh=mesh)
    np.testing.assert_allclose(meshed, single, rtol=1e-10, atol=1e-12)
    jmeshed, _ = j_agmat(prefix, mesh=jmesh)
    np.testing.assert_allclose(meshed, jmeshed, rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("kind", ["AA", "AD", "DD"])
def test_exact_scans_mesh(tmp_path, monkeypatch, mesh, jmesh, small, kind):
    """remma_epi{AA,AD,DD} on the 200-SNP set: a budget of 200 pairs per
    anchor run gives at least 9 runs, two rounds of the 8 shards.  Against
    the port without a mesh: the same rows, values at rtol 1e-12; against
    the JAX package with its mesh at tests/test_torch_exact.py's
    tolerances."""
    import gmat_tpu.scan.pairs as J
    from gmat_tpu_torch.scan import pairs as P

    monkeypatch.setattr(P, "_SCAN_PAIR_BUDGET", 200)
    anchors = [150, 39, 0, 17, 110, 64, 5, 130, 90, 20, 198, 7, 180, 101,
               160, 120]
    if kind == "AD":
        anchors = anchors[:9]
    tri = kind != "AD"
    per = np.array([199 - a if tri else 200 for a in anchors])
    assert len(list(P._anchor_runs(np.array(anchors), per, 200))) >= 9
    name = f"remma_epi{kind}"
    kw = {"snp_lst_0": anchors, "p_cut": 0.2}
    out = {k: str(tmp_path / k) for k in ("single", "meshed", "jax")}
    getattr(P, name)(*small[1], out_file=out["single"], device="cpu", **kw)
    getattr(P, name)(*small[1], out_file=out["meshed"], device="cpu",
                     mesh=mesh, **kw)
    getattr(J, name)(*small[1], out_file=out["jax"], mesh=jmesh, **kw)
    single, meshed, want = (_rows(out[k]) for k in ("single", "meshed",
                                                    "jax"))
    assert len(single) > 100
    np.testing.assert_array_equal(meshed[:, :2], single[:, :2])
    np.testing.assert_allclose(meshed[:, 2:], single[:, 2:], rtol=1e-12,
                               atol=1e-300)
    # the JAX package's mesh writes an unsorted anchor list's rows in
    # (i, j) order, the port in the list's order (the reference's)
    meshed = meshed[np.lexsort((meshed[:, 1], meshed[:, 0]))]
    want = want[np.lexsort((want[:, 1], want[:, 0]))]
    np.testing.assert_array_equal(meshed[:, :2], want[:, :2])
    np.testing.assert_allclose(meshed[:, 2], want[:, 2], rtol=1e-7,
                               atol=1e-12)
    np.testing.assert_allclose(meshed[:, 3], want[:, 3], rtol=1e-6,
                               atol=1e-10)
    np.testing.assert_allclose(meshed[:, 4], want[:, 4], rtol=1e-5,
                               atol=1e-12)


@pytest.mark.parametrize("kind", ["AA", "AD", "DD"])
def test_pair_tests_mesh(tmp_path, mesh, jmesh, mouse, kind):
    """998 pairs at max_test_pair=64: 16 chunks of 64, two steps of the 8
    shards.  Against the port without a mesh at rtol 1e-12, against the
    JAX package's mesh at tests/test_torch_exact.py's rtol 1e-6."""
    import gmat_tpu.scan.pairs as J
    from gmat_tpu_torch.scan import pairs as P

    gold = np.load(GOLDEN / "epiAA_pairs.npz")
    pair_file = str(tmp_path / "pairs")
    np.savetxt(pair_file, gold["pairs"], fmt="%d", header="snp_0 snp_1",
               comments="")
    name = f"remma_epi{kind}_pair"
    kw = {"max_test_pair": 64, "p_cut": 0.5}
    out = {k: str(tmp_path / k) for k in ("single", "meshed", "jax")}
    getattr(P, name)(*mouse["args"], pair_file, out_file=out["single"],
                     device="cpu", **kw)
    getattr(P, name)(*mouse["args"], pair_file, out_file=out["meshed"],
                     device="cpu", mesh=mesh, **kw)
    getattr(J, name)(*mouse["args"], pair_file, out_file=out["jax"],
                     mesh=jmesh, **kw)
    single, meshed, jax_rows = (_rows(out[k]) for k in
                                ("single", "meshed", "jax"))
    assert len(single) > 300
    np.testing.assert_array_equal(meshed[:, :2], single[:, :2])
    np.testing.assert_allclose(meshed[:, 2:], single[:, 2:], rtol=1e-12,
                               atol=1e-300)
    np.testing.assert_array_equal(meshed[:, :2], jax_rows[:, :2])
    np.testing.assert_allclose(meshed[:, 2:], jax_rows[:, 2:], rtol=1e-6,
                               atol=1e-12)


def _eff_oracle(kind, codes, py):
    a = codes["D" if kind == "DD" else "A"].astype(np.float64)
    b = codes["A" if kind == "AA" else "D"].astype(np.float64)
    return (a * py[:, None]).T @ b


def _assert_in_band(got, want, eff64, cut):
    """The two tables' pairs lie above cut·(1 - band) and differ only
    within the band; eff, chi_app at rtol 1e-4 (printed with %g) and
    p_app at 1e-3 on the common pairs.  Returns the common pairs."""
    gk = [(int(a), int(b)) for a, b in got[:, :2]]
    wk = [(int(a), int(b)) for a, b in want[:, :2]]
    assert len(set(gk)) == len(gk)
    for k in gk + wk:
        assert abs(eff64(k)) > cut(k) * (1 - BAND), k
    for k in set(gk) ^ set(wk):
        assert abs(abs(eff64(k)) - cut(k)) <= BAND * cut(k), k
    common = sorted(set(gk) & set(wk))
    gi, wi = dict(zip(gk, got)), dict(zip(wk, want))
    a = np.array([gi[k] for k in common])
    b = np.array([wi[k] for k in common])
    np.testing.assert_allclose(a[:, 2:4], b[:, 2:4], rtol=1e-4)
    np.testing.assert_allclose(a[:, 4], b[:, 4], rtol=1e-3, atol=1e-300)
    shared = set(common)
    assert [k for k in gk if k in shared] == [k for k in wk if k in shared]
    return common


@pytest.mark.parametrize("name", ["remma_epiAA_eff", "remma_epiAD_maf_eff"])
def test_eff_screens_mesh(tmp_path, mesh, jmesh, mouse, name):
    """With the mesh against the port without it and against the JAX
    package with its mesh: the same rows within the float64 band."""
    from scipy.stats import chi2

    import gmat_tpu
    import gmat_tpu_torch
    from gmat_tpu_torch.scan.screen import _het_bins, _maf_bins

    kind = name[9:11]
    s64 = _eff_oracle(kind, mouse["codes"], mouse["py"])
    m = s64.shape[0]
    off = ~np.eye(m, dtype=bool) if kind == "AD" else np.triu(
        np.ones((m, m), dtype=bool), 1)
    cut = float(np.quantile(np.abs(s64[off]), 1 - 3e-4))
    chi_cut = chi2.isf(1e-5, 1)
    if kind == "AD":
        bins_a = _maf_bins(mouse["geno"])[1]
        bins_b = _het_bins(mouse["geno"])[1]
        deno = cut * cut / chi_cut * (0.8 + 0.1 * (np.arange(111) % 5))
        kw = {"freqA": bins_a, "freqD": bins_b, "freq_deno": deno}
        table = np.sqrt(chi_cut * deno).astype(np.float32)

        def pair_cut(k):
            r0, r1 = (k[1], k[0]) if k[0] > k[1] else k
            return float(table[bins_a[r0] * 10 + bins_b[r1]])
    else:
        kw = {"var_app": cut * cut / chi_cut}
        flat = float(np.float32(np.sqrt(chi_cut * kw["var_app"])))

        def pair_cut(k):
            return flat
    kw["p_cut"] = 1e-5
    out = {k: str(tmp_path / k) for k in ("single", "meshed", "jax")}
    getattr(gmat_tpu_torch, name)(*mouse["args"], out_file=out["single"],
                                  device="cpu", **kw)
    getattr(gmat_tpu_torch, name)(*mouse["args"], out_file=out["meshed"],
                                  device="cpu", mesh=mesh, **kw)
    getattr(gmat_tpu, name)(*mouse["args"], out_file=out["jax"], mesh=jmesh,
                            **kw)
    eff64 = (lambda k: s64[k]) if kind == "AD" else (
        lambda k: s64[min(k), max(k)])
    meshed = _rows(out["meshed"])
    for other in ("single", "jax"):
        assert len(_assert_in_band(meshed, _rows(out[other]), eff64,
                                   pair_cut)) > 100


def test_approx_pipeline_mesh(tmp_path, monkeypatch, mesh, jmesh, mouse):
    """remma_epiAA_approx with the mesh: each device stage (calibration,
    screen, re-test) runs over the 8 shards, and the table equals the
    port's without a mesh (pairs within the band, the exact columns at
    rtol 1e-12) and the JAX package's with its mesh (rtol 1e-8)."""
    from scipy.stats import chi2

    import gmat_tpu
    import gmat_tpu_torch
    from gmat_tpu_torch.scan import pairs as P
    from gmat_tpu_torch.scan import screen as S

    calls = []
    for mod, stage in ((P, "pairs"), (S, "screen")):
        real = mod._map_shards

        def counting(mesh_, fn, shares, real=real, stage=stage):
            calls.append((stage, len(shares)))
            return real(mesh_, fn, shares)

        monkeypatch.setattr(mod, "_map_shards", counting)
    kw = {"p_cut": 1e-4, "num_random_pair": 5000, "seed": 3}
    out = {k: str(tmp_path / k) for k in ("single", "meshed", "jax")}
    gmat_tpu_torch.remma_epiAA_approx(*mouse["args"], out_file=out["single"],
                                      device="cpu", **kw)
    assert calls == []
    gmat_tpu_torch.remma_epiAA_approx(*mouse["args"], out_file=out["meshed"],
                                      device="cpu", mesh=mesh, **kw)
    # calibration (5,000 pairs: one step) and re-test on the pair test's
    # shards, the screen's sweep on its own
    assert calls.count(("pairs", 8)) >= 2 and ("screen", 8) in calls
    assert {c[1] for c in calls} == {8}
    gmat_tpu.remma_epiAA_approx(*mouse["args"], out_file=out["jax"],
                                mesh=jmesh, **kw)
    meshed = _rows(out["meshed"])
    s64 = _eff_oracle("AA", mouse["codes"], mouse["py"])
    var_app = np.median(meshed[:, 2] ** 2 / chi2.isf(meshed[:, 5], 1))
    flat = float(np.sqrt(chi2.isf(1e-4, 1) * var_app))
    for other, rtol in (("single", 1e-12), ("jax", 1e-8)):
        want = _rows(out[other])
        gk = [(int(a), int(b)) for a, b in meshed[:, :2]]
        wk = [(int(a), int(b)) for a, b in want[:, :2]]
        for k in set(gk) ^ set(wk):
            assert abs(abs(s64[k]) - flat) <= BAND * flat, k
        common = set(gk) & set(wk)
        assert len(common) > 20
        gi, wi = dict(zip(gk, meshed)), dict(zip(wk, want))
        a = np.array([gi[k] for k in sorted(common)])
        b = np.array([wi[k] for k in sorted(common)])
        cols = [2, 3, 4, 6]  # eff var chi p
        np.testing.assert_allclose(a[:, cols], b[:, cols], rtol=rtol,
                                   atol=1e-300)
        np.testing.assert_allclose(a[:, 5], b[:, 5], rtol=1e-3)


def test_cli_devices(tmp_path, monkeypatch, small):
    """`--device cpu --devices 4` writes the files of the same command
    without `--devices`: agmat at rtol 1e-10, the exhaustive epiaa scan of
    the 200-SNP set in runs of at most 2,000 pairs (11 runs, three rounds
    of the 4 shards) byte for byte."""
    from gmat_tpu_torch.cli import main
    from gmat_tpu_torch.scan import pairs as P

    monkeypatch.setattr(P, "_SCAN_PAIR_BUDGET", 2000)
    prefix = small[0]
    var = str(tmp_path / "var.txt")
    np.savetxt(var, small[1][3])
    for extra, tag in (([], "one"), (["--devices", "4"], "four")):
        assert main(["--device", "cpu", *extra, "agmat", prefix]) == 0
        shutil.move(prefix + ".agrm0", str(tmp_path / f"{tag}.agrm0"))
        assert main(["--device", "cpu", *extra, "epiaa", str(DATA / "pheno"),
                     prefix, "--grm", "ag", "--grm", "ag*ag", "--var", var,
                     "--p-cut", "0.01", "--out",
                     str(tmp_path / f"{tag}.epiAA")]) == 0
    np.testing.assert_allclose(np.loadtxt(tmp_path / "four.agrm0"),
                               np.loadtxt(tmp_path / "one.agrm0"),
                               rtol=1e-10, atol=1e-12)
    assert len(_rows(tmp_path / "one.epiAA")) > 100
    assert filecmp.cmp(tmp_path / "one.epiAA", tmp_path / "four.epiAA",
                       shallow=False)


# the 2-process world ---------------------------------------------------------

def _cohort(work, seed=7, n=40, m=96):
    """A seeded PLINK set, phenotype and additive GRM under `work`: the
    same on every process."""
    from gmat_tpu_torch.grm.grm import additive_grm
    from gmat_tpu_torch.io.bed import write_bed

    rng = np.random.default_rng(seed)
    geno = rng.choice([0.0, 1.0, 2.0], size=(n, m))
    prefix = str(work / "plink")
    write_bed(prefix, geno)
    fam = pd.read_csv(prefix + ".fam", sep=r"\s+", header=None, dtype=str)
    with open(work / "pheno", "w") as f:
        for (f0, i0), yv in zip(fam[[0, 1]].to_numpy(),
                                rng.standard_normal(n)):
            f.write(f"{f0} {i0} 1 {yv:.8f}\n")
    ag = additive_grm(torch.as_tensor(geno)).numpy()
    # a var_app whose cut lands near the |eff| 0.9 quantile
    mat = geno - geno.mean(axis=0)
    eff = (mat * 0.01).T @ mat
    cut = float(np.quantile(np.abs(eff[np.triu_indices(m, 1)]), 0.9))
    return geno, prefix, str(work / "pheno"), [ag], [0.5, 0.5], cut * cut / 20


def _worker(rank, world, port, out):
    """One process of the 2-process gloo world, 2 CPU shards each."""
    torch.set_num_threads(1)
    from gmat_tpu_torch.dist import initialize_multihost, sharded_additive_grm
    from gmat_tpu_torch.scan.screen import remma_epiAA_eff

    mesh = initialize_multihost(f"localhost:{port}", world, rank,
                                local_device_ids=["cpu", "cpu"])
    assert (mesh.size, mesh.world, mesh.rank) == (2 * world, world, rank)
    work = Path(out) / f"proc{rank}"
    work.mkdir()
    geno, prefix, pheno, gmat_lst, var_com, var_app = _cohort(work)
    kin = sharded_additive_grm(geno, mesh).numpy()
    remma_epiAA_eff(pheno, prefix, gmat_lst, var_com, var_app=var_app,
                    out_file=str(work / "epiAA_eff"), device="cpu",
                    mesh=mesh)
    np.save(work / "kin.npy", kin)
    import torch.distributed as dist

    dist.destroy_process_group()
    bad = [m for m in sys.modules if m in ("jax", "gmat_tpu")
           or m.startswith(("jax.", "gmat_tpu."))]
    assert not bad, bad


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_process_gloo_world(tmp_path):
    from gmat_tpu_torch.dist import make_mesh
    from gmat_tpu_torch.grm.grm import additive_grm
    from gmat_tpu_torch.scan.screen import remma_epiAA_eff

    port = _free_port()
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    procs = [subprocess.Popen([sys.executable, __file__, str(rank), "2",
                               str(port), str(tmp_path)],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, env=env)
             for rank in range(2)]
    try:
        logs = [p.communicate(timeout=180)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, f"worker failed:\n{log}"
    work = tmp_path / "single"
    work.mkdir()
    geno, prefix, pheno, gmat_lst, var_com, var_app = _cohort(work)
    want = additive_grm(torch.as_tensor(geno)).numpy()
    args = (pheno, prefix, gmat_lst, var_com)
    kw = {"var_app": var_app, "device": "cpu"}
    remma_epiAA_eff(*args, out_file=str(work / "four"),
                    mesh=make_mesh(devices=["cpu"] * 4), **kw)
    remma_epiAA_eff(*args, out_file=str(work / "none"), **kw)
    four = (work / "four").read_bytes()
    assert four.count(b"\n") > 20
    for rank in range(2):
        proc = tmp_path / f"proc{rank}"
        np.testing.assert_allclose(np.load(proc / "kin.npy"), want,
                                   rtol=1e-10, atol=1e-12)
        # the same global shards as one process's 4-shard mesh
        assert (proc / "epiAA_eff").read_bytes() == four
    # and the pairs of one device, within the float64 band
    from scipy.stats import chi2

    from gmat_tpu_torch.io.pheno import design_matrix
    from gmat_tpu_torch.scan.common import score_pieces

    py = score_pieces(design_matrix(pheno, prefix), gmat_lst, var_com,
                      "cpu").pymat.numpy()
    mat = geno - geno.mean(axis=0)
    s64 = (mat * py[:, None]).T @ mat
    cut = float(np.float32(np.sqrt(chi2.isf(1e-5, 1) * var_app)))
    _assert_in_band(_rows(work / "four"), _rows(work / "none"),
                    lambda k: s64[k], lambda k: cut)


# core/roofline.py ------------------------------------------------------------

def test_roofline_peak_and_trace(tmp_path, monkeypatch, caplog):
    from gmat_tpu_torch.core import roofline

    monkeypatch.delenv("GMAT_TPU_PEAK_TFLOPS", raising=False)
    assert roofline.peak_tflops() == 67.0  # H100: FP32 and FP64 DMMA
    monkeypatch.setenv("GMAT_TPU_PEAK_TFLOPS", "2.5")
    with caplog.at_level("INFO", logger=roofline.__name__):
        tf = roofline.log_phase("x", 5e12, 2.0, items=10.0)
    assert tf == 2.5 and "Roofline x: 2.50 TF/s" in caplog.text
    monkeypatch.delenv("GMAT_TPU_TRACE_DIR", raising=False)
    with roofline.maybe_trace("nothing"):
        torch.ones(4).sum()
    assert list(tmp_path.iterdir()) == []
    monkeypatch.setenv("GMAT_TPU_TRACE_DIR", str(tmp_path))
    with roofline.maybe_trace("screen"):
        torch.ones(64, 64) @ torch.ones(64, 64)
    traces = list((tmp_path / "screen").iterdir())
    assert len(traces) == 1
    trace = json.loads(traces[0].read_text())
    assert any("mm" in str(ev.get("name", "")) for ev in trace["traceEvents"])


# the card: needs CUDA --------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


@pytest.mark.cuda
def test_mesh_on_the_card_is_byte_identical(cuda, tmp_path, monkeypatch):
    """Two virtual shards on the card: remma_epiAA_eff and remma_epiAA
    write the bytes of the calls without a mesh, with one K1 sweep per
    shard and one K2 launch per anchor run (3 runs of at most 1,000
    pairs: two rounds of the shards, or three on one device)."""
    from gmat_tpu_torch.dist import make_mesh
    from gmat_tpu_torch.scan import kernels as K
    from gmat_tpu_torch.scan import pairs as P
    from gmat_tpu_torch.scan.pairs import remma_epiAA
    from gmat_tpu_torch.scan.screen import remma_epiAA_eff

    geno, prefix, pheno, gmat_lst, var_com, var_app = _cohort(
        tmp_path, n=300, m=700)
    mesh = make_mesh(devices=["cuda:0", "cuda:0"])
    args = (pheno, prefix, gmat_lst, var_com)
    monkeypatch.setattr(P, "_SCAN_PAIR_BUDGET", 1000)
    for tag, kw in (("one", {}), ("two", {"mesh": mesh})):
        for key in K.LAUNCHES:
            K.LAUNCHES[key] = 0
        remma_epiAA_eff(*args, var_app=var_app,
                        out_file=str(tmp_path / f"eff.{tag}"), **kw)
        remma_epiAA(*args, snp_lst_0=[3, 600, 17, 250], p_cut=0.05,
                    out_file=str(tmp_path / f"scan.{tag}"), **kw)
        torch.cuda.synchronize()
        shards = 2 if kw else 1
        assert K.LAUNCHES == {"screen_count": shards,
                              "screen_extract": shards,
                              "exact_scan": 3}, (tag, K.LAUNCHES)
    for name in ("eff", "scan"):
        one = (tmp_path / f"{name}.one").read_bytes()
        assert one.count(b"\n") > 10
        assert (tmp_path / f"{name}.two").read_bytes() == one


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]),
            sys.argv[4])
