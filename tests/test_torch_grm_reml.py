"""gmat_tpu_torch GRMs and REML vs the JAX package and the reference goldens:
GRMs at rtol 1e-12 (float64 Gram products), REML variances at rtol 1e-6
(the tolerance of tests/test_reml.py)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from gmat_tpu.grm import grm as jgrm
from gmat_tpu.io.pheno import design_matrix as j_design_matrix
from gmat_tpu.reml import wemai as jwemai
from gmat_tpu_torch.core import linalg as tlinalg
from gmat_tpu_torch.core import spans
from gmat_tpu_torch.grm import grm as tgrm
from gmat_tpu_torch.io.bed import write_bed
from gmat_tpu_torch.io.pheno import design_matrix as t_design_matrix
from gmat_tpu_torch.reml import wemai as twemai

import reml_before as before
from conftest import GOLDEN


@pytest.fixture(scope="module")
def grms(mouse_geno):
    g = jnp.asarray(mouse_geno)
    return np.asarray(jgrm.additive_grm(g)), np.asarray(jgrm.dominance_grm(g))


@pytest.mark.parametrize("kind", ["additive_grm", "dominance_grm"])
def test_grm_matches_jax(mouse_geno, grms, kind):
    got = getattr(tgrm, kind)(torch.as_tensor(mouse_geno)).numpy()
    want = grms[0] if kind == "additive_grm" else grms[1]
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("fn", ["agmat", "dgmat_as"])
def test_grm_files_match_jax(tmp_path, mouse_geno, fn):
    prefix_t, prefix_j = str(tmp_path / "t"), str(tmp_path / "j")
    geno = mouse_geno[:150]
    write_bed(prefix_t, geno)
    write_bed(prefix_j, geno)
    kin_t, inv_t = getattr(tgrm, fn)(prefix_t, inv=True, device="cpu")
    kin_j, inv_j = getattr(jgrm, fn)(prefix_j, inv=True)
    np.testing.assert_allclose(kin_t, kin_j, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(inv_t, inv_j, rtol=1e-9, atol=1e-9)
    suffix = ".agrm0" if fn == "agmat" else ".dgrm_as0"
    np.testing.assert_allclose(np.loadtxt(prefix_t + suffix),
                               np.loadtxt(prefix_j + suffix),
                               rtol=1e-12, atol=1e-12)


def test_zgzt_stack_and_reml_step_match_jax(mouse_pheno, mouse_prefix, grms):
    ag, dg = grms
    dm_t = t_design_matrix(mouse_pheno, mouse_prefix)
    dm_j = j_design_matrix(mouse_pheno, mouse_prefix)
    zg_t = twemai.build_zgzt_stack(dm_t, [ag, dg], "cpu")
    zg_j = jwemai.build_zgzt_stack(dm_j, [ag, dg])
    np.testing.assert_array_equal(zg_t.numpy(), np.asarray(zg_j))
    var = np.array([0.3, 0.1, 0.5])
    got = twemai._reml_step(torch.as_tensor(var), torch.as_tensor(dm_t.y),
                            torch.as_tensor(dm_t.xmat), zg_t)
    want = jwemai._reml_step(jnp.asarray(var), jnp.asarray(dm_j.y),
                             jnp.asarray(dm_j.xmat), zg_j)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-10)


@pytest.mark.parametrize(
    "key,build",
    [
        ("a_axa", lambda ag, dg: [ag, ag * ag]),
        ("a_d_axa", lambda ag, dg: [ag, dg, ag * ag]),
        ("a_d_axa_axd_dxd",
         lambda ag, dg: [ag, dg, ag * ag, ag * dg, dg * dg]),
    ],
)
def test_reml_matches_golden(mouse_pheno, mouse_prefix, grms, key, build):
    gold = np.load(GOLDEN / "reml_var.npz")[key]
    dm = t_design_matrix(mouse_pheno, mouse_prefix)
    var = twemai.wemai_reml(dm, build(*grms), device="cpu")
    np.testing.assert_allclose(var, gold, rtol=1e-6, atol=1e-10)


def test_wemai_multi_gmat_matches_jax(tmp_path, mouse_pheno, mouse_prefix,
                                      grms):
    ag, _ = grms
    out_t, out_j = str(tmp_path / "var_t.txt"), str(tmp_path / "var_j.txt")
    got = twemai.wemai_multi_gmat(mouse_pheno, mouse_prefix, [ag, ag * ag],
                                  out_file=out_t, precision="f64",
                                  device="cpu")
    want = jwemai.wemai_multi_gmat(mouse_pheno, mouse_prefix, [ag, ag * ag],
                                   out_file=out_j, precision="f64")
    np.testing.assert_allclose(got, want, rtol=1e-6)
    np.testing.assert_allclose(np.loadtxt(out_t), np.loadtxt(out_j),
                               rtol=1e-6)
    np.testing.assert_allclose(got, np.load(GOLDEN / "reml_var.npz")["a_axa"],
                               rtol=1e-6, atol=1e-10)


# the CPU keeps the REML iteration of before its card path became a CUDA
# graph with V⁻¹ from potri, bit for bit (tests/reml_before.py)

@pytest.fixture(scope="module")
def mouse_zg(mouse_pheno, mouse_prefix, grms):
    ag, _ = grms
    dm = t_design_matrix(mouse_pheno, mouse_prefix)
    return dm, twemai.build_zgzt_stack(dm, [ag, ag * ag], "cpu")


def _spd(n, seed):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, n))
    return torch.as_tensor(a @ a.T / n + np.eye(n))


@pytest.mark.parametrize("which", ["spd", "mouse_v"])
def test_chol_inv_logdet_on_the_cpu_is_unchanged(mouse_zg, which):
    if which == "spd":
        a = _spd(300, 21)
    else:
        var = torch.tensor([0.3, 0.1, 0.5], dtype=torch.float64)
        a = twemai._vmat(var, mouse_zg[1])
        assert torch.equal(a, before.vmat(var, mouse_zg[1]))
    got, want = tlinalg.chol_inv_logdet(a), before.chol_inv_logdet(a)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_reml_step_on_the_cpu_is_unchanged(mouse_zg):
    dm, zg = mouse_zg
    var = torch.tensor([0.3, 0.1, 0.5], dtype=torch.float64)
    args = (var, torch.as_tensor(dm.y), torch.as_tensor(dm.xmat), zg)
    got, want = twemai._reml_step(*args), before.reml_step(*args)
    assert len(got) == 6 and got[5] is None
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize(
    "key,build",
    [("a_axa", lambda ag, dg: [ag, ag * ag]),
     ("a_d_axa", lambda ag, dg: [ag, dg, ag * ag])],
)
def test_wemai_reml_on_the_cpu_is_unchanged_and_replays_nothing(
        mouse_pheno, mouse_prefix, grms, key, build):
    dm = t_design_matrix(mouse_pheno, mouse_prefix)
    gmat_lst = build(*grms)
    want, iters = before.wemai_reml(
        dm.y, dm.xmat, twemai.build_zgzt_stack(dm, gmat_lst, "cpu"))
    n0 = len(spans.spans())
    with profile(activities=[ProfilerActivity.CPU]):
        got = twemai.wemai_reml(dm, gmat_lst, device="cpu")
    loops = [r for r in spans.spans()[n0:] if r.name == "reml.iterate"]
    assert len(loops) == 1
    assert loops[0].counts["iterations"] == iters
    assert loops[0].counts["replays"] == 0
    np.testing.assert_array_equal(got, want)


def test_non_positive_definite_v_raises_on_the_cpu(mouse_zg):
    dm, zg = mouse_zg
    var = torch.tensor([1.0, 1.0, -50.0], dtype=torch.float64)
    args = (var, torch.as_tensor(dm.y), torch.as_tensor(dm.xmat), zg)
    with pytest.raises(torch.linalg.LinAlgError):
        before.reml_step(*args)
    with pytest.raises(torch.linalg.LinAlgError):
        twemai._reml_step(*args)
