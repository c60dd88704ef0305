"""gmat_tpu_torch.core (coding, stats, linalg) vs the JAX package on the same
numpy inputs, at rtol 1e-12 (both run float64 on the CPU)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gmat_tpu.core import coding as jcoding
from gmat_tpu.core import linalg as jlinalg
from gmat_tpu.core import stats as jstats
from gmat_tpu_torch.core import coding as tcoding
from gmat_tpu_torch.core import linalg as tlinalg
from gmat_tpu_torch.core import stats as tstats

RTOL = 1e-12


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


def _close(got, want, rtol=RTOL, atol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


@pytest.fixture(scope="module")
def geno():
    rng = np.random.default_rng(11)
    return rng.choice([0.0, 1.0, 2.0], size=(60, 90), p=[0.5, 0.3, 0.2])


@pytest.mark.parametrize("name", ["allele_freq", "additive_scale_of_freq",
                                  "dominance_scale_of_freq"])
def test_scalar_codings_match_jax(geno, name):
    freq_j = jcoding.allele_freq(jnp.asarray(geno))
    freq_t = tcoding.allele_freq(_t(geno))
    if name == "allele_freq":
        _close(freq_t, freq_j)
    elif name == "additive_scale_of_freq":
        _close(tcoding.additive_scale(freq_t), jcoding.additive_scale(freq_j))
    else:
        _close(tcoding.dominance_scale(freq_t),
               jcoding.dominance_scale(freq_j))


@pytest.mark.parametrize("kind", ["additive_code", "dominance_code"])
def test_codings_match_jax(geno, kind):
    got = getattr(tcoding, kind)(_t(geno))
    want = getattr(jcoding, kind)(jnp.asarray(geno))
    for g, w in zip(got, want):
        _close(g, w, atol=1e-15)


@pytest.mark.parametrize("df", [1, 2, 3])
def test_chi2_sf_matches_jax(df):
    x = np.concatenate([np.linspace(0.0, 60.0, 301), [1e-12, 120.0, 400.0]])
    _close(tstats.chi2_sf(_t(x), df), jstats.chi2_sf(jnp.asarray(x), df),
           atol=1e-300)


def test_chi2_sf_nan_and_isf():
    assert torch.isnan(tstats.chi2_sf(_t([np.nan]))).all()
    for p in (1e-2, 1e-5, 1e-8):
        assert tstats.chi2_isf(p) == jstats.chi2_isf(p)


@pytest.fixture(scope="module")
def spd():
    rng = np.random.default_rng(12)
    a = rng.standard_normal((40, 40))
    v = a @ a.T / 40 + np.eye(40)
    x = np.column_stack([np.ones(40), rng.standard_normal((40, 2))])
    return v, x


def test_chol_inv_logdet_matches_jax(spd):
    v, _ = spd
    inv_t, ld_t = tlinalg.chol_inv_logdet(_t(v))
    inv_j, ld_j = jlinalg.chol_inv_logdet(jnp.asarray(v))
    _close(inv_t, inv_j)
    _close(ld_t, ld_j)


def test_projection_pieces_matches_jax(spd):
    v, x = spd
    vinv = np.linalg.inv(v)
    p_t, ll_t = tlinalg.projection_pieces(_t(vinv), _t(x))
    p_j, ll_j = jlinalg.projection_pieces(jnp.asarray(vinv), jnp.asarray(x))
    _close(p_t, p_j, atol=1e-14)
    _close(ll_t, ll_j)


def test_sym_trace_product_matches_jax(spd):
    v, _ = spd
    w = np.linalg.inv(v)
    _close(tlinalg.sym_trace_product(_t(v), _t(w)),
           jlinalg.sym_trace_product(jnp.asarray(v), jnp.asarray(w)))


# V⁻¹ on a card comes from recursive Schur complements with leaves of at most
# SPD_LEAF rows; on the CPU the same recursion runs with the leaves' plain
# version, which holds its splits, offsets and orders here

def _spd_t(n, seed):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, n))
    return _t(a @ a.T / n + np.eye(n))


@pytest.mark.parametrize("n", [1, 31, 64, 65, 130, 200])
def test_spd_inverse_logdet_matches_inv_on_the_cpu(n):
    a = _spd_t(n, n)
    inv, logdet, info = tlinalg.spd_inverse_logdet(a)
    want = torch.linalg.inv(a)
    assert float((inv - want).abs().max() / want.abs().max()) <= 1e-12
    _close(logdet, torch.linalg.slogdet(a)[1])
    assert info.dtype == torch.int32 and int(info) == 0


@pytest.mark.parametrize("bad", [0, 63, 64, 150, 199])
def test_spd_inverse_logdet_finds_the_first_bad_minor_on_the_cpu(bad):
    a = _spd_t(200, 5)
    a[bad, bad] = -5.0
    a[min(bad + 7, 199), min(bad + 7, 199)] = -5.0  # a later one as well
    want = int(torch.linalg.cholesky_ex(a)[1])
    assert want == bad + 1
    assert int(tlinalg.spd_inverse_logdet(a)[2]) == want
    # the error a card raises from that order reads as the CPU's
    with pytest.raises(torch.linalg.LinAlgError) as was:
        tlinalg.chol_inv_logdet(a)
    assert str(was.value) == str(tlinalg.not_positive_definite(want))


@pytest.mark.parametrize("b", [1, 17, 64])
def test_spd_leaf_inverse_ref_matches_inv(b):
    from gmat_tpu_torch.core.native import spd_leaf_inverse_ref
    a = _spd_t(b, 40 + b)
    inv, logdet, order = spd_leaf_inverse_ref(a)
    _close(inv, torch.linalg.inv(a), rtol=1e-11, atol=1e-13)
    _close(logdet, torch.linalg.slogdet(a)[1])
    assert order == 0

