"""The effect screen of gmat_tpu_torch (scan/kernels.py) vs the JAX package's
Pallas screen in interpret mode and vs a float64 oracle.

On the CPU the wrappers run their plain PyTorch versions; the cases marked
`cuda` hold the Hopper kernel against them and skip without a card.  A hit
set is held to the float64 oracle's bracket: every pair with |S| above
cut·(1 + 1e-4) must be found, and every pair found must have |S| above
cut·(1 - 1e-4); float32 rounding may flip pairs inside the band only.

The JAX package is imported inside the tests that use it, so that the
`cuda` cases also run on a machine without JAX:
    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py
"""
import numpy as np
import pytest
import torch

from gmat_tpu_torch.scan import kernels as K

BAND = 1e-4


def _problem(n, m, seed):
    """The recipe of tests/test_pallas_kernels.py's `problem` fixture."""
    rng = np.random.default_rng(seed)
    geno = rng.choice([0.0, 1.0, 2.0], size=(n, m))
    freq = geno.sum(0) / (2 * n)
    mat = (geno - 2 * freq[None, :]).astype(np.float32)
    py = (rng.standard_normal(n) * 0.1).astype(np.float32)
    eff64 = (mat.astype(np.float64) * py.astype(np.float64)[:, None]).T \
        @ mat.astype(np.float64)
    return mat, py, eff64


@pytest.fixture(scope="module")
def problem():
    return _problem(96, 1100, 2026)  # m deliberately not a tile multiple


def _upper(eff64):
    return np.triu_indices(eff64.shape[0], 1)


def _quantile_cut(eff64, q):
    return float(np.quantile(np.abs(eff64[_upper(eff64)]), q))


def _oracle(eff64, cut, slack):
    m = eff64.shape[0]
    mask = (np.abs(eff64) > cut * (1.0 + slack)) & (
        np.arange(m)[None, :] > np.arange(m)[:, None])
    return set(zip(*(a.tolist() for a in np.nonzero(mask))))


def _assert_bracket(pairs, eff64, cut):
    got = set(zip(*(np.asarray(a).tolist() for a in pairs)))
    core, hull = _oracle(eff64, cut, BAND), _oracle(eff64, cut, -BAND)
    assert core <= got <= hull
    return got


def _hits(mat, py, cut, device="cpu"):
    return K.screen_hits(torch.as_tensor(mat, device=device),
                         torch.as_tensor(py, device=device), cut,
                         mat.shape[1])


@pytest.mark.parametrize("q", [0.995, 0.9])
def test_tile_counts_match_pallas_exactly(problem, q):
    import jax.numpy as jnp

    from gmat_tpu.scan.kernels import pallas_screen_counts

    mat, py, eff64 = problem
    cut = _quantile_cut((mat * py[:, None]).T @ mat, q)
    got = K.screen_tile_counts_ref(torch.as_tensor(mat), torch.as_tensor(py),
                                   cut, mat.shape[1], tile=512)
    want = np.asarray(pallas_screen_counts(jnp.asarray(mat), jnp.asarray(py),
                                           cut, interpret=True))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("q", [0.999, 0.99])
def test_hits_match_pallas_in_bracket(problem, q):
    from gmat_tpu.scan.kernels import pallas_screen

    mat, py, eff64 = problem
    cut = _quantile_cut(eff64, q)
    i, j, e = _hits(mat, py, cut)
    assert i.dtype == j.dtype == torch.int64 and e.dtype == torch.float32
    key = i * mat.shape[1] + j
    assert torch.all(key[1:] > key[:-1])  # sorted by (i, j), no duplicates
    got = _assert_bracket((i, j), eff64, cut)
    pi, pj, _ = pallas_screen(mat, py, cut, interpret=True)
    want = _assert_bracket((pi, pj), eff64, cut)
    core = _oracle(eff64, cut, BAND)
    assert len(core) > 100 and got ^ want <= _oracle(eff64, cut, -BAND) - core
    np.testing.assert_allclose(e.numpy(), eff64[i.numpy(), j.numpy()],
                               rtol=1e-4)


def test_zero_hits(problem):
    from gmat_tpu.scan.kernels import pallas_screen

    mat, py, _ = problem
    i, j, e = _hits(mat, py, 1e9)
    assert len(i) == len(j) == len(e) == 0
    assert len(pallas_screen(mat, py, 1e9, interpret=True)[0]) == 0
    counts = K.screen_counts(torch.as_tensor(mat), torch.as_tensor(py), 1e9,
                             mat.shape[1])
    assert counts.shape == (9, 9) and int(counts.sum()) == 0


def test_dense_hits_past_pallas_cap():
    """More than 16384 hits: the K-doubling retry case of `pallas_screen`
    (tests/test_pallas_kernels.py::test_extraction_cap_retry)."""
    from gmat_tpu.scan.kernels import pallas_screen

    rng = np.random.default_rng(2026)
    n, m = 24, 700
    mat = rng.standard_normal((n, m)).astype(np.float32)
    py = rng.standard_normal(n).astype(np.float32) * 0.1
    eff64 = (mat.astype(np.float64) * py.astype(np.float64)[:, None]).T \
        @ mat.astype(np.float64)
    i, j, _ = _hits(mat, py, 1e-7)
    got = _assert_bracket((i, j), eff64, 1e-7)
    assert len(got) > 16384
    pi, pj, _ = pallas_screen(mat, py, 1e-7, interpret=True)
    assert got == set(zip(pi.tolist(), pj.tolist()))


@pytest.mark.parametrize("n,m", [(50, 129), (33, 300), (7, 128)])
def test_driver_matches_plain_screen(n, m):
    """Two-phase driver (counts -> hot tiles -> extract -> sort) against the
    one-pass plain version, at ragged and tile-exact widths."""
    mat, py, eff64 = _problem(n, m, n + m)
    cut = _quantile_cut(eff64, 0.97)
    i, j, e = _hits(mat, py, cut)
    ri, rj, re = K.screen_hits_ref(torch.as_tensor(mat), torch.as_tensor(py),
                                   cut, m, block_elems=m * 5)
    torch.testing.assert_close(i, ri, rtol=0, atol=0)
    torch.testing.assert_close(j, rj, rtol=0, atol=0)
    torch.testing.assert_close(e, re, rtol=1e-6, atol=1e-6)
    counts = K.screen_counts(torch.as_tensor(mat), torch.as_tensor(py), cut, m)
    assert int(counts.sum()) == len(i)
    assert int(torch.tril(counts, -1).abs().sum()) == 0


def test_wrapper_rejects_bad_input(problem):
    mat, py, _ = problem
    with pytest.raises(TypeError):
        K.screen_counts(torch.as_tensor(mat, dtype=torch.float64),
                        torch.as_tensor(py, dtype=torch.float64), 1.0, 10)
    with pytest.raises(ValueError):
        K.screen_counts(torch.as_tensor(mat).T, torch.as_tensor(py), 1.0, 10)
    with pytest.raises(ValueError):
        K.screen_counts(torch.as_tensor(mat), torch.as_tensor(py), 1.0,
                        mat.shape[1] + 1)


# the Hopper kernel: needs the card ------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n,m,q", [(96, 1100, 0.999), (1000, 3001, 0.9995),
                                   (24, 700, 0.05)])
def test_kernel_matches_plain_version(cuda, n, m, q):
    mat, py, eff64 = _problem(n, m, 7)
    cut = _quantile_cut(eff64, q)
    mat_d, py_d = torch.as_tensor(mat, device=cuda), torch.as_tensor(py, device=cuda)
    mat64, py64 = mat_d.double(), py_d.double()
    before = dict(K.LAUNCHES)
    counts = K.screen_counts(mat_d, py_d, cut, m)
    core = K.screen_tile_counts_ref(mat64, py64, cut * (1 + BAND), m)
    hull = K.screen_tile_counts_ref(mat64, py64, cut * (1 - BAND), m)
    assert bool(torch.all(core <= counts)) and bool(torch.all(counts <= hull))
    i, j, e = K.screen_hits(mat_d, py_d, cut, m)
    torch.cuda.synchronize()
    assert K.LAUNCHES["screen_count"] == before["screen_count"] + 2
    assert K.LAUNCHES["screen_extract"] == before["screen_extract"] + 1
    _assert_bracket((i.cpu(), j.cpu()), eff64, cut)
    np.testing.assert_allclose(e.cpu().numpy(),
                               eff64[i.cpu().numpy(), j.cpu().numpy()],
                               rtol=1e-4)
    with pytest.raises(TypeError):
        K.screen_counts(mat64, py64, cut, m)
