"""The effect screen of gmat_tpu_torch (scan/kernels.py) vs the JAX package's
Pallas screen in interpret mode and vs a float64 oracle.

On the CPU the wrappers run their plain PyTorch versions; the cases marked
`cuda` hold the Hopper kernel against them and skip without a card.  The
kernels form S as three TF32 products (3xTF32); the CPU tests hold that
scheme, emulated, to the same bracket, and show one TF32 product leaving
it.  A hit
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


def test_general_wrapper_rejects_bad_input(problem):
    mat, py, _ = problem
    m = mat.shape[1]
    mat_t, py_t = torch.as_tensor(mat), torch.as_tensor(py)
    ids = torch.tensor([3, 1], dtype=torch.int32)
    with pytest.raises(ValueError):  # b with other rows than mat
        K.screen_counts(mat_t, py_t, 1.0, m, b=mat_t[:-1].contiguous())
    with pytest.raises(ValueError):  # an anchor id past the partners
        K.screen_counts(mat_t, py_t, 1.0, m, ids=torch.tensor(
            [0, m], dtype=torch.int32))
    with pytest.raises(TypeError):
        K.screen_counts(mat_t, py_t, 1.0, m, ids=ids.long())
    bins = torch.zeros(m, dtype=torch.int32)
    table = torch.ones(111)
    with pytest.raises(ValueError):  # bin 11 reads past the table
        K.screen_counts(mat_t, py_t, K.CutTable(bins + 11, bins, table), m)
    with pytest.raises(TypeError):
        K.screen_counts(mat_t, py_t, K.CutTable(bins, bins, table[:110]), m)


@pytest.mark.parametrize("ids", [None, [700, 3, 129, 300, 5, 1000]])
def test_banded_order_is_a_permutation_in_bands(ids):
    """`banded` reorders a launch's tile list (a work list, or the hot
    tiles) without losing or adding a tile: partner-tile bands of TILE_BAND
    ascending, anchor tiles ascending in a band."""
    m = 1100
    pos = (torch.arange(m, dtype=torch.int32) if ids is None
           else torch.tensor(ids, dtype=torch.int32))
    work = K.screen_worklist(pos, m)
    got = K.banded(work)
    assert got.dtype == torch.int32 and got.is_contiguous()
    assert sorted(map(tuple, got.tolist())) == sorted(map(tuple, work.tolist()))
    key = [(tb // K.TILE_BAND, ta, tb) for ta, tb in got.tolist()]
    assert key == sorted(key) and len(set(key)) == len(key)
    assert len(K.banded(work[:0])) == 0


# the precision scheme of the kernels: 3xTF32, emulated on the CPU ------------

def _operands(case):
    """(A, B, py, eff64) of the named fixture case as tensors (eff64 numpy):
    the `_problem` panel twice, or `_general_problem`'s additive and
    dominance codes."""
    if case == "problem":
        a, py, eff64 = _problem(96, 1100, 2026)
        b = a
    else:
        a, b, py, _, _ = _general_problem(50, 301, 0, 351, 0.97, "flat")
        eff64 = (a.astype(np.float64) * py.astype(np.float64)[:, None]).T @ b
    return torch.as_tensor(a), torch.as_tensor(b), torch.as_tensor(py), eff64


def test_tf32_round_ties_away_from_zero():
    """`tf32_round_ref` rounds as `cvt.rna.tf32.f32`: to nearest, a tie
    away from zero, never by truncation."""
    ulp = 2.0 ** -10  # TF32 spacing in [1, 2)
    x = torch.tensor([1 + ulp / 2, -(1 + ulp / 2), 1 + ulp / 4, 1 + 0.75 * ulp,
                      1 + 1.5 * ulp, 0.0, -0.0, 3.0], dtype=torch.float32)
    want = [1 + ulp, -(1 + ulp), 1.0, 1 + ulp, 1 + 2 * ulp, 0.0, -0.0, 3.0]
    assert K.tf32_round_ref(x).tolist() == want


@pytest.mark.parametrize("case", ["problem", "general_problem"])
@pytest.mark.parametrize("operand", [0, 1])
def test_tf32_split_parts(case, operand):
    """hi and lo are TF32 values (their low 13 mantissa bits zero) and
    |x − hi − lo| ≤ 2⁻²²·|x|, for A ⊙ py and for B."""
    a, b, py, _ = _operands(case)
    x = a * py[:, None] if operand == 0 else b
    hi, lo = K.tf32_split_ref(x)
    for part in (hi, lo):
        assert int((part.view(torch.int32) & 0x1FFF).abs().sum()) == 0
    x64 = x.double()
    resid = (x64 - hi.double() - lo.double()).abs()
    assert bool(torch.all(resid <= 2.0 ** -22 * x64.abs()))
    assert float((x64 - hi.double()).abs().max()) > 0  # lo carries bits


@pytest.mark.parametrize("case,q", [("problem", 0.999), ("problem", 0.99),
                                    ("general_problem", 0.99)])
def test_3xtf32_screen_in_bracket(case, q):
    """The emulated 3xTF32 product keeps the f64 hit bracket and eff within
    rtol 1e-4, like the float32 product it replaces."""
    a, b, py, eff64 = _operands(case)
    s = K.tile_product_3xtf32_ref(a, b, py).numpy()
    cut = _quantile_cut(eff64, q)
    m = s.shape[1]
    upper = np.arange(m)[None, :] > np.arange(s.shape[0])[:, None]
    pairs = np.nonzero((np.abs(s) > cut) & upper)
    _assert_bracket(pairs, eff64, cut)
    assert len(pairs[0]) > 100
    np.testing.assert_allclose(s[pairs], eff64[pairs], rtol=1e-4)


def test_one_pass_tf32_leaves_bracket():
    """Why three products: at a cut among many scores (the median |S| of a
    yeast-like panel) one TF32 product hi·hi misses pairs above the f64
    bracket or keeps pairs below it, and its eff is off by more than 1e-4;
    the 3xTF32 product on the same inputs stays inside."""
    rng = np.random.default_rng(2026)
    n, m = 1000, 400
    geno = rng.binomial(2, rng.uniform(0.05, 0.95, m), size=(n, m))
    mat = (geno - geno.mean(0)).astype(np.float32)
    py = (rng.standard_normal(n) * 0.1).astype(np.float32)
    eff64 = (mat.astype(np.float64) * py.astype(np.float64)[:, None]).T \
        @ mat.astype(np.float64)
    cut = _quantile_cut(eff64, 0.5)
    a, p = torch.as_tensor(mat), torch.as_tensor(py)
    hi_a, _ = K.tf32_split_ref(a * p[:, None])
    hi_b, _ = K.tf32_split_ref(a)
    upper = np.arange(m)[None, :] > np.arange(m)[:, None]
    core, hull = _oracle(eff64, cut, BAND), _oracle(eff64, cut, -BAND)
    s1 = (hi_a.T @ hi_b).numpy()
    one = set(zip(*(x.tolist() for x in np.nonzero((np.abs(s1) > cut) & upper))))
    assert not core <= one <= hull
    assert np.max(np.abs(s1 - eff64)[upper] / np.abs(eff64)[upper]
                  * (np.abs(eff64)[upper] > cut / 2)) > 1e-4
    s3 = K.tile_product_3xtf32_ref(a, a, p).numpy()
    _assert_bracket(np.nonzero((np.abs(s3) > cut) & upper), eff64, cut)


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


@pytest.mark.cuda
@pytest.mark.parametrize("n,m,q", [(33, 517, 0.99), (97, 1001, 0.99),
                                   (4168, 600, 0.99), (4168, 256, 0.99),
                                   (1304, 1000, 0.1)])
def test_kernel_chunk_and_width_edges(cuda, n, m, q):
    """n not a multiple of the kernels' 32-deep k-chunk (33, 97, 4168), a
    ragged and a tile-exact m, and a near keep-all cut (scores that cancel
    to a small |S|): counts in the f64 bracket, as many hits as the counts,
    hits in the bracket, eff within 1e-4 of f64 and of the emulated 3xTF32
    product, one launch of each kernel."""
    mat, py, eff64 = _problem(n, m, n + m)
    cut = _quantile_cut(eff64, q)
    mat_d, py_d = torch.as_tensor(mat, device=cuda), torch.as_tensor(py, device=cuda)
    mat64, py64 = mat_d.double(), py_d.double()
    before = dict(K.LAUNCHES)
    counts = K.screen_counts(mat_d, py_d, cut, m)
    p, j, e = K.screen_extract(mat_d, py_d, cut, m, counts)
    torch.cuda.synchronize()
    assert K.LAUNCHES["screen_count"] == before["screen_count"] + 1
    assert K.LAUNCHES["screen_extract"] == before["screen_extract"] + 1
    core = K.screen_tile_counts_ref(mat64, py64, cut * (1 + BAND), m)
    hull = K.screen_tile_counts_ref(mat64, py64, cut * (1 - BAND), m)
    assert bool(torch.all(core <= counts)) and bool(torch.all(counts <= hull))
    assert int(counts.sum()) == len(p) > 0
    p, j, e = p.cpu().numpy(), j.cpu().numpy(), e.cpu().numpy()
    _assert_bracket((p, j), eff64, cut)
    np.testing.assert_allclose(e, eff64[p, j], rtol=1e-4)
    emulated = K.tile_product_3xtf32_ref(mat_d, mat_d, py_d).cpu().numpy()
    np.testing.assert_allclose(e, emulated[p, j], rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("shift", [0, 5])
def test_identity_and_general_eff_bit_equal(cuda, shift):
    """A pair's eff has the same bits from the identity kernels and from
    the general kernels over a gathered anchor panel whose position p
    holds anchor p + shift (shift 0: anchors = arange(m), every pair at
    its identity tile position; shift 5: every pair 5 rows up its tile, or
    in the tile before): what the mesh's byte-equal files rest on."""
    n, m = 97, 1001
    mat, py, eff64 = _problem(n, m, 11)
    cut = _quantile_cut(eff64, 0.99)
    mat_d, py_d = torch.as_tensor(mat, device=cuda), torch.as_tensor(py, device=cuda)
    i, j, e = K.screen_positions(mat_d, py_d, cut, m)
    if shift == 0:  # anchor_panel would hand arange(m) to the identity path
        pa, ids = mat_d, torch.arange(m, dtype=torch.int32, device=cuda)
    else:
        pa, ids = K.anchor_panel(mat_d, torch.arange(shift, m, device=cuda), m)
    before = dict(K.LAUNCHES)
    counts = K.screen_counts(pa, py_d, cut, m, b=mat_d, ids=ids)
    p, gj, ge = K.screen_extract(pa, py_d, cut, m, counts, b=mat_d, ids=ids)
    torch.cuda.synchronize()
    assert K.LAUNCHES["screen_count"] == before["screen_count"] + 1
    assert K.LAUNCHES["screen_extract"] == before["screen_extract"] + 1
    gi = ids.long()[p.long()]
    order = torch.argsort(gi * m + gj.long())
    keep = i >= shift
    assert int(keep.sum()) > 100
    assert torch.equal(gi[order], i[keep])
    assert torch.equal(gj.long()[order], j[keep])
    assert torch.equal(ge[order].view(torch.int32), e[keep].view(torch.int32))


# the general screen: anchor subsets, a second panel, cut tables --------------

def _general_problem(n, m, n_anchors, seed, q, table_kind):
    """Additive and dominance codes of a seeded panel, py, an anchor list
    (None, or unsorted ids with the tile edges 127, 128, 255, 256 and m-2),
    and the cut: a flat quantile cut, a `CutTable` whose bins include 10,
    -999 (keep all) or 1e9 (no hits)."""
    rng = np.random.default_rng(seed)
    geno = rng.choice([0.0, 1.0, 2.0], size=(n, m))
    a = (geno - geno.mean(0)).astype(np.float32)
    het = (geno == 1.0).astype(np.float64)
    d = (het - het.mean(0)).astype(np.float32)
    py = (rng.standard_normal(n) * 0.1).astype(np.float32)
    anchors = None
    if n_anchors:
        edges = [x for x in (127, 128, 255, 256, m - 2) if x < m - 1]
        rest = np.setdiff1d(rng.permutation(m - 1), edges)[:n_anchors - len(edges)]
        anchors = rng.permutation(np.concatenate([edges, rest])).astype(np.int64)
    s64 = (a.astype(np.float64) * py.astype(np.float64)[:, None]).T @ d
    cut = float(np.quantile(np.abs(s64), q))
    if table_kind == "table":
        bins_a = rng.integers(0, 11, size=m).astype(np.int32)
        bins_b = rng.integers(0, 11, size=m).astype(np.int32)
        bins_a[:2] = bins_b[-2:] = 10
        table = (cut * (0.8 + 0.05 * (np.arange(111) % 9))).astype(np.float32)
        cut = K.CutTable(torch.as_tensor(bins_a), torch.as_tensor(bins_b),
                         torch.as_tensor(table))
    elif table_kind == "keep_all":
        cut = -999.0
    elif table_kind == "zero_hits":
        cut = 1e9
    return a, d, py, anchors, cut


def _on(cut, device):
    if isinstance(cut, K.CutTable):
        return K.CutTable(cut.bins_a.to(device), cut.bins_b.to(device),
                          cut.table.to(device))
    return cut


def _scaled(cut, factor):
    return cut.scaled(factor) if isinstance(cut, K.CutTable) else cut * factor


@pytest.mark.parametrize("n,m,n_anchors,table_kind", [
    (50, 301, 40, "table"), (33, 300, 0, "flat"), (24, 260, 7, "keep_all")])
def test_general_driver_matches_plain_screen(n, m, n_anchors, table_kind):
    """The two-phase driver of the general screen (gather -> counts over the
    work list -> hot tiles -> extract -> sort) against the one-pass plain
    version, with a second panel b."""
    a, d, py, anchors, cut = _general_problem(n, m, n_anchors, n + m, 0.97,
                                              table_kind)
    args = (torch.as_tensor(a), torch.as_tensor(py), cut, m)
    kw = {"b": torch.as_tensor(d),
          "anchors": None if anchors is None else torch.as_tensor(anchors)}
    i, j, e = K.screen_hits(*args, **kw)
    ri, rj, re = K.screen_hits_ref(*args, block_elems=m * 3, **kw)
    torch.testing.assert_close(i, ri, rtol=0, atol=0)
    torch.testing.assert_close(j, rj, rtol=0, atol=0)
    torch.testing.assert_close(e, re, rtol=1e-6, atol=1e-6)
    assert len(i) > 50 and bool(torch.all(j > i))
    pa, ids = K.anchor_panel(args[0], kw["anchors"], m)
    counts = K.screen_counts(pa, args[1], cut, m, b=kw["b"], ids=ids)
    assert int(counts.sum()) == len(i)
    work = set(map(tuple, K.screen_worklist(
        ids if ids is not None else torch.arange(m, dtype=torch.int32),
        m).tolist()))
    hot = set(map(tuple, torch.nonzero(counts).tolist()))
    assert hot <= work


@pytest.mark.cuda
@pytest.mark.parametrize("n,m,n_anchors,table_kind,q", [
    (97, 1001, 300, "table", 0.99),      # odd n, ragged m, unsorted subset
    (128, 1024, 301, "flat", 0.995),     # float4 loads on, a != b
    (64, 515, 0, "flat", 0.99),          # identity anchors, a != b
    (64, 515, 0, "table", 0.99),         # identity anchors, a table
    (33, 301, 77, "keep_all", 0.0),
    (50, 700, 129, "zero_hits", 0.0),
])
def test_general_kernel_matches_plain_version(cuda, n, m, n_anchors,
                                              table_kind, q):
    a, d, py, anchors, cut = _general_problem(n, m, n_anchors, 7, q,
                                              table_kind)
    a_d, d_d, py_d = (torch.as_tensor(x, device=cuda) for x in (a, d, py))
    cut_d = _on(cut, cuda)
    anc = None if anchors is None else torch.as_tensor(anchors, device=cuda)
    pa, ids = K.anchor_panel(a_d, anc, m)
    pa64, py64, d64 = pa.double(), py_d.double(), d_d.double()
    before = dict(K.LAUNCHES)
    counts = K.screen_counts(pa, py_d, cut_d, m, b=d_d, ids=ids)
    core = K.screen_tile_counts_ref(pa64, py64, _scaled(cut_d, 1 + BAND), m,
                                    b=d64, ids=ids)
    hull = K.screen_tile_counts_ref(pa64, py64, _scaled(cut_d, 1 - BAND), m,
                                    b=d64, ids=ids)
    lo, hi = (core, hull) if table_kind != "keep_all" else (hull, core)
    assert bool(torch.all(lo <= counts)) and bool(torch.all(counts <= hi))
    i, j, e = K.screen_hits(a_d, py_d, cut_d, m, b=d_d, anchors=anc)
    torch.cuda.synchronize()
    assert K.LAUNCHES["screen_count"] == before["screen_count"] + 2
    assert K.LAUNCHES["screen_extract"] == before["screen_extract"] + (
        table_kind != "zero_hits")
    pos = (i if anc is None else
           torch.argsort(anc)[torch.searchsorted(torch.sort(anc).values, i)])
    key = pos * m + j
    assert bool(torch.all(key[1:] > key[:-1]))  # list order, no repeats
    ri, rj, re = K.screen_hits_ref(a_d.double(), py64,
                                   _scaled(cut_d, 1 - BAND), m, b=d64,
                                   anchors=anc)
    ci, cj, _ = K.screen_hits_ref(a_d.double(), py64,
                                  _scaled(cut_d, 1 + BAND), m, b=d64,
                                  anchors=anc)
    got = set(zip(i.tolist(), j.tolist()))
    assert set(zip(ci.tolist(), cj.tolist())) <= got
    assert got <= set(zip(ri.tolist(), rj.tolist()))
    if table_kind == "zero_hits":
        assert len(got) == 0
        return
    ref = dict(zip(zip(ri.tolist(), rj.tolist()), re.tolist()))
    want = np.array([ref[k] for k in zip(i.tolist(), j.tolist())])
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(e.cpu().numpy(), want, rtol=1e-4,
                               atol=1e-6 * scale)
    if table_kind == "keep_all":
        ids_l = anchors.tolist()
        assert len(got) == sum(m - 1 - x for x in ids_l)
