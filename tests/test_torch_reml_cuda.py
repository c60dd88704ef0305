"""REML's iteration on the card: one replayed CUDA graph a step
(`reml/wemai.py::_GraphStep`) with V⁻¹ by recursive Schur complements
(`core/linalg.py::spd_inverse_logdet`, its leaves the kernel
`core/native.py::spd_leaf_inverse`), held against the eager path of
before (`tests/reml_before.py`: V⁻¹ by two triangular solves, the
variances through the host every iteration) run on the same card.

Variances are compared as the benchmark's `var_gap` does: each
component's gap relative to the larger of it and the median component, at
1e-10 (float64 rounding carried through up to 200 iterations, against a
fault, which moves them by 1e-6 or more).  Every case needs the card and
skips without one; no JAX is imported, so they run there as
    python -m pytest --noconftest -m cuda tests/test_torch_reml_cuda.py
"""
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import reml_before as before
from gmat_tpu_torch.core import linalg, native, spans
from gmat_tpu_torch.grm.grm import additive_grm, dominance_grm
from gmat_tpu_torch.io.bed import read_plink
from gmat_tpu_torch.io.pheno import DesignMatrices, design_matrix
from gmat_tpu_torch.reml import wemai

DATA = Path(__file__).resolve().parent / "data"
VAR_GAP = 1e-10
YEAST_N = 4168  # the yeast panel's individuals


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


def _var_gap(got, want):
    scale = np.maximum(np.abs(want), np.median(np.abs(want)))
    return float(np.max(np.abs(got - want) / scale))


def _reml_on_card(dm, gmat_lst, **kw):
    """wemai_reml on the card under a profiler: (variances, the counts of
    its `reml.iterate` span)."""
    n0 = len(spans.spans())
    with profile(activities=[ProfilerActivity.CPU]):
        var = wemai.wemai_reml(dm, gmat_lst, device="cuda", **kw)
    loops = [r for r in spans.spans()[n0:] if r.name == "reml.iterate"]
    assert len(loops) == 1
    return var, loops[0].counts


def _eager_before(dm, gmat_lst, **kw):
    zg = wemai.build_zgzt_stack(dm, gmat_lst, "cuda")
    return before.wemai_reml(dm.y, dm.xmat, zg, **kw)


def _spd(n, seed, device):
    g = torch.Generator(device=device).manual_seed(seed)
    r = torch.randn(n, n, generator=g, dtype=torch.float64, device=device)
    return r @ r.T / n + torch.eye(n, dtype=torch.float64, device=device)


@pytest.fixture(scope="module")
def mouse():
    geno = torch.as_tensor(read_plink(str(DATA / "plink")))
    ag, dg = additive_grm(geno).numpy(), dominance_grm(geno).numpy()
    return design_matrix(str(DATA / "pheno"), str(DATA / "plink")), ag, dg


@pytest.fixture(scope="module")
def yeast_sized():
    """A two-GRM problem at the yeast panel's n: ag from 3,000 SNPs of
    4,168 individuals and ag⊙ag, an intercept, and two traits: one with an
    AxA part (its REML converges) and one without (its AxA variance sits at
    the boundary and REML runs to its limit)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    rng = np.random.default_rng(2104)
    n, m = YEAST_N, 3000
    p = rng.uniform(0.05, 0.95, m)
    geno = rng.binomial(2, p, size=(n, m)).astype(np.float64)
    z = torch.as_tensor(geno - 2.0 * p, device="cuda")
    ag = z @ z.T / float(np.sum(2.0 * p * (1.0 - p)))
    aa = ag * ag
    eye = torch.eye(n, dtype=torch.float64, device="cuda")
    add = z @ torch.as_tensor(rng.standard_normal(m), device="cuda")
    add = add * np.sqrt(0.5) / add.std()
    chol = torch.linalg.cholesky(aa + 1e-3 * eye)
    axa = chol @ torch.as_tensor(rng.standard_normal(n), device="cuda")
    axa = axa * np.sqrt(0.3) / axa.std()
    noise = rng.standard_normal(n) * np.sqrt(0.4)
    traits = {"converging": (add + axa).cpu().numpy() + noise + 1.0,
              "boundary": add.cpu().numpy() + noise + 1.0}
    dms = {k: DesignMatrices(y=y, xmat=np.ones((n, 1)),
                             rec_ids=np.arange(n), n_col=n)
           for k, y in traits.items()}
    return dms, [ag, aa]


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 31, 64, 65, 300, 1304, YEAST_N])
def test_inverse_matches_inv(cuda, n):
    a = _spd(n, n, cuda)
    before_launches = native.LEAF_LAUNCHES["spd_leaf_inverse"]
    inv, logdet, info = linalg.spd_inverse_logdet(a)
    want = torch.linalg.inv(a)
    torch.cuda.synchronize()
    assert (native.LEAF_LAUNCHES["spd_leaf_inverse"] - before_launches
            == -(-n // native.SPD_LEAF))
    gap = float((inv - want).abs().max() / want.abs().max())
    assert gap <= 1e-12, gap
    want_ld = torch.linalg.slogdet(a)[1]
    assert abs(float(logdet - want_ld)) <= 1e-12 * max(1.0, abs(float(want_ld)))
    assert int(info) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 2, 33, 63, 64])
def test_leaf_kernel_matches_its_plain_version(cuda, b):
    a = _spd(b, 100 + b, cuda)
    big = torch.zeros(b + 3, b + 5, dtype=torch.float64, device=cuda)
    big[1:b + 1, 2:b + 2] = a  # strided in and out
    out = torch.full_like(big, 7.0)
    logdet = torch.empty((), dtype=torch.float64, device=cuda)
    order = torch.empty((), dtype=torch.int32, device=cuda)
    native.spd_leaf_inverse(big[1:b + 1, 2:b + 2], out[2:b + 2, 1:b + 1], logdet,
                       order, 256)
    inv, ld, first = native.spd_leaf_inverse_ref(a.cpu())
    torch.cuda.synchronize()
    assert first == 0 and int(order) == 0
    got = out[2:b + 2, 1:b + 1].cpu()
    assert float((got - inv).abs().max() / inv.abs().max()) <= 1e-13
    assert abs(float(logdet) - float(ld)) <= 1e-12 * max(1.0, abs(float(ld)))
    rest = out.clone()
    rest[2:b + 2, 1:b + 1] = 7.0
    assert bool((rest == 7.0).all())  # nothing written outside the block


@pytest.mark.cuda
@pytest.mark.parametrize("bad", [0, 63, 64, 127, 200, 1303])
def test_the_first_minor_not_positive_definite(cuda, bad):
    """The order LAPACK's Cholesky reports (cuSOLVER's reads one more when
    the first bad pivot ends one of its 128-row panels, bad = 127)."""
    a = _spd(1304, 3, cuda)
    a[bad, bad] = -5.0
    assert int(linalg.spd_inverse_logdet(a)[2]) == bad + 1
    assert int(torch.linalg.cholesky_ex(a.cpu())[1]) == bad + 1


@pytest.mark.cuda
def test_chol_inv_logdet_on_the_card(cuda):
    """The eager callers keep the Cholesky inverse, bit for bit; only the
    graph's step takes the Schur complements."""
    a = _spd(500, 7, cuda)
    inv, logdet = linalg.chol_inv_logdet(a)
    inv0, logdet0 = before.chol_inv_logdet(a)
    assert torch.equal(inv, inv0) and torch.equal(logdet, logdet0)
    bad = a - 10.0 * torch.eye(500, dtype=a.dtype, device=cuda)
    with pytest.raises(torch.linalg.LinAlgError):
        before.chol_inv_logdet(bad)
    with pytest.raises(torch.linalg.LinAlgError):
        linalg.chol_inv_logdet(bad)
    # the graph's step waits for nothing and raises nothing: it returns the
    # factorizations' orders
    y = torch.ones(500, dtype=a.dtype, device=cuda)
    out = wemai._reml_step(torch.tensor([1.0, -10.0], dtype=a.dtype,
                                        device=cuda), y, y[:, None], a[None])
    assert int(out[5][0]) == int(torch.linalg.cholesky_ex(bad.cpu())[1]) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["a_axa", "a_d_axa"])
def test_graph_matches_the_eager_path_on_mouse(cuda, mouse, model):
    dm, ag, dg = mouse
    gmat_lst = [ag, ag * ag] if model == "a_axa" else [ag, dg, ag * ag]
    want, iters = _eager_before(dm, gmat_lst)
    got, counts = _reml_on_card(dm, gmat_lst)
    assert _var_gap(got, want) <= VAR_GAP, (got, want)
    assert counts["iterations"] == iters


@pytest.mark.cuda
@pytest.mark.parametrize("trait", ["converging", "boundary"])
def test_graph_matches_the_eager_path_at_the_yeast_size(cuda, yeast_sized,
                                                        trait):
    dms, gmat_lst = yeast_sized
    want, iters = _eager_before(dms[trait], gmat_lst)
    got, counts = _reml_on_card(dms[trait], gmat_lst)
    assert _var_gap(got, want) <= VAR_GAP, (got, want)
    assert counts["iterations"] == iters
    assert (iters == 200) == (trait == "boundary")


@pytest.mark.cuda
def test_replays_count_every_iteration_after_the_capture(cuda, mouse):
    dm, ag, dg = mouse
    wemai._CARDS.clear()
    leaves = native.LEAF_LAUNCHES["spd_leaf_inverse"]
    _, first = _reml_on_card(dm, [ag, ag * ag])
    assert first["replays"] == first["iterations"] - 1  # the first captures
    # every step's leaves, those of the replays too: V's and XᵀV⁻¹X's
    per_step = -(-dm.n_rec // native.SPD_LEAF) + 1
    assert (native.LEAF_LAUNCHES["spd_leaf_inverse"] - leaves
            == per_step * first["iterations"])
    _, again = _reml_on_card(dm, [ag, ag * ag], init=[0.2, 0.2, 0.6])
    assert again["replays"] == again["iterations"]  # the same shape
    _, other = _reml_on_card(dm, [ag, dg, ag * ag])
    assert other["replays"] == other["iterations"] - 1  # a new shape
    _, capped = _reml_on_card(dm, [ag, ag * ag], maxiter=3)
    assert capped == {"iterations": 3, "at_limit": 1, "replays": 2}


@pytest.mark.cuda
def test_graph_follows_a_change_of_n(cuda, mouse):
    """Traits with records missing: each new n captures anew, into the
    memory of the graph before, and reads as the eager path."""
    dm, ag, _ = mouse
    gmat_lst = [ag, ag * ag]
    keep = np.arange(dm.n_rec)
    subsets = [keep, keep[:-10], keep[::2], keep, keep[:-10]]
    wemai._CARDS.clear()
    for rows in subsets:
        sub = DesignMatrices(y=dm.y[rows], xmat=dm.xmat[rows],
                             rec_ids=dm.rec_ids[rows], n_col=dm.n_col)
        want, iters = _eager_before(sub, gmat_lst)
        got, counts = _reml_on_card(sub, gmat_lst)
        assert _var_gap(got, want) <= VAR_GAP, (len(rows), got, want)
        assert counts["iterations"] == iters
        assert counts["replays"] == iters - 1


@pytest.mark.cuda
@pytest.mark.parametrize("state", ["capturing", "replaying"])
def test_non_positive_definite_v_raises_as_before(cuda, mouse, state):
    dm, ag, _ = mouse
    gmat_lst = [ag, ag * ag]
    wemai._CARDS.clear()
    if state == "replaying":
        wemai.wemai_reml(dm, gmat_lst, maxiter=2, device="cuda")
    bad = [1.0, 1.0, -50.0]
    with pytest.raises(torch.linalg.LinAlgError) as was:
        _eager_before(dm, gmat_lst, init=bad)
    with pytest.raises(type(was.value)):
        wemai.wemai_reml(dm, gmat_lst, init=bad, device="cuda")
    # the kept graph still serves the next trait
    got = wemai.wemai_reml(dm, gmat_lst, maxiter=2, device="cuda")
    want, _ = _eager_before(dm, gmat_lst, maxiter=2)
    assert _var_gap(got, want) <= VAR_GAP
