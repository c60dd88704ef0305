"""The reference's epistasis kinds on the CPU at a small size: its AD and
DD pair tests, screens, calibration draws and dominance GRM agree with the
port's (`remma_epiAD_pair`, `remma_epiDD_pair`, `remma_epi*_eff`,
`random_pair*`, `grm.dominance_grm`), and its AxA functions return what
they returned before the kinds came (a frozen copy of them below)."""
import numpy as np
import pytest
import torch

from benchmark import check, generate
from benchmark.reference import remma as R

N, M = 240, 150
F64 = torch.float64


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """A small panel, its PLINK files, one trait and its phenotype file."""
    work = tmp_path_factory.mktemp("kinds")
    geno = generate.synthetic_panel(N, M, 8, [0.05, 0.95], 2**33 + 3,
                                    torch.device("cpu"))
    fam = [(f"f{k // 8}", f"i{k}") for k in range(N)]
    prefix = str(work / "panel")
    generate.write_plink(prefix, geno, fam)
    spec = {"polygenic": 0.5, "pairs": 3, "pair_var": 0.05, "noise": 0.4}
    xmat = np.ones((N, 1))
    y = generate.phenotypes(geno, xmat, spec, 2**33 + 3, 1)[0]
    pheno = str(work / "trait.pheno")
    generate.write_pheno(pheno, generate.pheno_lines(fam, [["1"]] * N), y)
    return {"work": work, "geno": geno, "prefix": prefix, "pheno": pheno,
            "y": torch.as_tensor(y), "x": torch.as_tensor(xmat)}


def pieces(data, terms, var):
    grm_lst = R.grms(data["geno"], terms, F64)
    py, pmat = R.pieces(var, data["y"], data["x"], grm_lst)
    return grm_lst, py, pmat


def test_dominance_grm_is_the_ports():
    from gmat_tpu_torch.grm.grm import additive_grm, dominance_grm

    geno = generate.synthetic_panel(N, M, 8, [0.05, 0.95], 7,
                                    torch.device("cpu")).to(F64)
    ag, dg, agdg = R.grms(geno, ["ag", "dg", "ag*dg"], F64)
    assert torch.equal(dg, dominance_grm(geno))
    assert torch.equal(ag, additive_grm(geno))
    assert torch.equal(agdg, ag * dg)
    with pytest.raises(ValueError):
        R.grms(geno, ["ag*xg"], F64)


@pytest.mark.parametrize("ordered", [False, True])
def test_calibration_draw_is_the_ports(tmp_path, ordered):
    from gmat_tpu_torch.scan.random_pair import random_pair, random_pairAD

    fn = random_pairAD if ordered else random_pair
    got = fn(M, str(tmp_path / "rp"), num_pair=6000, seed=5)
    want = R.random_pairs(M, 6000, 5, ordered=ordered)
    np.testing.assert_array_equal(got, want)
    assert np.all(want[:, 0] != want[:, 1])
    assert np.any(want[:, 0] > want[:, 1]) == ordered


@pytest.mark.parametrize("kind", ["AD", "DD"])
def test_pair_stats_are_the_ports(data, kind, tmp_path):
    import gmat_tpu_torch

    terms, var = ["ag", "dg"], np.array([0.4, 0.2, 0.5])
    grm_lst, py, pmat = pieces(data, terms, var)
    pairs = R.random_pairs(M, 2000, 9, ordered=R.KINDS[kind][2])
    pair_file = str(tmp_path / "pairs")
    np.savetxt(pair_file, pairs, fmt="%d", header="snp_0 snp_1",
               comments="")
    out = str(tmp_path / "out")
    getattr(gmat_tpu_torch, f"remma_epi{kind}_pair")(
        data["pheno"], data["prefix"], [g.numpy() for g in grm_lst], var,
        pair_file, p_cut=1.1, out_file=out, device="cpu")
    got = np.loadtxt(out, skiprows=1, ndmin=2)
    np.testing.assert_array_equal(got[:, :2], pairs)
    mats = R.codings(data["geno"], kind, F64)
    eff, v, chi, p = R.pair_stats(*mats, py, pmat, pairs[:, 0], pairs[:, 1])
    for col, want in zip(got[:, 2:].T, (eff, v, chi, p)):
        np.testing.assert_allclose(col, want, rtol=1e-9)


@pytest.mark.parametrize("kind", ["AA", "AD", "DD"])
def test_screen_pair_sets_are_the_ports(data, kind, tmp_path):
    """The port's `remma_epi*_eff` at a flat cut keeps the reference
    screen's pairs, a pair on one side only lying at the cut (the port
    screens in float32)."""
    import gmat_tpu_torch

    terms, var = ["ag", "ag*ag"], np.array([0.5, 0.05, 0.5])
    grm_lst, py, _ = pieces(data, terms, var)
    ordered = R.KINDS[kind][2]
    mats = R.codings(data["geno"], kind, F64)
    p_cut = 0.02
    eff_all = R.screen(*mats, py, 0.0, ordered=ordered)[2]
    var_app = float(np.median(eff_all ** 2))
    cut = np.sqrt(R.chi2_crit(p_cut) * var_app)
    out = str(tmp_path / "eff")
    getattr(gmat_tpu_torch, f"remma_epi{kind}_eff")(
        data["pheno"], data["prefix"], [g.numpy() for g in grm_lst], var,
        var_app=var_app, p_cut=p_cut, out_file=out, device="cpu")
    rows = np.loadtxt(out, skiprows=1, ndmin=2)
    got = rows[:, :2].astype(np.int64)
    si, sj, seff = R.screen(*mats, py, cut, ordered=ordered)
    assert len(si) > 50
    assert len(eff_all) == (M * (M - 1) if ordered else M * (M - 1) // 2)
    assert np.all(si != sj) and np.any(si > sj) == ordered
    ref = R.pair_stats(*mats, py, torch.eye(N, dtype=F64), got[:, 0],
                       got[:, 1])[0]
    gap = check.set_gap(M, (got[:, 0], got[:, 1]), np.abs(ref), (si, sj),
                        np.abs(seff), cut)
    assert gap < 1e-5
    # eff of the written rows is the reference's, in the port's float32
    np.testing.assert_allclose(rows[:, 2], ref, rtol=2e-3, atol=1e-4 * cut)


def test_exhaustive_pair_sets():
    """AA and DD anchors pair with j > i; AD anchors range over every SNP
    and pair with every SNP, itself too (the port's full rectangle)."""
    from gmat_tpu_torch.scan.kernels import exact_pair_count
    from gmat_tpu_torch.scan.pairs import balanced_anchor_split

    m = 37
    for ordered, mask in ((False, "tri"), (True, "rect")):
        anchors = list(R.all_anchors(m, ordered))
        pairs = R.rectangle_pairs if ordered else R.triangle_pairs
        i, j = pairs(anchors, m)
        assert len(i) == R.pair_count(anchors, m, ordered) == \
            exact_pair_count(torch.as_tensor(anchors), m, mask)
        assert len(set(zip(i.tolist(), j.tolist()))) == len(i)
        for parts in (1, 3):
            split = [R.part_anchors(m, parts, k, ordered)
                     for k in range(1, parts + 1)]
            assert split == [balanced_anchor_split(m, parts, k, not ordered)
                             for k in range(1, parts + 1)]
            assert sorted(sum(split, [])) == anchors
    assert R.pair_count(range(m), m, True) == m * m


# the AxA reference before the kinds, frozen: the kinds leave it bit for bit

def _old_grms(geno, terms, dtype):
    mat, scale = R.centered(geno, dtype)
    ag = (mat @ mat.T) / scale
    ag.diagonal().mul_(1.001)
    out = []
    for term in terms:
        g = ag
        for _ in term.split("*")[1:]:
            g = g * ag
        out.append(g)
    return out


def _old_pair_stats(mat, py, pmat, i, j):
    i, j = torch.as_tensor(i), torch.as_tensor(j)
    out = [[], [], [], []]
    for s in range(0, len(i), R.PAIR_BLOCK):
        e = mat[:, i[s:s + R.PAIR_BLOCK]] * mat[:, j[s:s + R.PAIR_BLOCK]]
        eff = e.T @ py
        var = torch.sum(e * (pmat @ e), dim=0)
        chi = eff * eff / var
        for col, x in zip(out, (eff, var, chi, R.chi2_sf(chi))):
            col.append(x.double().cpu())
    return tuple(torch.cat(c).numpy() for c in out)


def _old_screen(mat, py, cut, tf32=False):
    a, b = mat * py[:, None], mat
    if tf32:
        a, b = R.tf32_round(a), R.tf32_round(b)
    m = mat.shape[1]
    cols = torch.arange(m)
    out = [[], [], []]
    for r0 in range(0, m - 1, R.SCREEN_ROWS):
        r1 = min(r0 + R.SCREEN_ROWS, m - 1)
        s = a[:, r0:r1].T @ b
        rows = torch.arange(r0, r1)
        hit = (torch.abs(s) > cut) & (cols[None, :] > rows[:, None])
        ri, cj = torch.nonzero(hit, as_tuple=True)
        for col, x in zip(out, (ri + r0, cj, s[ri, cj])):
            col.append(x)
    return tuple(torch.cat(c).numpy() for c in out)


def _old_random_pairs(num_snp, num_pair, seed, num_each_pair=5000):
    rng = np.random.default_rng(seed)
    seen, out = set(), []
    while len(out) < num_pair:
        arr = rng.integers(0, num_snp, size=(num_each_pair, 2))
        for i, j in arr[arr[:, 0] < arr[:, 1]]:
            if (int(i), int(j)) not in seen:
                seen.add((int(i), int(j)))
                out.append((int(i), int(j)))
    return np.asarray(out[:num_pair], dtype=np.int64)


def _old_part_anchors(num_snp, n_parts, part):
    size = num_snp // (2 * n_parts)
    hi = (2 * n_parts - part + 1) * size if part != 1 else num_snp - 1
    return (list(range((part - 1) * size, part * size))
            + list(range((2 * n_parts - part) * size, hi)))


def test_axa_results_are_bit_for_bit_as_before(data):
    geno = data["geno"]
    terms, var = ["ag", "ag*ag"], np.array([0.5, 0.05, 0.5])
    for dtype in (F64, torch.float32):
        for new, old in zip(R.grms(geno, terms, dtype),
                            _old_grms(geno, terms, dtype)):
            assert torch.equal(new, old)
    grm_lst, py, pmat = pieces(data, terms, var)
    mat = R.centered(geno, F64)[0]
    mats = R.codings(geno, "AA", F64)
    assert mats[0] is mats[1] and torch.equal(mats[0], mat)
    calib = R.random_pairs(M, 3000, 0)
    np.testing.assert_array_equal(calib, _old_random_pairs(M, 3000, 0))
    for new, old in zip(R.pair_stats(*mats, py, pmat, calib[:, 0],
                                     calib[:, 1]),
                        _old_pair_stats(mat, py, pmat, calib[:, 0],
                                        calib[:, 1])):
        np.testing.assert_array_equal(new, old)
    for tf32, dtype in ((False, F64), (True, torch.float32)):
        m32 = mat.to(dtype)
        for new, old in zip(R.screen(m32, m32, py.to(dtype), 0.05,
                                     tf32=tf32),
                            _old_screen(m32, py.to(dtype), 0.05, tf32)):
            np.testing.assert_array_equal(new, old)
    for parts, part in ((1, 1), (4, 1), (4, 3)):
        assert R.part_anchors(M, parts, part) == _old_part_anchors(
            M, parts, part)
    anchors = _old_part_anchors(M, 4, 2)
    i, j = R.triangle_pairs(anchors, M)
    rows = R.exact_scan(*mats, py, pmat, anchors, 0.05)
    old = _old_pair_stats(mat, py, pmat, i, j)
    hit = old[2] > R.chi2_crit(0.05)
    for new, want in zip(rows, (i, j) + old):
        np.testing.assert_array_equal(new, want[hit])
