"""REMMA (random SNP-BLUP mixed-model epistasis tests), written plainly.

Model, with one record per individual in .fam order (Z = I):

    y = X b + u_1 + ... + u_k + e,   u_i ~ N(0, σ²_i G_i),  e ~ N(0, σ²_e I)

- Codings: the additive M = g - 2p (allele frequency p), scale
  Σ 2p(1-p); the dominance D = het - s (het: g with 2 recoded to 0,
  s = 2p(1-p)), scale Σ s(1-s).
- GRMs: ag = M Mᵀ / Σ 2p(1-p), dg = D Dᵀ / Σ s(1-s), each with the
  diagonal times 1.001; the configuration names the terms ("ag", "dg",
  and elementwise products such as "ag*ag", "ag*dg", "dg*dg").
- REML by upstream GMAT's weighted EM + AI iteration (`reml`), which
  reports whether it converged within its iteration limit.
- Score pieces: P = V⁻¹ - V⁻¹X (XᵀV⁻¹X)⁻¹ XᵀV⁻¹, py = P y.
- An epistasis kind (`KINDS`) codes the first SNP of a pair (i, j) and
  the second: AA by (M, M), AD by (M, D), DD by (D, D).  Its test:
  e = mat0_i ⊙ mat1_j, eff = eᵀ py, var = eᵀ P e, chi = eff² / var,
  p = erfc(sqrt(chi / 2)).
- Pair sets: AA and DD take the pairs j > i; AD is ordered, and its
  screen and calibration draw take every (i, j) with i != j, its
  exhaustive scan every (i, j), i == j too (upstream's full rectangle).
- The effect screen keeps the pairs of the kind's set with |eff| >
  sqrt(chi_crit(p) · median var of the calibration pairs).

Every function takes a `dtype`: float64 is the reference; float32 (and
TF32 for the screen, by `tf32_round`) is the lower precision that the
benchmark's control runs in the program's place.
"""
from __future__ import annotations

import numpy as np
import torch

PAIR_BLOCK = 1 << 15  # pairs per block of e (n x block)
SCREEN_ROWS = 1024  # anchors per block of the full effect matrix


def tf32_round(x):
    """float32 `x` rounded to TF32 (10 explicit mantissa bits), as the
    TF32 tensor cores round a product's operands."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


def chi2_crit(p_cut):
    """chi such that P[Chi²₁ > chi] = p_cut, in float64."""
    z = torch.special.erfinv(torch.tensor(1.0 - p_cut, dtype=torch.float64))
    return float(2.0 * z * z)


def chi2_sf(chi):
    """P[Chi²₁ > chi] (erfc identity), in chi's dtype."""
    return torch.special.erfc(torch.sqrt(torch.clamp(chi, min=0.0) / 2.0))


#: kind -> (coding of the pair's first SNP, of its second, ordered pairs)
KINDS = {"AA": ("add", "add", False),
         "AD": ("add", "dom", True),
         "DD": ("dom", "dom", False)}


def centered(geno, dtype):
    """(M, scale): the centred additive coding g - 2p and Σ 2p(1-p)."""
    g = geno.to(dtype)
    freq = g.sum(dim=0) / (2.0 * g.shape[0])
    return g - 2.0 * freq, torch.sum(2.0 * freq * (1.0 - freq))


def dominance(geno, dtype):
    """(D, scale): the heterozygote indicator (g = 2 recoded to 0) minus
    s = 2p(1-p), and Σ s(1-s)."""
    g = geno.to(dtype)
    freq = g.sum(dim=0) / (2.0 * g.shape[0])
    s = 2.0 * freq * (1.0 - freq)
    het = torch.where(g > 1.5, torch.zeros_like(g), g)
    return het - s, torch.sum(s * (1.0 - s))


_CODING = {"add": centered, "dom": dominance}


def codings(geno, kind, dtype):
    """(mat0, mat1): the codings of the first and the second SNP of a pair
    of `kind`, one tensor where the two are the same."""
    first, second, _ = KINDS[kind]
    mat0 = _CODING[first](geno, dtype)[0]
    return mat0, (mat0 if second == first
                  else _CODING[second](geno, dtype)[0])


def grms(geno, terms, dtype):
    """The GRMs named by `terms`: "ag", "dg" and their elementwise
    products ("ag*ag", "ag*dg", "dg*dg", ...)."""
    base = {}
    out = []
    for term in terms:
        parts = [t.strip() for t in term.split("*")]
        for part in parts:
            if part not in ("ag", "dg"):
                raise ValueError(f"the reference has no GRM term {term!r}")
            if part not in base:
                mat, scale = _CODING["add" if part == "ag" else "dom"](
                    geno, dtype)
                base[part] = (mat @ mat.T) / scale
                base[part].diagonal().mul_(1.001)
        g = base[parts[0]]
        for part in parts[1:]:
            g = g * base[part]
        out.append(g)
    return out


def _projection(var, grm_lst, xmat):
    """P at the variances `var`."""
    n = xmat.shape[0]
    vmat = var[-1] * torch.eye(n, dtype=xmat.dtype, device=xmat.device)
    for v, g in zip(var[:-1], grm_lst):
        vmat = vmat + v * g
    vinv = torch.cholesky_inverse(torch.linalg.cholesky(vmat))
    vx = vinv @ xmat
    return vinv - vx @ torch.linalg.solve(xmat.T @ vx, vx.T)


def reml(y, xmat, grm_lst, maxiter=200, cc_par=1e-8, cc_gra=1e-6):
    """(variance components σ²_1 .. σ²_k, σ²_e as a float64 numpy vector,
    converged), computed in y's dtype, by the weighted EM + AI iteration of
    upstream GMAT's `wemai_multi_gmat` with its defaults: from all ones,
    each step solves ((1-w)·AI + w·EM) Δ = ∇ for the first w in 0, 0.01,
    .., 1 that keeps every variance positive (EM = diag(n / σ⁴)), until
    ‖Δ‖/‖σ²‖ < cc_par and ‖∇‖ < cc_gra.  `converged` is False when the
    iteration stops at `maxiter` instead, as it can where a component's
    maximum lies at its boundary 0: the variances are then the last
    iterate, no estimate."""
    n = y.shape[0]
    var = torch.ones(len(grm_lst) + 1, dtype=y.dtype, device=y.device)
    for _ in range(maxiter):
        pmat = _projection(var, grm_lst, xmat)
        py = pmat @ y
        gpy = [g @ py for g in grm_lst]
        grad = 0.5 * torch.stack(
            [torch.dot(py, gp) - torch.sum(pmat * g)
             for g, gp in zip(grm_lst, gpy)]
            + [torch.dot(py, py) - torch.trace(pmat)])
        w = torch.stack(gpy + [py], dim=1)
        ai = 0.5 * w.T @ (pmat @ w)
        em = torch.diag(n / (var * var))
        weight = torch.linspace(0.0, 1.0, 101, dtype=y.dtype,
                                device=y.device)[:, None, None]
        steps = torch.linalg.solve_ex((1.0 - weight) * ai + weight * em,
                                      grad.expand(101, -1))[0]
        ok = torch.nonzero(torch.all(var + steps > 0, dim=1)).flatten()
        step = steps[ok[0] if len(ok) else -1]
        var = var + step
        if (float(torch.linalg.norm(step) / torch.linalg.norm(var)) < cc_par
                and float(torch.linalg.norm(grad)) < cc_gra):
            return var.double().cpu().numpy(), True
    return var.double().cpu().numpy(), False


def pieces(var, y, xmat, grm_lst):
    """(py, P) at the variances `var`, in y's dtype."""
    var = torch.as_tensor(np.asarray(var), dtype=y.dtype, device=y.device)
    pmat = _projection(var, grm_lst, xmat)
    return pmat @ y, pmat


def pair_stats(mat0, mat1, py, pmat, i, j):
    """(eff, var, chi, p) of the pairs (i[k], j[k]) as float64 numpy
    arrays, e = mat0[:, i] ⊙ mat1[:, j], computed in mat0's dtype,
    `PAIR_BLOCK` pairs at a time."""
    i = torch.as_tensor(np.asarray(i, dtype=np.int64), device=mat0.device)
    j = torch.as_tensor(np.asarray(j, dtype=np.int64), device=mat0.device)
    out = [[], [], [], []]
    for s in range(0, len(i), PAIR_BLOCK):
        e = mat0[:, i[s:s + PAIR_BLOCK]] * mat1[:, j[s:s + PAIR_BLOCK]]
        eff = e.T @ py
        var = torch.sum(e * (pmat @ e), dim=0)
        chi = eff * eff / var
        for col, x in zip(out, (eff, var, chi, chi2_sf(chi))):
            col.append(x.double().cpu())
    return tuple(torch.cat(c).numpy() if c else np.empty(0) for c in out)


def triangle_pairs(anchors, num_snp):
    """(i, j) of every pair j > i of the anchors, anchors in list order
    and partners ascending."""
    anchors = np.asarray(anchors, dtype=np.int64)
    counts = num_snp - 1 - anchors
    i = np.repeat(anchors, counts)
    start = np.repeat(np.cumsum(counts) - counts, counts)
    j = i + 1 + (np.arange(counts.sum()) - start)
    return i, j


def rectangle_pairs(anchors, num_snp):
    """(i, j) of every pair of an anchor and any SNP, i == j too, anchors
    in list order and partners ascending."""
    anchors = np.asarray(anchors, dtype=np.int64)
    return (np.repeat(anchors, num_snp),
            np.tile(np.arange(num_snp, dtype=np.int64), len(anchors)))


def pair_count(anchors, num_snp, ordered=False):
    """The number of pairs that `exact_scan` tests for `anchors`."""
    anchors = np.asarray(list(anchors), dtype=np.int64)
    if ordered:
        return len(anchors) * num_snp
    return int(np.sum(num_snp - 1 - anchors))


def all_anchors(num_snp, ordered=False):
    """The anchors of a whole exhaustive scan: all but the last SNP (which
    has no partner j > i), every SNP where `ordered`."""
    return range(num_snp if ordered else num_snp - 1)


def exact_scan(mat0, mat1, py, pmat, anchors, p_cut, ordered=False):
    """Rows (i, j, eff, var, chi, p) of the pairs of `anchors` (j > i,
    or with `ordered` (AD) every partner) with chi > chi_crit(p_cut),
    every pair tested; at a p_cut of 1 or more, every pair whose chi is
    not NaN (the whole table)."""
    pairs = rectangle_pairs if ordered else triangle_pairs
    i, j = pairs(anchors, mat0.shape[1])
    crit = chi2_crit(p_cut) if p_cut < 1.0 else None
    keep = [[] for _ in range(6)]
    for s in range(0, len(i), 8 * PAIR_BLOCK):
        bi, bj = i[s:s + 8 * PAIR_BLOCK], j[s:s + 8 * PAIR_BLOCK]
        stats = pair_stats(mat0, mat1, py, pmat, bi, bj)
        hit = ~np.isnan(stats[2]) if crit is None else stats[2] > crit
        for col, x in zip(keep, (bi, bj) + stats):
            col.append(x[hit])
    return tuple(np.concatenate(c) for c in keep)


def screen(mat0, mat1, py, cut, ordered=False, tf32=False):
    """(i, j, eff) of every pair j > i, or with `ordered` every (i, j)
    with i != j, whose eff = Σ mat0_i py mat1_j has |eff| > cut, in mat0's
    dtype, rows ascending; with `tf32` both operands of the product are
    rounded to TF32."""
    a = mat0 * py[:, None]
    b = mat1
    if tf32:
        a, b = tf32_round(a), tf32_round(b)
    m = mat0.shape[1]
    last = m if ordered else m - 1  # the rows that have a partner
    cols = torch.arange(m, device=mat0.device)
    out = [[], [], []]
    for r0 in range(0, last, SCREEN_ROWS):
        r1 = min(r0 + SCREEN_ROWS, last)
        s = a[:, r0:r1].T @ b
        rows = torch.arange(r0, r1, device=mat0.device)
        pair = ((cols[None, :] != rows[:, None]) if ordered
                else (cols[None, :] > rows[:, None]))
        hit = (torch.abs(s) > cut) & pair
        ri, cj = torch.nonzero(hit, as_tuple=True)
        for col, x in zip(out, (ri + r0, cj, s[ri, cj])):
            col.append(x.cpu())
    return tuple(torch.cat(c).numpy() for c in out)


def random_pairs(num_snp, num_pair, seed, num_each_pair=5000,
                 ordered=False):
    """The calibration pairs of the approx pipeline: unique (i < j) pairs,
    or with `ordered` (AD) unique (i != j) pairs, rejection-sampled from
    numpy's default_rng(seed), as the upstream `random_pair` and
    `random_pairAD` draw them."""
    rng = np.random.default_rng(seed)
    seen = set()
    out = []
    while len(out) < num_pair:
        arr = rng.integers(0, num_snp, size=(num_each_pair, 2))
        keep = (arr[:, 0] != arr[:, 1]) if ordered else (arr[:, 0] < arr[:, 1])
        for i, j in arr[keep]:
            key = (int(i), int(j))
            if key not in seen:
                seen.add(key)
                out.append(key)
    return np.asarray(out[:num_pair], dtype=np.int64)


def part_anchors(num_snp, n_parts, part, ordered=False):
    """The anchors of part `part` of the upstream balanced triangular
    split into `n_parts`: blocks part-1 and 2·n_parts-part of
    num_snp // (2·n_parts) anchors, part 1 also taking the remainder, up
    to the last anchor of `all_anchors`."""
    size = num_snp // (2 * n_parts)
    hi = ((2 * n_parts - part + 1) * size if part != 1
          else len(all_anchors(num_snp, ordered)))
    return (list(range((part - 1) * size, part * size))
            + list(range((2 * n_parts - part) * size, hi)))
