"""The benchmark's inputs, made from the seed: genotype panels, the PLINK
files the program reads, and each trait's phenotype.

A configuration file names its panel:
- `"panel": {"synthetic": ...}` draws full-sib families on the device
  (allele frequencies p ~ U(lo, hi), two random parents per family,
  Mendelian transmission, SNPs independent), the recipe of the repo's
  chip smoke test at the upstream yeast shape;
- `"panel": {"plink": "<prefix under benchmark/>"}` reads a real PLINK
  set.
Its `"phenotype"` gives the variance of the polygenic additive part, the
number and variance of planted AxA pairs, the noise variance and the
covariate file (if any).  Every draw is on the device from a
`torch.Generator` seeded by (seed, stream), so one seed gives one set of
inputs.  `at_boundary` names the traits whose REML runs to its iteration
limit, for a mix that fixes their place in the window.
"""
from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import remma as R

_MAGIC = b"\x6c\x1b\x01"
_CODE_OF_DOSAGE = torch.tensor([0, 2, 3], dtype=torch.uint8)  # PLINK codes


def generator(seed, stream, device):
    """A torch.Generator on `device` for draw stream `stream` of `seed`."""
    state = np.random.SeedSequence([int(seed), int(stream)]).generate_state(
        2, np.uint32)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(state[0]) << 32 | int(state[1]))
    return gen


def synthetic_panel(n, m, family, freq_range, seed, device):
    """(n, m) int8 dosages of `n // family` full-sib families."""
    gen = generator(seed, 0, device)
    lo, hi = freq_range
    freq = lo + (hi - lo) * torch.rand(m, generator=gen, device=device)
    fams = n // family
    # family, parent, haplotype, SNP
    parents = torch.rand((fams, 2, 2, m), generator=gen, device=device) < freq
    geno = torch.zeros((fams, family, m), dtype=torch.int8, device=device)
    for q in range(2):
        pick = torch.rand((fams, family, m), generator=gen,
                          device=device) < 0.5
        geno += torch.where(pick, parents[:, None, q, 1],
                            parents[:, None, q, 0]).to(torch.int8)
    return geno.reshape(n, m)


def write_plink(prefix, geno, fam_ids):
    """Write dosages (n, m) int8 as `<prefix>.bed/.bim/.fam`."""
    n, m = geno.shape
    codes = _CODE_OF_DOSAGE.to(geno.device)[geno.long()]
    pad = (-n) % 4
    if pad:
        codes = torch.cat([codes, torch.zeros((pad, m), dtype=torch.uint8,
                                              device=geno.device)])
    quad = codes.T.reshape(m, -1, 4)
    packed = (quad[..., 0] | (quad[..., 1] << 2) | (quad[..., 2] << 4)
              | (quad[..., 3] << 6))
    with open(prefix + ".bed", "wb") as f:
        f.write(_MAGIC)
        f.write(packed.cpu().numpy().tobytes())
    with open(prefix + ".bim", "w") as f:
        f.write("".join(f"1\tsnp{j}\t0\t{j + 1}\tA\tB\n" for j in range(m)))
    with open(prefix + ".fam", "w") as f:
        f.write("".join(f"{fid}\t{iid}\t0\t0\t0\t-9\n" for fid, iid in fam_ids))


def read_plink(prefix):
    """(dosages (n, m) int8 numpy, [(fid, iid)]) of a PLINK set without
    missing genotypes."""
    with open(prefix + ".fam") as f:
        fam_ids = [tuple(line.split()[:2]) for line in f if line.strip()]
    with open(prefix + ".bim") as f:
        m = sum(1 for line in f if line.strip())
    n = len(fam_ids)
    raw = np.fromfile(prefix + ".bed", dtype=np.uint8)
    if raw[:3].tobytes() != _MAGIC:
        raise ValueError(f"{prefix}.bed is not a SNP-major PLINK file")
    raw = raw[3:].reshape(m, -1)
    codes = np.stack([(raw >> s) & 3 for s in (0, 2, 4, 6)], axis=2)
    codes = codes.reshape(m, -1)[:, :n].T
    if np.any(codes == 1):
        raise ValueError(f"{prefix}.bed has missing genotypes")
    dosage = np.array([0, 0, 1, 2], dtype=np.int8)
    return dosage[codes], fam_ids


def read_covariates(path):
    """(fam ids, covariate tokens as strings, covariates (n, c) float64)
    of a `fid iid c1 .. cc` file."""
    ids, toks = [], []
    with open(path) as f:
        for line in f:
            arr = line.split()
            if arr:
                ids.append((arr[0], arr[1]))
                toks.append(arr[2:])
    return ids, toks, np.asarray(toks, dtype=np.float64)


def phenotypes(geno, xmat, spec, seed, count):
    """(count, n) float64 traits as a numpy array: X b (b ~ N(0, 1) for a
    constant column, N(0, 0.25 / var) for the others), a polygenic
    additive part, the planted AxA pairs each standardised to its variance
    (pairs i < j at positions drawn for each trait), and noise."""
    dev = geno.device
    gen = generator(seed, 1, dev)
    g = geno.to(torch.float64)
    freq = g.sum(dim=0) / (2.0 * g.shape[0])
    mat = g - 2.0 * freq
    n, m = mat.shape
    scale = torch.sum(2.0 * freq * (1.0 - freq))
    beta = torch.randn((m, count), generator=gen, device=dev,
                       dtype=torch.float64)
    y = (mat @ beta).T * torch.sqrt(spec["polygenic"] / scale)
    x = torch.as_tensor(xmat, dtype=torch.float64, device=dev)
    sd = x.std(dim=0)
    b_scale = torch.where(sd > 0, 0.5 / torch.clamp(sd, min=1e-300),
                          torch.ones_like(sd))
    b = torch.randn((count, x.shape[1]), generator=gen, device=dev,
                    dtype=torch.float64) * b_scale
    y = y + b @ x.T
    k = spec["pairs"]
    planted = torch.empty((count, k, 2), dtype=torch.int64, device=dev)
    for t in range(count):
        pairs = set()
        while len(pairs) < k:
            a, c = torch.randint(0, m, (2,), generator=gen,
                                 device=dev).tolist()
            if a != c:
                pairs.add((min(a, c), max(a, c)))
        planted[t] = torch.as_tensor(sorted(pairs), device=dev)
    z = mat[:, planted[..., 0]] * mat[:, planted[..., 1]]  # (n, count, k)
    z = (z - z.mean(dim=0)) / z.std(dim=0)
    y = y + np.sqrt(spec["pair_var"]) * z.sum(dim=2).T
    y = y + np.sqrt(spec["noise"]) * torch.randn(
        (count, n), generator=gen, device=dev, dtype=torch.float64)
    return y.cpu().numpy()


def pheno_lines(fam_ids, cov_toks):
    """The fixed head `fid iid c1 .. cc ` of each phenotype line."""
    return [" ".join([fid, iid, *toks]) + " " for (fid, iid), toks
            in zip(fam_ids, cov_toks)]


def write_pheno(path, heads, y):
    """One record per individual, y with every digit (`%.17g`)."""
    with open(path, "w") as f:
        f.write("".join(f"{h}{v:.17g}\n" for h, v in zip(heads, y.tolist())))


def at_boundary(geno, xmat, traits, terms):
    """For each trait, whether REML's maximum of the last GRM's variance
    lies at its boundary 0: the score of that variance at 0 is not
    positive where the others take their REML estimates without it.

    Those estimates come from the first GRM's eigenbasis (`terms` has two
    entries, the first a GRM of its own), one variance ratio a trait,
    found on a log grid and refined by golden sections; everything is
    float64 on geno's device.  Upstream's EM + AI iteration runs to its
    iteration limit on such a trait, as its gradient never vanishes."""
    if len(terms) != 2:
        raise ValueError("at_boundary tests the second of two GRMs")
    dev = geno.device
    f64 = torch.float64
    g1, g2 = R.grms(geno, terms, f64)
    lam, u = torch.linalg.eigh(g1)
    del g1
    k2 = u.T @ (g2 @ u)
    del g2
    x = u.T @ torch.as_tensor(xmat, dtype=f64, device=dev)
    y = u.T @ torch.as_tensor(np.asarray(traits), dtype=f64, device=dev).T
    n, p = x.shape

    def fit(log_ratio):
        """(D (n, t), C (t, p, p), P̃y (n, t), y'P̃y (t,), REML profile
        (t,)) at the variance ratios σ²_1 / σ²_e = exp(log_ratio), where
        V = σ²_e D and P̃ = σ²_e P."""
        d = torch.exp(log_ratio)[None, :] * lam[:, None] + 1.0
        xdx = torch.einsum("ia,it,ib->tab", x, 1.0 / d, x)
        c = torch.linalg.inv(xdx)
        xdy = torch.einsum("ia,it->ta", x, y / d)
        py = (y - x @ torch.einsum("tab,tb->at", c, xdy)) / d
        sse = torch.sum(y * py, dim=0)
        prof = -0.5 * ((n - p) * torch.log(sse) + torch.sum(torch.log(d), 0)
                       + torch.logdet(xdx))
        return d, c, py, sse, prof

    grid = torch.linspace(-12.0, 12.0, 241, dtype=f64, device=dev)
    profs = torch.stack([fit(g.expand(y.shape[1]))[4] for g in grid])
    best = grid[torch.argmax(profs, dim=0)]
    lo, hi = best - 0.1, best + 0.1
    phi = (5.0 ** 0.5 - 1.0) / 2.0
    for _ in range(60):
        a, b = hi - phi * (hi - lo), lo + phi * (hi - lo)
        left = fit(a)[4] > fit(b)[4]
        lo, hi = torch.where(left, lo, a), torch.where(left, b, hi)
    d, c, py, sse, _ = fit((lo + hi) / 2.0)
    # twice the score of σ²_2 at 0, times σ²_e: P̃y' K P̃y / σ²_e - tr(P̃ K)
    sigma_e = sse / (n - p)
    quad = torch.sum(py * (k2 @ py), dim=0) / sigma_e
    dx = x[:, None, :] / d[:, :, None]  # D⁻¹ X, (n, t, p)
    kdx = (k2 @ dx.reshape(n, -1)).reshape(dx.shape)
    trace = (torch.sum(torch.diagonal(k2)[:, None] / d, dim=0)
             - torch.einsum("tab,itb,ita->t", c, dx, kdx))
    return (quad - trace <= 0.0).cpu().numpy()
