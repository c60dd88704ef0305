"""What the REMMA families (`approx.py`, `exhaustive.py`) share: the traits
of the REMMA recipe, each unit's phenotype file, the program's GRMs and
REML, the control's float32 twins of them, the scan table read back, and
the float64 check of REML that frames each family's own numbers.  Not a
family.

A REMMA mix names the public entry point of `gmat_tpu_torch` (`"scan"`)
and its arguments (`"args"`), and may name its epistasis kind (`"kind"`:
AA, AD or DD, AA where it names none), which sets the codings, the pair
set and the calibration draw of the reference (`reference/remma.py`).
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from benchmark import check, generate
from benchmark.reference import remma as R

HERE = Path(__file__).resolve().parents[1]
ROW_KEYS = ("i", "j", "eff", "var", "chi", "p")


def ordered(ctx):
    """Whether the mix's kind pairs SNPs in order (AD)."""
    return R.KINDS[ctx.kind][2]


def anchors(ctx, part=None):
    """The anchors of an exhaustive unit: all of them, or those of part
    `part` of the mix's split."""
    if part is None:
        return R.all_anchors(ctx.n_snp, ordered(ctx))
    return R.part_anchors(ctx.n_snp, ctx.traffic["parts"], part,
                          ordered(ctx))


def inputs(ctx):
    """The covariates (the configuration's file, or an intercept), each
    phenotype line's head and the pool of traits from the seed
    (`generate.phenotypes`): `ctx.xmat`, `ctx.heads`, `ctx.traits`."""
    spec = ctx.config["phenotype"]
    cov = spec.get("covariates")
    if cov:
        ids, toks, ctx.xmat = generate.read_covariates(str(HERE / cov))
        if ids != ctx.fam_ids:
            raise ValueError("covariate ids differ from the panel's")
    else:
        toks = [["1"]] * ctx.n_id
        ctx.xmat = np.ones((ctx.n_id, 1))
    ctx.heads = generate.pheno_lines(ctx.fam_ids, toks)
    ctx.traits = generate.phenotypes(ctx.geno, ctx.xmat, spec, ctx.seed,
                                     ctx.traffic["pool"])


def boundary(ctx):
    """For each trait of the pool, whether its REML maximum of the last
    GRM's variance lies at the boundary 0 (`generate.at_boundary`)."""
    return generate.at_boundary(ctx.geno, ctx.xmat, ctx.traits,
                                ctx.config["model"]["grms"])


def write_inputs(ctx, trait, stem):
    """The trait's phenotype file `<stem>.pheno`; returns its path."""
    pheno = f"{stem}.pheno"
    generate.write_pheno(pheno, ctx.heads, ctx.traits[trait])
    return pheno


def read(path):
    """The rows of a scan table as {i, j, eff, var, chi, p} arrays: the
    approx merge `snp_0 snp_1 eff var chi p_app p` or the exhaustive
    `snp_0 snp_1 eff chi p_val` (var then NaN)."""
    with open(path) as f:
        head = f.readline().split()
        body = np.loadtxt(f, ndmin=2)
    if body.size == 0:
        body = np.empty((0, len(head)))
    col = {name: body[:, k] for k, name in enumerate(head)}
    if "var" in col:
        stats = (col["eff"], col["var"], col["chi"], col[head[-1]])
    else:
        stats = (col["eff"], np.full(len(body), np.nan), col["chi"],
                 col[head[-1]])
    return dict(zip(ROW_KEYS, (body[:, 0].astype(np.int64),
                               body[:, 1].astype(np.int64)) + stats))


class Program:
    """gmat_tpu_torch on `device`, as a user's script drives it: the GRMs
    (`grm_products`), REML (`wemai_multi_gmat`) and the mix's scan, files
    in, files out."""

    def __init__(self, device):
        self.device = device

    def build(self):
        """Compile (first run) or find the kernels' library."""
        if self.device.type == "cuda":
            from gmat_tpu_torch.scan.kernels import build_library

            build_library()

    def setup(self, ctx):
        from gmat_tpu_torch.pipeline.remmax import grm_products

        return grm_products(ctx.config["model"]["grms"], ctx.prefix,
                            device=self.device)

    def reml(self, ctx, trait, pheno, out):
        from gmat_tpu_torch import wemai_multi_gmat

        return np.asarray(wemai_multi_gmat(pheno, ctx.prefix, ctx.product,
                                           out_file=out, device=self.device))

    def run_scan(self, ctx, pheno, var, out, **extra):
        """The mix's entry point with its arguments and `extra`."""
        import gmat_tpu_torch

        fn = getattr(gmat_tpu_torch, ctx.traffic["scan"])
        fn(pheno, ctx.prefix, ctx.product, var, out_file=out,
           device=self.device, **dict(ctx.traffic["args"], **extra))


class Control:
    """The reference in the program's place, one precision lower: float32
    codings, GRMs, REML and pieces."""

    def __init__(self, device):
        self.device = device
        self.mats = None

    def build(self):
        pass

    def setup(self, ctx):
        self.mats = R.codings(ctx.geno, ctx.kind, torch.float32)
        return R.grms(ctx.geno, ctx.config["model"]["grms"], torch.float32)

    def _design(self, ctx, trait):
        y = torch.as_tensor(ctx.traits[trait], dtype=torch.float32,
                            device=self.device)
        x = torch.as_tensor(ctx.xmat, dtype=torch.float32, device=self.device)
        return y, x

    def reml(self, ctx, trait, pheno, out):
        y, x = self._design(ctx, trait)
        return R.reml(y, x, ctx.product)[0]

    def pieces(self, ctx, trait, var):
        """(py, P) of the trait at the variances `var`."""
        y, x = self._design(ctx, trait)
        return R.pieces(var, y, x, ctx.product)


class Reference:
    """The float64 reference of one run's check, on the run's device: the
    mix kind's codings (`mats`), the GRMs, X, and each trait's REML,
    worked out once."""

    def __init__(self, ctx):
        f64, dev = torch.float64, ctx.device
        geno = ctx.geno.to(dev)
        self.ctx = ctx
        self.mats = R.codings(geno, ctx.kind, f64)
        self.grm_lst = R.grms(geno, ctx.config["model"]["grms"], f64)
        self.x = torch.as_tensor(ctx.xmat, dtype=f64, device=dev)
        self.var = {}  # trait -> (variances, converged)

    def y(self, trait):
        return torch.as_tensor(self.ctx.traits[trait], dtype=torch.float64,
                               device=self.ctx.device)

    def reml(self, trait):
        if trait not in self.var:
            self.var[trait] = R.reml(self.y(trait), self.x, self.grm_lst)
        return self.var[trait]

    def pieces(self, trait, var):
        return R.pieces(var, self.y(trait), self.x, self.grm_lst)


def run_check(ctx, units, log, names, unit_gaps):
    """{"var_gap", *names}: REML's `var_gap` and the family's numbers.

    `var_gap` is the largest gap of a variance component, relative to it
    or to the median component, over the sampled units whose reference
    REML converged.  A unit whose reference REML stops at its iteration
    limit (a component's maximum at its boundary) is not sound for it:
    both sides return a last iterate, not an estimate.  It is named on
    standard error and left out, and where no sampled unit converged,
    further completed units' REML are worked out in an order drawn from
    the seed until one has; only where none has does `var_gap` compare the
    last iterates, and says so.  For each sampled unit,
    `unit_gaps(ref, unit, py, pmat, pair_ref, gaps)` raises `gaps` by the
    family's numbers, where `pair_ref` is the reference's (eff, var, chi,
    p) of the unit's rows."""
    ref = Reference(ctx)
    gaps = dict.fromkeys(("var_gap",) + tuple(names), 0.0)
    sound, loose = [], []  # (trait, var_gap): reference converged / not

    def reference_var(unit):
        var, converged = ref.reml(unit.trait)
        (sound if converged else loose).append(
            (unit.trait, check.var_gap(unit.var, var)))
        return var

    for unit in units:
        var = reference_var(unit)
        py, pmat = ref.pieces(unit.trait, var)
        rows = unit.out
        pair_ref = R.pair_stats(*ref.mats, py, pmat, rows["i"], rows["j"])
        unit_gaps(ref, unit, py, pmat, pair_ref, gaps)
    if units and not sound:
        rest = [u for u in ctx.done if u not in units]
        order = np.random.default_rng([ctx.seed, 4]).permutation(len(rest))
        for k in order:
            if rest[k].trait not in ref.var:
                reference_var(rest[k])
                if sound:
                    break
    for _, gap in sound or loose:
        gaps["var_gap"] = check.worst(gaps["var_gap"], gap)
    if loose:
        traits = sorted({t for t, _ in loose})
        print(f"check note: the reference REML of trait(s) {traits} stopped "
              "at its iteration limit without converging; var_gap "
              + ("leaves them out" if sound else
                 "compares their last iterates, since no completed unit's "
                 "REML converged"), file=log)
    return gaps
