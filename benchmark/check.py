"""The check of what the window produced, against the plain reference.

After the window, a sample of the completed units drawn from the seed (the
longest among them) is worked out again by `reference/remma.py` in
float64 from the benchmark's own inputs: the GRMs, REML, P and py, and
then what the unit's scan wrote, in the codings and over the pair set of
the mix's epistasis kind (`Context.kind`).  Each number is held to its
limit in the traffic mix's `"check"`:

- `var_gap`: the largest gap of a variance component, relative to it or
  to the median component, whichever is larger, over the sampled units
  whose reference REML converged.  A unit whose reference REML stops at
  its iteration limit (a component's maximum at its boundary) is not
  sound for it: both sides return a last iterate, not an estimate.  It
  is named on standard error and left out, and where no sampled unit
  converged, further completed units' REML are worked out in an order
  drawn from the seed until one has; only where none has does `var_gap`
  compare the last iterates, and says so;
- `stat_gap` (approx): the largest relative gap of a written row's eff,
  var and chi, and of its p on the log scale, against the reference's
  test of that pair;
- `screen_gap` (approx): the rows' pair set against the pairs whose
  reference effect passes the calibrated cut.  A pair on one side only is
  allowed only at the cut: the number is the largest relative distance of
  such a pair's reference |eff| from the cut, 0 when the sets are equal;
- `row_gap` (exhaustive): `stat_gap` of the rows, and a pair on one side
  only of the rows and of the reference's pairs past chi_crit(p_cut) at
  the relative distance of its reference chi from chi_crit.
"""
from __future__ import annotations

import math
import sys

import numpy as np
import torch

from benchmark.reference import remma as R


def worst(a, b):
    """The larger of two gaps, NaN when either is NaN."""
    return math.nan if (math.isnan(a) or math.isnan(b)) else max(a, b)


def sample(ctx):
    """The checked units: all, or the longest and others drawn from the
    seed, `check.units` in all."""
    done = ctx.done
    count = ctx.traffic["check"]["units"]
    if len(done) <= count:
        return done
    longest = max(done, key=lambda u: u.end - u.start)
    others = [u for u in done if u is not longest]
    rng = np.random.default_rng([ctx.seed, 3])
    pick = sorted(rng.choice(len(others), count - 1, replace=False))
    return [longest] + [others[k] for k in pick]


def rel_gap(got, want):
    got, want = np.asarray(got, float), np.asarray(want, float)
    if got.size == 0:
        return 0.0
    return float(np.max(np.abs(got - want) / np.abs(want)))


def var_gap(got, want):
    """Largest gap of a variance component, relative to the component or
    to the median component, whichever is larger (a component at the
    boundary is all but zero)."""
    got, want = np.asarray(got, float), np.asarray(want, float)
    scale = np.maximum(np.abs(want), np.median(np.abs(want)))
    return float(np.max(np.abs(got - want) / scale))


def stat_gap(rows, ref):
    """Largest relative gap of eff, var (where written), chi, and log p."""
    eff, var, chi, p = ref
    gap = rel_gap(rows["eff"], eff)
    if not np.all(np.isnan(rows["var"])):
        gap = worst(gap, rel_gap(rows["var"], var))
    gap = worst(gap, rel_gap(rows["chi"], chi))
    logp = np.log(np.maximum(rows["p"], 1e-300))
    return worst(gap, rel_gap(logp, np.log(np.maximum(p, 1e-300))))


def set_gap(m, got_ij, got_ref, want_ij, want_ref, threshold):
    """Largest relative distance from `threshold` of the reference value
    of a pair on one side only (0 when the pair sets are equal)."""
    got = got_ij[0] * m + got_ij[1]
    want = want_ij[0] * m + want_ij[1]
    only_got = ~np.isin(got, want)
    only_want = ~np.isin(want, got)
    far = np.concatenate([np.abs(got_ref[only_got] - threshold),
                          np.abs(want_ref[only_want] - threshold)])
    return float(far.max() / threshold) if far.size else 0.0


def run(ctx, log=sys.stderr):
    """{name: {"value", "limit"}} over the sampled units."""
    spec, args = ctx.traffic["check"], ctx.traffic["args"]
    approx = ctx.traffic["family"] == "approx"
    units = sample(ctx)
    f64, dev, ordered = torch.float64, ctx.device, ctx.ordered
    geno = ctx.geno.to(dev)
    mats = R.codings(geno, ctx.kind, f64)
    grm_lst = R.grms(geno, ctx.config["model"]["grms"], f64)
    x = torch.as_tensor(ctx.xmat, dtype=f64, device=dev)
    gaps = dict.fromkeys(("var_gap", "stat_gap", "screen_gap") if approx
                         else ("var_gap", "row_gap"), 0.0)
    ref_var = {}  # trait -> (variances, converged)
    sound, loose = [], []  # (trait, var_gap): reference converged / not
    m = ctx.n_snp

    def reference_var(unit):
        if unit.trait not in ref_var:
            y = torch.as_tensor(ctx.traits[unit.trait], dtype=f64, device=dev)
            ref_var[unit.trait] = R.reml(y, x, grm_lst)
        var, converged = ref_var[unit.trait]
        (sound if converged else loose).append(
            (unit.trait, var_gap(unit.var, var)))
        return var

    for unit in units:
        var = reference_var(unit)
        y = torch.as_tensor(ctx.traits[unit.trait], dtype=f64, device=dev)
        py, pmat = R.pieces(var, y, x, grm_lst)
        rows = unit.out
        ref = R.pair_stats(*mats, py, pmat, rows["i"], rows["j"])
        got = (rows["i"], rows["j"])
        if approx:
            gaps["stat_gap"] = worst(gaps["stat_gap"], stat_gap(rows, ref))
            calib = R.random_pairs(m, args["num_random_pair"],
                                   args.get("seed", 0), ordered=ordered)
            med = np.median(R.pair_stats(*mats, py, pmat, calib[:, 0],
                                         calib[:, 1])[1])
            cut = math.sqrt(R.chi2_crit(args["p_cut"]) * med)
            si, sj, seff = R.screen(*mats, py, cut, ordered=ordered)
            gaps["screen_gap"] = worst(gaps["screen_gap"], set_gap(
                m, got, np.abs(ref[0]), (si, sj), np.abs(seff), cut))
        else:
            hits = R.exact_scan(*mats, py, pmat, ctx.anchors(unit.part),
                                args["p_cut"], ordered=ordered)
            gap = worst(stat_gap(rows, ref), set_gap(
                m, got, ref[2], hits[:2], hits[4],
                R.chi2_crit(args["p_cut"])))
            gaps["row_gap"] = worst(gaps["row_gap"], gap)
    if units and not sound:
        rest = [u for u in ctx.done if u not in units]
        order = np.random.default_rng([ctx.seed, 4]).permutation(len(rest))
        for k in order:
            if rest[k].trait not in ref_var:
                reference_var(rest[k])
                if sound:
                    break
    for _, gap in sound or loose:
        gaps["var_gap"] = worst(gaps["var_gap"], gap)
    if loose:
        traits = sorted({t for t, _ in loose})
        print(f"check note: the reference REML of trait(s) {traits} stopped "
              "at its iteration limit without converging; var_gap "
              + ("leaves them out" if sound else
                 "compares their last iterates, since no completed unit's "
                 "REML converged"), file=log)
    if not units:
        gaps = dict.fromkeys(gaps, math.nan)
    return {k: {"value": v, "limit": spec["limits"][k]}
            for k, v in gaps.items()}


def passed(checks):
    return all(c["value"] <= c["limit"] for c in checks.values())
