"""The check of what the window produced, against the plain reference.

After the window, a sample of the completed units drawn from the seed (the
longest among them, `sample`) is worked out again by the plain reference
from the benchmark's own inputs.  The mix's family (`families/<family>.py`,
`check_numbers`) computes the numbers compared; each is held to its limit
in the traffic mix's `"check"`.  This module holds what does not depend on
the family: the sample, the limits, and the arithmetic of the gaps that
the families share.
"""
from __future__ import annotations

import math
import sys

import numpy as np


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


def rel_gap(got, want, floor=False):
    """Largest gap relative to `want`; with `floor`, relative to `want` or
    to the median |want|, whichever is larger."""
    got, want = np.asarray(got, float), np.asarray(want, float)
    if got.size == 0:
        return 0.0
    scale = np.abs(want)
    if floor:
        scale = np.maximum(scale, np.median(scale))
    return float(np.max(np.abs(got - want) / scale))


def var_gap(got, want):
    """Largest gap of a variance component, relative to the component or
    to the median component, whichever is larger (a component at the
    boundary is all but zero)."""
    got, want = np.asarray(got, float), np.asarray(want, float)
    scale = np.maximum(np.abs(want), np.median(np.abs(want)))
    return float(np.max(np.abs(got - want) / scale))


def stat_gap(rows, ref, floor=False):
    """Largest relative gap of eff, var (where written), chi, and log p.
    With `floor` (a full table, whose null pairs hold values all but
    zero, where a relative gap reads the rounding of the smallest one),
    each relative to the value or to its column's median, whichever is
    larger, as `var_gap` does."""
    eff, var, chi, p = ref
    gap = rel_gap(rows["eff"], eff, floor)
    if not np.all(np.isnan(rows["var"])):
        gap = worst(gap, rel_gap(rows["var"], var, floor))
    gap = worst(gap, rel_gap(rows["chi"], chi, floor))
    logp = np.log(np.maximum(rows["p"], 1e-300))
    return worst(gap, rel_gap(logp, np.log(np.maximum(p, 1e-300)), floor))


def set_gap(m, got_ij, got_ref, want_ij, want_ref, threshold):
    """Largest relative distance from `threshold` of the reference value
    of a pair on one side only (0 when the pair sets are equal).  Where
    the threshold is not positive (a p_cut of 1 or more: every tested
    pair belongs on both sides), a pair on one side only reads 1."""
    got = got_ij[0] * m + got_ij[1]
    want = want_ij[0] * m + want_ij[1]
    only_got = ~np.isin(got, want)
    only_want = ~np.isin(want, got)
    far = np.concatenate([np.abs(got_ref[only_got] - threshold),
                          np.abs(want_ref[only_want] - threshold)])
    if not far.size:
        return 0.0
    return float(far.max() / threshold) if threshold > 0 else 1.0


def run(ctx, log=sys.stderr):
    """{name: {"value", "limit"}} over the sampled units; NaN where no
    unit completed."""
    units = sample(ctx)
    gaps = ctx.family.check_numbers(ctx, units, log)
    if not units:
        gaps = dict.fromkeys(gaps, math.nan)
    limits = ctx.traffic["check"]["limits"]
    return {k: {"value": v, "limit": limits[k]} for k, v in gaps.items()}


def passed(checks):
    return all(c["value"] <= c["limit"] for c in checks.values())
