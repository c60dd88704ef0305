"""The approx family: per trait REML, then the mix's `remma_epi*_approx`
(calibrate on random pairs, screen every pair of the kind's set by its
effect, re-test the survivors exactly).

The check (`_remma.run_check`) adds to `var_gap`:
- `stat_gap`: the largest relative gap of a written row's eff, var and
  chi, and of its p on the log scale, against the reference's test of
  that pair;
- `screen_gap`: the rows' pair set against the pairs whose reference
  effect passes the calibrated cut.  A pair on one side only is allowed
  only at the cut: the number is the largest relative distance of such a
  pair's reference |eff| from the cut, 0 when the sets are equal.
"""
from __future__ import annotations

import math

import numpy as np

from benchmark import check
from benchmark.families import _remma
from benchmark.families._remma import (boundary, inputs, read,  # noqa: F401
                                       write_inputs)
from benchmark.reference import remma as R


def calibrated_var(ctx, mats, py, pmat):
    """chi_crit(p_cut) times the median var of the mix's calibration
    pairs, in the dtype of `mats`: the square of the screen's cut on
    |eff|."""
    args = ctx.traffic["args"]
    calib = R.random_pairs(ctx.n_snp, args["num_random_pair"],
                           args.get("seed", 0), ordered=_remma.ordered(ctx))
    med = np.median(R.pair_stats(*mats, py, pmat, calib[:, 0],
                                 calib[:, 1])[1])
    return R.chi2_crit(args["p_cut"]) * med


class Program(_remma.Program):
    def scan(self, ctx, trait, pheno, var, out, part=None):
        """The approx table's path and the pipeline's stage seconds."""
        from gmat_tpu_torch.scan import screen

        self.run_scan(ctx, pheno, var, out)
        return out, dict(screen.LAST_APPROX_STAGES)


class Control(_remma.Control):
    def scan(self, ctx, trait, pheno, var, out, part=None):
        py, pmat = self.pieces(ctx, trait, var)
        mats, ordered = self.mats, _remma.ordered(ctx)
        cut = np.sqrt(calibrated_var(ctx, mats, py, pmat))
        i, j, _ = R.screen(*mats, py, cut, ordered=ordered, tf32=True)
        rows = (i, j) + R.pair_stats(*mats, py, pmat, i, j)
        return dict(zip(_remma.ROW_KEYS, rows)), {}


def pairs(ctx, part):
    """An approx unit counts no exhaustively tested pairs."""
    return 0


def _unit_gaps(ref, unit, py, pmat, pair_ref, gaps):
    ctx, rows = ref.ctx, unit.out
    gaps["stat_gap"] = check.worst(gaps["stat_gap"],
                                   check.stat_gap(rows, pair_ref))
    cut = math.sqrt(calibrated_var(ctx, ref.mats, py, pmat))
    si, sj, seff = R.screen(*ref.mats, py, cut, ordered=_remma.ordered(ctx))
    gaps["screen_gap"] = check.worst(gaps["screen_gap"], check.set_gap(
        ctx.n_snp, (rows["i"], rows["j"]), np.abs(pair_ref[0]), (si, sj),
        np.abs(seff), cut))


def check_numbers(ctx, units, log):
    return _remma.run_check(ctx, units, log, ("stat_gap", "screen_gap"),
                            _unit_gaps)
