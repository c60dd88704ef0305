"""The exhaustive family: the mix's `remma_epi*` over every pair of the
kind's set, per trait after REML, or part after part of the mix's
`remma_epi*_parallel` split (unit `part`), every pair exactly tested.

The check (`_remma.run_check`) adds to `var_gap` `row_gap`: `stat_gap`
of the rows (as the approx family's), and a pair on one side only of the
rows and of the reference's pairs past chi_crit(p_cut), at the relative
distance of its reference chi from chi_crit.  At a p_cut of 1 or more
(a full table) every tested pair is a row, and a pair on one side only
reads 1 (`check.set_gap`); the table's null pairs hold effects all but
zero, so each statistic's gap is taken relative to it or to its
column's median, whichever is larger (`check.stat_gap`'s `floor`).
"""
from __future__ import annotations

from benchmark import check
from benchmark.families import _remma
from benchmark.families._remma import (boundary, inputs, read,  # noqa: F401
                                       write_inputs)
from benchmark.reference import remma as R


class Program(_remma.Program):
    def scan(self, ctx, trait, pheno, var, out, part=None):
        """The scan table's path (a part's carries its number)."""
        if part is None:
            self.run_scan(ctx, pheno, var, out)
            return out, {}
        self.run_scan(ctx, pheno, var, out,
                      parallel=[ctx.traffic["parts"], part])
        return f"{out}.{part}", {}


class Control(_remma.Control):
    def scan(self, ctx, trait, pheno, var, out, part=None):
        py, pmat = self.pieces(ctx, trait, var)
        rows = R.exact_scan(*self.mats, py, pmat, _remma.anchors(ctx, part),
                            ctx.traffic["args"]["p_cut"],
                            ordered=_remma.ordered(ctx))
        return dict(zip(_remma.ROW_KEYS, rows)), {}


def pairs(ctx, part):
    """The pairs that a unit (the whole scan, or part `part`) tests."""
    return R.pair_count(_remma.anchors(ctx, part), ctx.n_snp,
                        _remma.ordered(ctx))


def _unit_gaps(ref, unit, py, pmat, pair_ref, gaps):
    ctx, rows = ref.ctx, unit.out
    p_cut = ctx.traffic["args"]["p_cut"]
    hits = R.exact_scan(*ref.mats, py, pmat, _remma.anchors(ctx, unit.part),
                        p_cut, ordered=_remma.ordered(ctx))
    stats = check.stat_gap(rows, pair_ref, floor=p_cut >= 1.0)
    pairs = check.set_gap(ctx.n_snp, (rows["i"], rows["j"]), pair_ref[2],
                          hits[:2], hits[4], R.chi2_crit(p_cut))
    gap = check.worst(stats, pairs)
    gaps["row_gap"] = check.worst(gaps["row_gap"], gap)


def check_numbers(ctx, units, log):
    return _remma.run_check(ctx, units, log, ("row_gap",), _unit_gaps)
