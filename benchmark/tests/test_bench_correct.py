"""The check that decides `correct`, on the CPU at a small size: sound runs
pass; the control (the reference one precision lower in the program's
place) and runs with the timed path broken underneath fail.  The harness
runs as it does on the card, with the program's kernels replaced by their
plain versions (device "cpu")."""
import numpy as np
import pytest
import torch

from benchmark import check, harness
from benchmark.program import Control
from benchmark.tests.conftest import small

CELLS = ("yeast.approx_aa", "yeast.exact_aa_parts", "mouse.exact_aa",
         "yeast.approx_ad", "mouse.fulltable_aa")


def run(bench, cell, program_cls=harness.Program, seed=2**33 + 11):
    config, traffic = small(cell, bench)
    return harness.run_cell(bench, cell, seed, 1.0, False, device="cpu",
                            program_cls=program_cls, config=config,
                            traffic=traffic)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_runs_are_correct(bench, cell):
    res, checks = run(bench, cell)
    assert res["correct"], checks
    assert res["attempted"] >= 1 and res["failed"] == 0


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(bench, cell):
    res, checks = run(bench, cell, program_cls=Control)
    assert not res["correct"], checks


def reml_unchanged(monkeypatch):
    """REML returns its starting state (all ones) unchanged."""
    from gmat_tpu_torch.reml import wemai

    monkeypatch.setattr(wemai, "wemai_reml",
                        lambda dm, gmat_lst, **kw: np.ones(len(gmat_lst) + 1))


def exact_hit_altered(monkeypatch):
    """The exact-scan kernel returns one hit's eff off by a part in 1e6."""
    from gmat_tpu_torch.scan import kernels

    real = kernels.exact_hits

    def broken(*args, **kw):
        i, j, eff, var, chi = real(*args, **kw)
        eff = eff.clone()
        eff[:1] *= 1.0 + 1e-6
        return i, j, eff, var, chi

    monkeypatch.setattr(kernels, "exact_hits", broken)


def exact_top_hit_altered(monkeypatch):
    """The exact-scan kernel returns the eff of its strongest hit (largest
    |eff|) off by a part in 1e6: in a full table the first hit may be a
    null pair whose eff is all but zero."""
    from gmat_tpu_torch.scan import kernels

    real = kernels.exact_hits

    def broken(*args, **kw):
        i, j, eff, var, chi = real(*args, **kw)
        eff = eff.clone()
        if len(eff):
            top = int(torch.argmax(torch.abs(eff)))
            eff[top] *= 1.0 + 1e-6
        return i, j, eff, var, chi

    monkeypatch.setattr(kernels, "exact_hits", broken)


def exact_half_dropped(monkeypatch):
    """The exact-scan kernel returns only the first half of its hits."""
    from gmat_tpu_torch.scan import kernels

    real = kernels.exact_hits

    def broken(*args, **kw):
        out = real(*args, **kw)
        return tuple(t[: (len(t) + 1) // 2] for t in out)

    monkeypatch.setattr(kernels, "exact_hits", broken)


def exact_hit_dropped(monkeypatch):
    """The exact-scan kernel drops its first hit: one row of a full table
    missing."""
    from gmat_tpu_torch.scan import kernels

    real = kernels.exact_hits
    monkeypatch.setattr(kernels, "exact_hits", lambda *a, **kw: tuple(
        t[1:] for t in real(*a, **kw)))


def screen_hit_dropped(monkeypatch):
    """The screen drops its first hit."""
    from gmat_tpu_torch.scan import screen

    real = screen.screen_positions
    monkeypatch.setattr(screen, "screen_positions",
                        lambda *a, **kw: tuple(t[1:] for t in real(*a, **kw)))


def pair_test_altered(monkeypatch):
    """The exact pair test returns its first pair's var off by 1e-6."""
    from gmat_tpu_torch.scan import pairs

    real = pairs._pair_kernel

    def broken(*args):
        eff, var, chi, p = real(*args)
        var = var.clone()
        var[:1] *= 1.0 + 1e-6
        return eff, var, eff * eff / var, p

    monkeypatch.setattr(pairs, "_pair_kernel", broken)


def ad_rows_transposed(monkeypatch):
    """The AD screen writes each sweep's rows the other way round: the
    first sweep's (i, j) as (j, i), the second's unflipped."""
    from gmat_tpu_torch.scan import screen

    real = screen._run_screen
    monkeypatch.setattr(
        screen, "_run_screen", lambda *a, flip_output=False, **kw: real(
            *a, flip_output=not flip_output, **kw))


def dominance_as_additive(monkeypatch):
    """The dominance coding is replaced by the additive one."""
    from gmat_tpu_torch.scan import common

    real = common.coded_matrix
    monkeypatch.setattr(common, "coded_matrix",
                        lambda g, kind, dtype=None: real(g, "add", dtype))


def ad_sweep_dropped(monkeypatch):
    """The AD screen's second sweep, (D_i, A_j) written (j, i), finds
    nothing."""
    from gmat_tpu_torch.scan import screen

    real = screen._run_screen

    def broken(*a, flip_output=False, **kw):
        out = real(*a, flip_output=flip_output, **kw)
        return tuple(t[:0] for t in out) if flip_output else out

    monkeypatch.setattr(screen, "_run_screen", broken)


FAULTS = [
    ("yeast.approx_aa", reml_unchanged),
    ("yeast.approx_aa", screen_hit_dropped),
    ("yeast.approx_aa", pair_test_altered),
    ("yeast.exact_aa_parts", exact_hit_altered),
    ("yeast.exact_aa_parts", exact_half_dropped),
    ("mouse.exact_aa", reml_unchanged),
    ("mouse.exact_aa", exact_hit_altered),
    ("yeast.approx_ad", ad_rows_transposed),
    ("yeast.approx_ad", dominance_as_additive),
    ("yeast.approx_ad", ad_sweep_dropped),
    ("mouse.fulltable_aa", exact_hit_dropped),
    ("mouse.fulltable_aa", exact_top_hit_altered),
]


@pytest.mark.parametrize(
    "size", ["small", pytest.param("cell", marks=pytest.mark.cuda)])
@pytest.mark.parametrize("cell,fault", FAULTS,
                         ids=[f"{c}-{f.__name__}" for c, f in FAULTS])
def test_a_broken_timed_path_is_not_correct(bench, monkeypatch, cell, fault,
                                            size):
    """Each fault of the timed path: on the CPU at a small size, and on the
    card in a short run of the full-size cell, where the compared numbers
    print (`-s`) for PERF.md."""
    fault(monkeypatch)
    if size == "small":
        res, checks = run(bench, cell)
    else:
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA device")
        res, checks = harness.run_cell(bench, cell, 2**33 + 29, 4.0, False)
        print(f"fault {cell} {fault.__name__}: "
              + " ".join(f"{k}={v['value']!r}" for k, v in checks.items()))
    assert not res["correct"], checks


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cells_on_the_card(bench, cell):
    """One short run of each full-size cell on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    res, checks = harness.run_cell(bench, cell, 2**33 + 17, 2.0, False)
    assert res["correct"], checks


def test_a_full_table_reads_finite_gaps(bench, monkeypatch):
    """At p_cut 1 every tested pair is a row: a sound run's row_gap is a
    finite rounding gap, and a run with one row dropped reads 1, not the
    inf or NaN of a division by chi_crit = 0; its statistics' gaps are
    floored at their columns' medians, where the plain relative gap reads
    the rounding of the table's smallest |eff|."""
    import math

    cell = "mouse.fulltable_aa"
    config, traffic = small(cell, bench)
    assert traffic["args"]["p_cut"] == 1.0
    seen = {}
    real = check.run

    def spy(ctx, log):
        seen["ctx"] = ctx
        return real(ctx, log)

    monkeypatch.setattr(check, "run", spy)
    _, sound = run(bench, cell)
    m = config["n_snp"]
    assert all(len(u.out["i"]) == m * (m - 1) // 2 for u in seen["ctx"].done)
    exact_hit_dropped(monkeypatch)
    _, dropped = run(bench, cell)
    assert math.isfinite(sound["row_gap"]["value"])
    assert sound["row_gap"]["value"] <= sound["row_gap"]["limit"]
    assert dropped["row_gap"]["value"] == 1.0


def test_floored_gaps_leave_a_near_zero_value_out():
    """A gap relative to a value all but zero reads its rounding; floored
    at the median of its column it reads the gap at the column's scale."""
    want = np.array([1.0, 2.0, 1e-9])
    got = want + 1e-15
    assert check.rel_gap(got, want) == pytest.approx(1e-6)
    assert check.rel_gap(got, want, floor=True) == pytest.approx(1e-15)


def test_set_gap_without_a_threshold():
    """A pair on one side only reads its relative distance from a positive
    threshold, as before, and 1 where the threshold is 0 (p_cut 1) or NaN
    (p_cut over 1)."""
    got = (np.array([0, 0, 1]), np.array([1, 2, 2]))
    want = (np.array([0, 0]), np.array([1, 2]))
    chi = np.array([5.0, 7.0, 2.5])
    assert check.set_gap(3, got, chi, want, chi[:2], 2.0) == 0.25
    assert check.set_gap(3, want, chi[:2], want, chi[:2], 0.0) == 0.0
    assert check.set_gap(3, got, chi, want, chi[:2], 0.0) == 1.0
    assert check.set_gap(3, got, chi, want, chi[:2], float("nan")) == 1.0
