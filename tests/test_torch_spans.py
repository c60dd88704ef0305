"""The port's spans and counters (`gmat_tpu_torch/core/spans.py`) on the
CPU: nothing records outside a profiler, the tree of spans that REML, the
approx pipeline and the exhaustive scan record under one, their counts,
the `gc` spans, the mesh's shard threads, the timers read from spans, and
no device synchronize or read by a span."""
import gc
import json
import logging
import os
import shutil
import threading

import numpy as np
import pytest
import torch
import torch.autograd.profiler as autograd_profiler
from torch.profiler import ProfilerActivity, profile

from gmat_tpu_torch import remma_epiAA, remma_epiAA_approx, wemai_multi_gmat
from gmat_tpu_torch.core import roofline, spans
from gmat_tpu_torch.dist.mesh import _map_shards, make_mesh
from gmat_tpu_torch.grm.grm import additive_grm
from gmat_tpu_torch.io.bed import read_plink
from gmat_tpu_torch.reml import wemai
from gmat_tpu_torch.scan import pairs as P
from gmat_tpu_torch.scan import screen as TS
from gmat_tpu_torch.scan.common import prepare_genotypes_device

from conftest import DATA, GOLDEN

STAGES = ("prep", "draw", "calibrate", "screen", "retest", "merge")


@pytest.fixture(scope="module")
def grms():
    ag = additive_grm(torch.as_tensor(read_plink(str(DATA / "plink")))).numpy()
    return [ag, ag * ag]


@pytest.fixture
def work(tmp_path):
    """A copy of the small panel and its phenotypes: a fresh phenotype file
    (so the design cache misses) beside a panel whose device copy is
    cached."""
    for ext in (".bed", ".bim", ".fam"):
        shutil.copy(DATA / f"plink{ext}", tmp_path / f"plink{ext}")
    shutil.copy(DATA / "pheno", tmp_path / "pheno")
    prepare_genotypes_device(str(tmp_path / "plink"), device="cpu")
    return tmp_path


@pytest.fixture
def off(monkeypatch):
    """No profiler active, GMAT_TPU_TRACE_DIR unset, no gc hook."""
    monkeypatch.setattr(spans, "_TRACE_DIR", None)
    assert not spans.profiler_active()
    if spans._on_gc in gc.callbacks:
        gc.callbacks.remove(spans._on_gc)


def trait(work, grms):
    """One trait of the benchmark, small: REML (unconverged at 3
    iterations), then the approx pipeline at the converged variances;
    returns those."""
    prefix, pheno = str(work / "plink"), str(work / "pheno")
    wemai_multi_gmat(pheno, prefix, grms, maxiter=3,
                     out_file=str(work / "var"), device="cpu")
    var = np.load(GOLDEN / "epi_scans.npz")["var_com"]
    remma_epiAA_approx(pheno, prefix, grms, var, p_cut=1e-4,
                       num_random_pair=5000, out_file=str(work / "ap"),
                       device="cpu")
    return var


def new_spans(before):
    return spans.spans()[before:]


def test_the_profiler_flag_is_held():
    """Recording rests on the flag that torch sets for every profiler
    session, whatever its activities: a torch that drops it fails here."""
    assert autograd_profiler._is_profiler_enabled is False
    with profile(activities=[ProfilerActivity.CPU]):
        assert autograd_profiler._is_profiler_enabled is True
        assert spans.profiler_active() and spans.recording()
    assert autograd_profiler._is_profiler_enabled is False


def test_nothing_records_outside_a_profiler(off, work, grms, caplog,
                                            monkeypatch):
    before = len(spans.spans())
    clock = []
    monkeypatch.setattr(spans.time, "perf_counter_ns",
                        lambda: clock.append(1) or 0)
    assert spans.span("a") is spans.span("b", root=True, pairs=3)
    with spans.span("a") as s:
        s.count("pairs", 2)
        spans.count("hits", 1)
    assert clock == [] and spans.current() is None
    monkeypatch.undo()
    with caplog.at_level(logging.INFO):
        trait(work, grms)
    assert len(spans.spans()) == before
    assert spans._on_gc not in gc.callbacks
    assert set(TS.LAST_APPROX_STAGES) == set(STAGES) | {"total"}
    assert all(v > 0 for v in TS.LAST_APPROX_STAGES.values())
    for line in ("Screen engine setup (pieces/geno/codings): ",
                 "Screen sweep(s) incl. assembly: ", "Approx table: ",
                 "Roofline screen: ", "Approx pipeline stages (s): "):
        assert line in caplog.text, line


def _children(recs, parent):
    return [r.name for r in recs if r.parent == parent.id]


def test_the_tree_under_a_profiler(off, work, grms):
    before = len(spans.spans())
    with profile(activities=[ProfilerActivity.CPU]):
        var = trait(work, grms)
        os.utime(work / "pheno", ns=(1, 1))  # the exact scan parses anew
        remma_epiAA(str(work / "pheno"), str(work / "plink"), grms, var,
                    snp_lst_0=range(4), p_cut=1e-3, out_file=str(work / "ex"),
                    device="cpu")
    recs = [r for r in new_spans(before) if r.name != "gc"]
    roots = [r for r in recs if r.parent == 0]
    assert [r.name for r in roots] == ["reml", "approx", "exact"]
    assert len({r.call for r in roots}) == 3
    by_id = {r.id: r for r in recs}
    for r in recs:
        top = r
        while top.parent:
            top = by_id[top.parent]
        assert r.call == top.id and top in roots, r.name
        assert top.start <= r.start <= r.end <= top.end
    reml, approx, exact = roots
    assert _children(recs, reml) == ["reml.parse", "reml.zgzt",
                                     "reml.iterate", "reml.write"]
    # the CPU runs REML's step eagerly: no iteration is a graph replay
    loop = next(r for r in recs if r.name == "reml.iterate")
    assert set(loop.counts) == {"iterations", "at_limit", "replays"}
    assert loop.counts["iterations"] >= 1 and loop.counts["replays"] == 0
    assert _children(recs, approx) == [f"approx.{s}" for s in STAGES]
    stage = {r.name[len("approx."):]: r for r in recs
             if r.parent == approx.id}
    assert _children(recs, stage["prep"]) == ["design.parse", "pieces"]
    # the stages hand each other arrays: no file leaf but the table's write,
    # which is the merge stage itself
    assert _children(recs, stage["draw"]) == []
    assert _children(recs, stage["calibrate"]) == ["pairs.test",
                                                    "calibrate.var"]
    assert _children(recs, stage["retest"]) == ["pairs.test"]
    assert _children(recs, stage["screen"]) == ["screen.setup",
                                                "screen.sweep"]
    assert _children(recs, stage["merge"]) == []
    rows = sum(1 for _ in open(work / "ap")) - 1
    assert rows > 0 and stage["merge"].counts == {"rows": rows}
    sweep = next(r for r in recs if r.name == "screen.sweep")
    assert _children(recs, sweep) == ["screen.run"]
    # the run's pairs and hits count once, on the sweep
    assert next(r for r in recs if r.name == "screen.run").counts == {}
    assert sweep.counts["pairs"] == 1407 * 1406 // 2
    assert sweep.counts["hits"] > 0
    test = [r for r in recs if r.name == "pairs.test"]
    assert test[0].counts["pairs"] == 5000
    assert test[1].counts["pairs"] == sweep.counts["hits"]
    assert _children(recs, exact) == ["exact.setup", "exact.scan"]
    setup = next(r for r in recs if r.name == "exact.setup")
    assert _children(recs, setup) == ["design.parse", "pieces"]
    scan = next(r for r in recs if r.name == "exact.scan")
    assert _children(recs, scan) == ["exact.kernel", "exact.write"]
    kernel = next(r for r in recs if r.name == "exact.kernel")
    assert kernel.counts["pairs"] == sum(1406 - a for a in range(4))
    # LAST_APPROX_STAGES is its stage spans' seconds
    got = dict(TS.LAST_APPROX_STAGES)
    assert got.pop("total") == approx.seconds
    assert got == {s: stage[s].seconds for s in STAGES}


def test_the_file_apis_keep_their_file_leaves(off, work, grms):
    """The public file APIs that share the approx pipeline's array cores
    still record their file leaves: `random_pair`'s `draw.write`, the pair
    test's `pairs.read` and `pairs.write`, the screen's `screen.write` and
    `screen.append`."""
    import gmat_tpu_torch

    prefix, pheno = str(work / "plink"), str(work / "pheno")
    var = np.load(GOLDEN / "epi_scans.npz")["var_com"]
    rp = str(work / "rp")
    before = len(spans.spans())
    with profile(activities=[ProfilerActivity.CPU]):
        gmat_tpu_torch.random_pair(1407, out_file=rp, num_pair=6000)
        gmat_tpu_torch.remma_epiAA_pair(pheno, prefix, grms, var,
                                        snp_pair_file=rp, p_cut=1.1,
                                        out_file=str(work / "pr"),
                                        device="cpu")
        gmat_tpu_torch.remma_epiAA_eff(pheno, prefix, grms, var,
                                       var_app=1e-3, p_cut=1e-4,
                                       out_file=str(work / "ef"),
                                       device="cpu")
    recs = [r for r in new_spans(before) if r.name != "gc"]
    roots = [r for r in recs if r.parent == 0]
    assert [r.name for r in roots] == ["draw.write", "pair", "eff"]
    draw, pair, eff = roots
    assert _children(recs, pair) == ["design.parse", "pieces", "pairs.read",
                                     "pairs.test", "pairs.write"]
    assert next(r for r in recs if r.name == "pairs.test").counts == {
        "pairs": 6000}
    assert _children(recs, eff) == ["screen.setup", "screen.sweep",
                                    "screen.write", "screen.append"]
    assert sum(1 for _ in open(rp)) == sum(1 for _ in open(work / "pr"))


def test_reml_counts_iterations_and_the_limit(off, work, grms):
    before = len(spans.spans())
    with profile(activities=[ProfilerActivity.CPU]):
        wemai_multi_gmat(str(work / "pheno"), str(work / "plink"), grms,
                         maxiter=3, out_file=str(work / "var"), device="cpu")
    it = [r for r in new_spans(before) if r.name == "reml.iterate"]
    assert len(it) == 1
    assert it[0].counts == {"iterations": 3, "at_limit": 1, "replays": 0}


def test_grm_uploads_count_twice_a_trait(off, work, grms):
    """Both GRMs cross to the device in REML and again in the score pieces
    of the scan: 2·k·n²·8 bytes a trait, the panel's copy cached."""
    before = len(spans.spans())
    with profile(activities=[ProfilerActivity.CPU]):
        trait(work, grms)
    recs = new_spans(before)
    n = grms[0].shape[0]
    assert sum(r.counts.get("h2d_bytes", 0) for r in recs) \
        == 2 * len(grms) * n * n * 8
    assert [r.counts["h2d_bytes"] for r in recs
            if "h2d_bytes" in r.counts] == [len(grms) * n * n * 8] * 2
    assert [r.name for r in recs if "h2d_bytes" in r.counts] == [
        "reml.zgzt", "pieces"]


def test_a_collection_is_a_gc_span(off):
    before = len(spans.spans())
    with profile(activities=[ProfilerActivity.CPU]):
        with spans.span("outer") as outer:
            gc.collect()
        assert spans._on_gc in gc.callbacks
    rec = [r for r in new_spans(before) if r.name == "gc"]
    assert rec and rec[-1].counts == {"generation": 2}
    assert rec[-1].parent == outer.id and rec[-1].call == outer.call
    assert outer.start <= rec[-1].start <= rec[-1].end <= outer.end
    gc.collect()  # the hook leaves once recording has stopped
    assert spans._on_gc not in gc.callbacks


def test_shard_threads_take_the_callers_span(off, work, grms, monkeypatch):
    mesh = make_mesh(devices=["cpu", "cpu"])
    before = len(spans.spans())

    def fn(dev, share):
        with spans.span("inner", share=share) as s:
            spans.count("seen")
        return s.thread

    with profile(activities=[ProfilerActivity.CPU]):
        with spans.span("outer") as outer:
            threads = _map_shards(mesh, fn, [0, 1])
        monkeypatch.setattr(P, "_SCAN_PAIR_BUDGET", 1000)  # a run an anchor
        remma_epiAA(str(work / "pheno"), str(work / "plink"), grms,
                    np.array([0.06, 0.08, 0.08]), snp_lst_0=range(6),
                    p_cut=1e-3, out_file=str(work / "ex"), mesh=mesh,
                    device="cpu")
    recs = new_spans(before)
    inner = [r for r in recs if r.name == "inner"]
    assert sorted(r.counts["share"] for r in inner) == [0, 1]
    assert all(r.parent == outer.id and r.call == outer.call
               and r.counts["seen"] == 1 for r in inner)
    assert threading.get_ident() not in threads
    scan = next(r for r in recs if r.name == "exact.scan")
    kernels = [r for r in recs if r.name == "exact.kernel"]
    assert len(kernels) == 6
    assert all(r.parent == scan.id and r.call == scan.call for r in kernels)
    assert scan.thread not in {r.thread for r in kernels}
    assert sum(r.counts["pairs"] for r in kernels) == sum(
        1406 - a for a in range(6))


def test_a_span_never_synchronizes_or_reads_the_device(off, work, grms,
                                                       monkeypatch):
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a, **k: calls.append("synchronize"))
    monkeypatch.setattr(torch.Tensor, "item",
                        lambda self: calls.append("item"))
    for on in (False, True):
        if on:
            with profile(activities=[ProfilerActivity.CPU]):
                with spans.span("s", timed=True) as s:
                    s.count("n", 1)
                    spans.count("m", 1)
        else:
            with spans.span("s", timed=True) as s:
                s.count("n", 1)
                spans.count("m", 1)
        assert s.seconds >= 0
    assert calls == []
    monkeypatch.undo()
    # the whole trait on the CPU device, traced: synchronize is for CUDA
    # devices alone and no span adds one
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a, **k: calls.append("synchronize"))
    with profile(activities=[ProfilerActivity.CPU]):
        trait(work, grms)
    assert calls == []


def test_the_trace_dir_records_and_writes_chrome_events(off, tmp_path,
                                                        monkeypatch):
    monkeypatch.setattr(spans, "_TRACE_DIR", str(tmp_path))
    before = len(spans.spans())
    with spans.span("outer", root=True, pairs=2):
        with spans.span("inner"):
            pass
    assert [r.name for r in new_spans(before)] == ["inner", "outer"]
    spans._write_at_exit()
    monkeypatch.setattr(spans, "_TRACE_DIR", None)
    gc.collect()
    path = tmp_path / "spans" / f"{os.getpid()}.json"
    events = json.loads(path.read_text())["traceEvents"]
    outer = next(e for e in events[::-1] if e["name"] == "outer")
    assert outer["ph"] == "X" and outer["args"]["pairs"] == 2
    import time

    assert abs(outer["ts"] - time.time_ns() / 1e3) < 60e6  # epoch clock


def test_spans_past_the_limit_are_dropped(off, monkeypatch):
    monkeypatch.setattr(spans, "LIMIT", len(spans.spans()) + 1)
    dropped = spans.dropped()
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(3):
            with spans.span("x"):
                pass
    assert len(spans.spans()) == spans.LIMIT
    assert spans.dropped() >= dropped + 2  # and any gc span past the limit
    gc.collect()


def test_round_line_reads_the_device_only_where_logged(work, grms,
                                                       monkeypatch, caplog):
    from gmat_tpu_torch.io.pheno import design_matrix

    dm = design_matrix(str(work / "pheno"), str(work / "plink"))
    reads = []
    real = torch.Tensor.__float__
    monkeypatch.setattr(torch.Tensor, "__float__",
                        lambda self: reads.append(1) or real(self))
    for level, want in ((logging.WARNING, 2), (logging.INFO, 4)):
        reads.clear()
        with caplog.at_level(level, logger=wemai.logger.name):
            wemai.wemai_reml(dm, grms, maxiter=1, device="cpu")
        assert len(reads) == want, level


def test_log_phase_holds_each_phase_to_its_peak(monkeypatch, caplog):
    monkeypatch.delenv("GMAT_TPU_PEAK_TFLOPS", raising=False)
    assert roofline.peak_tflops("screen") == pytest.approx(495 / 3)
    assert roofline.peak_tflops("exact_scan") == roofline.peak_tflops() == 67
    with caplog.at_level("INFO", logger=roofline.__name__):
        assert roofline.log_phase("screen", 33e12, 1.0) == pytest.approx(33)
    assert "(20% of 165 TF/s peak)" in caplog.text
    monkeypatch.setenv("GMAT_TPU_PEAK_TFLOPS", "2.5")
    assert roofline.peak_tflops("screen") == 2.5


def test_maybe_trace_opens_no_second_profiler(tmp_path, monkeypatch):
    monkeypatch.setenv("GMAT_TPU_TRACE_DIR", str(tmp_path))
    with profile(activities=[ProfilerActivity.CPU]):
        with roofline.maybe_trace("screen"):
            torch.ones(8) @ torch.ones(8)
    assert list(tmp_path.iterdir()) == []
    with roofline.maybe_trace("screen"):
        torch.ones(8) @ torch.ones(8)
    assert len(list((tmp_path / "screen").iterdir())) == 1
