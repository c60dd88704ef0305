"""One-call REMMAX orchestration: GRM -> REML -> scan -> annotation
(counterpart of `gmat_tpu/pipeline/remmax.py`).

The reference's workflow is four manual steps glued together by files.
`remmax()` runs the same pipeline with its stage artifacts on disk: the
variance file `<out>.var` is the same contract in both packages, so a run
resumes from a `.var` that either package wrote.  Each phase's wall time
goes to `<out>.timings.json` (keys `grm`, `reml`, `scan`, `annotate`), the
seconds of its span `remmax.<phase>` (`core.spans`).
"""
from __future__ import annotations

import contextlib
import json
import logging
import os
import time
from dataclasses import dataclass, field

import numpy as np

from gmat_tpu_torch.config import resolve_device
from gmat_tpu_torch.core.spans import span

logger = logging.getLogger(__name__)

MODEL_GRMS = {
    "a_axa": ["ag", "ag*ag"],
    "a_d_axa": ["ag", "dg", "ag*ag"],
    "a_d_axa_axd_dxd": ["ag", "dg", "ag*ag", "ag*dg", "dg*dg"],
}


@contextlib.contextmanager
def phase_timer(name: str, record: dict | None = None):
    """A span `remmax.<name>` around a pipeline phase; its wall seconds and
    the process's CPU seconds are logged and, with `record`, the wall
    seconds stored as record[name]."""
    c0 = time.process_time()
    with span(f"remmax.{name}", timed=True) as s:
        yield
    dc = time.process_time() - c0
    logger.info("%s: clock %.3fs, cpu %.3fs", name, s.seconds, dc)
    if record is not None:
        record[name] = s.seconds


@dataclass
class RemmaxResult:
    var_com: np.ndarray
    out_prefix: str
    timings: dict = field(default_factory=dict)

    @property
    def scan_file(self):
        return self.out_prefix + ".scan"

    @property
    def anno_file(self):
        return self.out_prefix + ".scan.anno"


def grm_products(specs, bed_prefix, device=None):
    """Host GRMs of `specs`: 'ag', 'dg' or elementwise products such as
    'ag*ag', 'ag*dg'.  Each base GRM is computed once on `device` from the
    `.bed` decoded in memory (no text files); the products are taken on
    the host.  Raises ValueError for an unknown term."""
    import torch

    from gmat_tpu_torch.config import EXACT_DTYPE
    from gmat_tpu_torch.grm.grm import additive_grm, dominance_grm
    from gmat_tpu_torch.io.bed import read_plink

    geno = torch.as_tensor(read_plink(bed_prefix), dtype=EXACT_DTYPE,
                           device=resolve_device(device))
    base = {}
    mats = []
    for spec in specs:
        prod = None
        for term in spec.split("*"):
            term = term.strip()
            if term not in ("ag", "dg"):
                raise ValueError(f"unknown GRM term {term!r} (use ag/dg)")
            if term not in base:
                fn = additive_grm if term == "ag" else dominance_grm
                base[term] = fn(geno).cpu().numpy()
            prod = base[term] if prod is None else prod * base[term]
        mats.append(prod)
    return mats


def remmax(pheno_file: str, bed_prefix: str, out_prefix: str = "remmax",
           model: str = "a_axa", scan: str = "epiAA_approx",
           p_cut: float = 1.0e-5, num_random_pair: int = 100000,
           dis: float = 0.0, maxiter: int = 200, seed: int = 0,
           resume: bool = True, device=None) -> RemmaxResult:
    """The full pipeline.

    model: which GRMs enter the null model:
        'a_axa' [ag, ag*ag] | 'a_d_axa' [ag, dg, ag*ag] |
        'a_d_axa_axd_dxd' (5 GRMs)
    scan: 'epiAA' | 'epiAD' | 'epiDD' exact scans, the '*_approx' /
        '*_maf_approx' screen pipelines, or 'add' / 'dom' single-SNP tests.
    resume: reuse `<out>.var` when it exists.
    Spans: the root `remmax`, a span `remmax.<phase>` per phase.
    """
    from gmat_tpu_torch.reml.wemai import wemai_multi_gmat
    from gmat_tpu_torch.scan import pairs as pairs_mod
    from gmat_tpu_torch.scan import screen as screen_mod
    from gmat_tpu_torch.scan import single as single_mod
    from gmat_tpu_torch.scan.annotation import annotation_snp_pos

    with span("remmax", root=True):
        dev = resolve_device(device)
        timings: dict = {}
        with phase_timer("grm", timings):
            mats = grm_products(MODEL_GRMS[model], bed_prefix, dev)

        var_file = out_prefix + ".var"
        if resume and os.path.exists(var_file):
            logger.info("resuming: reusing %s", var_file)
            var_com = np.loadtxt(var_file)
            timings["reml"] = 0.0
        else:
            with phase_timer("reml", timings):
                var_com = wemai_multi_gmat(pheno_file, bed_prefix, mats,
                                           maxiter=maxiter, out_file=var_file,
                                           device=dev)

        scan_file = out_prefix + ".scan"
        with phase_timer("scan", timings):
            if scan in ("add", "dom"):
                fn = getattr(single_mod, f"remma_{scan}")
                fn(pheno_file, bed_prefix, mats, var_com, out_file=scan_file,
                   device=dev)
            elif scan.endswith("approx"):
                fn = getattr(screen_mod, f"remma_{scan}")
                fn(pheno_file, bed_prefix, mats, var_com, p_cut=p_cut,
                   num_random_pair=num_random_pair, out_file=scan_file,
                   seed=seed, device=dev)
            else:
                fn = getattr(pairs_mod, f"remma_{scan}")
                fn(pheno_file, bed_prefix, mats, var_com, p_cut=p_cut,
                   out_file=scan_file, device=dev)

        with phase_timer("annotate", timings):
            if scan not in ("add", "dom"):
                annotation_snp_pos(scan_file, bed_prefix, p_cut=p_cut, dis=dis)

        with open(out_prefix + ".timings.json", "w") as f:
            json.dump(timings, f)
    return RemmaxResult(var_com=var_com, out_prefix=out_prefix,
                        timings=timings)
