"""Roofline logging and a profiler hook (counterpart of
`gmat_tpu/core/roofline.py`).

`log_phase` logs a phase's achieved FLOP rate against the card's peak for
that phase, and `maybe_trace` records a `torch.profiler` trace of whatever
runs inside it when `GMAT_TPU_TRACE_DIR` is set.

Peaks, published rates of one NVIDIA H100 SXM (80 GB HBM3) at its 700 W
power limit: the effect screen (kernel K1, phase "screen") runs its
product on the TF32 tensor cores as three TF32 products, so it is held
against 495 / 3 = 165 TFLOP/s of float32-grade work; the exact scan
(kernel K2, phase "exact_scan") and any other phase against 67 TFLOP/s,
float64 on the tensor cores (DMMA) and float32 on the CUDA cores.  Set
`GMAT_TPU_PEAK_TFLOPS` for another card, a lower power limit or a CPU run:
it then holds for every phase.
"""
from __future__ import annotations

import contextlib
import logging
import os
import time

from gmat_tpu_torch.core.spans import profiler_active

logger = logging.getLogger(__name__)

_DEFAULT_PEAK_TFLOPS = 67.0
_PHASE_PEAK_TFLOPS = {"screen": 495.0 / 3, "exact_scan": 67.0}


def peak_tflops(phase: str | None = None) -> float:
    """The FLOP rate that `phase`'s achieved rate is held against, in
    TFLOP/s: `GMAT_TPU_PEAK_TFLOPS` where set, else the phase's peak."""
    env = os.environ.get("GMAT_TPU_PEAK_TFLOPS")
    if env:
        return float(env)
    return _PHASE_PEAK_TFLOPS.get(phase, _DEFAULT_PEAK_TFLOPS)


def log_phase(name: str, flops: float, seconds: float,
              items: float | None = None, unit: str = "pairs") -> float:
    """Log one phase's achieved TFLOP/s against its peak; returns it.

    `seconds` is the phase's span's (`core.spans`); `items` / `unit` add
    the domain rate (e.g. pairs/s) to the line."""
    tf = flops / max(seconds, 1e-12) / 1e12
    peak = peak_tflops(name)
    extra = ""
    if items is not None:
        extra = " | %.3g %s/s" % (items / max(seconds, 1e-12), unit)
    logger.info("Roofline %s: %.2f TF/s (%.0f%% of %.0f TF/s peak), %.3f s%s",
                name, tf, 100.0 * tf / peak, peak, seconds, extra)
    return tf


@contextlib.contextmanager
def maybe_trace(label: str = "gmat"):
    """With GMAT_TPU_TRACE_DIR set, a `torch.profiler` trace (host and,
    where there is a card, CUDA activity) of the body, written as a Chrome
    trace under $GMAT_TPU_TRACE_DIR/<label>/; without it, or inside a
    profiler session already active, nothing."""
    trace_dir = os.environ.get("GMAT_TPU_TRACE_DIR")
    if not trace_dir or profiler_active():
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out_dir = os.path.join(trace_dir, label)
    os.makedirs(out_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    path = os.path.join(out_dir, f"{os.getpid()}.{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    logger.info("torch.profiler trace written to %s", path)
