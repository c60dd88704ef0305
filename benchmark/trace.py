"""The device trace of a `--trace 1` run: `torch.profiler` with CUDA
activity over the whole window, reduced to device intervals by name.

Busy time is the union of every device interval (kernels, copies, sets)
inside the window; the idle gaps between them are labelled with the
harness span that the host was in at the gap's middle.
"""
from __future__ import annotations

import subprocess
from dataclasses import dataclass


def start(device):
    """A running profiler of the device's activity (host activity where
    the device is the CPU, whose events then count as none)."""
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CUDA if device.type == "cuda"
                               else ProfilerActivity.CPU])
    prof.__enter__()
    return prof


def _events(prof):
    """(name, start ns, end ns) of the device events of a profile."""
    import torch

    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        if hasattr(e, "start_ns"):
            t0, dur = e.start_ns(), e.duration_ns()
        else:
            t0, dur = e.start_us() * 1000, e.duration_us() * 1000
        out.append((e.name(), int(t0), int(t0 + dur)))
    return out


@dataclass
class Trace:
    events: list  # (name, start ns, end ns), clipped to the window
    window_ns: tuple
    busy_s: float
    window_s: float
    gaps: list  # (start ns, end ns) of idle stretches

    def seconds(self, *patterns):
        """Device seconds of the events whose name holds any pattern."""
        return sum(e - s for name, s, e in self.events
                   if any(p in name for p in patterns)) / 1e9

    def breakdown(self, ctx):
        by_name = {}
        for name, s, e in self.events:
            by_name[name] = by_name.get(name, 0) + (e - s) / 1e9
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(self.gaps, key=lambda g: g[0] - g[1])[:10]
        return {"device_ops": [[n[:200], s] for n, s in ops],
                "idle_gaps": [[host_label(ctx, (a + b) // 2), (b - a) / 1e9]
                              for a, b in gaps]}


def host_label(ctx, t_ns):
    """The harness span that holds the instant `t_ns`."""
    for unit in ctx.units:
        for label, (s, e) in unit.spans.items():
            if ctx.ns(s) <= t_ns <= ctx.ns(e):
                return f"{unit.index}:{label}"
    return "harness"


def collect(prof, ctx):
    """Stop the profiler and reduce its device events over the window."""
    prof.__exit__(None, None, None)
    lo, hi = ctx.ns(ctx.window[0]), ctx.ns(ctx.window[1])
    events = sorted(((n, max(s, lo), min(e, hi)) for n, s, e in _events(prof)
                     if e > lo and s < hi), key=lambda ev: ev[1])
    busy, gaps, cursor = 0, [], lo
    for _, s, e in events:
        if s > cursor:
            gaps.append((cursor, s))
        if e > cursor:
            busy += e - max(s, cursor)
            cursor = e
    if hi > cursor:
        gaps.append((cursor, hi))
    return Trace(events=events, window_ns=(lo, hi), busy_s=busy / 1e9,
                 window_s=(hi - lo) / 1e9, gaps=gaps)


def power_limit():
    """The card's power limit in W, as nvidia-smi reads it (None if it
    cannot)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=20, check=True).stdout.split()
        return float(out[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def idle_share(ctx):
    """Percent of the traced window with nothing on the device."""
    tr = ctx.trace
    if tr is None or tr.window_s <= 0 or not tr.events:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
