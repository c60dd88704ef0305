"""Spans and counters of the port's own work, on the host's clock.

A span is a named interval of host time (`time.perf_counter_ns`, the clock
of `time.perf_counter`) with its own id, the id of the span that was open
when it opened (its parent) and the id of the call it belongs to: the
outermost span, which a public entry point opens (`root=True`), so that
every span of one REML or one scan shares it.  A span carries a small dict
of counts::

    with span("pairs.test", pairs=len(chunk)) as s:
        ...
        s.count("hits", n)

`count(key, n)` adds to the innermost open span of the calling thread.
Each thread keeps its own stack of open spans; a mesh's shard threads take
the span open where the shards were started as their parent (`inherit`).

Spans record only while a `torch.profiler` session is active in the
process, or when `GMAT_TPU_TRACE_DIR` is set (read when this module is
imported); then they are kept in memory, at most `LIMIT` of them (the rest
are counted by `dropped()`), and `spans()` returns them.  With
`GMAT_TPU_TRACE_DIR` set they are also written at the process's exit to
`$GMAT_TPU_TRACE_DIR/spans/<pid>.json` as Chrome trace events on the epoch
clock, beside `core.roofline.maybe_trace`'s traces.  While recording, each
collection of Python's garbage collector is a span `gc` counting its
`generation`.

Off, a span costs a flag check and returns a shared no-op object: no
record, no clock read.  A span opened with `timed=True` reads the clock
either way, for the callers that report its `seconds` (log lines,
`scan.screen.LAST_APPROX_STAGES`, `<out>.timings.json`).  On or off, a
span never synchronizes a device or reads a device value: device time is
the profiler's to measure.
"""
from __future__ import annotations

import atexit
import gc
import itertools
import json
import os
import threading
import time

import torch.autograd.profiler as _profiler

LIMIT = 1 << 20  # spans kept in memory

_TRACE_DIR = os.environ.get("GMAT_TPU_TRACE_DIR") or None
_records: list = []
_dropped = 0
_ids = itertools.count(1)
_lock = threading.RLock()  # reentrant: a collection may start inside it
_local = threading.local()
_gc_start = None  # perf_counter_ns at the start of the running collection
_exit_hooked = False


def profiler_active() -> bool:
    """Whether a `torch.profiler` session is active in the process: the
    flag that torch sets for every session, whatever its activities."""
    return _profiler._is_profiler_enabled


def recording() -> bool:
    """Whether spans record: a profiler session is active, or
    `GMAT_TPU_TRACE_DIR` is set."""
    return _profiler._is_profiler_enabled or _TRACE_DIR is not None


class Span:
    """One span: `name`, `start` and `end` (perf_counter ns), `id`,
    `parent` and `call` ids (0 for a root's parent), `thread` and
    `counts`."""

    __slots__ = ("name", "start", "end", "id", "parent", "call", "thread",
                 "counts", "_kept")

    def __init__(self, name, counts, kept):
        self.name = name
        self.counts = counts
        self.start = self.end = 0
        self._kept = kept
        if kept:
            up = _innermost()
            self.id = next(_ids)
            self.parent = up.id if up is not None else 0
            self.call = up.call if up is not None else self.id
            self.thread = threading.get_ident()

    @property
    def seconds(self) -> float:
        return (self.end - self.start) / 1e9

    def count(self, key, n=1):
        """Add `n` to the count `key` (kept spans only)."""
        if self._kept:
            with _lock:
                self.counts[key] = self.counts.get(key, 0) + n

    def __enter__(self):
        if self._kept:
            _stack().append(self)
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.end = time.perf_counter_ns()
        if self._kept:
            _stack().pop()
            _keep(self)
        return False


class _Off:
    """The span of a call that records nothing."""

    __slots__ = ()

    def count(self, key, n=1):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def span(name, *, root=False, timed=False, **counts):
    """A span named `name` with the initial `counts`, to use in a `with`.

    `root`: the span of a public entry point, kept only where no span is
    open (called from another entry point, its work falls under that one's
    spans).  `timed`: read the clock even where nothing records, for a
    caller that reports the span's `seconds`."""
    if not (_profiler._is_profiler_enabled or _TRACE_DIR is not None):
        return Span(name, counts, False) if timed else _OFF
    if root and _innermost() is not None:
        return Span(name, counts, False) if timed else _OFF
    _hook_gc()
    return Span(name, counts, True)


def count(key, n=1):
    """Add `n` to the count `key` of the calling thread's innermost open
    span (or the span it inherited); nothing where nothing records."""
    if not (_profiler._is_profiler_enabled or _TRACE_DIR is not None):
        return
    up = _innermost()
    if up is not None:
        up.count(key, n)


def current():
    """The calling thread's innermost open span while recording, else
    None: what `inherit` hands to another thread."""
    return _innermost() if recording() else None


class _Inherit:
    __slots__ = ("parent", "saved")

    def __init__(self, parent):
        self.parent = parent

    def __enter__(self):
        self.saved = getattr(_local, "base", None)
        _local.base = self.parent

    def __exit__(self, *exc):
        _local.base = self.saved
        return False


def inherit(parent):
    """In a `with`: spans that the calling thread opens where it has none
    open take `parent` (a `current()` of another thread) as their parent
    and its call id.  A None parent does nothing."""
    return _OFF if parent is None else _Inherit(parent)


def spans() -> list:
    """The spans kept so far, each at its end, in order of their ends."""
    with _lock:
        return list(_records)


def dropped() -> int:
    """Spans not kept because `LIMIT` were."""
    return _dropped


def _stack():
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def _innermost():
    stack = getattr(_local, "stack", None)
    if stack:
        return stack[-1]
    return getattr(_local, "base", None)


def _keep(rec):
    global _dropped, _exit_hooked
    with _lock:
        if len(_records) < LIMIT:
            _records.append(rec)
        else:
            _dropped += 1
        if _TRACE_DIR is not None and not _exit_hooked:
            _exit_hooked = True
            atexit.register(_write_at_exit)


def _hook_gc():
    if _on_gc in gc.callbacks:
        return
    with _lock:
        if _on_gc not in gc.callbacks:
            gc.callbacks.append(_on_gc)


def _on_gc(phase, info):
    """`gc.callbacks` hook: a span `gc` per collection while recording.
    Once recording has stopped, it removes itself where it is the last
    hook (removing an earlier one would make the collector skip the next
    hook for this phase)."""
    global _gc_start
    if not recording():
        _gc_start = None
        if phase == "stop" and gc.callbacks and gc.callbacks[-1] is _on_gc:
            gc.callbacks.pop()
        return
    if phase == "start":
        _gc_start = time.perf_counter_ns()
    elif _gc_start is not None:
        rec = Span("gc", {"generation": info.get("generation", -1)}, True)
        rec.start, rec.end = _gc_start, time.perf_counter_ns()
        _gc_start = None
        _keep(rec)


def chrome_events() -> list:
    """Every kept span as a Chrome trace event ("X", microseconds on the
    epoch clock), from one (perf_counter_ns, time_ns) anchor read now."""
    pc, wall = time.perf_counter_ns(), time.time_ns()
    pid = os.getpid()
    return [{"name": r.name, "ph": "X", "pid": pid, "tid": r.thread,
             "ts": (wall + r.start - pc) / 1e3, "dur": (r.end - r.start) / 1e3,
             "args": dict(r.counts, id=r.id, parent=r.parent, call=r.call)}
            for r in spans()]


def _write_at_exit():
    """Every kept span to $GMAT_TPU_TRACE_DIR/spans/<pid>.json."""
    if _TRACE_DIR is None or not _records:
        return
    out = os.path.join(_TRACE_DIR, "spans")
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, f"{os.getpid()}.json"), "w") as f:
        json.dump({"traceEvents": chrome_events(),
                   "otherData": {"dropped": _dropped}}, f)
