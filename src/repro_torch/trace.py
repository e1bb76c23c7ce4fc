"""Spans and counters of the port: where a fit's host and device time goes.

A :func:`span` marks one layer boundary of the port (``runtime.step``,
``vmp.token_plate``, ``svi.slice``, ...; inside a segment latent's
``vmp.token_plate``, ``kernels/fused_zmap.py``'s ``zmap.logits``,
``zmap.prior`` and ``zmap.stats``, one a phase).  Spans nest on a stack per
thread, so each knows its parent, and every span, always, adds to totals
by name: calls, host seconds, self host seconds (its duration less that
of its child spans) and the host seconds of its latest instance
(:func:`totals`).  That costs one dict update and one flag check a span.

**Recording** is on inside ``with recording():`` and while a
``torch.profiler`` session records (the profiler's own enabled flag); no
environment variable or argument turns it on.  While it is on, each span
is also kept as a :class:`Record` in a bounded buffer (:data:`CAPACITY`;
the counter ``trace.dropped`` counts those past it), with its name, id,
parent id, thread, host start and end (``time.perf_counter_ns``) and the
blocking syncs counted under it; on a CUDA device a record also holds a
CUDA event pair on the current stream, for its device ms; under a
profiler the span is also a ``record_function`` range, so the profiler's
trace holds it on its own clock.  Blocking syncs are counted through
``torch.cuda.set_sync_debug_mode("warn")``, set only while an outermost
recorded span is open and restored when it exits, its warnings counted
under the innermost open span and never printed.  Off, a span makes no
record, event or ``record_function`` and sets no sync-debug mode.

:func:`records` gives the latest recording stretch's records: a stretch
begins with a ``recording()`` block, or with the first span opened under
a profiler after one opened with recording off, and the next stretch
replaces its records; :func:`count` adds to a named counter (the
kernels' launches and routes, read by ``kernels.ops.launch_counts`` and
``route_counts``); :func:`counters`, :func:`totals` and :func:`reset` read
and clear the rest; :func:`report` prints a table by name.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import threading
import time
import warnings
from typing import Optional

import torch
from torch.autograd import profiler as _profiler

#: records kept per recording stretch; ``trace.dropped`` counts later spans
CAPACITY = 1 << 16

#: the warning that ``set_sync_debug_mode("warn")`` gives for each
#: synchronizing CUDA call
_SYNC_WARNING = "called a synchronizing CUDA operation"

_lock = threading.Lock()
_local = threading.local()
_ids = itertools.count(1)
_totals: dict = {}                   # name -> [calls, host ns, self ns, last ns]
_counters: collections.Counter = collections.Counter()
_records: list = []
_explicit = 0                        # depth of open recording() blocks
_in_stretch = False
_watchers = 0                        # outermost recorded spans open
_watch: Optional[tuple] = None       # (saved mode, warnings guard, handler)


class Record:
    """One recorded span.  ``syncs`` counts the blocking syncs made while
    it was the innermost open span (its children's are their own)."""

    __slots__ = ("name", "id", "parent", "thread", "start_ns", "end_ns",
                 "syncs", "events")

    def __init__(self, name, id, parent, thread, start_ns, events):
        self.name, self.id, self.parent = name, id, parent
        self.thread, self.start_ns, self.end_ns = thread, start_ns, None
        self.syncs, self.events = 0, events

    @property
    def host_ms(self) -> Optional[float]:
        """Host ms from enter to exit (None while the span is open)."""
        if self.end_ns is None:
            return None
        return (self.end_ns - self.start_ns) * 1e-6

    @property
    def device_ms(self) -> Optional[float]:
        """Device ms between the span's two CUDA events (idle inside the
        span included), waiting for the second; None without events."""
        if self.events is None or self.end_ns is None:
            return None
        start, end = self.events
        end.synchronize()
        return start.elapsed_time(end)


def _stack() -> list:
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


def _recording() -> bool:
    return bool(_explicit) or _profiler._is_profiler_enabled


def _new_stretch() -> None:
    global _in_stretch
    _records.clear()
    _in_stretch = True


def _count_sync(message, category, filename, lineno, file=None, line=None):
    """``warnings.showwarning`` while syncs are watched: a sync warning is
    counted under this thread's innermost recorded span; any other warning
    goes on to the saved handler."""
    if _SYNC_WARNING not in str(message):
        _watch[2](message, category, filename, lineno, file, line)
        return
    for sp in reversed(getattr(_local, "stack", ())):
        if sp.rec is not None:
            sp.rec.syncs += 1
            return


def _watch_syncs() -> None:
    global _watchers, _watch
    with _lock:
        _watchers += 1
        if _watchers == 1:
            guard = warnings.catch_warnings()
            guard.__enter__()
            warnings.filterwarnings("always", message=_SYNC_WARNING)
            # the mode's own notice, given once a process
            warnings.filterwarnings("ignore", message="Synchronization debug")
            _watch = (torch.cuda.get_sync_debug_mode(), guard,
                      warnings.showwarning)
            warnings.showwarning = _count_sync
            torch.cuda.set_sync_debug_mode("warn")


def _unwatch_syncs() -> None:
    global _watchers, _watch
    with _lock:
        _watchers -= 1
        if _watchers == 0:
            mode, guard, _ = _watch
            torch.cuda.set_sync_debug_mode(mode)
            guard.__exit__(None, None, None)
            _watch = None


class span(contextlib.ContextDecorator):
    """``with span(name):`` or ``@span(name)``: one layer boundary of the
    port, timed into :func:`totals` always and recorded while recording
    is on (module docstring)."""

    __slots__ = ("name", "rec", "_t0", "_child", "_rf", "_watcher")

    def __init__(self, name: str):
        self.name = name

    def _recreate_cm(self):
        return span(self.name)

    def __enter__(self):
        global _in_stretch
        stack = _stack()
        self.rec = self._rf = None
        self._watcher = False
        self._child = 0
        if _recording():
            parent = stack[-1].rec if stack else None
            with _lock:
                if not _in_stretch:
                    _new_stretch()
                if len(_records) < CAPACITY:
                    self.rec = Record(self.name, next(_ids),
                                      parent.id if parent else None,
                                      threading.current_thread().name, 0,
                                      None)
                    _records.append(self.rec)
                else:
                    _counters["trace.dropped"] += 1
            if self.rec is not None:
                cuda = torch.cuda.is_initialized()
                if cuda and parent is None:
                    self._watcher = True
                    _watch_syncs()
                if _profiler._is_profiler_enabled:
                    self._rf = _profiler.record_function(self.name)
                    self._rf.__enter__()
                if cuda:
                    ev = torch.cuda.Event(enable_timing=True)
                    ev.record()
                    self.rec.events = (ev, None)
        elif _in_stretch:
            _in_stretch = False
        stack.append(self)
        self._t0 = time.perf_counter_ns()
        if self.rec is not None:
            self.rec.start_ns = self._t0
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        stack = _stack()
        stack.pop()
        dur = t1 - self._t0
        if stack:
            stack[-1]._child += dur
        rec = self.rec
        if rec is not None:
            if rec.events is not None:
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                rec.events = (rec.events[0], ev)
            rec.end_ns = t1
            if self._rf is not None:
                self._rf.__exit__(None, None, None)
            if self._watcher:
                _unwatch_syncs()
        with _lock:
            t = _totals.get(self.name)
            if t is None:
                t = _totals[self.name] = [0, 0, 0, 0]
            t[0] += 1
            t[1] += dur
            t[2] += dur - self._child
            t[3] = dur
        return False


@contextlib.contextmanager
def recording():
    """Record every span for the block: a new recording stretch begins,
    whose records :func:`records` gives until the next one begins."""
    global _explicit, _in_stretch
    with _lock:
        if not _explicit:
            _new_stretch()
        _explicit += 1
    try:
        yield
    finally:
        with _lock:
            _explicit -= 1
            if not _recording():
                _in_stretch = False


def records() -> list:
    """The latest recording stretch's :class:`Record`\\ s, in the order
    their spans began."""
    with _lock:
        return list(_records)


def totals() -> dict:
    """``{name: {"calls", "host_s", "self_s", "last_s"}}`` of every span
    since the last :func:`reset`, recorded or not."""
    with _lock:
        return {n: {"calls": c, "host_s": h * 1e-9, "self_s": s * 1e-9,
                    "last_s": last * 1e-9}
                for n, (c, h, s, last) in _totals.items()}


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``."""
    with _lock:
        _counters[name] += n


def counters() -> dict:
    """Every counter's value since its last :func:`reset`."""
    with _lock:
        return dict(_counters)


def reset(prefix: Optional[str] = None) -> None:
    """Clear the totals, the counters and the records; with ``prefix``,
    only the counters whose names start with it."""
    with _lock:
        for name in [n for n in _counters
                     if prefix is None or n.startswith(prefix)]:
            del _counters[name]
        if prefix is None:
            _totals.clear()
            _records.clear()


def report() -> str:
    """A table by span name: calls, host ms, self ms, device ms and syncs
    of the latest recording stretch's records, or, where nothing was
    recorded, calls, host ms and self ms of the totals; then the
    counters."""
    recs = [r for r in records() if r.end_ns is not None]
    rows: dict = {}
    if recs:
        child = collections.Counter()
        for r in recs:
            if r.parent is not None:
                child[r.parent] += r.end_ns - r.start_ns
        for r in recs:
            row = rows.setdefault(r.name, [0, 0.0, 0.0, None, 0])
            row[0] += 1
            row[1] += r.host_ms
            row[2] += r.host_ms - child[r.id] * 1e-6
            if r.events is not None:
                row[3] = (row[3] or 0.0) + r.device_ms
            row[4] += r.syncs
    else:
        for n, t in totals().items():
            rows[n] = [t["calls"], t["host_s"] * 1e3, t["self_s"] * 1e3,
                       None, None]
    width = max([len(n) for n in rows] + [4])
    lines = [f"{'span':<{width}} {'calls':>7} {'host ms':>11} "
             f"{'self ms':>11} {'device ms':>11} {'syncs':>6}"]
    for n, (c, h, s, d, y) in sorted(rows.items(), key=lambda kv: -kv[1][1]):
        dev = "-" if d is None else f"{d:.3f}"
        lines.append(f"{n:<{width}} {c:>7} {h:>11.3f} {s:>11.3f} {dev:>11} "
                     f"{'-' if y is None else y:>6}")
    for n, v in sorted(counters().items()):
        lines.append(f"{n} = {v}")
    return "\n".join(lines)
