"""Profiling hooks: the port of floodgan_tpu/utils/profiling.py, and the
port's spans.

``trace(profile_dir)`` records a ``torch.profiler`` trace (CPU and, where
there is a card, CUDA activity) of its body and writes it into
``profile_dir`` as a Chrome trace (open it in chrome://tracing or
Perfetto).

``span(name, ident=None, parent=None, device=None)`` marks one stretch
of the program's work: the serving worker's gather, batch, stack and
delivery, the engine's copies and forward, the trainers' step and its
updates.  Spans record only while a torch profiler records in this
process, on any thread: under ``trace()``, under a caller's own
``torch.profiler.profile``, or under the benchmark's traced slice.  Off,
a span costs one flag check.  On, it enters a ``record_function`` range
of its name (so it shows in the profiler's trace), appends a
``SpanRecord`` to an in-memory ring of the newest ``RING_SIZE`` records,
read through ``span_records()``, and, given a CUDA ``device``, records a
CUDA event pair at its bounds, whose device milliseconds are resolved
when the records are read.  Records carry ``time.perf_counter`` times;
``profiler_clock_ns`` maps them onto the profiler's clock.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import itertools
import os
import threading
import time
from typing import Iterator, List, Optional

import torch
import torch.autograd.profiler as _autograd_profiler

RING_SIZE = 4096


@contextlib.contextmanager
def trace(profile_dir: Optional[str]) -> Iterator[None]:
    """Profile the body into ``profile_dir/trace.json``; no-op for None."""
    if not profile_dir:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(profile_dir, "trace.json"))


@dataclasses.dataclass
class SpanRecord:
    """One span: ``id`` is unique in the process, ``parent`` the id of the
    span that caused it (None for a root), ``ident`` the caller's number
    for it (a request, a batch, a step), ``start`` and ``end`` in
    ``time.perf_counter`` seconds, ``device_ms`` the card's milliseconds
    between its bounds (None without a CUDA device)."""

    name: str
    id: int
    parent: Optional[int]
    ident: Optional[int]
    start: float
    end: float
    device_ms: Optional[float] = None
    events: Optional[tuple] = dataclasses.field(default=None, repr=False, compare=False)


_ring: "collections.deque[SpanRecord]" = collections.deque(maxlen=RING_SIZE)
_ids = itertools.count(1)
_local = threading.local()  # .open: this thread's stack of open spans' ids


def tracing() -> bool:
    """Whether a torch profiler records in this process.  The flag is the
    process-wide one, so a thread started before the profiler sees it."""
    return _autograd_profiler._is_profiler_enabled


def _open_stack() -> list:
    stack = getattr(_local, "open", None)
    if stack is None:
        stack = _local.open = []
    return stack


class _Span:
    __slots__ = ("name", "ident", "parent", "device", "id", "start", "_range", "_events")

    def __init__(self, name: str, ident, parent, device):
        self.name, self.ident, self.parent, self.device = name, ident, parent, device

    def __enter__(self) -> "_Span":
        stack = _open_stack()
        if self.parent is None and stack:
            self.parent = stack[-1]
        self.id = next(_ids)
        stack.append(self.id)
        self._range = torch.profiler.record_function(self.name)
        self._range.__enter__()
        self._events = None
        if self.device is not None and self.device.type == "cuda":
            self._events = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            self._events[0].record(torch.cuda.current_stream(self.device))
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        end = time.perf_counter()
        if self._events is not None:
            self._events[1].record(torch.cuda.current_stream(self.device))
        self._range.__exit__(*exc)
        _open_stack().pop()
        _ring.append(SpanRecord(self.name, self.id, self.parent, self.ident, self.start, end, events=self._events))


_OFF = contextlib.nullcontext()


def span(name: str, ident: Optional[int] = None, parent: Optional[int] = None,
         device: Optional[torch.device] = None):
    """A context manager that records the stretch it encloses while
    ``tracing()`` (decided on entry; it yields the open span, whose
    ``.id`` children may name, or None when off).  ``parent`` defaults to
    the innermost span open on this thread.  On a CUDA ``device`` the
    span records a CUDA event pair on the device's current stream, for
    its ``device_ms``."""
    if not tracing():
        return _OFF
    return _Span(name, ident, parent, device)


def record(name: str, start: float, end: float, ident: Optional[int] = None, parent: Optional[int] = None) -> int:
    """Append the record of a stretch whose bounds were read before it was
    decided to record it (a request's wait, from another thread's clock
    reading); the caller checks ``tracing()`` first.  Returns its id.
    Such a span has no ``record_function`` range."""
    rid = next(_ids)
    _ring.append(SpanRecord(name, rid, parent, ident, start, end))
    return rid


def span_records() -> List[SpanRecord]:
    """The ring's records, in the order their spans ended (the newest
    ``RING_SIZE``); each one's device milliseconds are resolved here,
    waiting for its end event."""
    out = list(_ring)
    for r in out:
        events = r.events
        if events is not None:
            events[1].synchronize()
            r.device_ms = events[0].elapsed_time(events[1])
            r.events = None
    return out


def profiler_clock_ns(t: float) -> int:
    """The profiler's clock, in ns, at the ``time.perf_counter()`` reading
    ``t``.  The profiler stamps its events on the wall clock: an event's
    ``time_range`` counts microseconds from
    ``prof.profiler.kineto_results.trace_start_ns()``, and an exported
    Chrome trace's ``ts`` counts microseconds from its
    ``baseTimeNanoseconds``."""
    best = None
    for _ in range(3):  # the tightest bracket of three
        a = time.perf_counter_ns()
        wall = time.time_ns()
        b = time.perf_counter_ns()
        if best is None or b - a < best[0]:
            best = (b - a, wall - (a + b) // 2)
    return round(t * 1e9) + best[1]
