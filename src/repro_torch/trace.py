"""Spans on the profiler's clock: the port's opt-in host tracer.

Off by default; :func:`set_enabled` switches it on and off. Off,
:func:`span` returns one shared no-op after a single flag test: nothing is
allocated or stamped and no ``record_function`` is entered. On, a span
records its name, its id, its parent's id and a trace id shared by every
span under one root (``psvgp.fit`` roots a fit's trace), its start and end
as ``time.perf_counter_ns()``, and a dict of attributes, the counts taken
at that boundary. Each span is also a ``record_function`` range of the
same name (torch's C++ one, ``_RecordFunctionFast``: under the profiler
``torch.profiler.record_function``'s Python enter and exit take tens of
us, so its range strays that far from the span), and shows among the
profiler's host events on the device events' timeline. Kineto stamps events in epoch ns
(``kineto_results.trace_start_ns()`` plus ``time_range``); the tracer takes
one anchor pair ``(time.time_ns(), time.perf_counter_ns())`` when switched
on, and :func:`epoch_ns` maps a span's stamps onto that clock.

Finished spans wait in a bounded buffer (the oldest are dropped and
counted) until :func:`drain` hands them over. The tracer never
synchronizes: a span may carry a pair of CUDA events
(:meth:`Span.device_ms`, or its own with ``span(name, events=True)``) and
counters that are tensors on the device, all read only at :func:`drain`,
after the caller's own synchronize.

The operator's use, around an in-situ fit::

    from repro_torch import trace
    trace.set_enabled(True)
    state = psvgp.fit(static, psvgp.init(seed, cfg, data), data, 2500, use_scan=True)
    torch.cuda.synchronize()
    trace.set_enabled(False)
    spans = trace.drain()["spans"]

and read there the per-fit stall (``psvgp.fit`` less its ``psvgp.replay``:
warm-up, capture, copy-out), the device memory a fit leaves behind
(``retained_bytes``, ``device_allocs`` / ``device_frees`` on ``psvgp.fit``),
the capture's own cost (``psvgp.capture`` less ``psvgp.capture.step``) and
the replays' device time (``device_ms`` on ``psvgp.replay``). One tracer a
process, for spans opened by one thread at a time (the parent links are one
stack).
"""
from __future__ import annotations

import collections
import itertools
import time

import torch

CAPACITY = 10_000  # finished spans held until drain()


class _NoSpan:
    """What :func:`span` returns while tracing is off: does nothing."""

    on = False

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs) -> None:
        pass

    def device_ms(self, start, end) -> None:
        pass


class Span:
    """One timed range; a context manager, opened by :func:`span`."""

    on = True
    __slots__ = ("name", "span_id", "parent_id", "trace_id", "start_ns", "end_ns", "attrs",
                 "_events", "_range")

    def __init__(self, name: str, span_id: int, parent: Span | None, events: bool = False):
        self.name, self.span_id = name, span_id
        self.parent_id = parent.span_id if parent is not None else None
        self.trace_id = parent.trace_id if parent is not None else span_id
        self.start_ns = self.end_ns = 0
        self.attrs: dict = {}
        self._events = (torch.cuda.Event(enable_timing=True),
                        torch.cuda.Event(enable_timing=True)) if events else None

    def set(self, **attrs) -> None:
        """Attach counts taken at this boundary."""
        self.attrs.update(attrs)

    def device_ms(self, start, end) -> None:
        """Attribute ``device_ms``: the ms between two recorded CUDA events,
        read at :func:`drain`."""
        self._events = (start, end)

    def __enter__(self):
        _TRACER.stack.append(self)
        self._range = torch._C._profiler._RecordFunctionFast(self.name)
        self._range.__enter__()
        self.start_ns = time.perf_counter_ns()
        if self._events is not None:
            self._events[0].record()
        return self

    def __exit__(self, *exc):
        if self._events is not None:
            self._events[1].record()
        self._range.__exit__(*exc)
        self._range = None
        self.end_ns = time.perf_counter_ns()
        _TRACER.stack.pop()
        _TRACER.keep(self)
        return False

    def record(self) -> dict:
        if self._events is not None:
            start, end = self._events
            self.attrs["device_ms"] = start.elapsed_time(end) if end.query() else None
            self._events = None
        for k, v in self.attrs.items():  # counters kept on the device, read now
            if isinstance(v, torch.Tensor):
                self.attrs[k] = v.item()
        return {"name": self.name, "span_id": self.span_id, "parent_id": self.parent_id,
                "trace_id": self.trace_id, "start_ns": self.start_ns, "end_ns": self.end_ns,
                "attrs": self.attrs}


class _Tracer:
    def __init__(self):
        self.on = False
        self.anchor = (0, 0)
        self.spans: collections.deque = collections.deque(maxlen=CAPACITY)
        self.dropped = 0
        self.ids = itertools.count(1)
        self.stack: list[Span] = []  # the open spans, innermost last

    def keep(self, s: Span) -> None:
        if len(self.spans) == self.spans.maxlen:
            self.dropped += 1
        self.spans.append(s)


_NOOP = _NoSpan()
_TRACER = _Tracer()


def set_enabled(on: bool) -> None:
    """Switch the tracer on (taking a new clock anchor) or off. Spans kept
    so far stay until :func:`drain`."""
    if on and not _TRACER.on:
        _TRACER.anchor = (time.time_ns(), time.perf_counter_ns())
    _TRACER.on = bool(on)


def span(name: str, events: bool = False):
    """A context manager timing ``name``: a :class:`Span` while tracing is
    on, else a shared no-op. Attach counts with ``.set(...)`` under
    ``if s.on:``, so the off path builds no arguments. ``events``: the span
    also records a CUDA event on the current stream at its start and end,
    its ``device_ms`` read at :func:`drain`."""
    if not _TRACER.on:
        return _NOOP
    return Span(name, next(_TRACER.ids), _TRACER.stack[-1] if _TRACER.stack else None, events)


def drain() -> dict:
    """The finished spans, oldest first, as plain dicts (CUDA event pairs
    read now: call after synchronizing), the count dropped since the last
    drain and the clock anchor; empties the buffer."""
    spans = [s.record() for s in _TRACER.spans]
    _TRACER.spans.clear()
    dropped, _TRACER.dropped = _TRACER.dropped, 0
    return {"spans": spans, "dropped": dropped, "anchor_ns": list(_TRACER.anchor)}


def epoch_ns(perf_ns: int, anchor_ns) -> int:
    """A ``perf_counter_ns`` stamp on the profiler's (epoch ns) clock."""
    return anchor_ns[0] + (perf_ns - anchor_ns[1])
