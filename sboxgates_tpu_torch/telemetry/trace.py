"""Structured tracing: typed spans, recorded per thread, exported as a
Chrome/Perfetto ``trace.json`` (``--trace``).

Span taxonomy (the ``cat`` field):

==============  ==========================================================
``dispatch``    one device sweep call of the search layer
                (``SearchContext.dispatch``); the span count equals the
                ``device_dispatches`` counter.  Its args name the sweep,
                the node's gate count and, for a sweep that launches one
                of the kernels K1-K5, the analytic cost of its last launch
``deadline``    a guarded dispatch window, a breach, a retry exhaustion,
                a breaker trip
``journal``     one fsync'd journal append
``phase``       a PhaseProfiler phase frame (``--trace`` only)
``wait``        a consumer blocked on a device sync (overlap accounting)
``produce``     the host chunk stream's chunk-generation span
``stall``       a consumer blocked on the prefetch queue
``fallback``    a degradation signal (native service failure)
==============  ==========================================================

Recording model: each thread appends finished spans to its own buffer
(registered once under a lock, then append-only: list append is atomic in
CPython), so tracing adds no cross-thread contention, and a thread the
deadline abandoned keeps its spans apart from its successor's.  When
tracing is disabled (the default), a span is two attribute checks plus an
optional flight-ring append.  Spans time host-side events only and never
touch the device.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import List, Optional

from . import flight as _flightmod


def set_rank(rank: Optional[int]) -> None:
    """Pins this process's rank for trace and dump tagging (``None``: 0,
    the port's one process).  One rank store, the flight recorder's,
    serves both."""
    _flightmod.set_rank(rank)


def process_rank() -> int:
    """Rank for the trace ``pid`` and dump names: 0 unless
    :func:`set_rank` pinned another."""
    return _flightmod.flight_recorder().rank()


class _SpanHandle:
    """Context manager for one in-flight span; ``set(key=value)`` adds
    attributes discovered mid-span."""

    __slots__ = ("_tr", "name", "cat", "args", "_t0", "_flight")

    def __init__(self, tr: "Tracer", name: str, cat: str, args, flt: bool):
        self._tr = tr
        self.name = name
        self.cat = cat
        self.args = args
        self._flight = flt
        self._t0 = 0.0

    def set(self, **attrs) -> None:
        if self.args is None:
            self.args = attrs
        else:
            self.args.update(attrs)

    def __enter__(self) -> "_SpanHandle":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        self._tr.record(
            self.name, self.cat, self._t0, time.perf_counter(),
            self.args, flight=self._flight,
        )
        return False


class _NullSpan:
    """Shared no-op handle for the disabled-and-no-flight fast path."""

    __slots__ = ()

    def set(self, **attrs) -> None:
        pass

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False


_NULL = _NullSpan()


class Tracer:
    """Per-process span recorder; see the module docstring.

    ``enabled`` gates the trace buffers only: the flight ring is fed by
    flight-worthy spans regardless, so a run without ``--trace`` still
    leaves a usable dump.
    """

    def __init__(self, enabled: bool = False):
        self.enabled = enabled
        # Spans time with perf_counter; the export re-anchors them to the
        # wall clock taken at the same moment.
        self.epoch = time.perf_counter()
        self.epoch_unix = time.time()
        self._lock = threading.Lock()
        #: (tid, event list) per registered thread: a list, not a dict keyed
        #: by thread id, because ids are reused once a thread dies (the
        #: deadline's workers are short-lived).  Events are (name, cat, t0,
        #: dur_or_None, args_or_None) tuples.
        self._buffers: List[tuple] = []
        self._tls = threading.local()

    def _buf(self) -> List[tuple]:
        try:
            return self._tls.buf
        except AttributeError:
            buf: List[tuple] = []
            with self._lock:
                self._buffers.append((threading.get_ident(), buf))
            self._tls.buf = buf
            return buf

    def reset(self) -> None:
        """Drops every recorded event and restarts the epoch."""
        with self._lock:
            self._buffers.clear()
        self._tls = threading.local()
        self.epoch = time.perf_counter()
        self.epoch_unix = time.time()

    # -- recording ---------------------------------------------------------

    def span(self, name: str, cat: str, _flight: bool = True, **args):
        """A context manager timing one span.  ``_flight=False`` keeps
        high-frequency spans (phases, overlap intervals) out of the bounded
        flight ring."""
        if not self.enabled and not _flight:
            return _NULL
        return _SpanHandle(self, name, cat, args or None, _flight)

    def record(
        self, name: str, cat: str, t0: float, t1: float,
        args: Optional[dict] = None, flight: bool = True,
    ) -> None:
        """Records one finished span from caller-supplied timestamps."""
        if self.enabled:
            self._buf().append((name, cat, t0, t1 - t0, args))
        if flight:
            _flightmod.note(name, cat, t0, t1 - t0, args)

    def instant(
        self, name: str, cat: str, _flight: bool = True, **args
    ) -> None:
        """A zero-duration event (breaches, fallbacks, trips)."""
        t = time.perf_counter()
        if self.enabled:
            self._buf().append((name, cat, t, None, args or None))
        if _flight:
            _flightmod.note(name, cat, t, None, args or None)

    # -- export ------------------------------------------------------------

    def events(self) -> List[tuple]:
        """Every recorded event as (name, cat, t0, dur, tid, args),
        time-ordered."""
        with self._lock:
            bufs = [(tid, list(buf)) for tid, buf in self._buffers]
        out = [
            (name, cat, t0, dur, tid, args)
            for tid, buf in bufs
            for (name, cat, t0, dur, args) in buf
        ]
        out.sort(key=lambda e: e[2])
        return out

    def chrome_trace(self) -> dict:
        """The Chrome trace-event JSON object (Perfetto loads it): ``X``
        events for spans, ``i`` for instants, ``pid`` = process rank."""
        rank = process_rank()
        events: List[dict] = [
            {
                "ph": "M", "name": "process_name", "pid": rank, "tid": 0,
                "args": {"name": f"sboxgates rank {rank}"},
            },
            {
                "ph": "M", "name": "process_sort_index", "pid": rank,
                "tid": 0, "args": {"sort_index": rank},
            },
        ]
        for name, cat, t0, dur, tid, args in self.events():
            ev = {
                "name": name,
                "cat": cat,
                "ts": (self.epoch_unix + (t0 - self.epoch)) * 1e6,
                "pid": rank,
                "tid": tid,
            }
            if dur is None:
                ev["ph"] = "i"
                ev["s"] = "t"
            else:
                ev["ph"] = "X"
                ev["dur"] = dur * 1e6
            if args:
                ev["args"] = {k: _jsonable(v) for k, v in args.items()}
            events.append(ev)
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def export(self, path: str) -> str:
        """Writes the Perfetto trace to ``path`` (directories created);
        returns the path."""
        from ..resilience.checkpoint import durable_write_text

        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        durable_write_text(path, json.dumps(self.chrome_trace()))
        return path


def _jsonable(v):
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    return str(v)[:200]


_TRACER = Tracer()


def tracer() -> Tracer:
    """The process-global tracer every layer records into."""
    return _TRACER


def span(name: str, cat: str, _flight: bool = True, **args):
    return _TRACER.span(name, cat, _flight=_flight, **args)


def instant(name: str, cat: str, _flight: bool = True, **args) -> None:
    _TRACER.instant(name, cat, _flight=_flight, **args)


def trace_null():
    """The shared no-op span handle (the disabled fast path)."""
    return _NULL
