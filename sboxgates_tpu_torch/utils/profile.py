"""Per-phase wall-clock profiling (``ctx.prof``; ``-v -v`` prints its
report).

The reference has no tracing, only verbosity-gated progress lines.  The
port keeps the JAX package's per-phase timers at the same phase sites
(the node heads in ``search/context.py``, the LUT drivers in
``search/lut.py``, the recursion and the native engines in
``search/kwan.py``), so a run reports where its wall time went and the
candidates per second of each phase.

Self-time accounting: a phase's recorded seconds exclude the time spent in
nested phases, so the numbers add up even though the 5-LUT sweep runs
inside a recursion phase, and a re-entrant phase (the Kwan recursion)
accumulates each frame's own self time.

Overlap accounting (the host chunk stream): per phase, the consumer's
blocking device syncs are *device-wait* intervals (``add_wait``), the
background producer's chunk-generation spans *host-produce* intervals
(``add_produce``, from the producer thread) and the consumer's blocks on
the prefetch queue *stall* intervals (``add_stall``), all on the
``perf_counter`` clock.  ``off_critical_path_s`` is the produce time that
did not elapse inside a stall: 0 for a serial stream (``--pipeline-depth
1``), and near ``host_produce_s`` when the prefetcher keeps ahead.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Tuple

from ..telemetry import trace as _ttrace


class _OverlapStream:
    """Per-(phase, consumer) overlap accounting with bounded memory.

    Totals (wait/produce/stall seconds) accumulate as scalars at record
    time; interval lists are pending state kept ONLY for the two
    intersections (produce∩wait -> hidden, produce∩stall -> on-critical-
    path) and are folded into scalar accumulators as soon as no future
    interval can overlap them — an hours-long production run holds at
    most ~FOLD_AT intervals per stream instead of one tuple per chunk
    forever.

    Folding is safe because each stream is appended in monotonically
    non-decreasing time by exactly one thread (waits and stalls by the
    consumer, produces by that consumer's single producer): once both
    consumer streams have advanced past a produce span's end, no future
    wait/stall can reach back and overlap it, so its intersections are
    settled and it collapses into the accumulators.  Each produce span
    is folded exactly once and produce spans are mutually disjoint, so
    summing per-fold intersections is exact, not an approximation.
    """

    __slots__ = (
        "wait_s", "produce_s", "stall_s",
        "hidden_acc", "produce_merged_acc", "stall_produce_acc",
        "waits", "produces", "stalls",
        "last_wait_end", "last_stall_end", "last_produce_end",
    )

    FOLD_AT = 1024

    def __init__(self):
        self.wait_s = self.produce_s = self.stall_s = 0.0
        self.hidden_acc = 0.0
        self.produce_merged_acc = 0.0
        self.stall_produce_acc = 0.0
        self.waits: List[Tuple[float, float]] = []
        self.produces: List[Tuple[float, float]] = []
        self.stalls: List[Tuple[float, float]] = []
        self.last_wait_end = self.last_stall_end = 0.0
        self.last_produce_end = 0.0

    def fold(self, intersect, merged_len) -> None:
        """Collapse settled pending intervals into the accumulators."""
        if self.produces:
            # A produce span is settled once BOTH consumer streams have
            # recorded past its end (their future spans start no
            # earlier than their last end).
            w = min(self.last_wait_end, self.last_stall_end)
            idx = 0
            while idx < len(self.produces) and self.produces[idx][1] <= w:
                idx += 1
            if idx:
                done = self.produces[:idx]
                del self.produces[:idx]
                self.hidden_acc += intersect(self.waits, done)
                self.stall_produce_acc += intersect(self.stalls, done)
                self.produce_merged_acc += merged_len(done)
                # Drop consumer spans no remaining/future produce span
                # can overlap (future produces start at or after the
                # pending head / the last produce end).
                floor = (
                    self.produces[0][0] if self.produces
                    else self.last_produce_end
                )
                self.waits = [iv for iv in self.waits if iv[1] > floor]
                self.stalls = [iv for iv in self.stalls if iv[1] > floor]
        # Producer-less phases (the device-stream drivers record only
        # verdict waits) never trigger the produce fold: bound them
        # by shedding the oldest consumer spans outright.  Totals are
        # already scalar-accumulated, and a live producer lags the
        # consumer by at most the bounded queue depth (<< FOLD_AT), so
        # spans this old can never intersect a future produce.
        for attr in ("waits", "stalls"):
            iv = getattr(self, attr)
            if len(iv) > self.FOLD_AT:
                del iv[: len(iv) - self.FOLD_AT // 2]

    def pending_size(self) -> int:
        return len(self.waits) + len(self.produces) + len(self.stalls)


class PhaseProfiler:
    """Accumulates self-time seconds and call counts per named phase.

    Thread-safe: the frame stack is thread-local (a guarded sweep runs on
    the dispatch deadline's worker thread), and the accumulators are
    lock-protected.

    Usage::

        prof = PhaseProfiler()
        with prof.phase("lut5"):
            ...
        print(prof.report())
    """

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.seconds: Dict[str, float] = {}
        self.calls: Dict[str, int] = {}
        # Overlap accounting for the pipelined streaming drivers: device
        # -wait (consumer blocking on a verdict), host-produce
        # (background chunk generation), and consumer-stall (consumer
        # blocked on the prefetch queue — or producing inline at
        # depth 1) (start, end) perf_counter intervals, keyed by
        # (phase, consumer) so concurrent drivers sharing a phase name
        # never cross-pollinate each other's intersections: driver A's
        # produce span inside driver B's device wait is not hidden work.
        # _OverlapStream keeps the memory bounded (intervals fold into
        # scalar accumulators once settled).
        self._overlap: Dict[Tuple[str, int], _OverlapStream] = {}
        self._tls = threading.local()
        self._lock = threading.Lock()
        self._t0 = time.perf_counter()

    @property
    def _stack(self) -> List[List]:
        """Per-thread stack of [name, start_time, child_seconds] frames."""
        try:
            return self._tls.stack
        except AttributeError:
            self._tls.stack = []
            return self._tls.stack

    def phase(self, name: str) -> "_Phase":
        return _Phase(self, name)

    def add(self, name: str, seconds: float, calls: int = 1) -> None:
        with self._lock:
            self.seconds[name] = self.seconds.get(name, 0.0) + seconds
            self.calls[name] = self.calls.get(name, 0) + calls

    def _overlap_stream(self, name: str, consumer: Optional[int]):
        """The (phase, consumer) overlap stream; ``consumer`` identifies
        the consuming driver (defaults to the calling thread) so that
        concurrent drivers sharing a phase name stay separate."""
        key = (name, threading.get_ident() if consumer is None else consumer)
        stream = self._overlap.get(key)
        if stream is None:
            stream = self._overlap[key] = _OverlapStream()
        return stream

    def _trace_overlap(self, name: str, kind: str,
                       start: float, end: float) -> None:
        # Overlap streams double as span sources (--trace): each interval
        # becomes a wait/produce/stall span on the recording thread's
        # timeline, so the pipeline's producer/consumer interleaving is
        # visible in Perfetto, not just summed in the overlap table.
        # High-frequency -> trace buffers only, never the flight ring.
        tr = _ttrace.tracer()
        if tr.enabled:
            tr.record(f"{name}.{kind}", kind, start, end, flight=False)

    def add_wait(self, name: str, start: float, end: float,
                 consumer: Optional[int] = None) -> None:
        """Device-wait interval: consumer blocked on a device sync
        between perf_counter timestamps ``start`` and ``end``."""
        if not self.enabled:
            return
        self._trace_overlap(name, "wait", start, end)
        with self._lock:
            s = self._overlap_stream(name, consumer)
            s.wait_s += end - start
            s.waits.append((start, end))
            s.last_wait_end = max(s.last_wait_end, end)
            if s.pending_size() > _OverlapStream.FOLD_AT:
                s.fold(self._intersect, self._merged_len)

    def add_produce(self, name: str, start: float, end: float,
                    consumer: Optional[int] = None) -> None:
        """Host-produce interval: one chunk's generation span.  Called
        from the producer thread — ``consumer`` must carry the consuming
        driver's key (the prefetcher's owner records it at creation)."""
        if not self.enabled:
            return
        self._trace_overlap(name, "produce", start, end)
        with self._lock:
            s = self._overlap_stream(name, consumer)
            s.produce_s += end - start
            s.produces.append((start, end))
            s.last_produce_end = max(s.last_produce_end, end)
            if s.pending_size() > _OverlapStream.FOLD_AT:
                s.fold(self._intersect, self._merged_len)

    def add_stall(self, name: str, start: float, end: float,
                  consumer: Optional[int] = None) -> None:
        """Consumer-stall interval: time the consumer spent blocked in
        the prefetcher's get() — production on its critical path."""
        if not self.enabled:
            return
        self._trace_overlap(name, "stall", start, end)
        with self._lock:
            s = self._overlap_stream(name, consumer)
            s.stall_s += end - start
            s.stalls.append((start, end))
            s.last_stall_end = max(s.last_stall_end, end)
            if s.pending_size() > _OverlapStream.FOLD_AT:
                s.fold(self._intersect, self._merged_len)

    def snapshot(self) -> Dict[str, Tuple[float, int]]:
        """{phase: (self_seconds, calls)} for programmatic consumers."""
        return {
            k: (self.seconds[k], self.calls.get(k, 0))
            for k in self.seconds
        }

    @staticmethod
    def _merge(iv: List[Tuple[float, float]]) -> List[List[float]]:
        """Abutting/overlapping intervals merged into a disjoint set."""
        out: List[List[float]] = []
        for s, e in sorted(iv):
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    @classmethod
    def _merged_len(cls, iv: List[Tuple[float, float]]) -> float:
        """Total wall time covered by an interval set (merged length)."""
        return sum(e - s for s, e in cls._merge(iv))

    @classmethod
    def _intersect(cls, a: List[Tuple[float, float]],
                   b: List[Tuple[float, float]]) -> float:
        """Total length of the intersection of two interval sets (each
        set's intervals may abut/overlap; both are merged first)."""
        ma, mb = cls._merge(a), cls._merge(b)
        i = j = 0
        total = 0.0
        while i < len(ma) and j < len(mb):
            lo = max(ma[i][0], mb[j][0])
            hi = min(ma[i][1], mb[j][1])
            if hi > lo:
                total += hi - lo
            if ma[i][1] <= mb[j][1]:
                i += 1
            else:
                j += 1
        return total

    def overlap(self) -> Dict[str, Dict[str, float]]:
        """Per-phase overlap accounting for programmatic consumers:
        {phase: {device_wait_s, host_produce_s, consumer_stall_s,
        hidden_s, off_critical_path_s}}.

        ``hidden_s`` is the MEASURED intersection of producer spans with
        consumer device-wait spans — host-produce wall time that
        actually elapsed under a device sync.  ``off_critical_path_s``
        is the broader win, measured the same way: produce time that did
        NOT elapse inside a consumer stall (the consumer was busy
        dispatching/solving OR blocked on the device while the producer
        worked).  Interval intersection — not a produce-minus-stall
        duration difference — because stall totals also carry queue
        wakeup latency under CPU contention, which would eat real
        overlap.  A strictly serial driver produces inline inside get(),
        every produce span nests in its stall span, and both overlap
        numbers are exactly 0; a fully warmed pipeline's produce spans
        fall outside the (near-zero) stalls and ``off_critical_path_s``
        approaches ``host_produce_s``.

        Streams are kept per (phase, consumer) and each consumer's
        overlap is computed against its OWN producer/waits before the
        per-phase row sums the consumers — concurrent drivers sharing a
        phase name cannot inflate each other's numbers."""
        out: Dict[str, Dict[str, float]] = {}
        with self._lock:
            for (name, _consumer), s in self._overlap.items():
                hidden = s.hidden_acc + self._intersect(s.waits, s.produces)
                on_crit = (
                    s.stall_produce_acc
                    + self._intersect(s.stalls, s.produces)
                )
                # Merged produce length, not the raw sum: with the raw
                # sum, produce spans that overlap each other would
                # survive a stall that covers them all.
                merged = s.produce_merged_acc + self._merged_len(s.produces)
                row = out.setdefault(name, {
                    "device_wait_s": 0.0,
                    "host_produce_s": 0.0,
                    "consumer_stall_s": 0.0,
                    "hidden_s": 0.0,
                    "off_critical_path_s": 0.0,
                })
                row["device_wait_s"] += s.wait_s
                row["host_produce_s"] += s.produce_s
                row["consumer_stall_s"] += s.stall_s
                row["hidden_s"] += hidden
                row["off_critical_path_s"] += max(0.0, merged - on_crit)
        return out

    def report(self, stats: Optional[Dict[str, int]] = None) -> str:
        """Formatted table, hottest phase first.  ``stats`` (candidate
        counters named ``<phase>_candidates``, with any ``_sweep`` phase
        suffix stripped: ``pair_sweep`` -> ``pair_candidates``) adds a
        candidates/sec column where a counter matches a phase name."""
        wall = time.perf_counter() - self._t0
        lines = [
            "phase                     calls     self_s      %",
        ]
        total = sum(self.seconds.values())
        for name in sorted(self.seconds, key=self.seconds.get, reverse=True):
            sec = self.seconds[name]
            pct = 100.0 * sec / total if total > 0 else 0.0
            line = "%-24s %6d %10.3f %6.1f" % (
                name, self.calls.get(name, 0), sec, pct,
            )
            if stats:
                key = name.split(".")[0]
                if key.endswith("_sweep"):
                    key = key[: -len("_sweep")]
                cand = stats.get(f"{key}_candidates")
                # A parent phase whose time lives in child phases (e.g.
                # "lut7" over stageA/B) has ~no self time; a rate against
                # it would be meaningless noise.
                if cand and sec >= 0.01:
                    line += "   %.3g cand/s" % (cand / sec)
            lines.append(line)
        lines.append(
            "%-24s %6s %10.3f %6.1f   (wall %.3f s)"
            % ("total", "", total, 100.0 if total else 0.0, wall)
        )
        ov = self.overlap()
        if ov:
            # offcrit = produce time kept off the consumer's critical
            # path (see overlap()); offcrit% is the pipeline's score —
            # 0 for serial drivers, ->100 when fully overlapped.
            lines.append(
                "pipeline overlap          wait_s  produce_s   stall_s"
                "  offcrit_s  offcrit%"
            )
            for name in sorted(ov):
                o = ov[name]
                denom = o["host_produce_s"]
                lines.append(
                    "%-24s %8.3f %10.3f %9.3f %10.3f %9.1f"
                    % (
                        name,
                        o["device_wait_s"],
                        o["host_produce_s"],
                        o["consumer_stall_s"],
                        o["off_critical_path_s"],
                        100.0 * o["off_critical_path_s"] / denom
                        if denom > 0 else 0.0,
                    )
                )
        if stats:
            en = stats.get("engine_nodes", 0)
            pn = stats.get("python_nodes", 0)
            if en or pn:
                lines.append(
                    "engine-active nodes: %d/%d (%.1f%%), serviced device"
                    " requests: %d"
                    % (
                        en, en + pn,
                        100.0 * en / (en + pn),
                        stats.get("engine_devcalls", 0),
                    )
                )
        return "\n".join(lines)


class _Phase:
    __slots__ = ("_prof", "_name")

    def __init__(self, prof: PhaseProfiler, name: str):
        self._prof = prof
        self._name = name

    def __enter__(self):
        if self._prof.enabled:
            self._prof._stack.append([self._name, time.perf_counter(), 0.0])
        return self

    def __exit__(self, *exc):
        prof = self._prof
        if not prof.enabled:
            return False
        name, t0, child = prof._stack.pop()
        t1 = time.perf_counter()
        dt = t1 - t0
        prof.add(name, dt - child)
        if prof._stack:
            prof._stack[-1][2] += dt
        # Phase frames are trace spans too (--trace): the profiler is a
        # span SOURCE, giving the exported timeline the same phase
        # nesting the -vv table sums.  Trace buffers only (per-node
        # frequency would churn the bounded flight ring).
        tr = _ttrace.tracer()
        if tr.enabled:
            tr.record(name, "phase", t0, t1, flight=False)
        return False
