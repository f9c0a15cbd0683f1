"""The metrics registry: named, typed counters, gauges and histograms
behind a thread-safe facade.

``SearchContext.stats`` is a :class:`MetricsRegistry`.  It reads like a
dict (``Mapping``: subscripts, ``get``, ``items``, ``dict(ctx.stats)``),
and every mutation goes through an atomic facade method (``inc``, ``put``,
``observe``, ``merge``, ``restore``) under one lock, so concurrent threads
(the deadline's worker, the status server, the heartbeat) never lose an
update.  A declared counter that was never set reads 0.

Every name the port increments is declared in :data:`METRICS` (name, kind,
unit); the registry records undeclared names it sees, and a test asserts
the set stays empty.  Histogram families use a bracketed suffix
(``dispatch_latency_s[pivot_window/64x256x512]``): the base name is
declared once and every member inherits the declaration.  A name the port
shares with the JAX package's table has that table's kind and unit.

:data:`GLOBAL` is a process-wide registry for signals raised below any
search context (journal appends, native service failures); heartbeat lines
and ``metrics.json`` carry it under ``"process"``.
"""

from __future__ import annotations

import bisect
import threading
from collections.abc import MutableMapping
from dataclasses import dataclass
from typing import Dict, Iterator, Optional, Tuple

COUNTER = "counter"
GAUGE = "gauge"
HISTOGRAM = "histogram"


@dataclass(frozen=True)
class MetricDef:
    kind: str
    unit: str
    help: str


#: The declared metric schema: every counter the port increments and every
#: histogram it observes.
METRICS: Dict[str, MetricDef] = {
    # candidate counters (the reference-visible sweep totals; the same on
    # both routes and in both packages)
    "pair_candidates": MetricDef(COUNTER, "candidates", "2-input pairs swept"),
    "triple_candidates": MetricDef(COUNTER, "candidates", "3-gate combos swept"),
    "lut3_candidates": MetricDef(COUNTER, "candidates", "3-LUT tuples swept"),
    "lut5_candidates": MetricDef(COUNTER, "candidates", "5-LUT tuples swept"),
    "lut5_solved": MetricDef(COUNTER, "rows", "5-LUT decomposition solves"),
    "lut7_candidates": MetricDef(COUNTER, "candidates", "7-LUT tuples swept"),
    "lut7_solved": MetricDef(COUNTER, "rows", "7-LUT stage-B solve rows"),
    # dispatch
    "device_dispatches": MetricDef(
        COUNTER, "dispatches",
        "device sweep calls of the search layer, each through "
        "SearchContext.dispatch (one dispatch[<name>] span each).  A pivot "
        "stream launches many windows of tiles in one dispatch, so the "
        "count differs from the JAX package's by design",
    ),
    # resilience
    "dispatch_retries": MetricDef(COUNTER, "retries", "deadline-guard re-issues"),
    "deadline_breaches": MetricDef(COUNTER, "breaches", "local deadline breaches"),
    "breach_barriers": MetricDef(COUNTER, "rounds", "replicated verdict-barrier rounds joined"),
    "replicated_aborts": MetricDef(COUNTER, "windows", "windows abandoned on an agreed breach"),
    "degraded_ranks": MetricDef(COUNTER, "events", "retry schedules exhausted on this rank"),
    "circuit_breaker_trips": MetricDef(COUNTER, "events", "device circuit-breaker flips"),
    "flight_dumps": MetricDef(COUNTER, "dumps", "flight-recorder dumps written"),
    "journal_appends": MetricDef(COUNTER, "records", "fsync'd journal records appended"),
    # chained rounds (search/rounds.py)
    "round_driver_rounds": MetricDef(
        COUNTER, "rounds",
        "search rounds completed on the device by the fused round driver",
    ),
    "round_driver_fallbacks": MetricDef(
        COUNTER, "rounds",
        "chain rounds the fused driver handed to the host recursion",
    ),
    # engine (native) activity
    "engine_nodes": MetricDef(COUNTER, "nodes", "search nodes completed in the native engine"),
    "python_nodes": MetricDef(COUNTER, "nodes", "search nodes completed by the Python recursion"),
    "engine_devcalls": MetricDef(COUNTER, "calls", "device-work services for the native engine"),
    # rendezvous / restart batching (search/batched.py)
    "restart_batch_submits": MetricDef(COUNTER, "submits", "restart-batch rendezvous submits"),
    "restart_batch_dispatches": MetricDef(COUNTER, "dispatches", "restart-batch merged dispatches"),
    # fleet (search/fleet.py)
    "fleet_submits": MetricDef(COUNTER, "submits", "fleet rendezvous submits"),
    "fleet_rounds": MetricDef(COUNTER, "rounds", "fleet rendezvous flush rounds"),
    "fleet_dispatches": MetricDef(COUNTER, "dispatches", "merged fleet group dispatches"),
    "fleet_singletons": MetricDef(COUNTER, "dispatches", "1-entry fleet groups (direct dispatch)"),
    "fleet_stacked_dispatches": MetricDef(COUNTER, "dispatches", "stacked-ladder fleet dispatches"),
    "fleet_lanes": MetricDef(
        COUNTER, "lanes",
        "total fleet lanes dispatched (the lanes that ran: the port pads no "
        "group with duplicate lanes)",
    ),
    "batched_rows": MetricDef(COUNTER, "rows", "rendezvous-batched kernel rows"),
    "job_seconds": MetricDef(HISTOGRAM, "s", "per-job total wall time"),
    "job_time_to_first_hit_s": MetricDef(
        HISTOGRAM, "s",
        "per-job wall time from job start to its first completed circuit",
    ),
    # serve orchestrator (search/serve.py)
    "serve_jobs_admitted": MetricDef(
        COUNTER, "jobs", "jobs admitted into the serve queue"
    ),
    "serve_preemptions": MetricDef(
        COUNTER, "events",
        "serve jobs preempted at a journal boundary (snapshot + requeue)",
    ),
    "serve_quarantined": MetricDef(
        COUNTER, "jobs",
        "poison jobs quarantined after exhausting their retry schedule",
    ),
    "serve_merged_dispatches": MetricDef(
        COUNTER, "dispatches",
        "merged fleet dispatches issued by serve waves (one lane-form call "
        "serving a whole same-bucket wave's sweeps)",
    ),
    # result store (store/)
    "store_hits": MetricDef(
        COUNTER, "lookups",
        "queries answered with a stored, re-verified circuit (no device "
        "dispatch)",
    ),
    "store_misses": MetricDef(
        COUNTER, "lookups",
        "queries with no usable store entry (searched normally)",
    ),
    "store_partial_hits": MetricDef(
        COUNTER, "lookups",
        "queries seeded from a stored interrupted-search frontier",
    ),
    "store_puts": MetricDef(
        COUNTER, "entries", "result-store entries durably published"
    ),
    "store_corrupt_quarantined": MetricDef(
        COUNTER, "entries",
        "torn or digest-corrupt store entries moved to quarantine/ (each "
        "served as a miss)",
    ),
    # network admission front door (serve_net/)
    "net_requests": MetricDef(
        COUNTER, "requests",
        "HTTP requests dispatched by the admission endpoint (every "
        "outcome, 2xx through 5xx)",
    ),
    "net_jobs_admitted": MetricDef(
        COUNTER, "jobs",
        "fresh network admissions journaled and enqueued (the 202 path)",
    ),
    "net_joined": MetricDef(
        COUNTER, "requests",
        "duplicate submissions joined to an in-flight job instead of "
        "searching again (idempotent join: N clients, one search)",
    ),
    "net_repeat_hits": MetricDef(
        COUNTER, "requests",
        "submissions answered 200 with a finished circuit and zero "
        "device dispatches (store hit at admission, or repeat of a "
        "completed job)",
    ),
    "net_rejected_auth": MetricDef(
        COUNTER, "requests",
        "admission requests rejected 401/403 (missing/unknown token, "
        "disabled tenant) before the orchestrator is touched",
    ),
    "net_rejected_quota": MetricDef(
        COUNTER, "requests",
        "admissions rejected 429: the tenant is at its active-job quota",
    ),
    "net_rejected_rate": MetricDef(
        COUNTER, "requests",
        "requests rejected 429 by the per-tenant token-bucket rate limit",
    ),
    "net_oversize": MetricDef(
        COUNTER, "requests",
        "request bodies rejected 413 at the declared size bound "
        "(before a byte is read)",
    ),
    "net_timeouts": MetricDef(
        COUNTER, "requests",
        "requests cut off 408 at the socket read timeout (slowloris / "
        "half-open senders; the serve loop never wedges)",
    ),
    "net_errors": MetricDef(
        COUNTER, "requests",
        "admission requests answered 5xx (injected faults included); "
        "each drops a flight-recorder dump",
    ),
    # heartbeat and live introspection
    "heartbeats": MetricDef(COUNTER, "lines", "telemetry.jsonl heartbeat lines written"),
    "status_requests": MetricDef(
        COUNTER, "requests",
        "/status snapshots served by the live status endpoint",
    ),
    # spectral candidate order
    "order_tier_dispatches": MetricDef(
        COUNTER, "dispatches",
        "sweep-stream dispatches issued under spectral best-first tier "
        "order (lexicographic sweeps never touch this)",
    ),
    "order_first_hit_tier": MetricDef(
        COUNTER, "tier index",
        "accumulated tier index (0 = best) of the segment whose sweep "
        "produced each spectrally-ordered first hit",
    ),
    # histograms (bracketed members inherit the base declaration)
    "device_wait_s": MetricDef(
        HISTOGRAM, "s",
        "per-sync blocked time on a device verdict of the host chunk "
        "stream (per-phase members: device_wait_s[<phase>])",
    ),
    "dispatch_latency_s": MetricDef(
        HISTOGRAM, "s",
        "per-launch time of the hand-written kernels K1-K5 (members keyed "
        "like the attribution rows: dispatch_latency_s[<kernel>/<bucket>]). "
        "On the card: the CUDA-event elapsed time of a pooled event pair "
        "that the kernel's C entry point records on the launch's stream "
        "immediately before and after its <<<>>> launch: the kernel plus "
        "the stream's start-up latency (a few microseconds when the stream "
        "was idle), not the host's path into the entry point.  Read only "
        "once the driver's own sync for that launch has passed (an event "
        "query, never a wait), so telemetry adds no host sync; launches "
        "never synced are read at teardown.  On the CPU: the host wall "
        "time of the plain version",
    ),
    "serve_queue_wait_s": MetricDef(
        HISTOGRAM, "s",
        "serve queue wait per admission grant (enqueue or requeue to lane "
        "start)",
    ),
    "serve_wave_lanes": MetricDef(
        HISTOGRAM, "lanes", "lanes per merged serve wave at formation",
    ),
    "store_get_s": MetricDef(
        HISTOGRAM, "s",
        "end-to-end result-store lookup latency (canonicalize + read + "
        "rewrite + re-verify over all 2^8 inputs)",
    ),
    "rounds_per_dispatch": MetricDef(
        HISTOGRAM, "rounds",
        "search rounds completed per fused round-driver call (the "
        "rounds-per-dispatch setting at best, 1 for the per-round loop)",
    ),
    "net_admit_s": MetricDef(
        HISTOGRAM, "s",
        "admission-endpoint service time per accepted/answered POST "
        "(auth + bounded read + canonical key + durable admit record + "
        "enqueue)",
    ),
    "order_score_s": MetricDef(
        HISTOGRAM, "s",
        "wall time of one spectral scoring prepass (the "
        "spectral_score_stream / spectral_gate_scores dispatch plus tier "
        "segmentation) — the ordering overhead a time-to-first-hit win "
        "must beat",
    ),
}

#: Log-spaced default histogram bounds: 100 µs .. ~17 min.
DEFAULT_BOUNDS: Tuple[float, ...] = tuple(
    m * (10.0 ** e) for e in range(-4, 3) for m in (1.0, 3.0)
)


def base_name(name: str) -> str:
    """``device_wait_s[lut5.host_stream]`` -> ``device_wait_s``: the
    declared family a bracketed member belongs to."""
    i = name.find("[")
    return name if i < 0 else name[:i]


class Histogram:
    """Fixed-bound histogram: count/total/min/max plus per-bucket tallies
    (bucket ``i`` counts observations <= ``bounds[i]``; the last bucket is
    the overflow).  Mutated only under the owning registry's lock."""

    __slots__ = ("bounds", "counts", "count", "total", "min", "max")

    def __init__(self, bounds: Tuple[float, ...] = DEFAULT_BOUNDS):
        self.bounds = bounds
        self.counts = [0] * (len(bounds) + 1)
        self.count = 0
        self.total = 0.0
        self.min = float("inf")
        self.max = float("-inf")

    def observe(self, v: float) -> None:
        self.counts[bisect.bisect_left(self.bounds, v)] += 1
        self.count += 1
        self.total += v
        self.min = min(self.min, v)
        self.max = max(self.max, v)

    def merge(self, other: "Histogram") -> None:
        assert self.bounds == other.bounds
        for i, c in enumerate(other.counts):
            self.counts[i] += c
        self.count += other.count
        self.total += other.total
        self.min = min(self.min, other.min)
        self.max = max(self.max, other.max)

    def quantile(self, q: float) -> float:
        """Bucket-interpolated quantile estimate (Prometheus
        ``histogram_quantile`` semantics), clamped to the observed range;
        a rank in the overflow bucket returns the observed max."""
        if not self.count:
            return float("nan")
        target = q * self.count
        cum = 0.0
        for i, c in enumerate(self.counts):
            if c == 0:
                continue
            if cum + c >= target:
                if i == len(self.bounds):  # overflow bucket: unbounded
                    return self.max
                lo = self.bounds[i - 1] if i > 0 else 0.0
                hi = self.bounds[i]
                est = lo + (hi - lo) * (target - cum) / c
                return min(max(est, self.min), self.max)
            cum += c
        return self.max

    def snapshot(self) -> dict:
        out = {
            "count": self.count,
            "total": self.total,
            "bounds": list(self.bounds),
            "counts": list(self.counts),
        }
        if self.count:
            out["min"] = self.min
            out["max"] = self.max
            out["mean"] = self.total / self.count
            out["p50"] = self.quantile(0.50)
            out["p90"] = self.quantile(0.90)
            out["p99"] = self.quantile(0.99)
        return out


class MetricsRegistry(MutableMapping):
    """Thread-safe named-metric store; the ``ctx.stats`` facade.

    Mapping reads and iteration cover the scalar metrics (counters and
    gauges); histograms live alongside and export through
    :meth:`snapshot`.  ``declared=None`` disables undeclared-name tracking
    (:data:`GLOBAL`, private registries).
    """

    def __init__(
        self,
        initial: Optional[dict] = None,
        declared: Optional[Dict[str, MetricDef]] = METRICS,
    ):
        self._lock = threading.Lock()
        self._values: Dict[str, float] = dict(initial or {})
        self._hists: Dict[str, Histogram] = {}
        self._declared = declared
        self._undeclared: set = set()
        if declared is not None:
            for k in self._values:
                self._check(k)

    # -- facade mutators ---------------------------------------------------

    def _check(self, name: str) -> None:
        if self._declared is not None and (
            base_name(name) not in self._declared
        ):
            self._undeclared.add(name)

    def inc(self, name: str, by: float = 1) -> None:
        """Atomic counter increment (a negative ``by`` backs a tally out)."""
        with self._lock:
            self._check(name)
            self._values[name] = self._values.get(name, 0) + by

    def put(self, name: str, value) -> None:
        """Atomic gauge/counter set (a degrading driver backs out the
        candidates of its abandoned sweep)."""
        with self._lock:
            self._check(name)
            self._values[name] = value

    def observe(self, name: str, value: float) -> None:
        """One histogram observation (family members share the base
        declaration)."""
        with self._lock:
            self._check(name)
            h = self._hists.get(name)
            if h is None:
                h = self._hists[name] = Histogram()
            h.observe(value)

    def merge(self, other: "MetricsRegistry") -> None:
        """Folds another registry (a forked view's) into this one
        atomically."""
        ovals, ohists = other._snapshot_parts()
        with self._lock:
            for k, v in ovals.items():
                self._check(k)
                self._values[k] = self._values.get(k, 0) + v
            for k, h in ohists.items():
                mine = self._hists.get(k)
                if mine is None:
                    self._hists[k] = h
                else:
                    mine.merge(h)

    def ensure(self, *names: str) -> None:
        """Seeds ``names`` at 0 where unset, so a report lists them before
        their first increment."""
        with self._lock:
            for n in names:
                self._check(n)
                self._values.setdefault(n, 0)

    def restore(self, snapshot: dict) -> None:
        """Resets the scalar metrics to ``snapshot`` (a bailed engine
        call's counter rollback; histograms are monotone and keep)."""
        with self._lock:
            self._values = dict(snapshot)

    def fork(self) -> "MetricsRegistry":
        """A zeroed registry with this one's key set (merged back via
        :meth:`merge`)."""
        with self._lock:
            keys = list(self._values)
        return MetricsRegistry(
            dict.fromkeys(keys, 0), declared=self._declared
        )

    # -- reads -------------------------------------------------------------

    def _snapshot_parts(self):
        with self._lock:
            vals = dict(self._values)
            hists = {}
            for k, h in self._hists.items():
                c = Histogram(h.bounds)
                c.merge(h)
                hists[k] = c
        return vals, hists

    def scalars(self) -> dict:
        """Plain-dict snapshot of the scalar metrics."""
        with self._lock:
            return dict(self._values)

    def histograms(self) -> Dict[str, dict]:
        with self._lock:
            return {k: h.snapshot() for k, h in self._hists.items()}

    def snapshot(self) -> dict:
        """The full typed export (the ``metrics.json`` payload half)."""
        vals, hists = self._snapshot_parts()
        return {
            "counters": vals,
            "histograms": {k: h.snapshot() for k, h in hists.items()},
        }

    def undeclared(self) -> set:
        """Names recorded without a :data:`METRICS` declaration."""
        with self._lock:
            return set(self._undeclared)

    # -- Mapping protocol --------------------------------------------------

    def __getitem__(self, key: str):
        with self._lock:
            try:
                return self._values[key]
            except KeyError:
                d = None if self._declared is None else self._declared.get(key)
                if d is not None and d.kind == COUNTER:
                    return 0
                raise

    def __setitem__(self, key: str, value) -> None:
        self.put(key, value)

    def __delitem__(self, key: str) -> None:
        with self._lock:
            del self._values[key]

    def __iter__(self) -> Iterator[str]:
        return iter(self.scalars())

    def __len__(self) -> int:
        with self._lock:
            return len(self._values)

    def __contains__(self, key) -> bool:
        with self._lock:
            return key in self._values

    def __repr__(self) -> str:
        return f"MetricsRegistry({self.scalars()!r})"


#: Keys ``SearchContext.__init__`` seeds to zero: the JAX package's seeds
#: that the port increments.
CONTEXT_COUNTERS: Tuple[str, ...] = (
    "pair_candidates",
    "triple_candidates",
    "lut3_candidates",
    "lut5_candidates",
    "lut5_solved",
    "lut7_candidates",
    "lut7_solved",
    "dispatch_retries",
    "deadline_breaches",
    "device_dispatches",
)


def context_registry() -> MetricsRegistry:
    """A fresh ``ctx.stats`` registry seeded with the context counters."""
    return MetricsRegistry(dict.fromkeys(CONTEXT_COUNTERS, 0))


#: Process-global registry for signal sites below any search context;
#: exported under "process" in heartbeat lines and metrics.json.
GLOBAL = MetricsRegistry(declared=None)


_DICT_LOCK = threading.Lock()


def bump(stats, key: str, by: float = 1) -> None:
    """Atomic increment on a :class:`MetricsRegistry` or a plain dict
    (the deadline helpers take either); ``None`` is a no-op."""
    if stats is None:
        return
    if isinstance(stats, MetricsRegistry):
        stats.inc(key, by)
        return
    with _DICT_LOCK:
        stats[key] = stats.get(key, 0) + by
