"""Telemetry of the port: structured tracing, a metrics registry, a crash
flight recorder, a heartbeat, a live status endpoint, a watcher, and the
attribution of kernel time to the hand-written kernels.

- :mod:`.trace` — spans with typed attributes, recorded per thread and
  exported as a Chrome/Perfetto ``trace.json`` (``--trace``); every device
  sweep call (``SearchContext.dispatch``), deadline window, breach and
  journal append is one.
- :mod:`.metrics` — counters, gauges and histograms behind a thread-safe
  registry (``ctx.stats``), which reads like a dict.
- :mod:`.heartbeat` — the fsync'd ``telemetry.jsonl`` heartbeat of an
  explicit ``--output-dir`` (resume-aware) and the atomic end-of-run
  ``metrics.json``.
- :mod:`.flight` — a bounded ring of recent events, dumped on deadline
  exhaustion, breaker trips, injected crashes, ``SIGTERM`` and fatal
  exceptions.
- :mod:`.attribution` — the analytic cost of each kernel launch, the
  launch times (CUDA events on the card), and the roofline rows joining
  them.
- :mod:`.status` — the read-only ``/status`` endpoint (``--status-port``).
- :mod:`.watch` — ``python -m sboxgates_tpu_torch.telemetry.watch DIR``,
  a follower of the heartbeat that works on dead runs and on the JAX
  package's runs.

The package imports nothing of the search layer, so every layer can feed
it without import cycles, and nothing of torch at import time.
"""

from .flight import FlightRecorder, flight_dump, flight_recorder
from .heartbeat import Heartbeat
from .metrics import (
    CONTEXT_COUNTERS,
    GLOBAL,
    METRICS,
    MetricsRegistry,
    bump,
)
from .status import StatusServer, build_status
from .trace import Tracer, instant, set_rank, span, tracer

__all__ = [
    "CONTEXT_COUNTERS",
    "FlightRecorder",
    "GLOBAL",
    "Heartbeat",
    "METRICS",
    "MetricsRegistry",
    "StatusServer",
    "Tracer",
    "build_status",
    "bump",
    "flight_dump",
    "flight_recorder",
    "instant",
    "set_rank",
    "span",
    "tracer",
]
