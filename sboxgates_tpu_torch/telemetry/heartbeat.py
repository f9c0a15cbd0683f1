"""Periodic fsync'd telemetry heartbeat and the atomic end-of-run snapshot.

A :class:`Heartbeat` appends one JSON line per period to
``telemetry.jsonl`` in the run's telemetry directory (resume-aware: a
resumed run appends after the killed run's tail instead of truncating the
evidence).  Each line carries the registry's scalar counters, the
process-global registry, histogram quantiles, uptime and rank: a killed
run's last line bounds when it died and what it had done.

``stop()`` writes a final line and the atomic ``metrics.json`` snapshot
(the full typed export, histograms and the attribution table included).
Both files go through :func:`resilience.checkpoint.durable_write_text` or
an fsync'd append, the journal's discipline.

The heartbeat registers itself as a flight-recorder incident hook: a dump
forces an immediate out-of-band line, so the incident's counters are on
disk even when the process dies before the next period.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from typing import Optional

from ..resilience.checkpoint import durable_write_text
from . import attribution as _attribution
from . import flight as _flight
from .metrics import GLOBAL, MetricsRegistry

logger = logging.getLogger(__name__)

JSONL_NAME = "telemetry.jsonl"
SNAPSHOT_NAME = "metrics.json"
#: metrics.json / telemetry.jsonl schema version (the JAX package's).
SCHEMA = 1


class Heartbeat:
    """Background heartbeat writer; see the module docstring."""

    def __init__(
        self,
        registry: MetricsRegistry,
        directory: str,
        interval_s: float = 30.0,
        rank: int = 0,
        resume: bool = False,
        run_config: Optional[dict] = None,
        extra: Optional[dict] = None,
        incident_hook: bool = True,
    ):
        self.registry = registry
        self.directory = directory
        self.interval_s = float(interval_s)
        self.rank = int(rank)
        self.run_config = run_config
        #: Extra per-line sections: name -> zero-argument provider, read at
        #: every emit.  A failing provider becomes an error note.
        self.extra = dict(extra or {})
        #: Per-job serve heartbeats leave the flight recorder's incident
        #: hook out: the recorder is process-wide, and one job's incident
        #: must not write lines into every other job's telemetry.jsonl.
        self.incident_hook = bool(incident_hook)
        self._seq = 0
        self._t0 = time.monotonic()
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)
        self.path = os.path.join(directory, JSONL_NAME)
        if not resume:
            # A fresh run owns the file; the truncation is atomic, so a
            # kill here leaves no torn file for a resume to parse.
            durable_write_text(self.path, "")

    def add_provider(self, name: str, provider) -> None:
        """Registers one extra per-line section after construction (the
        serve CLI wires the orchestrator's queue view here)."""
        self.extra[name] = provider

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "Heartbeat":
        if self.interval_s > 0 and self._thread is None:
            self._thread = threading.Thread(
                target=self._work, name="sbg-heartbeat", daemon=True
            )
            self._thread.start()
        if self.incident_hook:
            _flight.flight_recorder().on_dump(self._on_incident)
        self.emit(kind="start")
        return self

    def stop(self, snapshot: bool = True) -> Optional[str]:
        """Final heartbeat line and (optionally) the atomic metrics.json;
        returns the snapshot path.  Idempotent; the incident hook goes
        first, so a later dump writes nothing past the final line."""
        _flight.flight_recorder().remove_hook(self._on_incident)
        already = self._stop.is_set()
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(self.interval_s + 5.0)
        if not already:
            self.emit(kind="final")
        if not snapshot:
            return None
        return self.write_snapshot()

    # -- emission ----------------------------------------------------------

    def _line(self, kind: str) -> dict:
        rec = {
            "schema": SCHEMA,
            "kind": kind,
            "seq": self._seq,
            "rank": self.rank,
            "pid": os.getpid(),
            # torchlint: ignore[R11] heartbeat wall-clock stamp is advisory telemetry, never replayed or keyed on
            "time_unix": time.time(),
            # torchlint: ignore[R11] uptime is advisory telemetry, not replayed state
            "uptime_s": round(time.monotonic() - self._t0, 3),
            "counters": self.registry.scalars(),
            "process": GLOBAL.scalars(),
            "quantiles": {
                name: {
                    k: snap[k]
                    for k in ("count", "mean", "p50", "p90", "p99")
                    if k in snap
                }
                for name, snap in self.registry.histograms().items()
            },
        }
        for name, provider in self.extra.items():
            try:
                rec[name] = provider()
            except Exception as e:
                logger.warning("heartbeat provider %r failed: %r", name, e)
                rec[name] = {"error": repr(e)}
        if kind == "start" and self.run_config is not None:
            rec["config"] = self.run_config
        return rec

    def emit(self, kind: str = "beat") -> None:
        """Appends one fsync'd heartbeat line (the periodic writer, the
        incident hook and stop() all come here)."""
        with self._lock:
            rec = self._line(kind)
            self._seq += 1
            try:
                with open(self.path, "a", encoding="utf-8") as f:
                    f.write(json.dumps(rec, sort_keys=True) + "\n")
                    f.flush()
                    os.fsync(f.fileno())
            except OSError:
                return
        self.registry.inc("heartbeats")

    def _on_incident(self, reason: str) -> None:
        self.emit(kind=f"incident:{reason}")

    def _work(self) -> None:
        while not self._stop.wait(self.interval_s):
            self.emit()

    # -- snapshot ----------------------------------------------------------

    def write_snapshot(self) -> str:
        """The atomic end-of-run ``metrics.json``: the registry's typed
        export, the process globals and the attribution rows."""
        payload = {
            "schema": SCHEMA,
            "rank": self.rank,
            # torchlint: ignore[R11] snapshot wall-clock stamp is advisory telemetry, never replayed or keyed on
            "time_unix": time.time(),
            # torchlint: ignore[R11] uptime is advisory telemetry, not replayed state
            "uptime_s": round(time.monotonic() - self._t0, 3),
            "heartbeat_lines": self._seq,
            "process": GLOBAL.scalars(),
            "attribution": _attribution.snapshot(self.registry),
            **self.registry.snapshot(),
        }
        if self.run_config is not None:
            payload["config"] = self.run_config
        path = os.path.join(self.directory, SNAPSHOT_NAME)
        durable_write_text(path, json.dumps(payload, sort_keys=True, indent=1))
        return path
