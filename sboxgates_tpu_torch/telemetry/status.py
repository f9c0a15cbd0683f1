"""Live run introspection: a read-only ``http.server`` endpoint serving a
``/status`` JSON snapshot of the run (``--status-port``).

Off by default; ``--status-port N`` turns it on (``0`` binds an ephemeral
port, reported in the heartbeat start line's config).  The snapshot is
built from state the search already keeps: the registry's counters and
histogram quantiles, per-phase search-space coverage with a derived ETA,
the attribution rows, and the providers the owner wires in (breaker and
placement state from the context).  Serving it makes no device sync.

One daemon thread serves requests one at a time; :meth:`StatusServer.shutdown`
closes the socket and joins the thread, so a stopped run leaves no thread
or port behind.
"""

from __future__ import annotations

import json
import logging
import math
import threading
import time
from http.server import BaseHTTPRequestHandler, HTTPServer
from typing import Callable, Dict, Optional

from . import attribution as _attribution

logger = logging.getLogger(__name__)

#: /status schema version (the JAX package's).
STATUS_SCHEMA = 1

#: The serving loop's poll interval (s): how long ``shutdown`` may wait
#: for the loop to notice, paid once at the end of every ``--status-port``
#: run.
POLL_S = 0.01

#: Candidate counters -> the k of the C(g, k) space they sweep.
COVERAGE_PHASES: Dict[str, int] = {
    "pair_candidates": 2,
    "triple_candidates": 3,
    "lut3_candidates": 3,
    "lut5_candidates": 5,
    "lut7_candidates": 7,
}


def coverage(
    scalars: dict, uptime_s: float, g: Optional[int] = None
) -> dict:
    """Per-phase search-space coverage from the candidate counters:
    candidates examined, the current node's C(g, k) (``g``: the gate count
    of the latest node sweep), the observed rate, and the ETA of one whole
    sweep of the current node's space at that rate.  The examined totals
    accumulate across nodes, so this is a rate and ETA source, not a
    progress bar."""
    out: dict = {}
    for name, k in COVERAGE_PHASES.items():
        examined = scalars.get(name)
        if not examined:
            continue
        row = {"examined": int(examined), "k": k}
        if uptime_s > 0:
            row["rate_per_s"] = examined / uptime_s
        if g is not None and g >= k:
            space = math.comb(int(g), k)
            row["current_space"] = space
            if uptime_s > 0 and examined > 0:
                row["eta_current_space_s"] = space / (examined / uptime_s)
        out[name] = row
    return out


def build_status(
    registry,
    t0_monotonic: float,
    extra: Optional[Dict[str, Callable[[], object]]] = None,
    gates_fn: Optional[Callable[[], Optional[int]]] = None,
) -> dict:
    """The /status payload.  ``gates_fn`` gives the current node's gate
    count for the coverage denominators (the CLI wires
    ``SearchContext.last_dispatch_gates``); None leaves coverage to
    examined-and-rate rows."""
    # torchlint: ignore[R11] /status uptime is advisory operator telemetry, never replayed
    uptime = time.monotonic() - t0_monotonic
    scalars = registry.scalars()
    hists = registry.histograms()
    g = None
    if gates_fn is not None:
        try:
            g = gates_fn()
        except Exception as e:
            logger.warning("status gates provider failed: %r", e)
    doc = {
        "schema": STATUS_SCHEMA,
        # torchlint: ignore[R11] /status wall-clock stamp is advisory operator telemetry, never replayed or keyed on
        "time_unix": time.time(),
        "uptime_s": round(uptime, 3),
        "counters": scalars,
        "histograms": hists,
        "coverage": coverage(scalars, uptime, g),
        "attribution": _attribution.snapshot(registry),
    }
    for key, provider in (extra or {}).items():
        try:
            doc[key] = provider()
        except Exception as e:
            # A failing provider becomes an error note; the endpoint (and
            # the run) go on.
            logger.warning("status provider %r failed: %r", key, e)
            doc[key] = {"error": repr(e)}
    return doc


class StatusServer:
    """The /status endpoint; see the module docstring."""

    def __init__(
        self,
        registry,
        port: int = 0,
        host: str = "127.0.0.1",
        extra: Optional[Dict[str, Callable[[], object]]] = None,
        gates_fn: Optional[Callable[[], Optional[int]]] = None,
        request_timeout_s: float = 5.0,
        max_body: int = 65536,
    ):
        self.registry = registry
        self.extra = extra
        self.gates_fn = gates_fn
        self._t0 = time.monotonic()
        self._thread: Optional[threading.Thread] = None
        outer = self

        class Handler(BaseHTTPRequestHandler):
            # A per-connection socket timeout: one half-open client must not
            # wedge the single-threaded server.
            timeout = float(request_timeout_s)

            def do_GET(self) -> None:  # noqa: N802 (stdlib API name)
                # /status takes no body: an advertised payload past the
                # bound is refused unread.
                try:
                    length = int(self.headers.get("Content-Length", 0))
                except ValueError:
                    length = 0
                if length > int(max_body):
                    self.send_error(413, "request body too large")
                    return
                if self.path.split("?", 1)[0] not in ("/status", "/"):
                    self.send_error(404, "try /status")
                    return
                try:
                    body = json.dumps(
                        outer.snapshot(), sort_keys=True
                    ).encode("utf-8")
                except Exception as e:
                    logger.warning("/status snapshot failed: %r", e)
                    self.send_error(500, "snapshot failed")
                    return
                outer.registry.inc("status_requests")
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, fmt, *args) -> None:
                # The CLI's stdout and stderr are the search's.
                logger.debug("status: " + fmt, *args)

        self._server = HTTPServer((host, int(port)), Handler)
        self._server.timeout = 1.0

    def add_provider(self, name: str, provider) -> None:
        """Registers one extra snapshot section after construction (the
        serve CLI wires the orchestrator's queue view here); it runs under
        the snapshot's error-note guard."""
        if self.extra is None:
            self.extra = {}
        self.extra[name] = provider

    @property
    def port(self) -> int:
        """The bound port (the ephemeral one with ``port=0``)."""
        return int(self._server.server_address[1])

    def snapshot(self) -> dict:
        return build_status(
            self.registry, self._t0, self.extra, gates_fn=self.gates_fn
        )

    def start(self) -> "StatusServer":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._serve, name="sbg-status", daemon=True
            )
            self._thread.start()
        return self

    def _serve(self) -> None:
        try:
            self._server.serve_forever(poll_interval=POLL_S)
        except Exception as e:
            logger.warning("status server exited: %r", e)

    def shutdown(self, timeout: float = 5.0) -> None:
        """Stops serving, closes the socket and joins the thread;
        idempotent and bounded."""
        t = self._thread
        if t is None:
            return
        self._thread = None
        self._server.shutdown()
        self._server.server_close()
        t.join(timeout)
