"""Hung-dispatch deadlines with retry and backoff.

A launched CUDA kernel cannot be interrupted from the host, and neither can
a wait on its results: a wedged sweep would hang the whole search past any
external timeout.  :func:`dispatch_with_retry` runs one blocking sweep
resolve in an abandonable worker thread: on a breach of its budget it
counts the breach, re-issues the sweep with exponential backoff, and after
the retry budget raises :class:`DispatchTimeout`, so the calling driver can
degrade to its host-fallback path (``search.lut.lut5_search``).  The
schedule, the counters and the ``dispatch.sweep`` fault site are the JAX
package's (``sboxgates_tpu/resilience/deadline.py``), so one spec breaches
the same sweeps in both packages.

An abandoned attempt keeps its own worker thread and result cell: its late
result never reaches the caller, and every re-issue builds its own device
buffers.  Each attempt carries an :class:`Attempt` gate
(:func:`current_attempt` on its worker thread), which the telemetry checks
so that an abandoned attempt records no launch time once it is abandoned.

Telemetry, at the JAX package's sites: a ``deadline.window`` span per
guarded attempt, a ``deadline.breach`` instant per breach, and on
exhaustion a ``deadline.exhausted`` instant and a ``deadline_exhausted``
flight-recorder dump.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from dataclasses import dataclass
from typing import Callable, Optional

from ..telemetry import flight as _tflight
from ..telemetry import metrics as _tmetrics
from ..telemetry import trace as _ttrace
from .faults import fault_point

logger = logging.getLogger(__name__)

_tls = threading.local()


class DispatchTimeout(RuntimeError):
    """A device dispatch exceeded its deadline budget (retries included)."""


def _bump(stats, key: str, by: int = 1) -> None:
    """Atomic counter increment on ``stats`` (a registry, a dict, or
    None)."""
    _tmetrics.bump(stats, key, by)


def _flight_exhausted(stats, label: str, windows: int) -> None:
    """Retry exhaustion is a flight-recorder incident: the dump carries
    the recent dispatch and deadline events and the window's label."""
    _ttrace.instant("deadline.exhausted", "deadline",
                    label=label, windows=windows)
    path = _tflight.flight_dump(
        "deadline_exhausted",
        registry=stats if isinstance(stats, _tmetrics.MetricsRegistry)
        else None,
        extra={"label": label, "windows": windows},
    )
    if path is not None:
        _bump(stats, "flight_dumps")


class Attempt:
    """The gate of one guarded attempt: ``abandoned`` is set, under
    ``lock``, when the deadline gives up on it."""

    __slots__ = ("lock", "abandoned")

    def __init__(self):
        self.lock = threading.Lock()
        self.abandoned = False

    def abandon(self) -> None:
        with self.lock:
            self.abandoned = True


def current_attempt() -> Optional[Attempt]:
    """The :class:`Attempt` whose worker is the calling thread, or None
    outside a guarded attempt."""
    return getattr(_tls, "attempt", None)


@dataclass
class DeadlineConfig:
    """Deadline policy for blocking device-sweep resolves.  ``budget_s <=
    0`` disables the guard (the default: ``SBG_DISPATCH_TIMEOUT_S``,
    ``Options.dispatch_timeout_s`` or ``--dispatch-timeout`` turn it on)."""

    budget_s: float = 0.0
    retries: int = 2
    backoff_s: float = 0.25

    @property
    def enabled(self) -> bool:
        return self.budget_s > 0


def config_from_env() -> DeadlineConfig:
    """SBG_DISPATCH_TIMEOUT_S / SBG_DISPATCH_RETRIES / SBG_DISPATCH_BACKOFF_S."""
    return DeadlineConfig(
        budget_s=float(os.environ.get("SBG_DISPATCH_TIMEOUT_S", "0")),
        retries=max(0, int(os.environ.get("SBG_DISPATCH_RETRIES", "2"))),
        backoff_s=float(os.environ.get("SBG_DISPATCH_BACKOFF_S", "0.25")),
    )


def run_with_deadline(fn: Callable, budget_s: float, label: str = ""):
    """Runs ``fn()`` in a daemon worker, waiting at most ``budget_s``
    seconds.  On a breach the worker is abandoned (it parks harmlessly on
    whatever blocks it) and :class:`DispatchTimeout` is raised here."""
    if budget_s <= 0:
        return fn()
    box: dict = {}
    done = threading.Event()
    attempt = Attempt()

    def work() -> None:
        _tls.attempt = attempt
        try:
            box["value"] = fn()
        except BaseException as e:  # delivered to the caller below
            box["error"] = e
        finally:
            done.set()

    worker = threading.Thread(target=work, name="sbg-deadline", daemon=True)
    worker.start()
    if not done.wait(budget_s):
        attempt.abandon()
        raise DispatchTimeout(
            f"device dispatch{f' [{label}]' if label else ''} exceeded its "
            f"{budget_s:g}s deadline (hung kernel or device?)"
        )
    if "error" in box:
        raise box["error"]
    return box["value"]


def dispatch_with_retry(
    fn: Callable,
    cfg: Optional[DeadlineConfig],
    stats: Optional[dict] = None,
    label: str = "",
    on_retry: Optional[Callable[[], None]] = None,
    site: str = "dispatch.sweep",
    lanes=(),
):
    """One guarded device-sweep resolve: deadline, retry, backoff.

    Every attempt first marks the ``dispatch.sweep`` fault site (so
    injection works with or without a deadline), then runs ``fn`` under
    :func:`run_with_deadline`.  A breach adds one to
    ``stats['deadline_breaches']``; each retry adds one to
    ``stats['dispatch_retries']``, sleeps the doubling backoff, calls
    ``on_retry`` (re-issue the dispatch) and tries again.  After
    ``cfg.retries`` retries the last :class:`DispatchTimeout` propagates,
    after a ``deadline_exhausted`` flight-recorder dump.
    A disabled config (or None) calls inline: no thread.  ``lanes`` names
    the jobs riding a merged wave's window (:func:`wave_dispatch_with_retry`):
    the breach and the timeout's message carry them.
    """

    def attempt():
        fault_point(site)
        return fn()

    if cfg is None or not cfg.enabled:
        return attempt()
    delay = cfg.backoff_s
    for k in range(cfg.retries + 1):
        try:
            with _ttrace.span("deadline.window", "deadline",
                              label=label, attempt=k) as sp:
                try:
                    return run_with_deadline(attempt, cfg.budget_s, label)
                except DispatchTimeout:
                    sp.set(breach=True)
                    raise
        except DispatchTimeout as e:
            _bump(stats, "deadline_breaches")
            extra = {"lanes": list(lanes)} if lanes else {}
            _ttrace.instant("deadline.breach", "deadline", label=label,
                            attempt=k, **extra)
            if lanes:
                e = DispatchTimeout(f"{e} (lanes: {', '.join(lanes)})")
            if k == cfg.retries:
                logger.warning(
                    "%s; %d retr%s exhausted", e, cfg.retries,
                    "y" if cfg.retries == 1 else "ies",
                )
                _flight_exhausted(stats, label, cfg.retries + 1)
                raise e
            _bump(stats, "dispatch_retries")
            logger.warning("%s; retry %d/%d in %.2fs", e, k + 1, cfg.retries,
                           delay)
            time.sleep(delay)
            delay *= 2
            if on_retry is not None:
                on_retry()
    raise AssertionError("unreachable")


def wave_dispatch_with_retry(fn: Callable, cfg: Optional[DeadlineConfig],
                             stats=None, label: str = "", lanes=(),
                             on_retry: Optional[Callable[[], None]] = None):
    """One guarded window for a WHOLE merged fleet wave call (one call
    carries every lane's sweep, so it cannot be guarded lane by lane):
    :func:`dispatch_with_retry`'s schedule with the breach attributed to
    every lane riding the window (``lanes``, named in the timeout and the
    ``deadline.breach`` instant).  One ``deadline_breaches`` per breached
    window."""
    return dispatch_with_retry(fn, cfg, stats=stats, label=label,
                               on_retry=on_retry, lanes=lanes)
