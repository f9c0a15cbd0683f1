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

Several processes: a process-spanning mesh runs its sweeps as collectives
of every rank, so an abort must be replicated — a rank that times out
alone and re-issues while its peers still wait would deadlock them.
:func:`replicated_dispatch_with_retry` ends every guarded window in one
verdict barrier (``distributed.breach_verdict`` on the group's store):
breach if any rank breached, and then every rank abandons the window,
renews the data group, re-issues on the same backoff schedule and, past
it, raises :class:`DispatchTimeout` in the same window, so the whole group
degrades to the host chunk stream together.  The barrier runs in its own
abandonable ``sbg-abort-watch`` worker; a peer that never reaches it (a
killed rank) counts as a breach.  On by default wherever a budget is set;
``SBG_DISPATCH_TIMEOUT_MULTIHOST=0`` opts out.

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


def _flight_exhausted(stats, label: str, windows: int,
                      reason: str = "deadline_exhausted") -> None:
    """Retry exhaustion is a flight-recorder incident: the dump carries
    the recent dispatch and deadline events and the window's label."""
    _ttrace.instant("deadline.exhausted", "deadline",
                    label=label, windows=windows)
    path = _tflight.flight_dump(
        reason,
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
    #: Guard process-spanning meshes too, with the replicated protocol
    #: (``SBG_DISPATCH_TIMEOUT_MULTIHOST=0`` opts out).
    multihost: bool = True

    @property
    def enabled(self) -> bool:
        return self.budget_s > 0


def config_from_env() -> DeadlineConfig:
    """SBG_DISPATCH_TIMEOUT_S / SBG_DISPATCH_RETRIES /
    SBG_DISPATCH_BACKOFF_S / SBG_DISPATCH_TIMEOUT_MULTIHOST (opt-out)."""
    return DeadlineConfig(
        budget_s=float(os.environ.get("SBG_DISPATCH_TIMEOUT_S", "0")),
        retries=max(0, int(os.environ.get("SBG_DISPATCH_RETRIES", "2"))),
        backoff_s=float(os.environ.get("SBG_DISPATCH_BACKOFF_S", "0.25")),
        multihost=os.environ.get("SBG_DISPATCH_TIMEOUT_MULTIHOST", "1")
        != "0",
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


def verdict_transport_timeout(budget_s: float) -> float:
    """How long the verdict exchange waits for its peers: two window
    budgets (a rank that resolved at once and one that breached at the
    full budget enter the same barrier one budget apart) plus one second.
    One formula for the exchange and the abort watcher's bound (which adds
    its margin on top), so the watcher always outlasts the exchange."""
    return 2.0 * max(budget_s, 0.0) + 1.0


def _verdict_barrier(verdict: Callable[[bool], bool], breached: bool,
                     budget_s: float, label: str = "") -> bool:
    """One verdict-barrier round in an abandonable ``sbg-abort-watch``
    worker (the ``dist.verdict`` fault site first): this rank's breach
    flag in, the agreed verdict out.  A barrier still unanswered after
    :func:`verdict_transport_timeout` plus 5 s is an agreed breach (the
    peers that cannot answer are the ones to write off); other errors of
    the exchange propagate."""
    box: dict = {}
    done = threading.Event()

    def _abort_watch() -> None:
        try:
            fault_point("dist.verdict")
            box["value"] = bool(verdict(breached))
        except BaseException as e:  # delivered below
            box["error"] = e
        finally:
            done.set()

    threading.Thread(target=_abort_watch, name="sbg-abort-watch",
                     daemon=True).start()
    abandon_s = verdict_transport_timeout(budget_s) + 5.0
    if not done.wait(abandon_s):
        logger.warning(
            "verdict barrier%s unreachable within %.2gs (killed rank?); "
            "treating the window as an agreed breach",
            f" [{label}]" if label else "", abandon_s,
        )
        return True
    if "error" in box:
        raise box["error"]
    return box["value"]


def replicated_dispatch_with_retry(
    fn: Callable,
    cfg: Optional[DeadlineConfig],
    verdict: Callable[[bool], bool],
    stats: Optional[dict] = None,
    label: str = "",
    on_abort: Optional[Callable[[], None]] = None,
):
    """The process-spanning counterpart of :func:`dispatch_with_retry`:
    each attempt window runs ``fn`` (which issues and resolves the sweep)
    under the deadline, then joins ONE verdict barrier
    (``verdict(local_breach) -> agreed``).  Agreed OK: the local result is
    returned (identical on every rank: the sharded streams exchange their
    verdicts).  Agreed breach: every rank abandons the window, calls
    ``on_abort`` (the data group's renewal), sleeps the same backoff and
    tries again; past the schedule every rank raises
    :class:`DispatchTimeout` in the same window.

    Counters: ``breach_barriers`` (barriers joined), ``deadline_breaches``
    (local breaches), ``replicated_aborts`` (windows abandoned by
    agreement), ``dispatch_retries`` and ``degraded_ranks`` (this rank
    exhausting the schedule).  A disabled config calls inline, with no
    barrier.  Every attempt marks the ``dispatch.sweep`` fault site (the
    JAX package's ``site=`` parameter, which no caller changes)."""

    def attempt():
        fault_point("dispatch.sweep")
        return fn()

    if cfg is None or not cfg.enabled:
        return attempt()
    delay = cfg.backoff_s
    for k in range(cfg.retries + 1):
        breached = False
        value = None
        with _ttrace.span("deadline.window", "deadline",
                          label=label, attempt=k) as sp:
            try:
                value = run_with_deadline(attempt, cfg.budget_s, label)
            except DispatchTimeout:
                breached = True
                _bump(stats, "deadline_breaches")
            agreed = _verdict_barrier(verdict, breached, cfg.budget_s, label)
            _bump(stats, "breach_barriers")
            sp.set(local_breach=breached, agreed_breach=agreed)
        if not agreed:
            return value
        _bump(stats, "replicated_aborts")
        if on_abort is not None:
            on_abort()
        if k == cfg.retries:
            _bump(stats, "degraded_ranks")
            logger.warning(
                "replicated abort%s: agreed breach window %d/%d — retry "
                "schedule exhausted, every rank degrades together",
                f" [{label}]" if label else "", k + 1, cfg.retries + 1,
            )
            _flight_exhausted(stats, label, cfg.retries + 1,
                              reason="replicated_degradation")
            raise DispatchTimeout(
                f"device dispatch{f' [{label}]' if label else ''} abandoned "
                f"by replicated agreement after {cfg.retries + 1} windows of "
                f"{cfg.budget_s:g}s"
            )
        _bump(stats, "dispatch_retries")
        logger.warning(
            "replicated abort%s: agreed breach (local %s); retry %d/%d in "
            "%.2fs", f" [{label}]" if label else "",
            "breach" if breached else "ok", k + 1, cfg.retries, delay,
        )
        time.sleep(delay)
        delay *= 2
    raise AssertionError("unreachable")
