"""Crash flight recorder: a bounded in-memory ring of recent telemetry
events that dumps to disk when the run hits an incident.

A run that exhausts its dispatch deadline, trips the device circuit
breaker, hits an injected crash, receives ``SIGTERM`` or dies on an
unhandled exception leaves ``flight-rankNN-K.json`` in its telemetry
directory (an explicit ``--output-dir``): the last few thousand spans and
events (dispatches, deadline windows, journal appends, fallbacks), a
counter snapshot and the incident's context.

The ring is always on: an append is a bounded ``deque`` push of one small
tuple per dispatch-grained event, thread-safe without a lock.  A dump holds
at most ``cap`` events, attribute values cut to 200 characters, and at most
:data:`DUMP_MAX_BYTES`.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from collections import deque
from typing import Callable, List, Optional

logger = logging.getLogger(__name__)

#: Ring capacity: minutes of dispatch-grained history.
RING_CAP = 4096
#: Hard cap on one dump's serialized size (bytes); events are dropped
#: oldest-first to fit.
DUMP_MAX_BYTES = 1 << 20


class FlightRecorder:
    """The bounded ring and its dump; one per process."""

    def __init__(self, cap: int = RING_CAP):
        self._ring: deque = deque(maxlen=cap)
        self._dir: Optional[str] = None
        self._rank = 0
        self._lock = threading.Lock()
        self._dumps = 0
        #: Incident hooks (the heartbeat's out-of-band line), called on
        #: every dump before the file is written.
        self._on_dump: List[Callable[[str], None]] = []

    # -- configuration -----------------------------------------------------

    def configure(self, directory: Optional[str]) -> None:
        """Sets the dump directory (``None`` disables dumps; the ring
        still records)."""
        with self._lock:
            self._dir = directory

    def set_rank(self, rank: Optional[int]) -> None:
        """Pins the rank tag of dumps and trace pids (``None``: 0): the
        process group's rank (``parallel.distributed.initialize``), 0 for
        a process without a group."""
        with self._lock:
            self._rank = 0 if rank is None else int(rank)

    def on_dump(self, hook: Callable[[str], None]) -> None:
        """Registers an incident hook called with the dump reason."""
        with self._lock:
            self._on_dump.append(hook)

    def remove_hook(self, hook: Callable[[str], None]) -> None:
        """Unregisters one incident hook (a stopped heartbeat must not
        write incident lines past its final line)."""
        with self._lock:
            try:
                self._on_dump.remove(hook)
            except ValueError:
                pass

    def clear_hooks(self) -> None:
        with self._lock:
            self._on_dump.clear()

    @property
    def directory(self) -> Optional[str]:
        return self._dir

    def rank(self) -> int:
        return self._rank

    # -- recording ---------------------------------------------------------

    def note(
        self, name: str, cat: str, t0: float, dur: Optional[float],
        args: Optional[dict],
    ) -> None:
        """Appends one event (deque append: thread-safe, bounded)."""
        self._ring.append((name, cat, t0, dur, threading.get_ident(), args))

    def events(self) -> List[tuple]:
        return list(self._ring)

    def reset(self) -> None:
        self._ring.clear()
        with self._lock:
            self._dumps = 0

    # -- dumping -----------------------------------------------------------

    def dump(
        self,
        reason: str,
        extra: Optional[dict] = None,
        registry=None,
        directory: Optional[str] = None,
    ) -> Optional[str]:
        """Writes the post-mortem file; returns its path, or None when no
        directory is configured.  Never raises: the dump rides failure
        paths where a second error must not mask the first."""
        try:
            return self._dump(reason, extra, registry, directory)
        except Exception as e:
            logger.warning("flight-recorder dump (%s) failed: %r", reason, e)
            return None

    def _dump(self, reason, extra, registry, directory) -> Optional[str]:
        with self._lock:
            d = directory or self._dir
            hooks = list(self._on_dump)
            if d is not None:
                self._dumps += 1
                n = self._dumps
        for hook in hooks:
            try:
                hook(reason)
            except Exception as e:
                logger.warning("flight incident hook failed: %r", e)
        if d is None:
            return None
        events = [
            {
                "name": name,
                "cat": cat,
                "t": t0,
                "dur": dur,
                "tid": tid,
                **(
                    {"args": {k: _trunc(v) for k, v in args.items()}}
                    if args else {}
                ),
            }
            for (name, cat, t0, dur, tid, args) in self.events()
        ]
        payload = {
            "schema": 1,
            "reason": reason,
            "rank": self.rank(),
            "pid": os.getpid(),
            # torchlint: ignore[R11] incident wall-clock stamp is advisory forensics metadata, never replayed or keyed on
            "time_unix": time.time(),
            # torchlint: ignore[R11] perf epoch for correlating dump with heartbeat lines; forensics only
            "time_perf": time.perf_counter(),
            "extra": {k: _trunc(v) for k, v in (extra or {}).items()},
            "events": events,
        }
        if registry is not None:
            try:
                payload["counters"] = {
                    str(k): _num(v) for k, v in dict(registry).items()
                }
            except Exception as e:
                logger.warning("flight dump counter snapshot failed: %r", e)
        # Bounded size: shed the oldest events until the dump fits.
        text = json.dumps(payload, sort_keys=True)
        while len(text) > DUMP_MAX_BYTES and payload["events"]:
            drop = max(1, len(payload["events"]) // 4)
            payload["events"] = payload["events"][drop:]
            payload["dropped_events"] = payload.get("dropped_events", 0) + drop
            text = json.dumps(payload, sort_keys=True)
        os.makedirs(d, exist_ok=True)
        path = os.path.join(d, f"flight-rank{self.rank():02d}-{n}.json")
        # Durable: a dump exists to survive the incident that triggered it.
        from ..resilience.checkpoint import durable_write_text

        durable_write_text(path, text)
        return path


def _trunc(v):
    if isinstance(v, (int, float, bool)) or v is None:
        return v
    return str(v)[:200]


def _num(v):
    return v if isinstance(v, (int, float, bool)) else str(v)[:200]


_RECORDER = FlightRecorder()


def flight_recorder() -> FlightRecorder:
    """The process-global flight recorder."""
    return _RECORDER


def note(name, cat, t0, dur, args) -> None:
    _RECORDER.note(name, cat, t0, dur, args)


def set_rank(rank: Optional[int]) -> None:
    _RECORDER.set_rank(rank)


def configure(directory: Optional[str], rank: Optional[int] = None) -> None:
    """Sets the dump directory, and the rank tag when ``rank`` is given."""
    _RECORDER.configure(directory)
    if rank is not None:
        _RECORDER.set_rank(rank)


def flight_dump(
    reason: str, extra: Optional[dict] = None, registry=None,
    directory: Optional[str] = None,
) -> Optional[str]:
    """Module-level dump entry the trigger sites call; see
    :meth:`FlightRecorder.dump`."""
    return _RECORDER.dump(
        reason, extra=extra, registry=registry, directory=directory
    )
