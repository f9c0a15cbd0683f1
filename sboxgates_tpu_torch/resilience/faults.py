"""Deterministic fault injection.

Production code calls :func:`fault_point` at named host-side sites; when a
site is armed, the configured action fires there — letting tests kill the
process at chosen points and prove that checkpoints stay intact and
``--resume-run`` reproduces the uninterrupted result bit for bit.

The spec grammar, the actions, the hit counting and the site names are the
JAX package's (``sboxgates_tpu/resilience/faults.py``), so one
``SBG_FAULTS`` value interrupts both packages at the same point of the same
search.  Sites the port fires:

========================  =====================================================
``ckpt.write``            mid-way through writing a checkpoint's temp file
``ckpt.replace``          after the temp file is durable, before ``os.replace``
``journal.append``        after a journal record reaches disk
``search.round``          between beam-search rounds (after the round record)
``search.node``           entering one ``create_circuit`` search node
``prefetch.produce``      producing one chunk in the streaming prefetcher
``dispatch.sweep``        issuing/resolving one guarded device sweep
``native.devcb``          servicing one native-engine device-work request
``order.score``           issuing one spectral candidate-order scoring pass
``serve.admit``           admitting one job into the serve queue
``serve.preempt``         a serve job's journal-boundary control point
``serve.requeue``         requeuing a preempted or failed serve job
``serve.drain``           entering a serve drain
``serve.wave``            a lane entering its merged serve wave
``store.get``             entering a result-store lookup
``store.put``             before a result-store entry write
``store.index``           before a result-store index append
``net.accept``            dispatching one admission-API HTTP request
``net.auth``              checking one admission request's bearer token
``net.body``              reading one admission request's body
``net.admit_journal``     after an admission-journal record reaches disk
========================  =====================================================

Arming — ``SBG_FAULTS`` (read at first use) or :func:`arm`::

    SBG_FAULTS="site:action[@when][,site:action[@when]...]"

``action`` is ``raise`` (raise :class:`InjectedFault`), ``crash``
(``os._exit(CRASH_EXIT_CODE)``, the uncatchable analog of SIGKILL or
preemption) or ``hang`` (block forever: what a wedged device call looks
like).  ``when`` selects hits of the site, counted from 1: ``N`` fires on
exactly the Nth hit, ``N+`` on the Nth and every later one; omitted means
``1+``.  Hit counting is per process and thread-safe; with a fixed seed
the same spec kills the same point every run.

A site name may carry a qualifier, in the JAX package's grammar, and then
fires only where it matches (with a hit counter of its own):

- ``@rank:N``: on the process of rank N of the process group
  (:func:`set_rank`, pinned by ``parallel.distributed.initialize``; rank 0
  without a group);
- ``@job:ID``: on a thread running serve job ``ID`` (:func:`set_job`, a
  per-thread pin the serve orchestrator sets around each job attempt and
  store consult; ``SBG_FAULT_JOB`` when the thread has none);
- ``@tenant:NAME``: on a thread serving tenant ``NAME`` (:func:`set_tenant`;
  ``SBG_FAULT_TENANT`` when the thread has none).
"""

from __future__ import annotations

import os
import re
import threading
import time
from dataclasses import dataclass
from typing import Dict, Optional

CRASH_EXIT_CODE = 17

ACTIONS = ("raise", "crash", "hang")

#: Sites the port fires (informational: fault_point accepts any name).
KNOWN_SITES = (
    "ckpt.write",
    "ckpt.replace",
    "journal.append",
    "search.round",
    "search.node",
    "prefetch.produce",
    "dispatch.sweep",
    "native.devcb",
    "order.score",
    "serve.admit",
    "serve.preempt",
    "serve.requeue",
    "serve.drain",
    "serve.wave",
    "store.get",
    "store.put",
    "store.index",
    "net.accept",
    "net.auth",
    "net.body",
    "net.admit_journal",
)


class InjectedFault(RuntimeError):
    """Raised by an armed ``raise`` fault site."""


@dataclass(frozen=True)
class _Spec:
    action: str
    first: int       # 1-based hit ordinal the fault starts firing at
    once: bool       # True: fire on exactly `first`; False: `first` onward

    def fires(self, hit: int) -> bool:
        return hit == self.first if self.once else hit >= self.first


_WHEN_RE = re.compile(r"^(\d+)(\+?)$")
_RANK_RE = re.compile(r"@rank:(\d+)$")
_JOB_RE = re.compile(r"@job:([A-Za-z0-9_.\-]+)$")
_TENANT_RE = re.compile(r"@tenant:([A-Za-z0-9_.\-]+)$")

_lock = threading.Lock()
_specs: Dict[str, _Spec] = {}
_hits: Dict[str, int] = {}
_env_loaded = False
#: Per-thread job and tenant pins (set_job, set_tenant): the serve
#: orchestrator runs many jobs in one process, and a qualified fault fires
#: only on the thread running that job or serving that tenant.
_job_local = threading.local()
_tenant_local = threading.local()
#: Whether any armed site is job- or tenant-qualified (recomputed under
#: _lock at every change of _specs), so the unarmed path reads two bools.
_job_targeted = False
_tenant_targeted = False


def _note_specs_changed() -> None:
    """Caller holds _lock: refresh the job and tenant targeting flags."""
    global _job_targeted, _tenant_targeted
    _job_targeted = any("@job:" in s for s in _specs)
    _tenant_targeted = any("@tenant:" in s for s in _specs)


#: This process's rank in the process group (``@rank:N`` sites).
_rank = 0


def set_rank(rank: Optional[int]) -> None:
    """Pins the rank that ``@rank:N`` sites match (``None``: 0)."""
    global _rank
    _rank = 0 if rank is None else int(rank)


def set_job(job_id: Optional[str]) -> None:
    """Pins the calling thread's serve job for ``@job:ID`` sites; None
    clears it."""
    _job_local.job = None if job_id is None else str(job_id)


def current_job() -> Optional[str]:
    """The calling thread's :func:`set_job` pin (no environment fallback):
    carried onto work handed to another thread, as the result store's
    writer does."""
    return getattr(_job_local, "job", None)


def set_tenant(tenant: Optional[str]) -> None:
    """Pins the calling thread's tenant for ``@tenant:NAME`` sites; None
    clears it."""
    _tenant_local.tenant = None if tenant is None else str(tenant)


def current_tenant() -> Optional[str]:
    """The calling thread's :func:`set_tenant` pin (no environment
    fallback)."""
    return getattr(_tenant_local, "tenant", None)


def parse_spec(text: str) -> Dict[str, _Spec]:
    """Parses an ``SBG_FAULTS`` value; raises ValueError on bad syntax."""
    out: Dict[str, _Spec] = {}
    for part in text.split(","):
        part = part.strip()
        if not part:
            continue
        # rsplit: the site itself may contain ':' (the qualifier suffix).
        fields = part.rsplit(":", 1)
        if len(fields) != 2 or not fields[0]:
            raise ValueError(
                f"bad fault spec {part!r}: expected "
                "'site[@rank:N|@job:ID|@tenant:NAME]:action[@when]'"
            )
        site, action = fields
        if ":" in site and not (
            _RANK_RE.search(site) or _JOB_RE.search(site)
            or _TENANT_RE.search(site)
        ):
            raise ValueError(
                f"bad fault site {site!r} in {part!r}: a ':' in a site "
                "name is only valid as an '@rank:N', '@job:ID', or "
                "'@tenant:NAME' suffix"
            )
        when = "1+"
        if "@" in action:
            action, _, when = action.partition("@")
        if action not in ACTIONS:
            raise ValueError(
                f"bad fault action {action!r} in {part!r}: "
                f"expected one of {ACTIONS}"
            )
        m = _WHEN_RE.match(when)
        if m is None or int(m.group(1)) < 1:
            raise ValueError(
                f"bad fault trigger {when!r} in {part!r}: expected 'N' or 'N+'"
            )
        out[site] = _Spec(action, int(m.group(1)), once=m.group(2) != "+")
    return out


def _load_env() -> None:
    global _env_loaded
    if _env_loaded:
        return
    _env_loaded = True
    text = os.environ.get("SBG_FAULTS", "")
    if text:
        _specs.update(parse_spec(text))
    _note_specs_changed()


def arm(site: str, action: str, when: str = "1+") -> None:
    """Arms one site (pair with :func:`disarm`)."""
    spec = parse_spec(f"{site}:{action}@{when}")
    with _lock:
        _load_env()
        _specs.update(spec)
        _note_specs_changed()


def disarm(site: Optional[str] = None) -> None:
    """Disarms one site (or all, the environment's spec included) and
    resets its hit counter(s)."""
    global _env_loaded
    with _lock:
        if site is None:
            _specs.clear()
            _hits.clear()
            _env_loaded = True
        else:
            _specs.pop(site, None)
            _hits.pop(site, None)
        _note_specs_changed()


def hit_count(site: str) -> int:
    """Hits recorded so far at ``site`` (armed sites only)."""
    with _lock:
        return _hits.get(site, 0)


def fault_point(site: str) -> None:
    """Marks a named fault site; fires the armed action, if any.  Unarmed,
    it costs a few dict lookups."""
    if not _env_loaded and not _specs:
        with _lock:
            _load_env()
    # This process's rank (set_rank); the job and tenant names are this thread's
    # pins (or the environment's), looked up only when some armed site
    # carries that kind of qualifier.
    names = [site, f"{site}@rank:{_rank}"]
    if _job_targeted:
        job = current_job() or os.environ.get("SBG_FAULT_JOB")
        if job is not None:
            names.append(f"{site}@job:{job}")
    if _tenant_targeted:
        tenant = current_tenant() or os.environ.get("SBG_FAULT_TENANT")
        if tenant is not None:
            names.append(f"{site}@tenant:{tenant}")
    if all(_specs.get(n) is None for n in names):
        return
    spec = None
    hit = 0
    with _lock:
        # Re-read under the lock: a concurrent disarm() may have won.
        for n in names:
            s = _specs.get(n)
            if s is None:
                continue
            h = _hits.get(n, 0) + 1
            _hits[n] = h
            if spec is None and s.fires(h):
                spec, hit, site = s, h, n
    if spec is None:
        return
    if spec.action == "raise":
        raise InjectedFault(f"injected fault at {site} (hit {hit})")
    if spec.action == "crash":
        # The uncatchable death: no atexit, no finally.  The flight
        # recorder dumps first (a preempted run gets the same grace from
        # SIGTERM), and its incident hook writes a heartbeat line.
        from ..telemetry import flight as _tflight

        _tflight.flight_dump("injected_crash", extra={"site": site, "hit": hit})
        print(f"[sbg-fault] crash at {site} (hit {hit})", flush=True)
        os._exit(CRASH_EXIT_CODE)
    # hang: block forever in small sleeps (a daemon worker parked here is
    # abandonable; a caller under a deadline times out).
    while True:
        time.sleep(0.05)
