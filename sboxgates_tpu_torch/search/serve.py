"""The serve mode (``--serve``): a fault-tolerant multi-tenant job queue
over one shared context.

PyTorch counterpart of the JAX package's ``search/serve.py`` (its HTTP
front door is :mod:`sboxgates_tpu_torch.serve_net`).  A :class:`ServeOrchestrator`
admits many searches, one :class:`ServeJob` per query, over ONE shared
:class:`SearchContext`: every job runs on a :class:`JobView` that shares
the base context's derived tables, device-table caches and built kernels,
with its own PRNG stream and counters.  Admission fills lanes (``lanes``,
reported with its fleet jobs bucket, :func:`lane_bucket`); the scheduler
prefers strictly higher priority, then the warm gate-count bucket (the
bucket most running jobs sweep at), then fair share between tenants, then
submission order.

**Merged waves** (default on; ``merge=False``, ``--serve-no-merge`` or
``SBG_SERVE_NO_MERGE=1`` turn them off): the same-bucket jobs one
admission round starts together share ONE
:class:`~sboxgates_tpu_torch.search.fleet.FleetRendezvous` (:class:`_Wave`),
so their node sweeps, streaming sweeps and chained-round windows run as
one lane-form call per round (K3's and K1's lane forms on the card).  A
lane that finishes, preempts or fails leaves the pool and the others keep
merging.  A lane's verdicts are its single-lane sweeps' and its PRNG
stream is untouched, so every job writes the files of its standalone run
with its :func:`job_seed`, merged or not.  A requeued wave lane records
its membership in the ``waves.jsonl`` sidecar (never in the job's journal,
which stays byte-identical to a standalone run), so a resumed
orchestrator regroups the wave.

Robustness:

* **Isolation.**  Each job has its own PRNG stream, its own directory
  (``root/<job_id>/``: checkpoints, journal, ``telemetry.jsonl``,
  ``metrics.json``) and a forked registry merged into the base at the end
  of each attempt.
* **Preemption = journal snapshot + requeue.**  A preemption lands on a
  journal progress record (the drivers' atomic resume unit), so the
  requeued attempt resumes bit-identically and the job's final circuit is
  its undisturbed run's.
* **Retry, timeout, backoff.**  A per-attempt wall budget, a retry count
  and an exponential backoff (:class:`DeadlineConfig`); a breach raises
  :class:`DispatchTimeout` at the job's next journal boundary.
* **Quarantine.**  A job that exhausts its retries is quarantined:
  terminal, flight-dumped into its own directory, counted in
  ``serve_quarantined``, without touching the shared context or the
  device breaker.
* **Drain.**  :meth:`ServeOrchestrator.drain` (SIGTERM in the CLI) closes
  admission, preempts every running job at its next journal boundary and
  leaves each job's final heartbeat line, ``metrics.json`` and a flight
  dump; re-running the same serve resumes every unfinished job.

Fault sites (``resilience.faults``, ``@job:ID`` and ``@tenant:NAME``
qualifiable): ``serve.admit`` on submission, ``serve.preempt`` at every
job journal progress boundary (an armed ``raise`` there is a
preemption), ``serve.requeue`` on the requeue (an armed ``raise``
consumes one retry), ``serve.drain`` entering the drain, ``serve.wave``
as a lane enters its merged wave.

**Result store** (``Options.result_store``): admission consults it before
queueing.  A full hit (a stored circuit for any query equal up to input
permutation and negation and output complement) is re-verified against
the query over all 2^8 inputs and lands the job straight in DONE with no
device dispatch: the job directory gets the circuit and a completed
journal.  A partial hit (the stored frontier of an interrupted search with
the same seed and draw-shaping configuration) seeds the job directory
with that frontier's journal records and checkpoints, and the ordinary
resume continues it bit-identically.  Finished searches publish through
the orchestrator's driver hooks; a drain publishes each interrupted job's
frontier.  Every store failure degrades to miss-and-search.

Threads: one scheduler (:meth:`ServeOrchestrator._work`) and one worker
per running job (:meth:`ServeOrchestrator._run_job`).  All shared
orchestrator state is guarded by ONE condition variable (``_cv``), never
held across a journal write, a driver call or a blocking wait.
"""

from __future__ import annotations

import hashlib
import json as _json
import logging
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np

from ..core import ttable as tt
from ..graph.state import NO_GATE, State
from ..resilience import faults
from ..resilience.checkpoint import durable_write_text
from ..resilience.deadline import DeadlineConfig, DispatchTimeout
from ..resilience.journal import JOURNAL_NAME, JOURNAL_VERSION, SearchJournal
from ..telemetry import flight as _tflight
from ..telemetry import trace as _ttrace
from ..telemetry.heartbeat import Heartbeat
from ..utils.sbox import SboxError, load_sbox, num_outputs
from .context import SearchContext, bucket_size
from .orchestrator import (
    generate_graph,
    generate_graph_one_output,
    make_targets,
)

logger = logging.getLogger(__name__)

# Job lifecycle states (the /status queue view vocabulary).
QUEUED = "queued"
RUNNING = "running"
PREEMPTED = "preempted"    # transient: snapshot taken, requeue pending
QUARANTINED = "quarantined"
DONE = "done"

#: Terminal states — run_until_idle() returns when every job is here.
TERMINAL = (DONE, QUARANTINED)

#: Journal record types that are driver progress units — the points a
#: preemption/timeout may land on (resume is bit-exact exactly there).
#: run_start/run_done are boundaries, not interruptible progress.
PROGRESS_RECORDS = ("iter_done", "round_done", "mb_round_done",
                    "job_done", "jobs_done", "chain_round")

#: /serve status-view schema version.
SERVE_SCHEMA = 1


class JobPreempted(Exception):
    """Raised at a job's journal boundary to snapshot + requeue it."""


class ServeClosed(RuntimeError):
    """submit() after drain(): admission is closed."""


def lane_bucket(n: int) -> int:
    """Rounds a requested lane count up to the fleet jobs-bucket ladder
    (``FLEET_BUCKETS`` + ``STACKED_BUCKETS``): the orchestrator's wave
    of concurrent jobs is shaped like a fleet jobs axis (the status view
    reports it)."""
    from .fleet import FLEET_LADDER

    for b in FLEET_LADDER:
        if n <= b:
            return b
    return FLEET_LADDER[-1]


def job_seed(run_seed: int, job_id: str) -> int:
    """Deterministic per-job PRNG seed: a job re-run standalone with
    this seed reproduces its serve-mode circuit bit-for-bit (the chaos
    matrix's comparison basis).  Stable across processes — a restarted
    serve run derives the same seeds."""
    h = hashlib.blake2b(
        f"{run_seed}:{job_id}".encode(), digest_size=4
    ).digest()
    return int.from_bytes(h, "little")


@dataclass
class ServeJob:
    """One tenant query: an S-box search job in the serve queue."""

    job_id: str
    sbox_path: str
    #: Output bit to search (``-1`` = all outputs, the full-graph beam).
    output: int = -1
    tenant: str = "default"
    #: Higher runs first; a strictly-higher queued priority may preempt
    #: the lowest-priority running job when no lane is free.
    priority: int = 0
    #: Per-job PRNG seed; None = derived via :func:`job_seed`.
    seed: Optional[int] = None
    permute: int = 0

    # -- runtime state (orchestrator-owned, mutated under _cv) -------------
    state: str = QUEUED
    #: Failed attempts so far (quarantine trips past the retry budget).
    failures: int = 0
    preemptions: int = 0
    #: Submission order (FIFO tiebreak) — set by submit().
    seq: int = 0
    #: Warm-affinity group: the gate-count bucket the job last swept at
    #: (its num_inputs bucket until the first preemption updates it).
    bucket: int = 0
    submitted_t: float = 0.0
    enqueued_t: float = 0.0     # last (re)queue time, for queue-wait
    not_before: float = 0.0     # backoff gate for requeued failures
    started_t: Optional[float] = None
    first_hit_t: Optional[float] = None
    finished_t: Optional[float] = None
    result_count: Optional[int] = None
    error: Optional[str] = None
    #: Latest attempt's forked registry (live per-job counters for the
    #: /status queue view; merged into the base at attempt end).
    registry: object = None
    #: Live merged wave this job is a lane of (a _Wave, orchestrator-
    #: owned) and its id for the status view; None outside a wave.
    wave: object = None
    wave_id: Optional[int] = None
    #: Wave-affinity key: the sorted member list of the last merged wave
    #: this job rode (set on a wave requeue, restored from the waves
    #: sidecar on resume) — the scheduler clusters jobs sharing it so a
    #: drained wave re-groups deterministically.
    last_wave: str = ""
    #: Result-store outcome for the status view: "hit" (answered from
    #: the store at admission, queue skipped) or "partial" (search
    #: seeded from a stored frontier); None = ordinary miss-and-search.
    store: Optional[str] = None
    #: Duplicate submissions attached to this job instead of searching
    #: again (:meth:`ServeOrchestrator.join`): N clients, one search.
    joined: int = 0
    _preempt: threading.Event = field(default_factory=threading.Event)

    @property
    def job_dir_name(self) -> str:
        return self.job_id


class JobView(SearchContext):
    """Per-job view of the shared serve context: the shape of
    :class:`~sboxgates_tpu_torch.search.batched.RestartContext` (shared
    derived tables and caches, its own PRNG stream and forked registry).
    Outside a merged wave a job dispatches exactly like a standalone run
    with the same seed (``rdv`` is what a fresh context builds: None on
    the CPU, a 1-thread rendezvous on a card); in a wave its sweeps
    rendezvous with the other lanes' (``rdv``), and ``allow_mux_threads``
    keeps the step-5 mux on what a fresh context with this seed would do,
    so the draw order, and the files, do not depend on the wave."""

    def __init__(self, base: SearchContext, seed: int, rdv=None,
                 label: Optional[str] = None):
        self.__dict__.update(base.__dict__)
        self.rng = np.random.default_rng(seed)
        self._seed_buf = (np.empty(0, dtype=np.int64), 0)
        self.stats = base.stats.fork()
        # The LUT engine's device-work service binds the context it
        # serves: every view builds its own.
        self.lut_engine_devcb = None
        # Names the job on its rendezvous submissions (a wave's breach is
        # attributed to the jobs riding it).
        self.dispatch_label = label
        if rdv is not None:
            self.rdv = rdv
            self.allow_mux_threads = base.rdv is not None
        elif base.rdv is not None:
            from .batched import Rendezvous

            self.rdv = Rendezvous(1, timer=base.launch_timer)


class _JobJournal(SearchJournal):
    """Per-job journal whose appends double as the job's cooperative
    control points: after each durable progress record the orchestrator
    hook runs (chaos ``serve.preempt`` site, the scheduler's preempt
    flag, the per-attempt deadline, first-hit detection).  A preemption
    therefore lands exactly on the journal's atomic progress unit —
    what makes snapshot + requeue resume bit-exact."""

    _serve_ctl: Optional[Callable[[str, dict], None]] = None

    def append(self, rtype: str, **payload):
        rec = super().append(rtype, **payload)
        ctl = self._serve_ctl
        if ctl is not None and self.writable and rtype in PROGRESS_RECORDS:
            ctl(rtype, rec)
        return rec


class _Wave:
    """One merged serve wave: the same-bucket jobs admitted together,
    sharing ONE :class:`~sboxgates_tpu_torch.search.fleet.FleetRendezvous`
    so their node sweeps (and chained-round windows) run as one lane-form
    call per round.  A
    lane that finishes, preempts, or fails mid-wave simply leaves the
    rendezvous pool (``rdv.finish``) — the survivors' merges continue
    with the shrunk lane set, the done-lane masking the fleet axis was
    built around.  When the last lane leaves, the wave's fleet counters
    fold into the run registry and the wave span is recorded."""

    def __init__(self, wave_id: int, jobs, ctx: SearchContext):
        from .fleet import FleetRendezvous

        self.wave_id = wave_id
        self.job_ids = tuple(j.job_id for j in jobs)
        self.bucket = jobs[0].bucket
        self.t0 = time.perf_counter()
        self._live = len(jobs)
        self.rdv = FleetRendezvous(
            len(jobs), timer=ctx.launch_timer,
            deadline=ctx.deadline_cfg, deadline_stats=ctx.stats,
            plan=ctx.fleet_plan,
        )

    @property
    def key(self) -> str:
        """Content-based membership key (the re-group affinity value the
        requeue records): stable across orchestrator restarts."""
        return ",".join(sorted(self.job_ids))


class ServeOrchestrator:
    """The serve-mode job queue + scheduler; see the module docstring.

    ``deadline`` shapes the per-job retry schedule exactly like the
    dispatch guards': ``budget_s`` is one attempt's wall budget (0 =
    unbounded), ``retries`` the requeue budget before quarantine, and
    ``backoff_s`` the base of the deterministic exponential requeue
    backoff.

    ``merge`` controls fleet-merged waves: when two or more same-bucket
    jobs are admitted together, their lanes share one fleet rendezvous
    and their per-round device dispatches collapse O(lanes) -> O(1)
    (None = on unless ``SBG_SERVE_NO_MERGE=1``; the CLI's
    ``--serve-no-merge`` maps here)."""

    def __init__(
        self,
        ctx: SearchContext,
        root: str,
        lanes: int = 4,
        deadline: Optional[DeadlineConfig] = None,
        log: Callable[[str], None] = print,
        merge: Optional[bool] = None,
    ):
        self.ctx = ctx
        self.root = root
        self.lanes = max(1, int(lanes))
        self.lane_bucket = lane_bucket(self.lanes)
        self.deadline = deadline if deadline is not None else DeadlineConfig(
            budget_s=0.0, retries=2, backoff_s=0.25
        )
        self.log = log
        if merge is None:
            merge = os.environ.get("SBG_SERVE_NO_MERGE", "0") != "1"
        self.merge = bool(merge) and self.lanes >= 2
        #: Content-addressed result store (ctx.result_store, built from
        #: Options.result_store): admission consults it, drains publish
        #: frontiers back; None = every query searches.
        self.store = getattr(ctx, "result_store", None)
        self._cv = threading.Condition()
        self._jobs: Dict[str, ServeJob] = {}
        self._seq = 0
        self._wave_seq = 0
        self._waves: Dict[int, _Wave] = {}
        self._draining = False
        self._stop = False
        self._scheduler: Optional[threading.Thread] = None
        self._workers: Dict[str, threading.Thread] = {}
        #: Terminal-transition hook: called with the ServeJob once it is
        #: DONE or QUARANTINED and its artifacts have landed.  Invoked
        #: outside _cv and exception-guarded: a failing observer can never
        #: take a worker down.
        self.on_terminal: Optional[Callable[[ServeJob], None]] = None
        os.makedirs(root, exist_ok=True)
        # Wave-membership sidecar (NOT the per-job search journal — that
        # must stay byte-identical to a standalone run): each wave
        # requeue appends the membership row a resuming orchestrator
        # reads back as re-group affinity.
        self._waves_path = os.path.join(root, "waves.jsonl")
        self._prior_waves: Dict[str, str] = {}
        try:
            with open(self._waves_path, "r", encoding="utf-8") as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    rec = _json.loads(line)
                    for jid in rec.get("jobs", ()):
                        self._prior_waves[jid] = rec.get("key", "")
        except FileNotFoundError:
            pass
        except (OSError, ValueError) as e:
            logger.warning("serve: unreadable waves sidecar (%r); "
                           "re-grouping affinity starts fresh", e)

    # -- admission ---------------------------------------------------------

    def submit(self, job: ServeJob) -> ServeJob:
        """Admits one job; raises :class:`ServeClosed` after drain().
        The ``serve.admit`` fault site fires BEFORE any state mutation,
        so an injected admission failure is loud and loses nothing.

        With a result store attached, admission consults it first: a
        full hit is admitted straight to DONE (circuit re-verified
        against the original query, zero device dispatches, queue
        skipped); a partial hit seeds the job directory with the stored
        frontier before the job queues normally."""
        faults.fault_point("serve.admit")
        # Submission time is captured BEFORE the store consult: ttfh
        # must include the consult itself (canonicalize + read +
        # rewrite + re-verify) — that IS the cache-hit latency the
        # tenant sees.
        t_sub = time.perf_counter()
        if job.seed is None:
            job.seed = job_seed(self.ctx.opt.seed or 0, job.job_id)
        with self._cv:
            if self._draining:
                raise ServeClosed(
                    f"serve queue is draining; job {job.job_id!r} rejected"
                )
            if job.job_id in self._jobs:
                raise ValueError(f"duplicate job id {job.job_id!r}")
        sbox = n_in = None
        if not job.bucket or self.store is not None:
            # Warm-affinity seed value (a fresh job sweeps at its input
            # count; preemption updates this to the live gate bucket)
            # AND the store-consult query shape.  An unreadable table
            # only costs grouping/caching quality here — the worker's
            # own load_sbox surfaces the real error through the
            # retry/quarantine path.
            try:
                sbox, n_in = load_sbox(job.sbox_path, job.permute)
                if not job.bucket:
                    job.bucket = bucket_size(n_in)
            except (OSError, SboxError) as e:
                logger.warning(
                    "serve admit: cannot size job %s from %s (%r); "
                    "defaulting its bucket", job.job_id, job.sbox_path, e,
                )
                if not job.bucket:
                    job.bucket = bucket_size(8)
        hit = None
        if self.store is not None and sbox is not None:
            # The store consult runs OUTSIDE the lock (canonicalize +
            # disk read + all-2^8-inputs re-verify; host-side numpy
            # only, zero device dispatches).  The job pin makes the
            # store.* chaos sites @job:ID-targetable here, like every
            # worker-side site.
            faults.set_job(job.job_id)
            faults.set_tenant(job.tenant)
            try:
                hit = self._consult_store(job, sbox, n_in)
            finally:
                faults.set_job(None)
                faults.set_tenant(None)
        now = time.perf_counter()
        with self._cv:
            if self._draining:
                raise ServeClosed(
                    f"serve queue is draining; job {job.job_id!r} rejected"
                )
            if job.job_id in self._jobs:
                raise ValueError(f"duplicate job id {job.job_id!r}")
            self._seq += 1
            job.seq = self._seq
            job.submitted_t = t_sub
            job.enqueued_t = now
            if not job.last_wave:
                # Resume affinity: a prior run's drained wave re-groups
                # deterministically (the waves sidecar is the record).
                job.last_wave = self._prior_waves.get(job.job_id, "")
            if hit is not None:
                job.state = DONE
                job.store = "hit"
                job.first_hit_t = job.finished_t = time.perf_counter()
                job.result_count = 1
            else:
                job.state = QUEUED
            self._jobs[job.job_id] = job
            self.ctx.stats.inc("serve_jobs_admitted")
            self._cv.notify_all()
        if hit is not None:
            # ttfh/job_seconds observed at admission: the cache-hit
            # latency the tenant sees.
            self.ctx.stats.observe(
                "job_time_to_first_hit_s", job.first_hit_t - job.submitted_t
            )
            self.ctx.stats.observe(
                "job_seconds", job.finished_t - job.submitted_t
            )
            self.log(
                f"serve: job {job.job_id} served from the result store "
                "(1 state)"
            )
            self._notify_terminal(job)
        return job

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "ServeOrchestrator":
        if self._scheduler is None:
            self._scheduler = threading.Thread(
                target=self._work, name="sbg-serve-sched", daemon=True
            )
            self._scheduler.start()
        return self

    def stop(self, timeout_s: float = 5.0) -> None:
        """Stops the scheduler thread without touching job state —
        the quiet shutdown for a caller whose jobs are already terminal
        (the CLI after run_until_idle).  Use :meth:`drain` to preempt
        in-flight work.  Idempotent."""
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        t = self._scheduler
        if t is not None:
            t.join(timeout_s)
            self._scheduler = None

    def drain(self, timeout_s: float = 30.0) -> dict:
        """Graceful shutdown: admission closes, every running job is
        preempted at its next journal boundary (snapshot + per-job
        artifacts), and the scheduler stops.  Idempotent; returns the
        final :meth:`status_view`."""
        faults.fault_point("serve.drain")
        with self._cv:
            self._draining = True
            running = [j for j in self._jobs.values() if j.state == RUNNING]
            self._cv.notify_all()
        for j in running:
            j._preempt.set()
        deadline = time.perf_counter() + timeout_s
        with self._cv:
            while any(
                j.state == RUNNING for j in self._jobs.values()
            ) and time.perf_counter() < deadline:
                self._cv.wait(0.1)
            self._stop = True
            self._cv.notify_all()
        t = self._scheduler
        if t is not None:
            t.join(timeout_s)
            self._scheduler = None
        for t in list(self._workers.values()):
            t.join(max(0.0, deadline - time.perf_counter()) + 1.0)
        if self.store is not None:
            # Publish every interrupted job's frontier (journal snapshot
            # + referenced checkpoints) back to the result store AFTER
            # the workers have landed their final journal records: an
            # equivalent query in another process resumes from here.
            with self._cv:
                pending = [
                    j for j in self._jobs.values()
                    if j.state not in TERMINAL
                ]
            for j in pending:
                faults.set_job(j.job_id)
                faults.set_tenant(j.tenant)
                try:
                    self._publish_frontier(j)
                finally:
                    faults.set_job(None)
                    faults.set_tenant(None)
        return self.status_view()

    def run_until_drained(self, timeout_s: Optional[float] = None) -> dict:
        """Blocks until :meth:`drain` begins, then until the drain
        lands: the main loop of a server whose admission goes on for the
        process lifetime, so "all current jobs done" is not done; only a
        drain ends it."""
        deadline = (
            None if timeout_s is None else time.perf_counter() + timeout_s
        )
        with self._cv:
            while not self._draining and not self._stop:
                if deadline is not None and time.perf_counter() > deadline:
                    return self.status_view()
                self._cv.wait(0.5)
        # The drain phase gets the same budget again (not the remnant):
        # a bounded caller wants "don't hang", not exact accounting.
        return self.run_until_idle(timeout_s=timeout_s)

    def run_until_idle(self, timeout_s: Optional[float] = None) -> dict:
        """Blocks until every admitted job is terminal (DONE or
        QUARANTINED); returns :meth:`status_view`.  The CLI's serve
        main loop — SIGTERM lands in :meth:`drain` via the signal
        handler, which also unblocks this wait."""
        deadline = (
            None if timeout_s is None else time.perf_counter() + timeout_s
        )
        with self._cv:
            while True:
                jobs = list(self._jobs.values())
                # Workers drained too: a job's terminal transition
                # happens before its worker writes artifacts and merges
                # its registry fork — idle means both are done.
                if jobs and not self._workers and all(
                    j.state in TERMINAL for j in jobs
                ):
                    break
                if self._draining and not self._workers and not any(
                    j.state == RUNNING for j in jobs
                ):
                    break
                if deadline is not None and time.perf_counter() > deadline:
                    break
                self._cv.wait(0.1)
        return self.status_view()

    # -- scheduling --------------------------------------------------------

    def _runnable_locked(self, now: float) -> List[ServeJob]:
        # The _workers guard closes a re-admission race: _requeue()
        # flips a job back to QUEUED from the worker's except block,
        # BEFORE its finally stops the per-job heartbeat, merges the
        # registry fork, and pops the worker entry — admitting the job
        # again in that window would run two workers against one job
        # directory (racing heartbeats, clobbered _workers bookkeeping,
        # and a drain() that joins the wrong thread).  The entry is
        # popped under _cv, so the job becomes runnable exactly when
        # its previous attempt has fully landed.
        return [
            j for j in self._jobs.values()
            if j.state == QUEUED and j.not_before <= now
            and j.job_id not in self._workers
        ]

    def _admit_locked(self, now: float) -> List[ServeJob]:
        """Bin-packing + fair-share pick under the lock: fill free lanes
        from the ready queue, preferring (1) strictly higher priority,
        (2) the warm bucket — the gate-count bucket most running jobs
        occupy, so one wave shares kernel shapes across tenants, and
        (3) fair-share tenant rotation (fewest running lanes first),
        with FIFO submission order as the tiebreak."""
        running = [j for j in self._jobs.values() if j.state == RUNNING]
        free = self.lanes - len(running)
        if free <= 0:
            return []
        ready = self._runnable_locked(now)
        if not ready:
            return []
        by_tenant: Dict[str, int] = {}
        for j in running:
            by_tenant[j.tenant] = by_tenant.get(j.tenant, 0) + 1
        bucket_votes: Dict[int, int] = {}
        for j in running:
            bucket_votes[j.bucket] = bucket_votes.get(j.bucket, 0) + 1
        if not bucket_votes:
            for j in ready:
                bucket_votes[j.bucket] = bucket_votes.get(j.bucket, 0) + 1
        warm = max(bucket_votes, key=lambda b: (bucket_votes[b], -b))
        picks: List[ServeJob] = []
        pool = list(ready)
        picked_waves: set = set()
        while free > 0 and pool:
            pool.sort(key=lambda j: (
                -j.priority,
                0 if j.bucket == warm else 1,
                # Wave re-group affinity: once one member of a recorded
                # wave is picked ON MERIT, its former wave-mates follow
                # into the same admission round, so a drained merged
                # wave re-forms deterministically on resume.  The pull
                # only ever activates for already-picked waves — a job
                # with (or without) a recorded wave keeps its ordinary
                # priority/bucket/tenant/FIFO position otherwise, so
                # wave history can never starve anyone.
                0 if j.last_wave and j.last_wave in picked_waves else 1,
                by_tenant.get(j.tenant, 0),
                j.seq,
            ))
            j = pool.pop(0)
            by_tenant[j.tenant] = by_tenant.get(j.tenant, 0) + 1
            if j.last_wave:
                picked_waves.add(j.last_wave)
            picks.append(j)
            free -= 1
        return picks

    def _preempt_targets_locked(self, now: float) -> List[ServeJob]:
        """Priority preemption: when no lane is free and a strictly
        higher-priority job is ready, the lowest-priority running jobs
        yield (snapshot + requeue), one per waiting higher-priority
        job."""
        running = sorted(
            (j for j in self._jobs.values() if j.state == RUNNING),
            key=lambda j: (j.priority, -j.seq),
        )
        if len(running) < self.lanes:
            return []
        waiting = sorted(
            self._runnable_locked(now),
            key=lambda j: -j.priority,
        )
        targets = []
        ri = 0
        for w in waiting:
            # Skip victims already flagged (their lane frees at their
            # next journal boundary) — an in-flight preemption must not
            # shadow the next-lowest-priority lane from a second
            # higher-priority waiter.
            while ri < len(running) and running[ri]._preempt.is_set():
                ri += 1
            if ri >= len(running):
                break
            victim = running[ri]
            if w.priority <= victim.priority:
                # waiting is sorted by priority descending: if this
                # waiter cannot preempt the cheapest remaining victim,
                # no later waiter can.
                break
            targets.append(victim)
            ri += 1
        return targets

    def _work(self) -> None:
        """The scheduler thread: admit ready jobs onto free lanes, fire
        priority preemptions, sleep on the condition variable between
        events.  Spawns workers OUTSIDE the lock."""
        while True:
            now = time.perf_counter()
            picks: List[ServeJob] = []
            preempts: List[ServeJob] = []
            with self._cv:
                if self._stop:
                    return
                if not self._draining:
                    picks = self._admit_locked(now)
                    for j in picks:
                        j.state = RUNNING
                        j.started_t = now
                        j.wave = None
                        j.wave_id = None
                        j._preempt = threading.Event()
                        self.ctx.stats.observe(
                            "serve_queue_wait_s", now - j.enqueued_t
                        )
                    self._form_waves_locked(picks)
                    preempts = self._preempt_targets_locked(now)
                if not picks and not preempts:
                    self._cv.wait(0.1)
            for j in preempts:
                j._preempt.set()
            for j in picks:
                t = threading.Thread(
                    target=self._run_job, args=(j,),
                    name=f"sbg-serve-{j.job_id}", daemon=True,
                )
                with self._cv:
                    self._workers[j.job_id] = t
                t.start()

    # -- merged waves ------------------------------------------------------

    def _form_waves_locked(self, picks: List[ServeJob]) -> None:
        """Groups this admission round's picks into merged waves (caller
        holds the lock): every bucket group of two or more jobs becomes
        one wave whose lanes share a fleet rendezvous — one lane-form
        call per round for the whole group, instead of one dispatch
        stream per tenant thread.  Solo picks keep the per-job path."""
        if not self.merge:
            return
        groups: Dict[int, List[ServeJob]] = {}
        for j in picks:
            groups.setdefault(j.bucket, []).append(j)
        for group in groups.values():
            if len(group) < 2:
                continue
            self._wave_seq += 1
            wave = _Wave(self._wave_seq, group, self.ctx)
            self._waves[wave.wave_id] = wave
            for j in group:
                j.wave = wave
                j.wave_id = wave.wave_id
            self.ctx.stats.observe(
                "serve_wave_lanes", float(len(group))
            )

    def _leave_wave(self, wave: _Wave, job: ServeJob) -> None:
        """One lane leaves its merged wave (job done, preempted, or
        failed): the rendezvous pool shrinks (rdv.finish — the survivors
        keep merging at the smaller lane set) and the LAST lane folds
        the wave's fleet counters into the run registry and records the
        wave span."""
        wave.rdv.finish()
        with self._cv:
            job.wave = None
            job.wave_id = None
            wave._live -= 1
            last = wave._live == 0
            if last:
                self._waves.pop(wave.wave_id, None)
        if last:
            from .fleet import fleet_stats_into

            fleet_stats_into(self.ctx, wave.rdv)
            self.ctx.stats.inc(
                "serve_merged_dispatches",
                wave.rdv.stats["fleet_dispatches"],
            )
            _ttrace.tracer().record(
                f"serve.wave[{wave.wave_id}]", "wave", wave.t0,
                time.perf_counter(),
                {"lanes": len(wave.job_ids),
                 "merged_dispatches": int(
                     wave.rdv.stats["fleet_dispatches"]
                 ),
                 "submits": int(wave.rdv.stats["submits"])},
            )

    def _record_wave_requeue(self, job: ServeJob, wave: _Wave) -> None:
        """Durable wave-membership row for a requeued lane (drain or
        preemption mid-wave): the sidecar — NOT the per-job search
        journal, which must stay byte-identical to a standalone run —
        is what lets a resuming orchestrator re-group the wave
        deterministically."""
        job.last_wave = wave.key
        try:
            with open(self._waves_path, "a", encoding="utf-8") as f:
                f.write(_json.dumps({
                    "wave": wave.wave_id, "key": wave.key,
                    "jobs": list(wave.job_ids),
                    "requeued": job.job_id,
                }) + "\n")
        except OSError as e:
            logger.warning(
                "serve: cannot record wave membership for %s (%r); "
                "resume re-grouping degrades to FIFO", job.job_id, e,
            )

    # -- result store ------------------------------------------------------

    def _job_config(self, job: ServeJob) -> dict:
        """The per-job journal run_start configuration (one shape for
        the worker's journal, a hit's completed journal, and a seeded
        frontier's materialized journal)."""
        return {
            "job": job.job_id,
            "sbox": os.path.abspath(job.sbox_path),
            "output": job.output,
            "seed": int(job.seed),
            "tenant": job.tenant,
            "iterations": self.ctx.opt.iterations,
        }

    def _frontier_cfg(self, job: ServeJob) -> dict:
        """The draw-shaping configuration a frontier entry binds:
        frontiers embed PRNG state, so a stored frontier may only seed a
        search that would consume the exact same draw stream."""
        opt = self.ctx.opt
        return {
            "seed": int(job.seed),
            "output": job.output,
            "permute": job.permute,
            "iterations": opt.iterations,
            "metric": opt.metric,
            "lut": opt.lut_graph,
            "randomize": opt.randomize,
            "batch": opt.batch_restarts,
            "chain_rounds": opt.chain_rounds,
            # Candidate ordering changes the dispatch count of every
            # ordered sweep (and each dispatch draws a seed), so a
            # frontier taken under one order only replays under it.
            "candidate_order": opt.candidate_order,
        }

    def _consult_store(self, job: ServeJob, sbox, n_in: int):
        """The admission-time store consult (no locks held).  A FULL
        hit writes the job's artifacts (checkpoint + completed journal)
        and returns the hit; a PARTIAL hit seeds the job directory with
        the stored frontier and returns None (the job queues normally);
        a miss returns None.  Every failure shape degrades to a miss —
        the store can only ever save work, never lose a job."""
        job_dir = self._job_dir(job)
        # A job directory that already journaled locally resumes from
        # its OWN journal (the restarted-serve-run case); a store
        # frontier must not clobber that strictly-newer local state.
        has_local = os.path.exists(os.path.join(job_dir, JOURNAL_NAME))
        fcfg = None if has_local else self._frontier_cfg(job)
        mask = tt.mask_table(n_in)
        metric = self.ctx.opt.metric
        if job.output >= 0:
            target = tt.target_table(sbox, job.output)
            kind, val = self.store.fetch(
                target, mask, metric, frontier_cfg=fcfg
            )
        else:
            try:
                n_out = num_outputs(sbox, n_in)
            except SboxError:
                return None
            targets = make_targets(sbox)[:n_out]
            kind, val = self.store.fetch_multi(
                targets, mask, metric, frontier_cfg=fcfg
            )
        if kind == "hit":
            try:
                self._finish_hit(job, val)
                return val
            except OSError as e:
                logger.warning(
                    "serve: cannot land store hit for %s (%r); "
                    "searching instead", job.job_id, e,
                )
                return None
        if kind == "partial":
            self._seed_frontier(job, val)
        return None

    def _finish_hit(self, job: ServeJob, hit) -> None:
        """Lands a full store hit as ordinary job artifacts: the
        re-verified circuit as a durable checkpoint and a COMPLETED
        per-job journal, so the job directory is indistinguishable from
        a finished search (and a resumed serve run sees it as done)."""
        from ..graph.xmlio import save_state

        job_dir = self._job_dir(job)
        os.makedirs(job_dir, exist_ok=True)
        st = hit.state
        if job.output >= 0:
            # Entries are normalized to output bit 0; rebind to the
            # queried bit (for an exact repeat this reproduces the
            # publisher's file byte-for-byte).
            gid = st.outputs[0]
            st.outputs = [NO_GATE] * 8
            st.outputs[job.output] = gid
        journal = SearchJournal.start(
            job_dir, dict(self._job_config(job), store="hit")
        )
        ckpt = save_state(st, job_dir)
        journal.append(
            "run_done", beam=[os.path.basename(ckpt)], store="hit"
        )

    def _seed_frontier(self, job: ServeJob, body: dict) -> None:
        """Materializes a stored interrupted-search frontier into the
        job directory — checkpoints plus a journal whose progress
        records are the stored snapshot — so the worker's ordinary
        resume path continues the search bit-identically (the journal's
        resume contract, applied across processes via the store)."""
        job_dir = self._job_dir(job)
        try:
            os.makedirs(job_dir, exist_ok=True)
            for fname, xml in body.get("checkpoints", {}).items():
                fname = os.path.basename(fname)
                durable_write_text(os.path.join(job_dir, fname), xml)
            run_start = {
                "seq": 0, "type": "run_start",
                "version": JOURNAL_VERSION,
                "config": dict(self._job_config(job), store="partial"),
            }
            lines = [_json.dumps(run_start, sort_keys=True)]
            lines.extend(
                _json.dumps(rec, sort_keys=True)
                for rec in body.get("records", [])
            )
            durable_write_text(
                os.path.join(job_dir, JOURNAL_NAME),
                "\n".join(lines) + "\n",
            )
            job.store = "partial"
        except OSError as e:
            logger.warning(
                "serve: cannot seed frontier for %s (%r); searching "
                "from scratch", job.job_id, e,
            )

    def _publish_frontier(self, job: ServeJob) -> None:
        """Publishes a drained job's journal snapshot (progress records
        + the checkpoint bodies they reference) as a store frontier, so
        an equivalent query in ANOTHER process resumes from here."""
        store = self.store
        if store is None or store.readonly:
            return
        job_dir = self._job_dir(job)
        records = SearchJournal.load_records(job_dir)
        if (
            len(records) < 2
            or records[0].get("type") != "run_start"
            or any(r.get("type") == "run_done" for r in records)
        ):
            return
        ckpts = {}
        for rec in records:
            names = []
            if rec.get("ckpt"):
                names.append(rec["ckpt"])
            names.extend(rec.get("beam") or [])
            for nm in names:
                nm = os.path.basename(nm)
                if nm in ckpts:
                    continue
                try:
                    with open(
                        os.path.join(job_dir, nm), encoding="utf-8"
                    ) as f:
                        ckpts[nm] = f.read()
                except OSError:
                    return  # incomplete frontier: don't publish
        try:
            sbox, n_in = load_sbox(job.sbox_path, job.permute)
        except (OSError, SboxError):
            return
        mask = tt.mask_table(n_in)
        metric = self.ctx.opt.metric
        cfg = self._frontier_cfg(job)
        meta = {"job": job.job_id, "tenant": job.tenant}
        if job.output >= 0:
            store.put_frontier(
                tt.target_table(sbox, job.output), mask, metric, cfg,
                records[1:], ckpts, meta=meta,
            )
        else:
            try:
                n_out = num_outputs(sbox, n_in)
            except SboxError:
                return
            store.put_frontier(
                None, mask, metric, cfg, records[1:], ckpts,
                multi=make_targets(sbox)[:n_out], meta=meta,
            )

    # -- the worker --------------------------------------------------------

    def _job_dir(self, job: ServeJob) -> str:
        return os.path.join(self.root, job.job_dir_name)

    def _progress_hook(
        self, job: ServeJob, t0: float
    ) -> Callable[[str, dict], None]:
        """The per-attempt journal control point; see _JobJournal."""
        cfg = self.deadline

        def hook(rtype: str, rec: dict) -> None:
            # First-hit detection: the first progress record carrying a
            # result (an iteration's checkpoint, a round's beam, a
            # chained output's completed round) is the tenant's first
            # hit; ttfh counts from SUBMISSION — queue wait and retries
            # included, the latency the tenant sees.
            hit = (
                bool(rec.get("ckpt")) or bool(rec.get("beam"))
                or rtype == "chain_round"
            )
            if hit and job.first_hit_t is None:
                job.first_hit_t = time.perf_counter()
                self.ctx.stats.observe(
                    "job_time_to_first_hit_s",
                    job.first_hit_t - job.submitted_t,
                )
            try:
                faults.fault_point("serve.preempt")
            except faults.InjectedFault as e:
                # An injected raise at the preempt site IS a chaos
                # preemption: snapshot (already durable) + requeue.
                raise JobPreempted(str(e)) from None
            if job._preempt.is_set():
                raise JobPreempted("preempted by scheduler")
            if cfg.budget_s > 0 and time.perf_counter() - t0 > cfg.budget_s:
                raise DispatchTimeout(
                    f"serve job {job.job_id!r} exceeded its "
                    f"{cfg.budget_s:g}s attempt budget"
                )

        return hook

    def _run_job(self, job: ServeJob) -> None:
        """One attempt of one job on its own worker thread.  Never
        raises: every outcome is a state transition (DONE, requeue, or
        QUARANTINED) so a poison job can never take the scheduler — or
        a neighbor tenant — down with it."""
        faults.set_job(job.job_id)
        faults.set_tenant(job.tenant)
        t0 = time.perf_counter()
        job_dir = self._job_dir(job)
        view: Optional[JobView] = None
        hb: Optional[Heartbeat] = None
        with self._cv:
            wave = job.wave
        try:
            if wave is not None:
                # Chaos site for the merged-wave path: an injected raise
                # here is a lane failure AT WAVE ENTRY — the finally
                # below still leaves the wave, so an injected poison
                # lane can never strand its wave-mates' rendezvous.
                faults.fault_point("serve.wave")
            view = JobView(
                self.ctx, int(job.seed),
                rdv=wave.rdv if wave is not None else None,
                label=job.job_id,
            )
            with self._cv:
                job.registry = view.stats
            journal = _JobJournal.for_job(
                self.root, job.job_dir_name,
                {"job": job.job_id, "sbox": os.path.abspath(job.sbox_path),
                 "output": job.output, "seed": int(job.seed),
                 "tenant": job.tenant,
                 "iterations": self.ctx.opt.iterations},
                resume=True,
            )
            journal._serve_ctl = self._progress_hook(job, t0)
            hb = Heartbeat(
                view.stats, job_dir, interval_s=0, rank=0,
                resume=journal.resumed,
                run_config={"job": job.job_id, "tenant": job.tenant,
                            "seed": int(job.seed), "output": job.output,
                            "attempt": job.failures + job.preemptions},
                incident_hook=False,
            ).start()
            sbox, num_inputs = load_sbox(job.sbox_path, job.permute)
            targets = make_targets(sbox)
            st = State.init_inputs(num_inputs)

            def jlog(s: str) -> None:
                if self.ctx.opt.verbosity >= 1:
                    self.log(f"[{job.job_id}] {s}")

            if job.output >= 0:
                results = generate_graph_one_output(
                    view, st, targets, job.output, save_dir=job_dir,
                    log=jlog, journal=journal,
                )
            else:
                results = generate_graph(
                    view, st, targets, save_dir=job_dir, log=jlog,
                    journal=journal,
                )
            with self._cv:
                job.state = DONE
                job.finished_t = time.perf_counter()
                job.result_count = len(results)
            # job_seconds spans submission -> completion (queue wait and
            # retries included — the latency the tenant sees); the ttfh
            # histogram is observed ONCE, by the progress hook, at the
            # first hit.
            self.ctx.stats.observe(
                "job_seconds", job.finished_t - job.submitted_t
            )
            _ttrace.tracer().record(
                f"job[{job.job_id}]", "job", job.submitted_t,
                job.finished_t, {"found": bool(results)},
            )
            self.log(
                f"serve: job {job.job_id} done "
                f"({len(results)} state{'s' if len(results) != 1 else ''})"
            )
        except JobPreempted as e:
            with self._cv:
                job.state = PREEMPTED
                job.preemptions += 1
                if view is not None and view.last_dispatch_gates:
                    job.bucket = bucket_size(view.last_dispatch_gates)
            if wave is not None:
                # Snapshot landed at the journal boundary; the requeue
                # records wave membership so resume re-groups the wave
                # deterministically (the non-preempted lanes keep
                # merging — the finally's leave shrinks the pool).
                self._record_wave_requeue(job, wave)
            self.ctx.stats.inc("serve_preemptions")
            self.log(f"serve: job {job.job_id} preempted ({e})")
            if self._draining and view is not None:
                # Drain artifacts: the flight dump lands IN the job's
                # directory (the heartbeat/metrics.json below do too;
                # the interrupted search's frontier is published by
                # drain() once every worker has landed).
                _tflight.flight_dump(
                    "serve_drain", registry=view.stats,
                    directory=job_dir, extra={"job": job.job_id},
                )
            self._requeue(job)
        except BaseException as e:  # the poison-job safety net
            failures = None
            with self._cv:
                job.failures += 1
                job.error = repr(e)
                failures = job.failures
            if failures > self.deadline.retries:
                self._quarantine(job, view)
            else:
                backoff = self.deadline.backoff_s * (
                    2 ** (failures - 1)
                )
                self.log(
                    f"serve: job {job.job_id} failed ({e!r}); retry "
                    f"{failures}/{self.deadline.retries} in "
                    f"{backoff:.2f}s"
                )
                if wave is not None:
                    self._record_wave_requeue(job, wave)
                self._requeue(job, backoff_s=backoff)
        finally:
            faults.set_job(None)
            faults.set_tenant(None)
            if wave is not None:
                self._leave_wave(wave, job)
            if hb is not None:
                try:
                    hb.stop()
                except Exception as e:
                    # A failed per-job artifact write must not turn a
                    # completed/requeued job into a worker crash.
                    logger.warning(
                        "serve: job %s heartbeat stop failed: %r",
                        job.job_id, e,
                    )
            if view is not None:
                self.ctx.stats.merge(view.stats)
            with self._cv:
                terminal = job.state in TERMINAL
            if terminal:
                # Fired after the artifacts have landed and BEFORE the
                # worker entry is popped: run_until_idle/_drained and
                # wait_terminal() wait for the entry, so nothing that
                # returns "idle" or "terminal" can outrun the observer
                # (the admission journal's durable done marker).  A
                # terminal job is never requeued, so it cannot run again.
                self._notify_terminal(job)
            with self._cv:
                self._workers.pop(job.job_id, None)
                self._cv.notify_all()

    def _requeue(self, job: ServeJob, backoff_s: float = 0.0) -> None:
        """Back onto the queue (preemption or retriable failure).  The
        ``serve.requeue`` chaos site fires first; an injected raise
        there consumes one retry and requeues anyway — a chaos-lost
        requeue becomes a counted failure, never a vanished job."""
        try:
            faults.fault_point("serve.requeue")
        except faults.InjectedFault as e:
            with self._cv:
                job.failures += 1
                job.error = repr(e)
                failures = job.failures
            if failures > self.deadline.retries:
                self._quarantine(job, None)
                return
            backoff_s = max(
                backoff_s,
                self.deadline.backoff_s * (2 ** (failures - 1)),
            )
        now = time.perf_counter()
        with self._cv:
            job.state = QUEUED
            job.enqueued_t = now
            job.not_before = now + backoff_s
            job._preempt = threading.Event()
            self._cv.notify_all()

    def _quarantine(self, job: ServeJob, view: Optional[JobView]) -> None:
        """Terminal isolation for a poison job: flight dump into the
        job's own directory, counter, log line — and nothing else.  The
        shared context, the device breaker, and every other tenant are
        untouched."""
        with self._cv:
            job.state = QUARANTINED
            job.finished_t = time.perf_counter()
            self._cv.notify_all()
        self.ctx.stats.inc("serve_quarantined")
        _tflight.flight_dump(
            "serve_quarantine",
            registry=view.stats if view is not None else None,
            directory=self._job_dir(job),
            extra={"job": job.job_id, "error": job.error},
        )
        self.log(
            f"serve: job {job.job_id} QUARANTINED after "
            f"{job.failures} failed attempts ({job.error})"
        )

    # -- introspection -----------------------------------------------------

    def status_view(self) -> dict:
        """The per-job queue view for ``/status`` and the heartbeat
        lines: states, tenants, priorities, per-job ttfh-so-far, and a
        small live-counter slice read from each job's registry FORK —
        all host-side state, zero device syncs."""
        now = time.perf_counter()
        with self._cv:
            jobs = {}
            counts = dict.fromkeys(
                (QUEUED, RUNNING, PREEMPTED, QUARANTINED, DONE), 0
            )
            for j in self._jobs.values():
                counts[j.state] = counts.get(j.state, 0) + 1
                row = {
                    "state": j.state,
                    "tenant": j.tenant,
                    "priority": j.priority,
                    "bucket": j.bucket,
                    "failures": j.failures,
                    "preemptions": j.preemptions,
                }
                if j.wave_id is not None:
                    row["wave"] = j.wave_id
                if j.store is not None:
                    # Cache-hit jobs visibly skip the queue; frontier-
                    # seeded jobs visibly resume mid-search.
                    row["store"] = j.store
                if j.state == QUEUED:
                    row["queue_wait_s"] = round(now - j.enqueued_t, 3)
                if j.state == RUNNING and j.started_t is not None:
                    row["running_s"] = round(now - j.started_t, 3)
                if j.first_hit_t is not None:
                    row["ttfh_s"] = round(j.first_hit_t - j.submitted_t, 3)
                if j.result_count is not None:
                    row["results"] = j.result_count
                if j.error is not None:
                    row["error"] = j.error
                if j.joined:
                    row["joined"] = j.joined
                reg = j.registry
                if reg is not None and j.state == RUNNING:
                    # The fork's own lock serializes this read against
                    # the job thread; no device sync, no ordering need.
                    row["dispatches"] = int(
                        reg.get("device_dispatches", 0)
                    )
                jobs[j.job_id] = row
            view = {
                "schema": SERVE_SCHEMA,
                "lanes": self.lanes,
                "lane_bucket": self.lane_bucket,
                "merge": self.merge,
                "waves": len(self._waves),
                "draining": self._draining,
                "counts": counts,
                "jobs": jobs,
            }
            if self.store is not None:
                view["store"] = self.store.status_view()
            return view

    def job(self, job_id: str) -> Optional[ServeJob]:
        """The admitted job by id, or None."""
        with self._cv:
            return self._jobs.get(job_id)

    def active_jobs(self, tenant: str) -> int:
        """Non-terminal jobs this tenant currently owns (an admission
        quota's denominator)."""
        with self._cv:
            return sum(
                1 for j in self._jobs.values()
                if j.tenant == tenant and j.state not in TERMINAL
            )

    def join(self, job_id: str) -> Optional[ServeJob]:
        """Attaches one more client to an already-admitted job (the
        idempotent-submission join-in-flight path): N duplicate
        submissions share ONE search.  Returns the job, or None if no
        such job is admitted."""
        with self._cv:
            j = self._jobs.get(job_id)
            if j is not None:
                j.joined += 1
            return j

    def wait_terminal(
        self, job_id: str, timeout_s: float
    ) -> Optional[ServeJob]:
        """Blocks until the job is terminal (DONE or QUARANTINED) AND
        its worker has landed artifacts and merged its fork (a long-poll
        primitive: a condition-variable wait, no device sync).  Returns
        the job (terminal or not at timeout), or None if unknown."""
        deadline = time.perf_counter() + max(0.0, timeout_s)
        with self._cv:
            while True:
                j = self._jobs.get(job_id)
                if j is None:
                    return None
                if j.state in TERMINAL and job_id not in self._workers:
                    return j
                left = deadline - time.perf_counter()
                if left <= 0:
                    return j
                self._cv.wait(min(left, 0.5))

    def result_files(self, job_id: str) -> List[str]:
        """Absolute paths of a DONE job's result circuits, recovered
        from its journal's ``run_done`` record (``beam`` carries the
        state basenames).  Host-side file reads only; empty when the
        job is not terminal or its artifacts are gone."""
        with self._cv:
            j = self._jobs.get(job_id)
        if j is None or j.state not in TERMINAL:
            return []
        job_dir = self._job_dir(j)
        records = SearchJournal.load_records(job_dir)
        beam: List[str] = []
        for rec in records:
            if rec.get("type") == "run_done":
                beam = list(rec.get("beam") or [])
        out = []
        for name in beam:
            path = os.path.join(job_dir, os.path.basename(str(name)))
            if os.path.exists(path):
                out.append(path)
        return out

    def _notify_terminal(self, job: ServeJob) -> None:
        """Fires the owner's :attr:`on_terminal` observer (outside
        ``_cv``, exception-guarded): the admission journal's durable
        "done" marker rides here, and a failing observer must never
        take a worker — or an admission — down."""
        cb = self.on_terminal
        if cb is None:
            return
        try:
            cb(job)
        except Exception as e:
            logger.warning(
                "serve: on_terminal observer failed for job %s: %r",
                job.job_id, e,
            )
