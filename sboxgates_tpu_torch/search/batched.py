"""Batched independent restarts and concurrent mux branches: the rendezvous.

PyTorch counterpart of the JAX package's ``search/batched.py``.  R
randomized restarts of one search (``-i R --batch-iterations``), or the
select-bit branches of one step-5 multiplexer, run as host threads, and
their device sweeps *rendezvous*: when every live thread is blocked on a
sweep, same-kind requests run as ONE call of the sweep's lane form
(``<sweep>_lanes`` of :mod:`sboxgates_tpu_torch.ops.sweeps`, named by the
registry of :mod:`.warmup`), which syncs once per round for all lanes.  A
group of one runs the single-lane sweep.

Semantics are the JAX package's: each thread has its own PRNG stream (a seed
drawn from the parent's generator, in job order, before any thread starts)
and its own counters, and results fold in job order, so a run is
deterministic however the threads interleave, and merging changes no
verdict (a lane's verdict is the single-lane sweep's).  Restarts are
independent: a restart's budget is not ratcheted by another's success.

What differs from the JAX package, by design: a merged group runs its own
lanes only.  The JAX package pads a group to a fixed vmap bucket (16 or 32
lanes on an accelerator) by duplicating entries, to reuse compiled shapes;
the port compiles nothing per shape, so padding would only repeat work.
The sweeps outside the registry (the wide and spectral streams) dispatch
from their own thread, as in the JAX package.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Callable, List, Optional

import numpy as np

from ..core import ttable as tt
from ..graph.state import NO_GATE, State
from ..graph.xmlio import save_state, state_filename
from ..telemetry import attribution as _tattr
from ..telemetry import metrics as _tmetrics
from ..telemetry import trace as _ttrace
from . import warmup as _warmup
from .context import SearchContext
from .kwan import create_circuit

#: Largest group one lane-form call of the base rendezvous takes (the JAX
#: package's biggest vmap bucket); larger groups run in slices.
MAX_GROUP = 32


class Rendezvous:
    """Collects sweep requests from the threads of a pool; when every live
    thread is blocked on one, same-key requests run as one lane-form call."""

    #: Cap on concurrently spawned helper threads (mux-branch workers).
    MAX_SPAWNED = 16

    #: Whether ``SearchContext.stream_dispatch`` routes the streaming sweeps
    #: (pivot, 5-LUT and feasibility streams) through this rendezvous: only
    #: the fleet's does, as in the JAX package.
    merges_streams = False

    def __init__(self, n_threads: int, timer=None):
        self.cv = threading.Condition()
        self.live = n_threads
        self.spawned = 0
        self.waiting: List[dict] = []
        # The launch timer of the run (``SearchContext.launch_timer``): the
        # thread that flushes a group times its launches into it.
        self.timer = timer
        # Private counters, folded into ctx.stats by the drivers.
        self.stats = _tmetrics.MetricsRegistry(
            {"submits": 0, "dispatches": 0, "batched_rows": 0},
            declared=None,
        )

    def submit(self, key, name: str, statics: dict, args, g=None,
               label=None):
        """Queues one sweep (registry ``name`` with ``statics`` on
        positional ``args``) and blocks until its group has run; returns
        the sweep's result.  ``g`` is the submitting state's gate count and
        ``label`` names the submitting lane (for breach attribution)."""
        entry = {
            "key": key, "name": name, "statics": statics, "args": args,
            "done": False, "g": g, "label": label,
        }
        with self.cv:
            self.stats.inc("submits")
            self.waiting.append(entry)
            if len(self.waiting) == self.live:
                self._flush()
            else:
                while not entry["done"]:
                    self.cv.wait()
        if "error" in entry:
            raise entry["error"]
        return entry["result"]

    def finish(self) -> None:
        """Marks the calling thread as done submitting (leaves the pool)."""
        with self.cv:
            self._leave()

    def _leave(self) -> None:
        self.live -= 1
        if self.live > 0 and len(self.waiting) == self.live:
            self._flush()
        self.cv.notify_all()

    def try_spawn(self) -> bool:
        """Reserves a slot for a helper thread (adds it to the pool); False
        at the :attr:`MAX_SPAWNED` cap (the caller runs the job inline)."""
        with self.cv:
            if self.spawned >= self.MAX_SPAWNED:
                return False
            self.spawned += 1
            self.live += 1
            self.cv.notify_all()
            return True

    def child_done(self) -> None:
        """Releases a :meth:`try_spawn` slot."""
        with self.cv:
            self.spawned -= 1
            self._leave()

    def suspend(self) -> None:
        """The calling thread leaves the pool to block on something other
        than a sweep (joining children); pair with :meth:`resume`."""
        self.finish()

    def resume(self) -> None:
        with self.cv:
            self.live += 1

    def _flush(self) -> None:
        """Runs every pending group (the caller holds the lock; every other
        live thread is blocked).  A failure is delivered to every entry of
        its group, never left undelivered."""
        groups: dict = {}
        for e in self.waiting:
            groups.setdefault(e["key"], []).append(e)
        self.waiting = []
        for key, entries in groups.items():
            try:
                with _tattr.recording(self.timer):
                    self._run_group(key, entries)
            except BaseException as exc:
                for e in entries:
                    e["error"] = exc
            self.stats.inc("dispatches")
            for e in entries:
                e["done"] = True
        if self.timer is not None:
            self.timer.settle()
        self.cv.notify_all()

    def _run_group(self, key, entries) -> None:
        name = entries[0]["name"]
        statics = entries[0]["statics"]
        n = len(entries)
        if n == 1:
            e = entries[0]
            # A "rendezvous" span, not "dispatch": base-rendezvous groups
            # are not counted in device_dispatches (as in the JAX package).
            with _ttrace.span(f"rendezvous[{name}]", "rendezvous", lanes=1):
                e["result"] = _warmup.kernel(name, statics)(*e["args"])
            return
        if n > MAX_GROUP:
            for lo in range(0, n, MAX_GROUP):
                self._run_group(key, entries[lo : lo + MAX_GROUP])
            return
        lanes = _warmup.KERNELS[name].lanes
        with _ttrace.span(f"rendezvous[{name}]", "rendezvous", lanes=n,
                          merged=n):
            out = lanes([e["args"] for e in entries], **statics)
        for e, r in zip(entries, out):
            e["result"] = r
        self.stats.inc("batched_rows", n)


class RestartContext(SearchContext):
    """Per-thread view of a shared :class:`SearchContext` (a restart, a mux
    branch, a fleet job): the same derived tables, options and caches, its
    own PRNG stream and counters, sweeps routed through ``rdv``."""

    def __init__(self, base: SearchContext, seed: int, rdv: Rendezvous):
        self.__dict__.update(base.__dict__)
        self.rng = np.random.default_rng(seed)
        self._seed_buf = (np.empty(0, dtype=np.int64), 0)
        self.stats = base.stats.fork()
        self.rdv = rdv
        # The LUT engine's device-work service binds the context it serves:
        # every view builds its own.
        self.lut_engine_devcb = None

    def merge_stats_into(self, base: SearchContext) -> None:
        """Folds this view's counters into ``base`` (atomic)."""
        base.stats.merge(self.stats)


def run_mux_jobs(ctx: SearchContext, jobs: List[Callable]) -> List:
    """Runs independent mux-branch jobs concurrently over the context's
    rendezvous: each job gets a :class:`RestartContext` (seeds drawn in one
    block from ``ctx.rng``, in job order) and a helper thread while
    :meth:`Rendezvous.try_spawn` slots last; the rest run inline.  Results
    come back in job order, so the caller's fold is the serial loop's.

    jobs: callables taking the per-branch context."""
    rdv = ctx.rdv
    n = len(jobs)
    seeds = [int(s) for s in ctx.rng.integers(0, 2**31, size=n)]
    results: List = [None] * n
    errors: List[BaseException] = []
    threads: List[threading.Thread] = []
    inline: List[int] = []

    def child(i: int) -> None:
        try:
            cctx = RestartContext(ctx, seeds[i], rdv)
            results[i] = jobs[i](cctx)
            cctx.merge_stats_into(ctx)
        except BaseException as e:  # re-raised after the join
            errors.append(e)
        finally:
            rdv.child_done()

    for i in range(n):
        if rdv.try_spawn():
            t = threading.Thread(target=child, args=(i,), name=f"mux-{i}")
            threads.append(t)
            t.start()
        else:
            inline.append(i)
    try:
        for i in inline:
            cctx = RestartContext(ctx, seeds[i], rdv)
            results[i] = jobs[i](cctx)
            cctx.merge_stats_into(ctx)
    except BaseException as e:
        # Delivered after the children are joined: raising now would leave
        # them blocked in rdv.submit (this thread still counts as live).
        errors.append(e)
    finally:
        if threads:
            rdv.suspend()
            for t in threads:
                t.join()
            rdv.resume()
    if errors:
        raise errors[0]
    return results


def _run_job(rctx: SearchContext, jobs, results, i: int, kind: str,
             base: SearchContext) -> None:
    nst, target, mask = jobs[i]
    t0 = time.perf_counter()
    out = create_circuit(rctx, nst, target, mask, [])
    rctx.observe_job(f"{kind}-{i}", t0, time.perf_counter(), out != NO_GATE)
    results[i] = (nst, out)
    rctx.merge_stats_into(base)


def run_batched_circuits(ctx: SearchContext, jobs: List[tuple]) -> List[tuple]:
    """Runs independent ``create_circuit`` jobs concurrently with
    rendezvous-merged sweeps.  jobs: (state, target, mask), each state
    owned by its job; returns [(state, out_gid)] in job order.

    A fleet context routes the wave through the fleet dispatcher
    (:func:`.fleet.run_fleet_waves`, the same seed discipline).  On a
    one-core host a gate-mode batch whose nodes all run on the host runs
    its jobs one after another with the same per-job seeds (the threads
    would have nothing to overlap), as the JAX package does."""
    if ctx.opt.fleet:
        from .fleet import run_fleet_waves

        return run_fleet_waves(ctx, jobs)
    n = len(jobs)
    rdv = Rendezvous(n, timer=ctx.launch_timer)
    seeds = [int(s) for s in ctx.rng.integers(0, 2**31, size=n)]
    results: List[Optional[tuple]] = [None] * n
    if (
        (os.cpu_count() or 2) <= 1
        and not ctx.opt.lut_graph
        and all(ctx.node_host_only(st) for st, _, _ in jobs)
    ):
        for i in range(n):
            _run_job(RestartContext(ctx, seeds[i], Rendezvous(1)), jobs,
                     results, i, "restart", ctx)
        ctx.stats.ensure("restart_batch_dispatches", "restart_batch_submits")
        return results
    errors: List[BaseException] = []

    def worker(i: int) -> None:
        try:
            _run_job(RestartContext(ctx, seeds[i], rdv), jobs, results, i,
                     "restart", ctx)
        except BaseException as e:  # surfaced after the join
            errors.append(e)
        finally:
            rdv.finish()

    threads = [
        threading.Thread(target=worker, args=(i,), name=f"restart-{i}")
        for i in range(n)
    ]
    try:
        for t in threads:
            t.start()
    finally:
        for t in threads:
            if t.ident is not None:
                t.join()
    if errors:
        raise errors[0]
    ctx.stats.inc("restart_batch_dispatches", rdv.stats["dispatches"])
    ctx.stats.inc("restart_batch_submits", rdv.stats["submits"])
    return results


def generate_graph_one_output_batched(
    ctx: SearchContext,
    st: State,
    targets,
    output: int,
    save_dir: Optional[str] = ".",
    log: Callable[[str], None] = print,
    journal=None,
) -> List[State]:
    """Batched counterpart of
    :func:`.orchestrator.generate_graph_one_output`: all ``iterations``
    restarts run concurrently.  Returns the successful states, best last.

    The batch is the journal's unit (all per-restart seeds are drawn in one
    block): a kill inside it reruns the whole batch from the run's recorded
    PRNG state; a resume after it replays the recorded checkpoints."""
    opt = ctx.opt
    r = opt.iterations
    if journal is not None:
        rec = journal.last("batch_done")
        if rec is not None:
            log("Resumed: batched restarts already complete.")
            return [journal.load_checkpoint(p) for p in rec["beam"]]
    mask = tt.mask_table(st.num_inputs)
    jobs = [(st.copy(), targets[output], mask) for _ in range(r)]
    raw = run_batched_circuits(ctx, jobs)

    ok: List[State] = []
    for i, (nst, out) in enumerate(raw):
        if out == NO_GATE:
            log(f"({i + 1}/{r}): Not found.")
            continue
        nst.outputs[output] = out
        log(
            f"({i + 1}/{r}): {nst.num_gates - nst.num_inputs} gates. "
            f"SAT metric: {nst.sat_metric}"
        )
        if save_dir is not None:
            save_state(nst, save_dir)
        ok.append(nst)
    if opt.metric == 0:  # GATES
        ok.sort(key=lambda s: -s.num_gates)
    else:
        ok.sort(key=lambda s: -s.sat_metric)
    if journal is not None:
        names = [state_filename(s) for s in ok]
        journal.append("batch_done", beam=names, rng=ctx.rng_snapshot())
        journal.append("run_done", beam=names)
    return ok
