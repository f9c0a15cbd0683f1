"""Fleet-batched search: the job axis of the search engine.

PyTorch counterpart of the JAX package's ``search/fleet.py``.  Each job (one
S-box output, one restart, one permutation) runs its ``create_circuit``
recursion on a host thread with its own context view
(:class:`.batched.RestartContext`: private PRNG and counters); their
registry sweeps — the fused node heads and the streaming sweeps
(``SearchContext.stream_dispatch``) — rendezvous in a
:class:`FleetRendezvous`.  When every live job is blocked on a sweep,
same-signature requests run as ONE call of the sweep's lane form
(``<sweep>_lanes`` of :mod:`sboxgates_tpu_torch.ops.sweeps`): one launch of K3's or K1's lane
form per round for all lanes, and one host sync.

Per-job seeds are drawn in one block per wave of at most
``Options.fleet_max_wave`` jobs, in job order, so a fleet writes the files
of the per-job loop with the same seeds (the rendezvous batched driver's),
whatever the thread timing.

The lockstep steps (:func:`fleet_gate_step`, :func:`fleet_lut_step`,
:func:`fleet_lut7_step`, :func:`fleet_pivot_step`) sweep many jobs' node
heads in one stacked call: lanes pad to the jobs bucket of
:func:`fleet_bucket` and draw one seed per lane of the bucket, as the JAX
package's do; done lanes and pad lanes carry zero tables and masks (nothing
to sweep) and come back as zero rows.

Unlike the JAX package, a merged rendezvous group runs exactly its own
lanes (no duplicated pad lanes: nothing is compiled per shape here), and
there is no job-axis mesh (``--fleet-candidates`` above 1 is ROADMAP A10's).
"""

from __future__ import annotations

import threading
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..ops import sweeps
from ..resilience import deadline as _deadline
from ..telemetry import trace as _ttrace
from . import warmup as _warmup
from .batched import Rendezvous, RestartContext

#: Flat-operand jobs buckets of the JAX package (vmap lanes per dispatch).
FLEET_BUCKETS = (1, 2, 4, 8, 16, 32)

#: Its stacked-operand buckets, past the flat cap.
STACKED_BUCKETS = (64, 128, 256, 512, 1024, 2048, 4096)

#: The full jobs-bucket ladder.
FLEET_LADDER = FLEET_BUCKETS + STACKED_BUCKETS

#: Default jobs per fleet wave (resident threads); ``Options.fleet_max_wave``
#: overrides it, and shapes the per-wave seed blocks.
FLEET_MAX_WAVE = 256


def fleet_max_wave(ctx) -> int:
    """The run's jobs-per-wave cap."""
    return max(1, int(getattr(ctx.opt, "fleet_max_wave", FLEET_MAX_WAVE)
                      or FLEET_MAX_WAVE))


def fleet_bucket(n: int, shards: int = 1) -> int:
    """Jobs bucket covering ``n`` lanes, a multiple of ``shards``: the next
    rung of :data:`FLEET_LADDER`, or the next multiple of ``shards`` past
    the ladder."""
    for b in FLEET_LADDER:
        if b >= n and b >= shards and b % shards == 0:
            return b
    return -(-n // shards) * shards


def prev_fleet_bucket(b: int) -> Optional[int]:
    """The next smaller jobs bucket, or None below the smallest."""
    prev = None
    for fb in FLEET_LADDER:
        if fb >= b:
            return prev
        prev = fb
    return prev


class FleetRendezvous(Rendezvous):
    """The fleet's rendezvous: merges the streaming sweeps too
    (``merges_streams``), and runs each merged group's call under ONE
    deadline window for the whole wave (:func:`..resilience.deadline.
    wave_dispatch_with_retry`, the breach attributed to every lane) when a
    budget is armed."""

    merges_streams = True

    def __init__(self, n_threads: int, timer=None, deadline=None,
                 deadline_stats=None):
        super().__init__(n_threads, timer=timer)
        self.deadline = deadline
        self.deadline_stats = deadline_stats
        self.stats.ensure("fleet_dispatches", "fleet_singletons",
                          "fleet_stacked_dispatches", "fleet_lanes")

    def _guarded(self, call, label, lane_labels):
        cfg = self.deadline
        if cfg is None or not cfg.enabled:
            return call()
        return _deadline.wave_dispatch_with_retry(
            call, cfg,
            stats=(self.deadline_stats if self.deadline_stats is not None
                   else self.stats),
            label=label, lanes=lane_labels,
        )

    def _run_group(self, key, entries) -> None:
        name = entries[0]["name"]
        statics = entries[0]["statics"]
        n = len(entries)
        labels = [e.get("label") or f"lane{r}" for r, e in enumerate(entries)]
        if n == 1:
            e = entries[0]

            def single():
                # Fleet singletons are device dispatches (fleet_stats_into
                # counts them), so the span category is "dispatch".
                with _ttrace.span(f"fleet[{name}]", "dispatch", lanes=1,
                                  g=e.get("g")):
                    return _warmup.kernel(name, statics)(*e["args"])

            e["result"] = self._guarded(single, f"fleet[{name}]", labels[:1])
            self.stats.inc("fleet_singletons")
            return
        lanes_fn = _warmup.KERNELS[name].lanes
        gmax = max((e.get("g") or 0) for e in entries) or None
        stacked = n > FLEET_BUCKETS[-1]

        def merged():
            # One merged group = one lane-form call = one "dispatch" span.
            with _ttrace.span(f"fleet[{name}]", "dispatch", lanes=n,
                              merged=n, stacked=stacked, g=gmax):
                return lanes_fn([e["args"] for e in entries], **statics)

        out = self._guarded(merged, f"fleet[{name}]", labels)
        for e, r in zip(entries, out):
            e["result"] = r
        self.stats.inc("fleet_dispatches")
        if stacked:
            self.stats.inc("fleet_stacked_dispatches")
        self.stats.inc("fleet_lanes", n)
        self.stats.inc("batched_rows", n)


def fleet_stats_into(ctx, rdv: FleetRendezvous) -> None:
    """Folds one wave's fleet counters into the run's ``ctx.stats``: every
    merged group and every singleton was one device dispatch."""
    for k in ("fleet_dispatches", "fleet_singletons",
              "fleet_stacked_dispatches", "fleet_lanes"):
        ctx.stats.inc(k, rdv.stats[k])
    ctx.stats.inc("fleet_submits", rdv.stats["submits"])
    ctx.stats.inc("fleet_rounds", rdv.stats["dispatches"])
    ctx.stats.inc(
        "device_dispatches",
        rdv.stats["fleet_dispatches"] + rdv.stats["fleet_singletons"],
    )


def _run_fleet_wave(ctx, jobs: List[tuple]) -> List[tuple]:
    """One fleet wave: a thread per job, seeds drawn in one block."""
    from ..graph.state import NO_GATE
    from .kwan import create_circuit

    n = len(jobs)
    cap = fleet_max_wave(ctx)
    if n > cap:
        raise ValueError(
            f"fleet wave of {n} jobs exceeds the wave cap {cap}; "
            "split into waves"
        )
    rdv = FleetRendezvous(n, timer=ctx.launch_timer,
                          deadline=ctx.deadline_cfg, deadline_stats=ctx.stats)
    seeds = [int(s) for s in ctx.rng.integers(0, 2**31, size=n)]
    results: List[Optional[tuple]] = [None] * n
    errors: List[BaseException] = []

    def worker(i: int) -> None:
        try:
            rctx = RestartContext(ctx, seeds[i], rdv)
            nst, target, mask = jobs[i]
            t0 = time.perf_counter()
            out = create_circuit(rctx, nst, target, mask, [])
            rctx.observe_job(f"fleet-{i}", t0, time.perf_counter(),
                             out != NO_GATE)
            results[i] = (nst, out)
            rctx.merge_stats_into(ctx)
        except BaseException as e:  # surfaced after the join
            errors.append(e)
        finally:
            rdv.finish()

    threads = [
        threading.Thread(target=worker, args=(i,), name=f"fleet-{i}")
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
    fleet_stats_into(ctx, rdv)
    return results


def run_fleet_waves(ctx, jobs: List[tuple]) -> List[tuple]:
    """Runs any number of jobs through :func:`_run_fleet_wave` in waves of
    :func:`fleet_max_wave`.  jobs: [(state, target, mask)], each state owned
    by its job; returns [(state, out_gid)] in job order."""
    cap = fleet_max_wave(ctx)
    out: List[tuple] = []
    for lo in range(0, len(jobs), cap):
        out.extend(_run_fleet_wave(ctx, jobs[lo : lo + cap]))
    return out



def toy_fleet_boxes(n: int = 8) -> List:
    """``n`` distinct 3-input BoxJobs (parity/majority variants), the JAX
    package's fleet fixture: cheap searches whose node heads sweep on the
    device when the native route is off."""
    from .multibox import BoxJob

    boxes = []
    for j in range(n):
        box = np.zeros(256, dtype=np.uint8)
        for i in range(8):
            x0, x1, x2 = i & 1, (i >> 1) & 1, (i >> 2) & 1
            parity = x0 ^ x1 ^ x2
            major = (x0 + x1 + x2) >= 2
            bits = (parity ^ (j & 1)) | ((major ^ ((j >> 1) & 1)) << 1)
            box[i] = bits ^ ((j >> 2) & 1)
        boxes.append(BoxJob(f"toy{j}", box, 3))
    return boxes


# -------------------------------------------------------------------------
# Lockstep fleet steps
# -------------------------------------------------------------------------


def _stacked_call(ctx, name, statics, rows, lanes, g=None):
    """One stacked call of a registry sweep's lane form over ``rows`` (one
    per lane of the jobs bucket): one ``device_dispatches``, one
    ``stacked[<name>]`` span."""
    fn = _warmup.KERNELS[name].lanes

    def call():
        with _ttrace.span(f"stacked[{name}]", "dispatch", lanes=lanes, g=g,
                          stacked=True):
            return fn(rows, **statics)

    return ctx.dispatch(name, call, g=g)


def _frame(ctx, jobs, done):
    """(states, n, done, table bucket, lanes) of a stacked step."""
    from .context import bucket_size

    sts = [st for st, _, _ in jobs]
    n = len(jobs)
    if n > FLEET_LADDER[-1]:
        raise ValueError(f"fleet step of {n} jobs exceeds "
                         f"{FLEET_LADDER[-1]}; slice the fleet")
    done = [False] * n if done is None else list(done)
    b = max(bucket_size(st.num_gates) for st in sts)
    return sts, n, done, b, fleet_bucket(n)


def _lane_gs(sts, done, lanes):
    n = len(sts)
    return [0 if done[i] else sts[i].num_gates for i in range(n)] + [0] * (
        lanes - n)


def _lane_words(ctx, jobs, done, col, lanes):
    """Per-lane 8-word rows (done and pad lanes zero) on the device."""
    rows = [np.zeros(8, np.uint32) if done[i] else np.asarray(job[col])
            for i, job in enumerate(jobs)]
    rows += [np.zeros(8, np.uint32)] * (lanes - len(jobs))
    return [ctx.words(r) for r in rows]


def _lane_excls(ctx, inbits, n, lanes):
    rows = [ctx.excl_array(ib) for ib in inbits]
    rows += [np.full(8, -1, np.int32)] * (lanes - n)
    return [torch.from_numpy(r).to(ctx.device) for r in rows]


def _finish(out, n, done, width):
    v = np.zeros((n, width), dtype=np.int32)
    for i in range(n):
        if not done[i]:
            v[i] = out[i]
    return v


def _head_rows(ctx, sts, done, gs, b, lanes):
    """(tables, valid_g, pair_combos, pair_valid) per lane of a fused head."""
    tables = ctx.fleet_device_tables(sts, done=done, lanes=lanes, bucket=b)
    combos = ctx._pair_combos(b)
    ar = torch.arange(b, device=ctx.device)
    out = []
    for i in range(lanes):
        g = gs[i]
        out.append((tables[i], ar < g, combos, (combos < g).all(dim=1)))
    return out


def fleet_gate_step(ctx, jobs: Sequence[tuple], done=None) -> np.ndarray:
    """One lockstep sweep of the gate-mode node head over every job
    (``gate_step_stream``'s lane form): the jobs' tables stacked to the
    jobs bucket, one seed per lane.  ``done`` jobs ride as zero lanes and
    come back as zero rows.  jobs: [(state, target, mask)]; returns int32
    [len(jobs), 4] in job order."""
    from ..ops import combinatorics as comb
    from .context import STREAM_CHUNK, pick_chunk

    sts, n, done, b, lanes = _frame(ctx, jobs, done)
    gs = _lane_gs(sts, done, lanes)
    has_not = bool(ctx.not_entries) and not ctx.opt.lut_graph
    has_triple = not ctx.opt.lut_graph
    chunk3 = pick_chunk(max(int(comb.n_choose_k(b, 3)), 1), STREAM_CHUNK[3])
    seeds = [ctx.next_seed() for _ in range(lanes)]
    targets = _lane_words(ctx, jobs, done, 1, lanes)
    masks = _lane_words(ctx, jobs, done, 2, lanes)
    excl = torch.from_numpy(ctx.excl_array([])).to(ctx.device)
    rows = [
        (*head[:2], head[2], head[3], ctx.binom, gs[i], targets[i], masks[i],
         excl, max(gs[i] * (gs[i] - 1) * (gs[i] - 2) // 6, 0),
         ctx.pair_table, ctx.not_table if has_not else ctx.pair_table,
         ctx.triple_table, seeds[i])
        for i, head in enumerate(_head_rows(ctx, sts, done, gs, b, lanes))
    ]
    out = _stacked_call(
        ctx, "gate_step_stream",
        dict(chunk3=chunk3, has_not=has_not, has_triple=has_triple), rows,
        lanes, g=max(gs) or None,
    )
    return _finish(out, n, done, 4)


def fleet_lut_step(ctx, jobs: Sequence[tuple], done=None,
                   inbits=None) -> np.ndarray:
    """Stacked form of the fused LUT node head (``lut_step_stream``'s lane
    form) over every job; all live jobs must share its static shape class.
    Returns int32 [len(jobs), 8] in job order (done rows zero)."""
    from ..ops import combinatorics as comb
    from .context import (LUT5_HEAD_SOLVE_ROWS, STREAM_CHUNK, lut_head_has5,
                          pick_chunk)

    sts, n, done, b, lanes = _frame(ctx, jobs, done)
    inbits = [[] for _ in range(n)] if inbits is None else list(inbits)
    live_g = [st.num_gates for i, st in enumerate(sts) if not done[i]]
    if not live_g:
        return np.zeros((n, 8), dtype=np.int32)
    statics_set = {
        (
            pick_chunk(max(comb.n_choose_k(g, 3), 1), STREAM_CHUNK[3]),
            pick_chunk(max(comb.n_choose_k(g, 5), 1), STREAM_CHUNK[5])
            if lut_head_has5(g) else 1024,
            lut_head_has5(g),
        )
        for g in live_g
    }
    if len(statics_set) != 1:
        raise ValueError(
            "fleet_lut_step needs one static shape class; live jobs "
            f"span {sorted(statics_set)}"
        )
    chunk3, chunk5, has5 = next(iter(statics_set))
    gs = _lane_gs(sts, done, lanes)
    targets = _lane_words(ctx, jobs, done, 1, lanes)
    masks = _lane_words(ctx, jobs, done, 2, lanes)
    excls = _lane_excls(ctx, inbits, n, lanes)
    seeds = [ctx.next_seed() for _ in range(lanes)]
    jw, jm = ctx.lut5_tabs()
    rows = [
        (*head, ctx.binom, gs[i], targets[i], masks[i], excls[i],
         max(gs[i] * (gs[i] - 1) * (gs[i] - 2) // 6, 0),
         int(comb.n_choose_k(gs[i], 5)), ctx.pair_table, jw, jm, seeds[i])
        for i, head in enumerate(_head_rows(ctx, sts, done, gs, b, lanes))
    ]
    out = _stacked_call(
        ctx, "lut_step_stream",
        dict(chunk3=chunk3, chunk5=chunk5, has5=has5,
             solve_rows=LUT5_HEAD_SOLVE_ROWS),
        rows, lanes, g=max(gs) or None,
    )
    return _finish(out, n, done, 8)


def fleet_lut7_step(ctx, jobs: Sequence[tuple], done=None,
                    inbits=None) -> np.ndarray:
    """Stacked form of the single-chunk 7-LUT step (``lut7_step_stream``'s
    lane form); all live jobs must have one chunk class.  Returns int32
    [len(jobs), 14] in job order (done rows zero)."""
    from ..ops import combinatorics as comb
    from .context import LUT7_HEAD_SOLVE_ROWS, STREAM_CHUNK, pick_chunk

    sts, n, done, b, lanes = _frame(ctx, jobs, done)
    inbits = [[] for _ in range(n)] if inbits is None else list(inbits)
    live_g = [st.num_gates for i, st in enumerate(sts) if not done[i]]
    if not live_g:
        return np.zeros((n, 14), dtype=np.int32)
    chunk_set = {pick_chunk(max(comb.n_choose_k(g, 7), 1), STREAM_CHUNK[7])
                 for g in live_g}
    if len(chunk_set) != 1:
        raise ValueError(
            "fleet_lut7_step needs one chunk class; live jobs span "
            f"{sorted(chunk_set)}"
        )
    chunk7 = next(iter(chunk_set))
    gs = _lane_gs(sts, done, lanes)
    tables = ctx.fleet_device_tables(sts, done=done, lanes=lanes, bucket=b)
    targets = _lane_words(ctx, jobs, done, 1, lanes)
    masks = _lane_words(ctx, jobs, done, 2, lanes)
    excls = _lane_excls(ctx, inbits, n, lanes)
    seeds = [ctx.next_seed() for _ in range(lanes)]
    jidx, jpp = ctx.lut7_tabs()
    rows = [
        (tables[i], ctx.binom, gs[i], targets[i], masks[i], excls[i],
         int(comb.n_choose_k(gs[i], 7)), jidx, jpp, seeds[i])
        for i in range(lanes)
    ]
    out = _stacked_call(
        ctx, "lut7_step_stream",
        dict(chunk7=chunk7, solve7=LUT7_HEAD_SOLVE_ROWS), rows, lanes,
        g=max(gs) or None,
    )
    return _finish(out, n, done, 14)


def fleet_pivot_step(ctx, jobs: Sequence[tuple], done=None, inbits=None,
                     start_t=0, t_limit: Optional[int] = None) -> np.ndarray:
    """Stacked pivot sweep: many jobs' pivot 5-LUT sweeps in lockstep, two
    stacked calls (the pair cells, then the streams through K1's lane
    form, whatever ``--pivot-backend`` says).  All live jobs must share a
    pivot g-bucket.  ``start_t`` is a scalar or one start tile per job;
    ``t_limit`` caps the tiles each lane sweeps this call.  Done lanes ride
    with ``t_end = 0`` (no work) and come back as zero rows.  Returns int32
    [len(jobs), 9] in job order (the ``lut5_pivot_stream`` packing)."""
    from . import lut as L

    sts, n, done, b, lanes = _frame(ctx, jobs, done)
    inbits = [[] for _ in range(n)] if inbits is None else list(inbits)
    if np.isscalar(start_t):
        start_t = [int(start_t)] * n
    live = [i for i in range(n) if not done[i]]
    if not live:
        return np.zeros((n, 9), dtype=np.int32)
    pb_set = {L.pivot_g_bucket(sts[i].num_gates) for i in live}
    if len(pb_set) != 1:
        raise ValueError(
            "fleet_pivot_step needs one pivot g-bucket; live jobs span "
            f"{sorted(pb_set)}"
        )
    gmax = max(sts[i].num_gates for i in live)
    tl, th = L.pivot_tile_shape(gmax)
    sweeps.job_axis_backend(ctx.opt.pivot_backend)
    tables = ctx.fleet_device_tables(sts, done=done, lanes=lanes, bucket=b)
    host = {}
    for i in live:
        excl = [bb for bb in inbits[i] if bb >= 0]
        host[i] = L.pivot_host_operands(sts[i].num_gates, tl, th, excl)
    p2pad = max(h[3].shape[0] for h in host.values())
    lows = np.zeros((lanes, p2pad, 2), np.int64)
    highs = np.zeros((lanes, p2pad, 2), np.int64)
    lv = np.zeros((lanes, p2pad), bool)
    hv = np.zeros((lanes, p2pad), bool)
    descs = [np.zeros((0, 5), np.int32)] * lanes
    starts = [0] * lanes
    t_ends = [0] * lanes
    for i, (_, _, d, lows_p, highs_p, lowvalid, highvalid, t_real) in (
            host.items()):
        k = lows_p.shape[0]
        lows[i, :k], highs[i, :k] = lows_p, highs_p
        lv[i, :k], hv[i, :k] = lowvalid, highvalid
        descs[i] = d
        starts[i] = int(start_t[i])
        t_ends[i] = (t_real if t_limit is None
                     else min(t_real, starts[i] + t_limit))
    targets = _lane_words(ctx, jobs, done, 1, lanes)
    masks = _lane_words(ctx, jobs, done, 2, lanes)
    seeds = [ctx.next_seed() for _ in range(lanes)]
    put = lambda a: torch.from_numpy(a).to(ctx.device)  # noqa: E731
    glows, ghighs = put(lows), put(highs)
    cells = _stacked_call(
        ctx, "pivot_pair_cells", {},
        [(tables[i], glows[i], ghighs[i], targets[i], masks[i])
         for i in range(lanes)],
        lanes, g=gmax,
    )
    jw, jm = ctx.lut5_tabs()
    glv, ghv = put(lv), put(hv)
    rows = [
        (tables[i], *cells[i], glv[i], ghv[i], descs[i], starts[i], t_ends[i],
         jw, jm, seeds[i])
        for i in range(lanes)
    ]
    out = _stacked_call(
        ctx, "lut5_pivot_stream", dict(tl=tl, th=th, backend="packed"), rows,
        lanes, g=gmax,
    )
    return _finish(out, n, done, 9)
