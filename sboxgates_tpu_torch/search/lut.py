"""3/5/7-input LUT search drivers.

The whole C(G, k) combination space of a search node is swept by the
streams of :mod:`sboxgates_tpu_torch.ops.sweeps`: each unranks its own
chunks on the device, runs the Karnaugh-cell feasibility filter and stops at
the first chunk (or pivot tile) holding a hit — "first hit in chunk order"
replaces the reference's MPI race (lut.c:116-487).  The host sees compact
verdicts and decodes the chosen gates and functions.

Every driver here makes the same sweep calls, and draws the same seeds and
host random numbers in the same order, as the JAX package's
``search/lut.py`` on its single-device path.

Resilience, as in that package: each blocking sweep the JAX package guards
runs under ``ctx.guarded_dispatch`` (one ``dispatch.sweep`` fault-site hit
per call, a deadline with retries when one is set), its seed drawn outside
the retried call.  A sweep that exhausts its retries raises
:class:`DispatchTimeout`; the 5-LUT search, the overflow resume and the
7-LUT stage A then trip the context's circuit breaker and run the host
chunk stream (:func:`_host_feasible_chunks`: host-made chunks through the
stage-A filter, K3 for 5-tuples), which finds the same first hit in rank
order.  ``SBG_DEVICE_ENUM=0`` takes that stream from the start.

Under a mesh (``ctx.mesh_plan``) the drivers take the JAX package's mesh
branches: the 3-LUT and the small-space 5-LUT searches sweep the sharded
feasibility stream (the chunk rounded up to a shard multiple) and solve on
the host, the pivot sweep runs the sharded lockstep rounds of
:func:`..parallel.mesh.sharded_pivot_stream` (one seed per sharded call,
the hit rows resolved in tile order), candidate ordering stays
lexicographic, and the spaces beyond int32 ranks take the host chunk
stream.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from collections import deque
from contextlib import closing
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..graph.state import NO_GATE, State, check_num_gates_possible
from ..ops import combinatorics as comb
from ..ops import pivot_tile, spectral, sweeps
from ..resilience.deadline import DispatchTimeout
from ..resilience.faults import fault_point
from .context import (
    LUT5_CHUNK,
    LUT5_SOLVE_CHUNK,
    LUT7_CAP,
    LUT7_CHUNK,
    LUT7_SOLVE_CHUNK,
    LUT7_SOLVE_SIZES,
    PIVOT_MIN_TOTAL,
    STREAM_CHUNK,
    SearchContext,
    lut_head_has5,
    lut_head_has7,
    pick_chunk,
)

logger = logging.getLogger(__name__)


def _unpack32(word: int) -> np.ndarray:
    return ((int(word) >> np.arange(32)) & 1).astype(bool)


def _unpack128(words: np.ndarray) -> np.ndarray:
    out = np.zeros(128, dtype=bool)
    for w in range(4):
        out[w * 32 : (w + 1) * 32] = _unpack32(int(words[w]) & 0xFFFFFFFF)
    return out


def _pick_row(ctx: SearchContext, rows: np.ndarray) -> int:
    """Random choice among candidate rows (the reference shuffles its scan
    order, sboxgates.c:285-299); the first row when not randomizing."""
    if ctx.opt.randomize and len(rows) > 1:
        return int(rows[int(ctx.rng.integers(0, len(rows)))])
    return int(rows[0])


# -------------------------------------------------------------------------
# 3-LUT
# -------------------------------------------------------------------------


def _add_lut3_result(
    ctx: SearchContext, st: State, rank: int, pr1: int, pr0: int, target, mask
) -> int:
    """Materializes a feasible 3-LUT: unrank the triple, fill don't-care
    function bits (randomized as in the reference, lut.c:102-108), add and
    verify."""
    a, b, c = (int(x) for x in comb.unrank_combination(rank, st.num_gates, 3))
    func = pr1
    if ctx.opt.randomize:
        func |= int(ctx.rng.integers(0, 256)) & ~(pr1 | pr0) & 0xFF
    gid = st.add_lut(func, a, b, c)
    st.verify_gate(gid, target, mask)
    return gid


def lut3_search(ctx: SearchContext, st: State, target, mask, inbits) -> int:
    """All gate triples x any 3-input function (reference: lut_search phase
    1, lut.c:501-523 — which scans all triples, so ``inbits`` is unused).
    Returns the new LUT's gate id or NO_GATE."""
    g = st.num_gates
    if g < 3:
        return NO_GATE
    del inbits
    if ctx.mesh_plan is not None:
        found, cstart, feas, r1, r0, examined, _ = ctx.feasible_stream_driver(
            st, target, mask, [], k=3
        )
        ctx.stats.inc("lut3_candidates", examined)
        if not found:
            return NO_GATE
        rows = np.nonzero(feas.cpu().numpy())[0]
        row = _pick_row(ctx, rows)
        r1, r0 = sweeps.to_u32(r1), sweeps.to_u32(r0)
        return _add_lut3_result(
            ctx, st, cstart + row, int(r1[row]) & 0xFF, int(r0[row]) & 0xFF,
            target, mask,
        )
    args, total, chunk = ctx.stream_args(st, target, mask, [], 3)
    seed = ctx.next_seed()
    v = ctx.guarded_dispatch(
        lambda: ctx.stream_dispatch(
            "lut3_stream", dict(chunk=chunk), (*args, 0, total, seed), g=g
        ),
        "lut3.stream",
    )
    ctx.stats.inc("lut3_candidates", int(v[4]))
    if not v[0]:
        return NO_GATE
    return _add_lut3_result(
        ctx, st, int(v[1]), int(v[2]) & 0xFF, int(v[3]) & 0xFF, target, mask
    )


# -------------------------------------------------------------------------
# 5-LUT
# -------------------------------------------------------------------------


def _decode_lut5(
    ctx: SearchContext, combo, sigma: int, func_outer: int,
    req1_cells: np.ndarray, req0_cells: np.ndarray, splits, w_tab, m_tab,
) -> dict:
    """Reconstructs the inner LUT function for a device-selected
    decomposition: group the 32 cells by (outer output, inner pattern)."""
    a, b, c, d, e = (int(combo[p]) for p in splits[sigma])
    wbits = _unpack32(w_tab[sigma, func_outer])
    groups = np.zeros(32, dtype=np.int64)
    for m in range(4):
        mm = _unpack32(m_tab[sigma, m])
        groups[mm & wbits] = 4 + m
        groups[mm & ~wbits] = m
    func_inner = sweeps.solve_inner_function(
        req1_cells, req0_cells, groups, ctx.rng if ctx.opt.randomize else None
    )
    assert func_inner is not None, "device reported spurious 5-LUT hit"
    return {
        "func_outer": func_outer,
        "func_inner": func_inner,
        "gates": (a, b, c, d, e),
    }


def _solve_lut5_rows(
    ctx: SearchContext, st: State, combos: np.ndarray, req1: np.ndarray,
    req0: np.ndarray, splits, w_tab, m_tab,
) -> Optional[dict]:
    """Runs the packed-cell decomposition solver over feasible tuples (in
    sub-chunks padded with all-ones rows, which conflict in every cell) and
    decodes the first hit.  ``req1``/``req0`` are uint32 arrays.  Each
    solve runs under ``ctx.host_sync_deadline``."""
    jw, jm = ctx.lut5_tabs()
    for lo in range(0, len(combos), LUT5_SOLVE_CHUNK):
        hi = min(lo + LUT5_SOLVE_CHUNK, len(combos))
        scs = pick_chunk(hi - lo, LUT5_SOLVE_CHUNK)
        p1, _ = comb.pad_rows(req1[lo:hi], scs, fill=0xFFFFFFFF)
        p0, _ = comb.pad_rows(req0[lo:hi], scs, fill=0xFFFFFFFF)
        ctx.stats.inc("lut5_solved", hi - lo)
        seed = ctx.next_seed()
        v = ctx.host_sync_deadline(
            lambda a=p1, b=p0: ctx.stream_dispatch(
                "lut5_solve", {}, (ctx.words(a), ctx.words(b), jw, jm, seed),
                g=st.num_gates,
            ),
            "lut5.solve",
        )
        if not v[0]:
            continue
        t = lo + int(v[1])
        sigma, func_outer = divmod(int(v[2]), 256)
        return _decode_lut5(
            ctx, combos[t], sigma, func_outer, _unpack32(req1[t]),
            _unpack32(req0[t]), splits, w_tab, m_tab,
        )
    return None


# Pivot g-buckets and tile shapes: the tile shape of a search is keyed on the
# bucket covering its gate count, as in the JAX package (tile boundaries
# shape the per-tile seeds, so they are part of the search's semantics).
PIVOT_G_BUCKETS = (64, 96, 128, 192, 256, 384, 512)


def pivot_g_bucket(g: int) -> int:
    for b in PIVOT_G_BUCKETS:
        if g <= b:
            return b
    raise ValueError(f"too many gates for the pivot sweep: {g}")


def pivot_tile_shape(g: int) -> Tuple[int, int]:
    """(low rows, high rows) per pivot tile."""
    if pivot_g_bucket(g) <= 128:
        return 256, 512
    return 512, 512


def pivot_host_operands(g: int, tl: int, th: int, excl):
    """Host operands of one node's pivot sweep: (lows, highs, descs,
    lows_p, highs_p, lowvalid, highvalid, t_real).  The pair arrays are
    padded by one tile so every tile slice is in range (padded rows
    invalid).  One builder for :class:`PivotOperands` and the stacked
    ``search.fleet.fleet_pivot_step``."""
    lows, highs, _ = sweeps.pivot_pair_grids(g)
    descs = sweeps.pivot_tile_descs(g, tl, th, excl)
    p2 = lows.shape[0]
    p2pad = p2 + max(tl, th)
    lowvalid = np.zeros(p2pad, bool)
    highvalid = np.zeros(p2pad, bool)
    lowvalid[:p2] = ~np.isin(lows, excl).any(1) if excl else True
    highvalid[:p2] = ~np.isin(highs, excl).any(1) if excl else True
    lows_p = np.zeros((p2pad, 2), np.int64)
    lows_p[:p2] = lows
    highs_p = np.zeros((p2pad, 2), np.int64)
    highs_p[:p2] = highs
    return (lows, highs, descs, lows_p, highs_p, lowvalid, highvalid,
            descs.shape[0])


class PivotOperands:
    """Host + device operands of the pivot 5-LUT sweep: pair grids, tile
    descriptors (host), validity masks and per-pair cell masks (device).
    The pair arrays are padded by one tile so every tile slice is in
    range; padded rows are invalid.  For the ``"pre"`` backend the cell
    masks are also expanded to int8 lanes (``lanes``), once.  ``dispatch``
    (a context's :meth:`SearchContext.dispatch`) wraps the pair-cell
    sweep; None calls it directly."""

    def __init__(self, g, tl, th, excl, tables, target, mask, device,
                 backend="packed", dispatch=None):
        self.g, self.tl, self.th = g, tl, th
        (lows, highs, descs, lows_p, highs_p, lowvalid, highvalid,
         self.t_real) = pivot_host_operands(g, tl, th, excl)
        self.lows, self.highs, self.descs = lows, highs, descs
        if self.t_real == 0:
            return
        tile_sizes = (
            (descs[:, 2] - descs[:, 1]).astype(np.int64)
            * (descs[:, 4] - descs[:, 3]).astype(np.int64)
        )
        self.size_cum = np.concatenate([[0], np.cumsum(tile_sizes)])
        self.tables = tables
        put = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
        cells = (
            tables, put(lows_p), put(highs_p),
            sweeps.as_words(target, device), sweeps.as_words(mask, device),
        )
        if dispatch is None:
            self.lc1, self.lc0, self.hc = sweeps.pivot_pair_cells(*cells)
        else:
            self.lc1, self.lc0, self.hc = dispatch(
                "pivot_pair_cells", lambda: sweeps.pivot_pair_cells(*cells), g=g
            )
        self.jlv = put(lowvalid)
        self.jhv = put(highvalid)
        self.lanes = None
        if backend == "pre":
            self.lanes = tuple(
                pivot_tile.expand_lanes(x) for x in (self.lc1, self.lc0, self.hc)
            )

    def stream_args(self):
        """Positional operands of lut5_pivot_stream / lut5_pivot_tile for
        the backend the operands were built for: the cells as words, or as
        lanes for ``"pre"``."""
        cells = self.lanes or (self.lc1, self.lc0, self.hc)
        return (self.tables, *cells, self.jlv, self.jhv, self.descs)


def _lut5_search_pivot(
    ctx: SearchContext, st: State, target, mask, inbits
) -> Optional[dict]:
    """Pivot-structured whole-space sweep (sweeps.lut5_pivot_stream): no
    per-candidate gathers, no rank arithmetic, no int32 space limit."""
    g = st.num_gates
    tl, th = pivot_tile_shape(g)
    excl = [b for b in inbits if b >= 0]
    backend = ctx.opt.pivot_backend
    ops = PivotOperands(
        g, tl, th, excl, ctx.device_tables(st), target, mask, ctx.device,
        backend=backend, dispatch=ctx.dispatch,
    )
    t_real = ops.t_real
    if t_real == 0:
        return None
    lows, highs = ops.lows, ops.highs
    descs, size_cum = ops.descs, ops.size_cum
    args = ops.stream_args()
    splits, w_tab, m_tab = sweeps.lut5_split_tables()
    jw, jm = ctx.lut5_tabs()

    def combo_at(m: int, lo_abs: int, hi_abs: int) -> np.ndarray:
        return np.array(
            [lows[lo_abs, 0], lows[lo_abs, 1], m, highs[hi_abs, 0], highs[hi_abs, 1]],
            dtype=np.int32,
        )

    def redrive_tile(t_over: int) -> Optional[dict]:
        """Overflow fallback: one tile's full feasibility data, every
        feasible tuple solved (no in-kernel row cap).  Merged like the
        stream itself, so concurrent jobs' re-drives run as one launch of
        K1's lane form."""
        feas, r1, r0 = ctx.stream_dispatch(
            "lut5_pivot_tile", dict(tl=tl, th=th, backend=backend),
            (*args, t_over), g=g,
        )
        rows = np.nonzero(feas.cpu().numpy())[0]
        ctx.launch_timer.settle()
        if not rows.size:
            return None
        if ctx.opt.randomize:
            rows = rows[ctx.rng.permutation(len(rows))]
        d = descs[t_over]
        combos = np.stack([
            combo_at(int(d[0]), int(d[1]) + int(r) // th, int(d[3]) + int(r) % th)
            for r in rows
        ])
        return _solve_lut5_rows(
            ctx, st, combos, sweeps.to_u32(r1)[rows], sweeps.to_u32(r0)[rows],
            splits, w_tab, m_tab,
        )

    def decode(v) -> dict:
        """The hit of a verdict's (m, lo_abs, hi_abs, sigma, func_outer,
        req1, req0)."""
        return _decode_lut5(
            ctx, combo_at(int(v[0]), int(v[1]), int(v[2])), int(v[3]),
            int(v[4]), _unpack32(int(v[5]) & 0xFFFFFFFF),
            _unpack32(int(v[6]) & 0xFFFFFFFF), splits, w_tab, m_tab,
        )

    if ctx.mesh_plan is not None:
        from ..parallel.mesh import sharded_pivot_stream

        # Lockstep rounds of one tile per shard; the shards' verdict rows
        # resolved in tile order (a solver overflow re-driven in full).
        start_t = 0
        while start_t < t_real:
            seed = ctx.next_seed()
            verdicts = ctx.guarded_dispatch(
                lambda s=start_t: ctx.dispatch(
                    "lut5_pivot_stream", lambda: sharded_pivot_stream(
                        ctx.mesh_plan, *args, s, t_real, jw, jm, seed,
                        tl=tl, th=th, backend=backend,
                    ), g=g),
                "lut5.pivot.sharded",
            )
            next_t = int(verdicts[0, 9])
            ctx.stats.inc(
                "lut5_candidates",
                int(size_cum[min(next_t, t_real)] - size_cum[start_t]),
            )
            hits = verdicts[verdicts[:, 0] != 0]
            for hv in hits[np.argsort(hits[:, 1], kind="stable")]:
                if int(hv[0]) == 1:
                    return decode(hv[2:9])
                res = redrive_tile(int(hv[1]))
                if res is not None:
                    return res
            start_t = next_t
        return None

    # Spectral best-first tile order: each tile keys on its pivot gate, so
    # one gate-score pass tiers all tiles (no rank arithmetic, no bound on
    # the space).  One stream (and one seed) per segment window.
    segments = None
    if (ctx.opt.candidate_order == "spectral" and t_real > 1
            and ctx.mesh_plan is None):
        segments = _order_tile_segments(
            ctx, args[0], target, mask, descs, t_real, "lut5.pivot", g
        )
    ordered = segments is not None
    if not ordered:
        segments = [(0, t_real, 0)]
    for seg_lo, seg_hi, tier in segments:
        start_t = seg_lo
        while start_t < seg_hi:
            # One guarded call (one dispatch.sweep hit) per stream, however
            # many windows it launches: the JAX package's one resolve.
            seed = ctx.next_seed()
            v = ctx.guarded_dispatch(
                lambda s=start_t, hi=seg_hi: ctx.stream_dispatch(
                    "lut5_pivot_stream",
                    dict(tl=tl, th=th, backend=backend),
                    (*args, s, hi, jw, jm, seed), g=g,
                ),
                "lut5.pivot",
            )
            if ordered:
                ctx.stats.inc("order_tier_dispatches")
            status, next_t = int(v[0]), int(v[8])
            ctx.stats.inc(
                "lut5_candidates",
                int(size_cum[min(next_t, t_real)] - size_cum[start_t]),
            )
            if status == 0:
                break  # segment exhausted; on to the next tier segment
            if status == 1:
                if ordered:
                    ctx.stats.inc("order_first_hit_tier", tier)
                return decode(v[1:8])
            # status 2: more feasible tuples in tile next_t - 1 than the
            # in-stream solver rows — solve that tile's tuples in full.
            res = redrive_tile(next_t - 1)
            if res is not None:
                if ordered:
                    ctx.stats.inc("order_first_hit_tier", tier)
                return res
            start_t = next_t
    return None


def lut5_search(ctx: SearchContext, st: State, target, mask, inbits) -> Optional[dict]:
    """5-LUT search: LUT(LUT(a,b,c), d, e) realizing the target
    (reference: search_5lut, lut.c:116-249).  Returns {func_outer,
    func_inner, gates: (a,b,c,d,e)} or None.  Large spaces take the
    pivot-structured sweep.

    A device sweep whose retries all breach the deadline trips the circuit
    breaker and degrades to :func:`_lut5_search_host`, which sweeps the same
    space in rank order; with the breaker tripped, the search goes there
    directly."""
    g = st.num_gates
    if g < 5:
        return None
    if ctx.device_degraded or (
        comb.n_choose_k(g, 5) < PIVOT_MIN_TOTAL
        and not sweeps.device_rank_limit(g, 5)
    ):
        return _lut5_search_host(ctx, st, target, mask, inbits)
    try:
        if comb.n_choose_k(g, 5) >= PIVOT_MIN_TOTAL:
            return _lut5_search_pivot(ctx, st, target, mask, inbits)
        if ctx.mesh_plan is not None:
            return _lut5_mesh_stream(ctx, st, target, mask, inbits)
        return _lut5_stream_loop(ctx, st, target, mask, inbits, 0)
    except DispatchTimeout as e:
        logger.warning(
            "%s; degrading the 5-LUT sweep to the host-fallback driver", e
        )
        ctx.trip_device_breaker()
        return _lut5_search_host(ctx, st, target, mask, inbits)


def _lut5_stream_loop(ctx, st, target, mask, inbits, start) -> Optional[dict]:
    """Fused 5-LUT sweep from rank ``start``: filter + compaction +
    decomposition solve, one verdict per stream.  Also the resume path
    after a fused-head solver overflow.

    Under ``candidate_order="spectral"`` a fresh sweep (``start == 0``)
    walks the score-tier segments of :func:`_order_segments` best-first,
    one stream per segment window; an overflow resume (``start > 0``)
    stays lexicographic, as in the JAX package."""
    g = st.num_gates
    args, total, chunk = ctx.stream_args(st, target, mask, inbits, 5)
    splits, w_tab, m_tab = sweeps.lut5_split_tables()
    jw, jm = ctx.lut5_tabs()
    segments = None
    if start == 0:
        segments = _order_segments(ctx, 5, (args, total, chunk), "lut5.stream")
    ordered = segments is not None
    if not ordered:
        segments = [(start, total, 0)]
    for seg_lo, seg_hi, tier in segments:
        start = seg_lo
        while start < seg_hi:
            seed = ctx.next_seed()
            v = ctx.guarded_dispatch(
                lambda s=start, hi=seg_hi: ctx.stream_dispatch(
                    "lut5_stream", dict(chunk=chunk),
                    (*args, s, hi, jw, jm, seed), g=g,
                ),
                "lut5.stream",
            )
            if ordered:
                ctx.stats.inc("order_tier_dispatches")
            status, cstart = int(v[0]), int(v[6])
            ctx.stats.inc("lut5_candidates", int(v[7]))
            if status == 0:
                break  # segment exhausted; on to the next tier segment
            if status == 1:
                if ordered:
                    ctx.stats.inc("order_first_hit_tier", tier)
                return _decode_lut5(
                    ctx, comb.unrank_combination(int(v[1]), g, 5), int(v[2]),
                    int(v[3]), _unpack32(int(v[4]) & 0xFFFFFFFF),
                    _unpack32(int(v[5]) & 0xFFFFFFFF), splits, w_tab, m_tab,
                )
            # status 2: the chunk at cstart had more feasible tuples than
            # the in-stream solver examined — re-drive just that chunk in
            # full, then resume after it (within the segment).
            res = _lut5_chunk_two_phase(
                ctx, st, target, mask, inbits, cstart, prebuilt=(args, total, chunk)
            )
            if res is not None:
                if ordered:
                    ctx.stats.inc("order_first_hit_tier", tier)
                return res
            start = cstart + chunk
    return None


def _lut5_mesh_stream(ctx, st, target, mask, inbits) -> Optional[dict]:
    """The mesh's small-space 5-LUT search: the sharded feasibility stream
    to each chunk holding feasible tuples, solved on the host, resumed
    after a chunk that does not solve."""
    total = comb.n_choose_k(st.num_gates, 5)
    prebuilt = ctx.stream_args(st, target, mask, inbits, 5)
    start = 0
    while start < total:
        found, cstart, feas, r1, r0, examined, chunk = ctx.feasible_stream_driver(
            st, target, mask, inbits, k=5, start=start, prebuilt=prebuilt
        )
        ctx.stats.inc("lut5_candidates", examined)
        if not found:
            return None
        res = _lut5_solve_feasible_chunk(ctx, st, cstart, feas, r1, r0)
        if res is not None:
            return res
        start = cstart + chunk
    return None


def _lut5_solve_feasible_chunk(ctx, st, cstart, feas, r1, r0) -> Optional[dict]:
    """Host side of one feasible chunk: unrank the flagged rows and solve."""
    g = st.num_gates
    splits, w_tab, m_tab = sweeps.lut5_split_tables()
    rows = np.nonzero(feas.cpu().numpy())[0]
    if ctx.opt.randomize:
        rows = rows[ctx.rng.permutation(len(rows))]
    combos = np.stack(
        [comb.unrank_combination(cstart + int(r), g, 5) for r in rows]
    )
    return _solve_lut5_rows(
        ctx, st, combos, sweeps.to_u32(r1)[rows], sweeps.to_u32(r0)[rows],
        splits, w_tab, m_tab,
    )


def _lut5_chunk_two_phase(
    ctx, st, target, mask, inbits, cstart, prebuilt=None
) -> Optional[dict]:
    """Overflow fallback: one chunk's full feasibility data, every
    feasible tuple solved (no in-stream row cap)."""
    found, fstart, feas, r1, r0, _, _ = ctx.feasible_stream_driver(
        st, target, mask, inbits, k=5, start=cstart, prebuilt=prebuilt
    )
    if not found or fstart != cstart:
        return None
    return _lut5_solve_feasible_chunk(ctx, st, cstart, feas, r1, r0)


def lut5_resume_overflow(
    ctx: SearchContext, st: State, target, mask, inbits, cstart: int
) -> Optional[dict]:
    """Resume a 5-LUT search after a fused-head solver overflow at chunk
    rank ``cstart``: re-drive that chunk, then resume the fused stream
    after it.  Degrades like :func:`lut5_search`, to the host chunk stream
    over the whole space (its prefix holds no hit, so the first hit is the
    same)."""
    if ctx.device_degraded:
        return _lut5_search_host(ctx, st, target, mask, inbits)
    try:
        with ctx.prof.phase("lut5"):
            res = _lut5_chunk_two_phase(ctx, st, target, mask, inbits, cstart)
            if res is None:
                chunk = pick_chunk(comb.n_choose_k(st.num_gates, 5),
                                   STREAM_CHUNK[5])
                res = _lut5_stream_loop(ctx, st, target, mask, inbits,
                                        cstart + chunk)
    except DispatchTimeout as e:
        logger.warning(
            "%s; degrading the overflow-resume 5-LUT sweep to the "
            "host-fallback driver", e,
        )
        ctx.trip_device_breaker()
        res = _lut5_search_host(ctx, st, target, mask, inbits)
    return res


def _device_enum_enabled() -> bool:
    """``SBG_DEVICE_ENUM=0`` sends the big-space streams to the host chunk
    stream even on a healthy device (the JAX package's lever)."""
    return os.environ.get("SBG_DEVICE_ENUM", "1") != "0"


def _feasible_chunks(ctx: SearchContext, st: State, target, mask, inbits, k: int,
                     chunk_cap: int, stat_key: str, phase: str):
    """Feasibility-chunk stream of the spaces beyond int32 rank arithmetic
    (and of every 5/7-LUT sweep once the breaker tripped): the device's
    64-bit stream (:func:`_wide_feasible_chunks`), or the host chunk stream
    (:func:`_host_feasible_chunks`) with the breaker tripped or
    ``SBG_DEVICE_ENUM=0``.  Both yield ``(combos_fn, feasible, req1, req0)``
    per feasible chunk in rank order.  The device stream charges ranks
    examined, the host stream the rows left after the exclusions.  A mesh
    takes the host stream too (its sharded streams own the chunk
    placement), as in the JAX package."""
    if (ctx.mesh_plan is None and not ctx.device_degraded
            and _device_enum_enabled()):
        return _wide_feasible_chunks(
            ctx, st, target, mask, inbits, k, chunk_cap, stat_key, phase
        )
    return _host_feasible_chunks(
        ctx, st, target, mask, inbits, k, chunk_cap, stat_key, phase
    )


def _wide_feasible_chunks(ctx: SearchContext, st: State, target, mask, inbits, k: int,
                          chunk_cap: int, stat_key: str, phase: str):
    """Feasibility stream for spaces beyond int32 rank arithmetic: one
    guarded :func:`sweeps.feasible_stream_wide` sweep from the resume point
    to the next feasible chunk, unranking on the device.  Yields
    ``(combos_fn, feasible, req1, req0)`` per feasible chunk in rank order;
    ``combos_fn(rows)`` decodes just the hit rows."""
    g = st.num_gates
    total = comb.n_choose_k(g, k)
    if total <= 0:
        return
    chunk = pick_chunk(total, chunk_cap)
    tables = ctx.device_tables(st)
    jt, jm = ctx.words(target), ctx.words(mask)
    jexcl = torch.from_numpy(ctx.excl_array(inbits)).to(ctx.device)
    start = 0
    while start < total:
        v, feas, r1, r0 = ctx.guarded_dispatch(
            lambda s=start: ctx.dispatch(
                "feasible_stream_wide", lambda: sweeps.feasible_stream_wide(
                    tables, ctx.binom_wide, g, jt, jm, jexcl, s, total, k=k,
                    chunk=chunk,
                ), g=g),
            f"{phase}.wide",
        )
        found = bool(v[0])
        cstart = int(np.uint32(v[1])) | (int(np.uint32(v[2])) << 32)
        if not found:
            ctx.stats.inc(stat_key, total - start)
            return
        ctx.stats.inc(stat_key, min(cstart + chunk, total) - start)

        def combos_fn(rows, cs=cstart):
            return comb.unrank_combinations(
                np.uint64(cs) + np.asarray(rows, np.uint64), g, k
            )

        yield combos_fn, feas.cpu().numpy(), r1, r0
        start = cstart + chunk


def _host_feasible_chunks(ctx: SearchContext, st: State, target, mask, inbits,
                          k: int, chunk_cap: int, stat_key: str, phase: str):
    """The host chunk stream: a :class:`comb.ChunkPrefetcher` makes the
    chunks on the host (the native runtime's generator, the exclusions,
    padding) up to ``ctx.pipeline_depth`` ahead, and as many stage-A filter
    launches stay in flight on the device (:func:`sweeps.lut_filter`: the
    K3 kernel for 5-tuples).  Each chunk's verdict is one any-feasible
    scalar, read under ``ctx.host_sync_deadline``: this is the degradation
    target, so a dead device fails loudly here and never re-enters the
    retry ladder.  Yields ``(combos_fn, feasible, req1, req0)`` for the
    feasible chunks in rank order; the candidates of each chunk consumed
    (rows after the exclusions) are charged to ``stat_key``, so a driver
    that stops early counts what the serial loop would."""
    g = st.num_gates
    tables = ctx.device_tables(st)
    jt, jm = ctx.words(target), ctx.words(mask)
    excl = [b for b in inbits if b >= 0]
    stream = comb.CombinationStream(g, k)
    csize = pick_chunk(stream.total, chunk_cap)
    depth = ctx.pipeline_depth
    rows = torch.arange(csize, device=ctx.device)
    pin = ctx.device.type == "cuda"
    ckey = threading.get_ident()
    name = "lut5_filter" if k == 5 else "lut_filter"
    with ctx.host_prefetcher(stream, csize, excl, phase) as pf:
        inflight: deque = deque()
        exhausted = False
        while True:
            while not exhausted and len(inflight) < depth:
                item = pf.get()
                if item is None:
                    exhausted = True
                    break
                padded, nvalid = item
                host = torch.from_numpy(padded)
                if pin:
                    host = host.pin_memory()
                combos = host.to(ctx.device, non_blocking=True)
                feas, req1, req0 = ctx.dispatch(name, lambda c=combos, n=nvalid: (
                    sweeps.lut_filter(tables, c, rows < n, jt, jm)), g=g)
                inflight.append((padded, nvalid, feas.any(), feas, req1, req0))
            if not inflight:
                return
            padded, nvalid, hit, feas, req1, req0 = inflight.popleft()
            ctx.stats.inc(stat_key, nvalid)
            t0 = time.perf_counter()
            found = ctx.host_sync_deadline(lambda h=hit: bool(h), phase)
            t1 = time.perf_counter()
            # After the verdict's sync: the chunk's filter launch is done.
            ctx.prof.add_wait(phase, t0, t1, consumer=ckey)
            ctx.stats.observe("device_wait_s", t1 - t0)
            ctx.stats.observe(f"device_wait_s[{phase}]", t1 - t0)
            ctx.launch_timer.settle()
            if not found:
                continue
            yield (lambda r, p=padded: p[r]), feas.cpu().numpy(), req1, req0


def _lut5_search_host(ctx: SearchContext, st: State, target, mask, inbits) -> Optional[dict]:
    """Big-space 5-LUT driver: the device's 64-bit stream, or the host
    chunk stream (:func:`_feasible_chunks` routes).  Chunks resolve in rank
    order, so the first hit is the same on either route and at every
    pipeline depth.  A deadline breach on the device route trips the
    breaker and reruns the search through the host chunk stream."""
    splits, w_tab, m_tab = sweeps.lut5_split_tables()
    cand_before = ctx.stats["lut5_candidates"]
    try:
        chunks = _feasible_chunks(
            ctx, st, target, mask, inbits, 5, LUT5_CHUNK, "lut5_candidates",
            "lut5.host_stream",
        )
        with closing(chunks):
            for combos_fn, feas, req1p, req0p in chunks:
                fidx = np.nonzero(feas)[0]
                res = _solve_lut5_rows(
                    ctx, st, combos_fn(fidx), sweeps.to_u32(req1p)[fidx],
                    sweeps.to_u32(req0p)[fidx], splits, w_tab, m_tab,
                )
                if res is not None:
                    return res
        return None
    except DispatchTimeout as e:
        if ctx.device_degraded:
            raise  # already on the host stream: fail loudly
        logger.warning(
            "%s; degrading the big-space 5-LUT enumeration to the host "
            "chunk stream", e,
        )
        ctx.stats.put("lut5_candidates", cand_before)
        ctx.trip_device_breaker()
        return _lut5_search_host(ctx, st, target, mask, inbits)


# -------------------------------------------------------------------------
# Spectral best-first candidate ordering (candidate_order="spectral")
#
# ops/spectral.py scores every gate table against the masked target; the
# drivers bucket rank chunks (or pivot tiles) into score tiers and sweep the
# same streams through the tiers best-first via their (start, stop)
# operands.  Ordering only: the segments partition the space
# (comb.tier_segments asserts it), and the scores are a pure integer
# function of (tables, target, mask), so the order — hence the dispatch
# count and the seed draws — is deterministic per configuration.
# -------------------------------------------------------------------------

#: Score tiers of the best-first rank remap.
ORDER_TIERS = 4


def _use_spectral(ctx: SearchContext, total: int, chunk: int) -> bool:
    """Route guard for the ordered rank streams: opted in, more than one
    chunk to order, within the scoring budget, and off a mesh (its
    sharded streams keep lexicographic order)."""
    return (
        ctx.opt.candidate_order == "spectral"
        and ctx.mesh_plan is None
        and chunk < total <= spectral.SPECTRAL_SCORE_MAX
    )


def _order_segments(ctx, k, prebuilt, phase):
    """Best-first rank segments ``[(lo_rank, hi_rank, tier), ...]`` of a
    chunked stream, partitioning [0, total) in chunk-aligned ranges, or
    None when the stream keeps lexicographic order.  One guarded
    ``spectral_score_stream`` pass (the ``order.score`` fault site) scores
    every rank chunk."""
    args, total, chunk = prebuilt
    if not _use_spectral(ctx, total, chunk):
        return None
    n_chunks = -(-total // chunk)
    n_pad = 8
    while n_pad < n_chunks:
        n_pad *= 2

    t0 = time.perf_counter()

    def attempt():
        fault_point("order.score")
        return ctx.dispatch("spectral_score_stream", lambda: sweeps.spectral_score_stream(
            *args, total, k=k, chunk=chunk, n_chunks=n_pad
        ).cpu().numpy(), g=args[2])

    scores = ctx.guarded_dispatch(attempt, f"{phase}.order")
    segs = [
        (lo * chunk, min(hi * chunk, total), tier)
        for lo, hi, tier in comb.tier_segments(scores, n_chunks, ORDER_TIERS)
    ]
    ctx.stats.observe("order_score_s", time.perf_counter() - t0)
    return segs


def _order_tile_segments(ctx, dev_tables, target, mask, descs, t_real, phase, g):
    """Pivot-path best-first ordering: every tile keys on its pivot gate
    ``descs[:, 0]``, so one guarded gate-score pass (kernel K5 on the card,
    the ``order.score`` fault site) tiers the tiles.  Returns
    ``[(lo_tile, hi_tile, tier), ...]`` partitioning [0, t_real)."""

    t0 = time.perf_counter()

    def attempt():
        fault_point("order.score")
        return ctx.dispatch("spectral_gate_scores", lambda: sweeps.spectral_gate_scores(
            dev_tables, ctx.words(target), ctx.words(mask)
        ).cpu().numpy(), g=g)

    gscores = ctx.guarded_dispatch(attempt, f"{phase}.order")
    tile_scores = gscores[descs[:t_real, 0]]
    segs = comb.tier_segments(tile_scores, t_real, ORDER_TIERS)
    ctx.stats.observe("order_score_s", time.perf_counter() - t0)
    return segs


# -------------------------------------------------------------------------
# 7-LUT
# -------------------------------------------------------------------------


def _lut7_collect_hits(ctx: SearchContext, st: State, target, mask, inbits):
    """Stage A: stream the C(G,7) space through the feasibility filter,
    collecting up to LUT7_CAP feasible tuples in rank order (reference:
    lut.c:290-327).  Returns (combos, req1 [n, 4], req0 [n, 4]) uint32.

    A device stream that exhausts its deadline retries trips the breaker,
    and collection restarts from rank 0 on the host chunk stream (a device
    prefix plus a host tail could reorder hits), its candidate count
    backed out."""
    g = st.num_gates
    use_device_stream = (
        sweeps.device_rank_limit(g, 7) and not ctx.device_degraded
    )
    phase = "lut7.stageA"
    hits = ([], [], [], 0)
    if use_device_stream:
        cand_before = ctx.stats["lut7_candidates"]
        try:
            hits = _lut7_device_stage_a(ctx, st, target, mask, inbits, phase)
        except DispatchTimeout as e:
            logger.warning(
                "%s; degrading 7-LUT stage A to the host-chunked driver", e
            )
            ctx.stats.put("lut7_candidates", cand_before)
            ctx.trip_device_breaker()
            use_device_stream = False
    if not use_device_stream:
        cand_before = ctx.stats["lut7_candidates"]
        try:
            hits = _lut7_stage_a_chunks(ctx, st, target, mask, inbits, phase)
        except DispatchTimeout as e:
            if ctx.device_degraded:
                raise
            logger.warning(
                "%s; degrading 7-LUT stage A to the host chunk stream", e
            )
            ctx.stats.put("lut7_candidates", cand_before)
            ctx.trip_device_breaker()
            hits = _lut7_stage_a_chunks(ctx, st, target, mask, inbits, phase)
    hit_combos, hit_req1, hit_req0, nhits = hits
    if nhits == 0:
        empty = np.zeros((0, 4), np.uint32)
        return np.zeros((0, 7), np.int32), empty, empty
    combos = np.concatenate(hit_combos)[:LUT7_CAP]
    req1 = np.concatenate(hit_req1)[:LUT7_CAP]
    req0 = np.concatenate(hit_req0)[:LUT7_CAP]
    if ctx.opt.randomize:
        perm = ctx.rng.permutation(len(combos))
        combos, req1, req0 = combos[perm], req1[perm], req0[perm]
    return combos, req1, req0


def _lut7_device_stage_a(ctx: SearchContext, st: State, target, mask, inbits,
                         phase: str):
    """The int32-rank device half of stage A: one guarded feasible stream
    per window, to LUT7_CAP hits.  Under candidate_order="spectral" the
    windows walk the score-tier segments best-first; run to exhaustion
    they collect the lex hit set, and a binding LUT7_CAP keeps the
    best-scored hits.  Raises DispatchTimeout past the deadline."""
    g = st.num_gates
    hit_combos: List[np.ndarray] = []
    hit_req1: List[np.ndarray] = []
    hit_req0: List[np.ndarray] = []
    nhits = 0
    total = comb.n_choose_k(g, 7)
    prebuilt = ctx.stream_args(st, target, mask, inbits, 7)
    segments = _order_segments(ctx, 7, prebuilt, phase)
    ordered = segments is not None
    if not ordered:
        segments = [(0, total, 0)]
    for seg_lo, seg_hi, tier in segments:
        start = seg_lo
        while start < seg_hi and nhits < LUT7_CAP:
            found, cstart, feas, r1, r0, examined, chunk = ctx.feasible_stream_driver(
                st, target, mask, inbits, k=7, start=start, prebuilt=prebuilt,
                stop=seg_hi,
            )
            ctx.stats.inc("lut7_candidates", examined)
            if ordered:
                ctx.stats.inc("order_tier_dispatches")
            if not found:
                break  # segment exhausted; on to the next tier segment
            if ordered and nhits == 0:
                ctx.stats.inc("order_first_hit_tier", tier)
            rows = np.nonzero(feas.cpu().numpy())[0]
            hit_combos.append(np.stack(
                [comb.unrank_combination(cstart + int(r), g, 7) for r in rows]
            ))
            hit_req1.append(sweeps.to_u32(r1)[rows])
            hit_req0.append(sweeps.to_u32(r0)[rows])
            nhits += len(rows)
            start = cstart + chunk
    return hit_combos, hit_req1, hit_req0, nhits


def _lut7_stage_a_chunks(ctx: SearchContext, st: State, target, mask, inbits,
                         phase: str):
    """The big-space half of stage A: feasible tuples through
    :func:`_feasible_chunks`, to LUT7_CAP hits (chunks past the crossing
    are neither consumed nor counted)."""
    hit_combos: List[np.ndarray] = []
    hit_req1: List[np.ndarray] = []
    hit_req0: List[np.ndarray] = []
    nhits = 0
    chunks = _feasible_chunks(
        ctx, st, target, mask, inbits, 7, LUT7_CHUNK, "lut7_candidates", phase
    )
    with closing(chunks):
        for combos_fn, feas, req1p, req0p in chunks:
            fidx = np.nonzero(feas)[0]
            hit_combos.append(combos_fn(fidx))
            hit_req1.append(sweeps.to_u32(req1p)[fidx])
            hit_req0.append(sweeps.to_u32(req0p)[fidx])
            nhits += len(fidx)
            if nhits >= LUT7_CAP:
                break
    return hit_combos, hit_req1, hit_req0, nhits


def lut7_search(ctx: SearchContext, st: State, target, mask, inbits) -> Optional[dict]:
    """7-LUT search: LUT(LUT(a,b,c), LUT(d,e,f), g) (reference: search_7lut,
    lut.c:256-487): (A) collect up to LUT7_CAP feasible 7-tuples, (B) sweep
    (ordering x outer x middle) function space over them."""
    if st.num_gates < 7:
        return None
    with ctx.prof.phase("lut7.stageA"):
        combos, req1, req0 = _lut7_collect_hits(ctx, st, target, mask, inbits)
    if len(combos) == 0:
        return None
    with ctx.prof.phase("lut7.stageB"):
        return _lut7_solve_hits(ctx, combos, req1, req0)


def _lut7_solve_hits(ctx: SearchContext, combos, req1, req0) -> Optional[dict]:
    """Stage B over the collected hit list (reference: lut.c:416-475), in
    blocks padded to the smallest LUT7_SOLVE_SIZES step."""
    jidx, jpp = ctx.lut7_tabs()
    for lo in range(0, len(combos), LUT7_SOLVE_CHUNK):
        hi = min(lo + LUT7_SOLVE_CHUNK, len(combos))
        size = next(s for s in LUT7_SOLVE_SIZES if s >= hi - lo)
        r1, _ = comb.pad_rows(req1[lo:hi], size, fill=0xFFFFFFFF)
        r0, _ = comb.pad_rows(req0[lo:hi], size, fill=0xFFFFFFFF)
        ctx.stats.inc("lut7_solved", hi - lo)
        seed = ctx.next_seed()
        v = ctx.host_sync_deadline(
            lambda a=r1, b=r0: ctx.stream_dispatch(
                "lut7_solve", {}, (ctx.words(a), ctx.words(b), jidx, jpp, seed),
            ),
            "lut7.solve",
        )
        if not v[0]:
            continue
        t = lo + int(v[1])
        func_outer, func_middle = divmod(int(v[3]), 256)
        return _decode_lut7(
            ctx, combos[t], int(v[2]), func_outer, func_middle, req1[t], req0[t]
        )
    return None


def _decode_lut7(
    ctx: SearchContext, combo, sigma: int, func_outer: int, func_middle: int,
    req1w: np.ndarray, req0w: np.ndarray,
) -> dict:
    """Reconstructs the inner LUT function for a device-selected 7-LUT
    decomposition: group the 128 cells by (outer out, middle out, x_g)."""
    orders, wo_tab, wm_tab, g_tab = sweeps.lut7_split_tables()
    order = orders[sigma]
    a, b, c, d, e, f = (int(combo[p]) for p in order[:6])
    gg = int(combo[order[6]])
    groups = (
        _unpack128(wo_tab[sigma, func_outer]).astype(np.int64) * 4
        + _unpack128(wm_tab[sigma, func_middle]).astype(np.int64) * 2
        + _unpack128(g_tab[sigma]).astype(np.int64)
    )
    func_inner = sweeps.solve_inner_function(
        _unpack128(req1w), _unpack128(req0w), groups,
        ctx.rng if ctx.opt.randomize else None,
    )
    assert func_inner is not None, "device reported spurious 7-LUT hit"
    return {
        "func_outer": func_outer,
        "func_middle": func_middle,
        "func_inner": func_inner,
        "gates": (a, b, c, d, e, f, gg),
    }


# -------------------------------------------------------------------------
# Combined driver
# -------------------------------------------------------------------------


def _add_lut5_result(ctx: SearchContext, st: State, res: dict, target, mask) -> int:
    """Materializes a 5-LUT decomposition as two LUT gates (reference:
    lut.c:553-580)."""
    a, b, c, d, e = res["gates"]
    outer = st.add_lut(res["func_outer"], a, b, c)
    gid = st.add_lut(res["func_inner"], outer, d, e)
    st.verify_gate(gid, target, mask)
    if ctx.opt.verbosity >= 1:
        # The reference's rank-tagged find line (lut.c:219); one process.
        print(
            "[% 4d] Found 5LUT: %02x %02x    %3d %3d %3d %3d %3d"
            % (0, res["func_outer"], res["func_inner"], a, b, c, d, e)
        )
    return gid


def _add_lut7_result(ctx: SearchContext, st: State, res: dict, target, mask) -> int:
    """Materializes a 7-LUT decomposition as three LUT gates (reference:
    lut.c:593-624)."""
    a, b, c, d, e, f, gg = res["gates"]
    outer = st.add_lut(res["func_outer"], a, b, c)
    middle = st.add_lut(res["func_middle"], d, e, f)
    gid = st.add_lut(res["func_inner"], outer, middle, gg)
    st.verify_gate(gid, target, mask)
    if ctx.opt.verbosity >= 1:
        print(
            "[% 4d] Found 7LUT: %02x %02x %02x %3d %3d %3d %3d %3d %3d %3d"
            % (
                0, res["func_outer"], res["func_middle"], res["func_inner"],
                a, b, c, d, e, f, gg,
            )
        )
    return gid


def _lut7_phase(ctx: SearchContext, st: State, target, mask, inbits) -> int:
    """Budget-gated 7-LUT phase: three new gates on success (reference:
    lut.c:582-625)."""
    if not check_num_gates_possible(st, 3, 0, ctx.opt.metric):
        return NO_GATE
    with ctx.prof.phase("lut7"):
        res = lut7_search(ctx, st, target, mask, inbits)
    if res is None:
        return NO_GATE
    return _add_lut7_result(ctx, st, res, target, mask)


def lut_search(ctx: SearchContext, st: State, target, mask, inbits) -> int:
    """Full LUT search: 3-LUT, then 5-LUT (2 new gates), then 7-LUT (3 new
    gates), with budget gating between phases (reference: lut_search,
    lut.c:489-631)."""
    with ctx.prof.phase("lut3"):
        gid = lut3_search(ctx, st, target, mask, inbits)
    if gid != NO_GATE:
        return gid
    if not check_num_gates_possible(st, 2, 0, ctx.opt.metric):
        return NO_GATE
    with ctx.prof.phase("lut5"):
        res = lut5_search(ctx, st, target, mask, inbits)
    if res is not None:
        return _add_lut5_result(ctx, st, res, target, mask)
    return _lut7_phase(ctx, st, target, mask, inbits)


def lut_search_from_head(
    ctx: SearchContext, st: State, target, mask, inbits, head: np.ndarray
) -> int:
    """LUT-search continuation of a fused head (ctx.lut_step): decode its
    3/5-LUT verdict, handle the 5-LUT overflow / pivot-sized cases, then the
    7-LUT phase.  ``head`` is the int32[8] verdict with step >= 4 or 0."""
    g = st.num_gates
    step = int(head[0])

    if step == 4:
        return _add_lut3_result(
            ctx, st, int(head[1]), int(head[2]) & 0xFF, int(head[3]) & 0xFF,
            target, mask,
        )

    if not check_num_gates_possible(st, 2, 0, ctx.opt.metric):
        return NO_GATE

    res = None
    splits, w_tab, m_tab = sweeps.lut5_split_tables()
    if step == 5:
        res = _decode_lut5(
            ctx, comb.unrank_combination(int(head[1]), g, 5), int(head[2]),
            int(head[3]), _unpack32(int(head[4]) & 0xFFFFFFFF),
            _unpack32(int(head[5]) & 0xFFFFFFFF), splits, w_tab, m_tab,
        )
    elif step == 6:
        res = lut5_resume_overflow(ctx, st, target, mask, inbits, int(head[1]))
    elif not lut_head_has5(g):
        # The head skipped 5-LUT (pivot-sized space or g < 5).
        with ctx.prof.phase("lut5"):
            res = lut5_search(ctx, st, target, mask, inbits)

    if res is not None:
        return _add_lut5_result(ctx, st, res, target, mask)

    if not lut_head_has7(g):
        return _lut7_phase(ctx, st, target, mask, inbits)

    # Single-chunk 7-LUT space: stage A + stage B for one seed.
    if not check_num_gates_possible(st, 3, 0, ctx.opt.metric):
        return NO_GATE
    v = ctx.lut7_step(st, target, mask, inbits)
    status = int(v[0])
    if status == 1:
        combo = comb.unrank_combination(int(v[1]), g, 7)
        fo, fm = divmod(int(v[3]), 256)
        r7_1 = np.asarray(v[6:10]).astype(np.int32).view(np.uint32)
        r7_0 = np.asarray(v[10:14]).astype(np.int32).view(np.uint32)
        res7 = _decode_lut7(ctx, combo, int(v[2]), fo, fm, r7_1, r7_0)
        return _add_lut7_result(ctx, st, res7, target, mask)
    if status == 2:
        # Solver overflow: the staged path re-counts the same space and
        # re-solves these tuples; back out both tallies.
        ctx.stats.inc("lut7_candidates", -int(v[4]))
        ctx.stats.inc("lut7_solved", -int(v[5]))
        return _lut7_phase(ctx, st, target, mask, inbits)
    return NO_GATE
