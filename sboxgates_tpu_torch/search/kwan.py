"""Kwan's recursive circuit construction.

Host-side mirror of the reference's ``create_circuit`` (sboxgates.c:282-616):
branchy control flow stays in Python while every candidate scan runs as a
device sweep or, for states the placement policy sends to the host, on the
native runtime.  States are value-copied around the step-5 multiplexer
recursion exactly as in the reference — the copy semantics are load-bearing
for backtracking.  The mux branches are folded in bit order; with a
rendezvous attached (``Options.parallel_mux``, on for a device other than
the CPU) they run as concurrent threads whose sweeps merge
(:func:`.batched.run_mux_jobs`), each with its own seed, as in the JAX
package.

With ``Options.native`` the whole recursion from a node runs in the
native engine (csrc ``sbg_gate_engine`` / ``sbg_lut_engine``); Python only
replays the adopted gate additions and re-verifies them.  The LUT engine
hands the nodes that need device work (pivot-sized 5-LUT space, head-solver
overflow, staged 7-LUT) to :func:`_lut_engine_service`, which runs the same
search drivers on the device, and resumes in place.  When the service fails
the engine bails, the counters its requests added are dropped, and the node
runs on the Python engine on the same device, as in the JAX package.
"""

from __future__ import annotations

from typing import List

import numpy as np

from ..core import boolfunc as bf
from ..graph.state import (
    GATES,
    NO_GATE,
    State,
    check_num_gates_possible,
    get_sat_metric,
)
from ..resilience.faults import fault_point
from .context import SearchContext
from .lut import lut_search_from_head


def create_circuit(
    ctx: SearchContext, st: State, target, mask, inbits: List[int]
) -> int:
    """Returns the id of a gate realizing ``target`` under ``mask``, adding
    gates to ``st`` as needed; NO_GATE on failure.  Step numbers reference
    Kwan's paper, as in the reference implementation."""
    # Fault site: one hit per search node entered.
    fault_point("search.node")
    # Re-entrant phase: its self time is the host control flow, without
    # the nested sweeps' phases.
    with ctx.prof.phase("kwan_host"):
        return _create_circuit(ctx, st, target, mask, inbits)


def _create_circuit(
    ctx: SearchContext, st: State, target, mask, inbits: List[int]
) -> int:
    opt = ctx.opt
    metric = opt.metric

    if ctx.uses_native_engine(st):
        if not opt.lut_graph:
            return _native_engine_search(ctx, st, target, mask, inbits)
        ret = _native_lut_engine_search(ctx, st, target, mask, inbits)
        if ret is not None:
            return ret
        # The engine's device-work service failed: the Python engine runs
        # this node (its own sweeps on the same device).
    ctx.stats.inc("python_nodes")

    # Steps 1-4 for one seed; budget gates are applied host-side in the
    # reference's order (sboxgates.c:301-435).  The LUT head also runs the
    # whole 3-LUT and small-space 5-LUT sweeps.
    head = None
    if opt.lut_graph:
        head = ctx.lut_step(st, target, mask, inbits)
        step, x0, x1 = int(head[0]), int(head[1]), int(head[2])
        if step >= 4:
            step = 0  # LUT payloads are consumed after the step 1-3 gates
    else:
        step, x0, x1 = ctx.gate_step(st, target, mask)

    # Steps 1-2: an existing gate, or the complement of one.
    if step == 1:
        st.verify_gate(x0, target, mask)
        return x0
    if not check_num_gates_possible(st, 1, get_sat_metric(bf.NOT), metric):
        return NO_GATE
    if step == 2:
        ret = st.add_not_gate(x0, metric)
        st.verify_gate(ret, target, mask)
        return ret

    # Step 3: one available gate over all pairs.
    if not check_num_gates_possible(st, 1, get_sat_metric(bf.AND), metric):
        return NO_GATE
    if step == 3:
        g1, g2, entry = ctx.decode_pair_hit(st, x0, x1, use_not=False)
        ret = st.add_boolfunc_2(entry.fun, g1, g2, metric)
        st.verify_gate(ret, target, mask)
        return ret

    if opt.lut_graph:
        ret = lut_search_from_head(ctx, st, target, mask, inbits, head)
        if ret != NO_GATE:
            st.verify_gate(ret, target, mask)
            return ret
    else:
        # Step 4a: pairs with NOT-augmented functions.
        if not check_num_gates_possible(
            st, 2, get_sat_metric(bf.AND) + get_sat_metric(bf.NOT), metric
        ):
            return NO_GATE
        if step == 4:
            g1, g2, entry = ctx.decode_pair_hit(st, x0, x1, use_not=True)
            ret = st.add_boolfunc_2(entry.fun, g1, g2, metric)
            st.verify_gate(ret, target, mask)
            return ret

        # Step 4b: gate triples x 3-input functions.
        if not check_num_gates_possible(
            st, 3, 2 * get_sat_metric(bf.AND) + get_sat_metric(bf.NOT), metric
        ):
            return NO_GATE
        if step == 5:
            gids, entry = ctx.decode_triple_hit(st, x0, x1)
            ret = st.add_boolfunc_3(entry.fun, gids[0], gids[1], gids[2], metric)
            st.verify_gate(ret, target, mask)
            return ret

    # Step 5: multiplex over an unused input bit and recurse on the two
    # Karnaugh-map halves (sboxgates.c:438-607).  Only the first six used
    # bits are tracked (the reference truncates identically,
    # sboxgates.c:443-449).  The branches are independent state copies; with
    # a rendezvous attached they run as concurrent threads (the fold below
    # stays in bit order).
    tracked = inbits[:6]
    bit_order = [b for b in range(st.num_inputs) if b not in tracked]
    if not bit_order:
        return NO_GATE
    if opt.randomize:
        ctx.rng.shuffle(bit_order)

    if (
        ctx.rdv is not None
        # A context view that must keep the standalone draw order (the JAX
        # package's merged serve-wave views) sets allow_mux_threads=False.
        and getattr(ctx, "allow_mux_threads", True)
        and len(bit_order) > 1
        and not ctx.node_host_only(st)
    ):
        from .batched import run_mux_jobs

        def job(bit):
            return lambda cctx: _mux_try_bit(
                cctx, st, target, mask, bit, tracked
            )

        outcomes = run_mux_jobs(ctx, [job(b) for b in bit_order])
    else:
        outcomes = [
            _mux_try_bit(ctx, st, target, mask, b, tracked) for b in bit_order
        ]

    best: State = None
    best_out = NO_GATE
    for outcome in outcomes:
        if outcome is None:
            continue
        nst, nst_out = outcome
        if metric == GATES:
            better = best is None or nst.num_gates < best.num_gates
        else:
            better = best is None or nst.sat_metric < best.sat_metric
        if better:
            best = nst
            best_out = nst_out

    if best is None:
        return NO_GATE
    best.verify_gate(best_out, target, mask)
    # Adopt the best sub-state in place (the reference's *st = best).
    st.max_sat_metric = best.max_sat_metric
    st.sat_metric = best.sat_metric
    st.max_gates = best.max_gates
    st.gates = best.gates
    st.outputs = best.outputs
    st.tables = best.tables
    return best_out


# -------------------------------------------------------------------------
# Native engines
# -------------------------------------------------------------------------

# Engine stats slots (csrc eng_run) -> context counters; slot 0 is nodes.
_ENGINE_STATS = {
    1: "pair_candidates",
    2: "triple_candidates",
    3: "lut3_candidates",
    4: "lut5_candidates",
    5: "lut7_candidates",
    6: "lut7_solved",
    7: "engine_devcalls",
}


class _EngineView:
    """Read-only :class:`State` facade over the LUT engine's live tables
    for the device-work service: the search drivers it calls
    (lut5_search, lut5_resume_overflow, lut7_search) touch only
    ``num_gates`` and ``live_tables()``."""

    __slots__ = ("_tables", "num_gates")

    def __init__(self, tables, g: int):
        self._tables = tables
        self.num_gates = g

    def live_tables(self):
        return self._tables


def _lut_engine_service(ctx: SearchContext, threaded: bool = False):
    """The LUT engine's device-work service (the Python half of csrc's
    sbg_eng_devcb contract): each request runs the search driver the
    Python recursion would run at that node, against ``ctx``'s seeds and
    counters, while the engine waits in the callback.

    ``threaded`` (the engine fans its outermost mux over threads,
    :meth:`SearchContext.engine_mux_threads`): requests may arrive
    concurrently, so each runs against its own context view seeded from the
    engine branch stream's per-call draw ``rng`` (deterministic whatever
    the thread timing) and folds its counters into ``ctx``."""
    from . import lut as lutmod

    def run(cctx, kind, st, target, mask, inbits, arg0):
        fault_point("native.devcb")
        if kind == 1:  # pivot-sized space: the full 5-LUT search
            with cctx.prof.phase("lut5"):
                res = lutmod.lut5_search(cctx, st, target, mask, inbits)
        elif kind == 2:  # head-solver overflow: resume from chunk arg0
            res = lutmod.lut5_resume_overflow(cctx, st, target, mask, inbits,
                                              arg0)
        elif kind == 3:  # staged 7-LUT
            with cctx.prof.phase("lut7"):
                res = lutmod.lut7_search(cctx, st, target, mask, inbits)
            if res is None:
                return None
            return (
                res["func_outer"], res["func_middle"], res["func_inner"],
                *res["gates"],
            )
        else:
            raise ValueError(f"unknown engine device-work kind {kind}")
        if res is None:
            return None
        return (res["func_outer"], res["func_inner"], *res["gates"])

    def service(kind, tables, g, target, mask, inbits, arg0, rng, slot):
        st = _EngineView(tables, g)
        if not threaded:
            return run(ctx, kind, st, target, mask, inbits, arg0)
        from .batched import Rendezvous, RestartContext

        cctx = RestartContext(ctx, rng, Rendezvous(1))
        try:
            return run(cctx, kind, st, target, mask, inbits, arg0)
        finally:
            cctx.merge_stats_into(ctx)

    return service


def _engine_replay(ctx, st: State, target, mask, out_gid, added, stats) -> int:
    """Shared tail of both engines: merge the counters, replay the adopted
    gate additions onto ``st`` (tables and SAT metric recomputed by the
    State) and re-verify; the engine's result is never trusted blindly."""
    for idx, key in _ENGINE_STATS.items():
        if int(stats[idx]):
            ctx.stats.inc(key, int(stats[idx]))
    ctx.stats.inc("engine_nodes", int(stats[0]))
    if out_gid == NO_GATE:
        return NO_GATE
    for row in added:
        t, i1, i2, i3, func = (int(x) for x in row)
        st.replay_gate(t, i1, i2 if t != bf.NOT else NO_GATE, i3, func)
    st.verify_gate(out_gid, target, mask)
    return out_gid


def _engine_seed(ctx) -> int:
    """The engine's PRNG seed: one draw from the context's generator."""
    return int(ctx.rng.integers(0, 2**63)) if ctx.opt.randomize else 0


def _engine_args(ctx, st: State, target, mask, inbits):
    return (
        np.ascontiguousarray(st.live_tables()), st.num_gates, st.num_inputs,
        st.max_gates, st.sat_metric, st.max_sat_metric, ctx.opt.metric,
        np.asarray(target), np.asarray(mask), list(inbits), ctx.opt.randomize,
        _engine_seed(ctx),
    )


def _native_engine_search(
    ctx: SearchContext, st: State, target, mask, inbits: List[int]
) -> int:
    """The gate-mode recursion in the native engine."""
    with ctx.prof.phase("gate_engine_native"):
        out_gid, added, stats = ctx.gate_engine_caller()(
            *_engine_args(ctx, st, target, mask, inbits),
            use_not=bool(ctx.not_entries),
        )
    return _engine_replay(ctx, st, target, mask, out_gid, added, stats)


def _native_lut_engine_search(
    ctx: SearchContext, st: State, target, mask, inbits: List[int]
):
    """The LUT-mode recursion in the native engine, its device-work nodes
    serviced by :func:`_lut_engine_service`.  Returns the gate id (or
    NO_GATE), or None when the service failed and the engine bailed: the
    counters are then put back as before the call (requests serviced
    before the failure counted into ``ctx.stats``), and the caller reruns
    the node."""
    from .. import native

    mux_threads = ctx.engine_mux_threads()
    if ctx.lut_engine_devcb is None:
        ctx.lut_engine_devcb = native.make_eng_devcb(
            _lut_engine_service(ctx, threaded=True) if mux_threads > 1
            else _lut_engine_service(ctx)
        )
    stats_snapshot = dict(ctx.stats)
    with ctx.prof.phase("lut_engine_native"):
        out_gid, added, stats = ctx.lut_engine_caller()(
            *_engine_args(ctx, st, target, mask, inbits),
            devcb=ctx.lut_engine_devcb, mux_threads=mux_threads,
        )
    if added is None:  # bailed: the device-work service failed
        ctx.stats.restore(stats_snapshot)
        return None
    return _engine_replay(ctx, st, target, mask, out_gid, added, stats)


# -------------------------------------------------------------------------
# Step-5 multiplexers
# -------------------------------------------------------------------------


def _mux_try_bit(ctx: SearchContext, st: State, target, mask, bit, tracked):
    """One select bit of the step-5 multiplexer: the mux construction(s) on
    copies of ``st``; returns (new_state, out_gate) or None."""
    metric = ctx.opt.metric
    next_inbits = tracked + [bit]
    fsel = st.table(bit).copy()

    if ctx.opt.lut_graph:
        nst = st.copy()
        nst.max_gates -= 1  # reserve room for the mux LUT
        fb = create_circuit(ctx, nst, target, mask & ~fsel, next_inbits)
        if fb == NO_GATE:
            return None
        fc = create_circuit(ctx, nst, target, mask & fsel, next_inbits)
        if fc == NO_GATE:
            return None
        nst.max_gates += 1
        if fb == fc:
            nst_out = fb
        elif fb == bit:
            nst_out = nst.add_and_gate(fb, fc, metric)
        elif fc == bit:
            nst_out = nst.add_or_gate(fb, fc, metric)
        else:
            # LUT mux 0xac = sel ? fc : fb (sboxgates.c:506-508)
            nst_out = nst.add_lut(0xAC, bit, fb, fc)
        if nst_out == NO_GATE:
            return None
        nst.verify_gate(nst_out, target, mask)
        return nst, nst_out

    and_xor = get_sat_metric(bf.AND) + get_sat_metric(bf.XOR)
    or_xor = get_sat_metric(bf.OR) + get_sat_metric(bf.XOR)

    # AND-based mux: out = fb ^ (sel & fc) (sboxgates.c:516-537)
    nst_and = st.copy()
    nst_and.max_gates -= 2
    nst_and.max_sat_metric -= and_xor
    fb = create_circuit(ctx, nst_and, target & ~fsel, mask & ~fsel, next_inbits)
    mux_out_and = NO_GATE
    if fb != NO_GATE:
        fc = create_circuit(
            ctx, nst_and, nst_and.table(fb) ^ target, mask & fsel, next_inbits
        )
        nst_and.max_gates += 2
        nst_and.max_sat_metric += and_xor
        andg = nst_and.add_and_gate(fc, bit, metric)
        mux_out_and = nst_and.add_xor_gate(fb, andg, metric)
        if mux_out_and != NO_GATE:
            nst_and.verify_gate(mux_out_and, target, mask)

    # OR-based mux: out = fd ^ (sel | fe) (sboxgates.c:539-567), under the
    # AND mux's size when that one succeeded.
    nst_or = st.copy()
    if mux_out_and != NO_GATE:
        nst_or.max_gates = nst_and.num_gates
        nst_or.max_sat_metric = nst_and.sat_metric
    nst_or.max_gates -= 2
    nst_or.max_sat_metric -= or_xor
    fd = create_circuit(ctx, nst_or, ~target & fsel, mask & fsel, next_inbits)
    mux_out_or = NO_GATE
    if fd != NO_GATE:
        fe = create_circuit(
            ctx, nst_or, nst_or.table(fd) ^ target, mask & ~fsel, next_inbits
        )
        nst_or.max_gates += 2
        nst_or.max_sat_metric += or_xor
        org = nst_or.add_or_gate(fe, bit, metric)
        mux_out_or = nst_or.add_xor_gate(fd, org, metric)
        if mux_out_or != NO_GATE:
            nst_or.verify_gate(mux_out_or, target, mask)
        nst_or.max_gates = st.max_gates
        nst_or.max_sat_metric = st.max_sat_metric

    if mux_out_and == NO_GATE and mux_out_or == NO_GATE:
        return None
    if metric == GATES:
        use_and = mux_out_or == NO_GATE or (
            mux_out_and != NO_GATE and nst_and.num_gates < nst_or.num_gates
        )
    else:
        use_and = mux_out_or == NO_GATE or (
            mux_out_and != NO_GATE and nst_and.sat_metric < nst_or.sat_metric
        )
    return (nst_and, mux_out_and) if use_and else (nst_or, mux_out_or)
