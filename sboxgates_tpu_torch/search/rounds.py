"""Chained rounds: a greedy chain of one-gate (or one-LUT) rounds driven
through the fused round driver.

PyTorch counterpart of the JAX package's ``search/rounds.py``.  A chain of
(target, mask) rounds is solved over one shared, growing graph: round r
adds the gate (a NOT, a 3-LUT, or the two LUTs of a 5-LUT) that realizes
target r over the current graph, or matches an existing gate.  Up to
``rounds_per_dispatch`` rounds go to the device in one call of
:func:`sboxgates_tpu_torch.ops.sweeps.round_driver`; its compact hit
journal is replayed onto the host :class:`State` through the ordinary
mutators and ``verify_gate`` (never trusted blindly).  A round the driver
cannot finish (no such gate exists, or the 5-LUT head solver overflowed)
runs the full recursive search on the host for that round only.

Bit identity with the JAX package and across window sizes: the per-round
kernel seeds and don't-care fill bytes are drawn in ONE host block per
chain segment (:func:`_draw_round_block`), so the PRNG stream does not
depend on how the chain is cut into windows; the journal records one
``chain_round`` per round (never per window) and the drawn block once
(``chain_seeds``).  A chain whose device windows exhaust their deadline
retries trips the circuit breaker and completes on the host fallback.

:func:`run_fleet_round_chains` runs a wave of such chains in lockstep
through ``fleet_round_driver``; under a fleet rendezvous (a merged serve
wave) plain :func:`run_round_chain` windows merge into one lane-form call
through ``ctx.stream_dispatch``.  Both give each lane exactly its
one-chain result.  Fused windows keep lexicographic candidate order
whatever ``--candidate-order`` says (a window is one call with no
host-visible segment boundaries); the fallback rounds reach the ordered
drivers through ``create_circuit``.
"""

from __future__ import annotations

import logging
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..graph.state import GATES, NO_GATE, State
from ..ops import combinatorics as comb
from ..ops import sweeps
from ..resilience.deadline import DispatchTimeout
from ..telemetry import trace as _ttrace
from .context import (
    BUCKETS,
    LUT5_HEAD_SOLVE_ROWS,
    PIVOT_MIN_TOTAL,
    STREAM_CHUNK,
    SearchContext,
    pick_chunk,
)

logger = logging.getLogger(__name__)

#: Heights the hit journal and the per-round operands pad to: the window's
#: round count rounded up to a rung (the JAX package's static shapes; here
#: they keep the merge keys of concurrent windows equal).
ROUND_BUCKETS = (1, 2, 4, 8, 16, 32)


def round_bucket(n: int) -> int:
    for b in ROUND_BUCKETS:
        if n <= b:
            return b
    return ROUND_BUCKETS[-1]


def _chain_bucket(g: int, want: int) -> Tuple[int, int]:
    """(table bucket, rounds) for a window starting at gate count ``g``:
    the smallest gate bucket with room for ``want`` rounds at the worst
    case of two gates per round, the window shrunk when even the top
    bucket cannot hold it."""
    for b in BUCKETS:
        if b >= g + 2 * want:
            return b, want
    cap = (BUCKETS[-1] - g) // 2
    if cap < 1:
        raise ValueError(f"no append capacity for a round at {g} gates")
    return BUCKETS[-1], min(want, cap)


def _draw_round_block(ctx: SearchContext, n: int) -> Tuple[np.ndarray, np.ndarray]:
    """Kernel seeds and don't-care fill bytes of the next ``n`` rounds,
    drawn in one block (-1 seeds and zero bytes when not randomizing)."""
    if not ctx.opt.randomize:
        return np.full(n, -1, np.int32), np.zeros(n, np.int32)
    seeds = np.asarray([ctx.next_seed() for _ in range(n)], np.int32)
    dcs = np.asarray(
        [int(ctx.rng.integers(0, 256)) for _ in range(n)], np.int32
    )
    return seeds, dcs


def _gate_rows(st: State, g_from: int) -> List[List[int]]:
    """The gates appended past ``g_from`` as [type, in1, in2, in3,
    function] rows (what ``State.replay_gate`` takes back)."""
    return [
        [int(g.type), int(g.in1), int(g.in2), int(g.in3), int(g.function)]
        for g in st.gates[g_from:]
    ]


def _replay_round(ctx: SearchContext, st: State, row, target, mask) -> int:
    """Applies one device-completed round's hit row to the host state
    through the ordinary (table-recomputing, self-verifying) mutators.
    Returns the round's output gate."""
    kind, x0, x1, x2, x3 = (int(v) for v in row[:5])
    if kind == 1:
        st.verify_gate(x0, target, mask)
        return x0
    if kind == 2:
        gid = st.add_not_gate(x0, GATES)
        st.verify_gate(gid, target, mask)
        return gid
    if kind == 3:
        a, b, c = (int(v) for v in comb.unrank_combination(x0, st.num_gates, 3))
        gid = st.add_lut(x1, a, b, c)
        st.verify_gate(gid, target, mask)
        return gid
    if kind == 4:
        splits, _, _ = sweeps.lut5_split_tables()
        combo = comb.unrank_combination(x0, st.num_gates, 5)
        a, b, c, d, e = (int(combo[p]) for p in splits[x1])
        outer = st.add_lut(x2, a, b, c)
        gid = st.add_lut(x3, outer, d, e)
        st.verify_gate(gid, target, mask)
        return gid
    raise AssertionError(f"round_driver reported unknown hit kind {kind}")


def _default_fallback(ctx: SearchContext, st: State, target, mask) -> int:
    from .kwan import create_circuit  # deferred: kwan imports context

    return create_circuit(ctx, st, target, mask, [])


def _chain_resume(ctx: SearchContext, st: State, rounds, journal):
    """The resume-or-start preamble of both drivers: replays journaled
    ``chain_round`` records onto the state, restores the PRNG position,
    and restores (or draws and journals) the seed and fill block.  A run
    killed after the block draw but before any round finished resumes from
    the position recorded with the block.  Returns ``(outs, r, base,
    seeds, dcs)``."""
    outs: List[int] = []
    r = 0
    blk = None
    if journal is not None:
        blk = journal.last("chain_seeds")
        recs = journal.of_type("chain_round")
        for rec in recs:
            tgt, msk = rounds[rec["round"]]
            for t, i1, i2, i3, fn in rec["gates"]:
                st.replay_gate(t, i1, i2, i3, fn)
            st.verify_gate(rec["out"], tgt, msk)
            outs.append(rec["out"])
        if recs:
            ctx.rng_restore(recs[-1]["rng"])
            r = recs[-1]["round"] + 1
    if blk is not None:
        base = int(blk["base"])
        seeds = np.asarray(blk["seeds"], np.int32)
        dcs = np.asarray(blk["dcs"], np.int32)
        if not outs:
            ctx.rng_restore(blk["rng"])
    else:
        base = r
        seeds, dcs = _draw_round_block(ctx, len(rounds) - r)
        if journal is not None:
            journal.append(
                "chain_seeds", base=base,
                seeds=[int(x) for x in seeds], dcs=[int(x) for x in dcs],
                rng=ctx.rng_snapshot(),
            )
    return outs, r, base, seeds, dcs


class _ChainLane:
    """One chain: its context view (PRNG and counters), growing state,
    rounds and journal, with the one implementation of the
    ``chain_round`` record and of the host-fallback round for both
    drivers."""

    def __init__(self, ctx, st, rounds, journal=None, fallback=None):
        self.ctx = ctx
        self.st = st
        self.rounds = list(rounds)
        self.journal = journal
        self.fallback = fallback
        self.outs: List[int] = []
        self.r = 0
        self.base = 0
        self.seeds = None
        self.dcs = None

    @property
    def remaining(self) -> int:
        return len(self.rounds) - self.r

    def resume(self) -> "_ChainLane":
        (self.outs, self.r, self.base, self.seeds,
         self.dcs) = _chain_resume(self.ctx, self.st, self.rounds,
                                   self.journal)
        return self

    def record(self, rnd: int, out: int, g_from: int) -> None:
        self.outs.append(out)
        if self.journal is not None:
            self.journal.append(
                "chain_round", round=rnd, out=out,
                gates=_gate_rows(self.st, g_from),
                rng=self.ctx.rng_snapshot(),
            )

    def host_round(self) -> None:
        target, mask = self.rounds[self.r]
        g_from = self.st.num_gates
        self.ctx.stats.inc("round_driver_fallbacks")
        out = (self.fallback or _default_fallback)(
            self.ctx, self.st, target, mask
        )
        if out == NO_GATE:
            raise RuntimeError(f"round {self.r}: no circuit found")
        self.record(self.r, out, g_from)
        self.r += 1

    def window(self, n: int, rb: int):
        """Targets, masks, seeds and fill bytes of this chain's next ``n``
        rounds, padded to ``rb`` rows."""
        targets = np.zeros((rb, 8), np.uint32)
        masks = np.zeros((rb, 8), np.uint32)
        for i in range(n):
            # torchlint: ignore[R2x] the chain's round targets are host word arrays; asarray normalizes them before the upload
            targets[i] = np.asarray(self.rounds[self.r + i][0], np.uint32)
            # torchlint: ignore[R2x] the chain's round masks are host word arrays; asarray normalizes them before the upload
            masks[i] = np.asarray(self.rounds[self.r + i][1], np.uint32)
        seeds = np.zeros(rb, np.int32)
        dcs = np.zeros(rb, np.int32)
        lo = self.r - self.base
        seeds[:n] = self.seeds[lo : lo + n]
        dcs[:n] = self.dcs[lo : lo + n]
        return targets, masks, seeds, dcs

    def apply(self, hits, n: int, rb: int) -> None:
        """Counts and replays one window's hit journal: the rounds done,
        the examined ranks of each round run (the frozen one included),
        and the host round of a lane that froze."""
        stats = self.ctx.stats
        rounds_done = int(hits[rb, 0])
        stats.inc("round_driver_rounds", rounds_done)
        stats.observe("rounds_per_dispatch", float(rounds_done))
        counted = rounds_done + (1 if rounds_done < n else 0)
        for i in range(counted):
            stats.inc("lut3_candidates", int(hits[i, 5]))
            stats.inc("lut5_candidates", int(hits[i, 6]))
        for i in range(rounds_done):
            target, mask = self.rounds[self.r + i]
            g_from = self.st.num_gates
            out = _replay_round(self.ctx, self.st, hits[i], target, mask)
            self.record(self.r + i, out, g_from)
        self.r += rounds_done
        if rounds_done < n:
            # Frozen on a miss or a solver overflow: the full recursive
            # search owns this round.
            self.host_round()


def _statics(b: int, rb: int) -> dict:
    """The drivers' static arguments for a window at table bucket ``b``:
    the chunk sizes of the JAX package (the 3-LUT chunk from C(b, 3), the
    5-LUT chunk from the pivot threshold)."""
    return dict(
        chunk3=pick_chunk(comb.n_choose_k(b, 3), STREAM_CHUNK[3]),
        chunk5=pick_chunk(PIVOT_MIN_TOTAL, STREAM_CHUNK[5]),
        has5=True, max_rounds=rb, solve_rows=LUT5_HEAD_SOLVE_ROWS,
    )


def _shared(ctx: SearchContext):
    """(splits, w_tab, m_tab, excl) operands shared by every window."""
    splits, _, _ = sweeps.lut5_split_tables()
    w_tab, m_tab = ctx.lut5_tabs()
    excl = torch.from_numpy(SearchContext.excl_array([])).to(ctx.device)
    return splits, w_tab, m_tab, excl


def run_round_chain(
    ctx: SearchContext,
    st: State,
    rounds: Sequence[Tuple[np.ndarray, np.ndarray]],
    *,
    rounds_per_dispatch: int = 8,
    journal=None,
    fallback: Optional[Callable] = None,
) -> List[int]:
    """Solves a chain of (target, mask) rounds greedily over one growing
    graph, up to ``rounds_per_dispatch`` rounds per device call (clamped
    to the top :data:`ROUND_BUCKETS` rung).  Returns the per-round output
    gates.  Rounds the driver cannot finish run ``fallback(ctx, st,
    target, mask)`` (default: the full recursive search); a window that
    exhausts its deadline retries trips the circuit breaker and the chain
    completes through the fallback.  ``journal`` records one
    ``chain_round`` per finished round, so a killed chain resumes to the
    same files for every ``rounds_per_dispatch``."""
    n_per = max(1, min(int(rounds_per_dispatch), ROUND_BUCKETS[-1]))
    frame = _ChainLane(ctx, st, rounds, journal=journal,
                       fallback=fallback).resume()
    splits, w_tab, m_tab, excl = _shared(ctx)
    degraded = ctx.device_degraded

    while frame.remaining > 0:
        if (
            degraded
            or ctx.device_degraded
            # No room for a worst-case round below the gate cap: the host
            # search still owns the round (it can match an existing gate
            # or add the one final row).
            or st.num_gates + 2 > BUCKETS[-1]
        ):
            frame.host_round()
            continue
        g = st.num_gates
        b, n = _chain_bucket(g, min(n_per, frame.remaining))
        rb = round_bucket(n)
        targets, masks, seeds, dcs = frame.window(n, rb)
        padded = np.zeros((b, 8), np.uint32)
        padded[:g] = st.live_tables()
        statics = _statics(b, rb)
        args = (
            ctx.words(padded), ctx.binom, g, ctx.words(targets),
            ctx.words(masks), excl, seeds, dcs, n, PIVOT_MIN_TOTAL, splits,
            w_tab, m_tab,
        )
        span = dict(rounds=n, g=g, order=ctx.opt.candidate_order)
        if ctx._merge_streams():
            # A merged wave window: this chain's window rendezvouses with
            # the other lanes' into one lane-form call.  _merge_streams is
            # off under a deadline budget, so the guarded path below keeps
            # that configuration.
            with _ttrace.span("round_driver", "round", merged=True, **span):
                hits = ctx.stream_dispatch("round_driver", statics, args, g=g)
        else:
            try:
                with _ttrace.span("round_driver", "round", **span):
                    hits = ctx.guarded_dispatch(
                        lambda: ctx.kernel_call("round_driver", statics, args,
                                                g=g),
                        "round_driver",
                    )
            except DispatchTimeout as e:
                logger.warning(
                    "%s; degrading the round chain to the host fallback", e
                )
                ctx.trip_device_breaker()
                degraded = True
                continue
        frame.apply(np.asarray(hits), n, rb)
    assert st.num_gates == len(st.gates)
    return frame.outs


def run_fleet_round_chains(
    ctx: SearchContext,
    lanes: Sequence[tuple],
    *,
    rounds_per_dispatch: int = 8,
    journals: Optional[Sequence] = None,
    fallback: Optional[Callable] = None,
) -> List[List[int]]:
    """Lockstep form of :func:`run_round_chain` for a wave of independent
    chains, ``lanes`` = ``[(lane_ctx, state, rounds)]``: each window is
    ONE ``fleet_round_driver`` call advancing every lane by up to
    ``rounds_per_dispatch`` rounds.  Each lane's circuit, PRNG draws and
    journal (``journals``, per lane) are the ones :func:`run_round_chain`
    gives it alone.  A lane that misses runs its fallback round on its own
    view while the others go on chaining; a finished lane rides as an
    inert ``n_rounds = 0`` row.  A wave window that exhausts its deadline
    retries trips the breaker and every lane completes on the host.
    Returns the lanes' output-gate lists, in lane order."""
    from .fleet import fleet_bucket

    n_per = max(1, min(int(rounds_per_dispatch), ROUND_BUCKETS[-1]))
    frames = [
        _ChainLane(lctx, st, rounds, fallback=fallback,
                   journal=journals[i] if journals is not None else None
                   ).resume()
        for i, (lctx, st, rounds) in enumerate(lanes)
    ]
    splits, w_tab, m_tab, excl = _shared(ctx)
    lanes_bucket = fleet_bucket(len(frames))
    degraded = ctx.device_degraded

    while True:
        live = [f for f in frames if f.remaining > 0]
        if not live:
            break
        if degraded or ctx.device_degraded:
            for f in live:
                while f.remaining > 0:
                    f.host_round()
            break
        # Lanes at the append cap take this round on the host; the wave
        # keeps chaining without them.
        capped = [f for f in live if f.st.num_gates + 2 > BUCKETS[-1]]
        for f in capped:
            f.host_round()
        live = [f for f in live if f not in capped]
        if not live:
            continue
        gmax = max(f.st.num_gates for f in live)
        b, n = _chain_bucket(gmax, min(n_per, max(f.remaining for f in live)))
        rb = round_bucket(n)
        tables = np.zeros((lanes_bucket, b, 8), np.uint32)
        g0s = np.zeros(lanes_bucket, np.int32)
        n_rounds = np.zeros(lanes_bucket, np.int32)
        targets = np.zeros((lanes_bucket, rb, 8), np.uint32)
        masks = np.zeros((lanes_bucket, rb, 8), np.uint32)
        seeds = np.zeros((lanes_bucket, rb), np.int32)
        dcs = np.zeros((lanes_bucket, rb), np.int32)
        window = []
        for f in live:
            i = frames.index(f)
            n_i = min(n, f.remaining)
            tables[i, : f.st.num_gates] = f.st.live_tables()
            g0s[i] = f.st.num_gates
            n_rounds[i] = n_i
            targets[i], masks[i], seeds[i], dcs[i] = f.window(n_i, rb)
            window.append((i, f, n_i))
        statics = _statics(b, rb)
        args = (
            ctx.words(tables), ctx.binom, g0s, ctx.words(targets),
            ctx.words(masks), excl, seeds, dcs, n_rounds, PIVOT_MIN_TOTAL,
            splits, w_tab, m_tab,
        )
        try:
            with _ttrace.span("fleet_round_driver", "round",
                              lanes=len(window), rounds=n, g=gmax,
                              order=ctx.opt.candidate_order):
                hits = ctx.guarded_dispatch(
                    lambda: ctx.kernel_call("fleet_round_driver", statics,
                                            args, g=gmax),
                    "fleet_round_driver",
                )
        except DispatchTimeout as e:
            logger.warning(
                "%s; degrading the fleet round chains to the host fallback", e
            )
            ctx.trip_device_breaker()
            degraded = True
            continue
        for i, f, n_i in window:
            f.apply(hits[i], n_i, rb)
    for f in frames:
        assert f.st.num_gates == len(f.st.gates)
    return [f.outs for f in frames]

