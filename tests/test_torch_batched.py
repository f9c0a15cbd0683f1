"""The job axis of the port, part 1: the lane forms and the rendezvous.

- Lane forms (``<sweep>_lanes`` in ``sboxgates_tpu_torch/ops/sweeps.py``):
  every lane's verdict equals the single-lane sweep's on that lane's
  operands and seed, with ragged lanes (different gate counts, lanes that stop at different steps
  and chunks, lanes with nothing to sweep).  The operands are the ones the
  search context builds (captured from ``lut_step``/``gate_step``/
  ``lut7_step`` and the 5-LUT drivers), states made with numpy from a seed.
- The plain versions of K1's and K3's lane forms against their single-lane
  plain versions, lane by lane, with inert lanes.
- C2 (concurrent mux branches): ``Options.parallel_mux`` resolves like the
  JAX package's, and the port with the mux on writes the JAX package's
  files for the same command with its mux on (goldens made by the JAX CLI
  with ``parallel_mux`` resolved on, as on an accelerator:
  ``tests/torch_job_goldens.py``); runs are deterministic.
- Batched restarts (``-i N --batch-iterations``) with and without ``-o``
  against the JAX CLI's files.

Tolerance: exact equality throughout (integer words and verdicts).
"""

import math
import os

import numpy as np
import pytest
import torch

from sboxgates_tpu_torch.core import boolfunc as bf
from sboxgates_tpu_torch.core import ttable as tt
from sboxgates_tpu_torch.graph.state import GATES, State
from sboxgates_tpu_torch.ops import lut5_filter, pivot_tile, sweeps
from sboxgates_tpu_torch.search import Options, SearchContext, warmup
from sboxgates_tpu_torch.search import lut as lutmod
from sboxgates_tpu_torch.search.lut import PivotOperands

from torch_cli_helpers import ROOT, compare_run, golden_case, run_port_cli

torch.set_num_threads(1)

CPU = torch.device("cpu")


def rand_state(rng, num_inputs, g):
    st = State.init_inputs(num_inputs)
    while st.num_gates < g:
        a, b = rng.choice(st.num_gates, size=2, replace=False)
        if rng.integers(0, 4) == 0:
            st.add_not_gate(int(a), GATES)
        else:
            st.add_gate(int(rng.choice([bf.AND, bf.OR, bf.XOR])), int(a),
                        int(b), GATES)
    return st


def capture(ctx, fn, *args):
    """Runs ``fn(*args)`` with the context's registry dispatches recorded:
    [(name, statics, args, single-lane result)]."""
    calls = []

    def rec(name, statics, a, g=None):
        out = warmup.kernel(name, statics)(*a)
        calls.append((name, statics, a, out))
        return out

    ctx._dispatch = rec
    ctx.stream_dispatch = rec
    try:
        fn(*args)
    finally:
        del ctx._dispatch
        del ctx.stream_dispatch
    return calls


def same(a, b):
    if isinstance(a, tuple):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            same(x, y)
    elif isinstance(a, torch.Tensor):
        assert torch.equal(a, b)
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def check_lanes(calls):
    """Groups the captured calls by merge key and holds each group's lane
    form against the single-lane results."""
    groups = {}
    for name, statics, a, out in calls:
        groups.setdefault(warmup.warm_key(name, statics, a), []).append(
            (name, statics, a, out))
    assert groups
    for entries in groups.values():
        name, statics = entries[0][0], entries[0][1]
        outs = warmup.KERNELS[name].lanes([e[2] for e in entries], **statics)
        assert len(outs) == len(entries)
        for e, o in zip(entries, outs):
            same(e[3], o)
    return groups


def _ctx(lut, **kw):
    return SearchContext(Options(device="cpu", lut_graph=lut, native=False,
                                 try_nots=not lut, **kw))


def test_gate_step_lanes_match_single_lane_calls():
    rng = np.random.default_rng(3)
    ctx = _ctx(False, seed=5)
    mask = tt.mask_table(6)
    calls = []
    for i in range(6):
        st = rand_state(rng, 6, 14)
        t = st.live_tables()
        target = [t[11] & mask, ~t[9] & mask, (t[1] ^ t[4]) & mask,
                  tt.eval_gate2(bf.NAND, t[0], t[3]) & mask,
                  ((t[0] & t[1]) ^ t[5]) & mask,
                  rng.integers(0, 2**32, 8, dtype=np.uint32) & mask][i]
        calls += capture(ctx, ctx.gate_step, st, target, mask)
    steps = {int(c[3][0]) for c in calls}
    assert {1, 2, 3} <= steps and steps & {0, 5}  # some lanes reach triples
    groups = check_lanes(calls)
    assert max(len(g) for g in groups.values()) == 6


def test_lut_step_lanes_match_single_lane_calls():
    """Ragged LUT heads: gate counts 13-20 in one bucket, targets that stop
    at steps 1-3, the 3-LUT and 5-LUT streams, and misses."""
    rng = np.random.default_rng(4)
    ctx = _ctx(True, seed=9)
    mask = tt.mask_table(8)
    calls = []
    for i, g in enumerate((13, 14, 16, 20, 14, 16, 13)):
        st = rand_state(rng, 8, g)
        t = st.live_tables()
        kind = i % 5
        if kind == 0:
            target = t[g - 2]
        elif kind == 1:
            target = tt.eval_lut(0x96, t[1], t[5], t[g - 1])
        elif kind == 2:
            outer = tt.eval_lut(0x2D, t[0], t[3], t[g - 1])
            target = tt.eval_lut(0xB4, outer, t[2], t[g - 3])
        else:
            target = rng.integers(0, 2**32, 8, dtype=np.uint32)
        calls += capture(ctx, ctx.lut_step, st, target & mask, mask,
                         [1] if i == 4 else [])
    steps = {int(c[3][0]) for c in calls}
    assert {1, 4, 5, 0} <= steps
    groups = check_lanes(calls)
    assert max(len(g) for g in groups.values()) >= 6


def test_lut7_step_lanes_match_single_lane_calls():
    rng = np.random.default_rng(6)
    ctx = _ctx(True, seed=2)
    mask = tt.mask_table(8)
    calls = []
    for i in range(5):
        st = rand_state(rng, 8, 10)
        t = st.live_tables()
        if i < 3:
            outer = tt.eval_lut(0x6A, t[0], t[4], t[9])
            mid = tt.eval_lut(0x3C, t[1], t[2], t[8])
            target = tt.eval_lut(0xCA, outer, mid, t[5 + i])
        else:
            target = rng.integers(0, 2**32, 8, dtype=np.uint32)
        calls += capture(ctx, ctx.lut7_step, st, target & mask, mask, [])
    check_lanes(calls)


def test_lut5_and_lut3_stream_lanes_match_single_lane_calls():
    """The standalone 5-LUT and 3-LUT streams of lut5_search / lut3_search
    (the sweeps a fleet merges), ragged starts and totals."""
    rng = np.random.default_rng(8)
    ctx = _ctx(True, seed=4)
    mask = tt.mask_table(8)
    calls = []
    for i, g in enumerate((24, 26, 24, 30)):
        st = rand_state(rng, 8, g)
        t = st.live_tables()
        if i % 2 == 0:
            outer = tt.eval_lut(0x2D, t[1], t[7], t[g - 2])
            target = tt.eval_lut(0xB4, outer, t[3], t[g - 1])
        else:
            target = rng.integers(0, 2**32, 8, dtype=np.uint32)
        calls += capture(ctx, lutmod.lut5_search, ctx, st, target & mask,
                         mask, [])
        calls += capture(ctx, lutmod.lut3_search, ctx, st, target & mask,
                         mask, [])
    names = {c[0] for c in calls}
    assert {"lut5_stream", "lut3_stream"} <= names
    check_lanes([c for c in calls if c[0] in ("lut5_stream", "lut3_stream")])


def test_feasible_stream_lanes_match_single_lane_calls():
    import math

    rng = np.random.default_rng(10)
    binom = sweeps.binom_device(CPU)
    mask = sweeps.as_words(tt.mask_table(8), CPU)
    rows = {5: [], 7: []}
    for g, k, start in ((12, 5, 0), (14, 5, 1024), (9, 7, 0), (12, 5, 10**6),
                        (10, 7, 0)):
        tabs = np.zeros((64, 8), np.uint32)
        tabs[:g] = rand_state(rng, 8, g).live_tables()
        target = rng.integers(0, 2**32, 8, dtype=np.uint32)
        rows[k].append((sweeps.as_words(tabs, CPU), binom, g,
                        sweeps.as_words(target, CPU), mask,
                        torch.full((8,), -1, dtype=torch.int32), start,
                        math.comb(g, k)))
    for k, sub in rows.items():
        single = [sweeps.feasible_stream(*r, k=k, chunk=1024) for r in sub]
        for a, b in zip(single, sweeps.feasible_stream_lanes(sub, k=k, chunk=1024)):
            same(a, b)


def _pivot_rows(rng, gs, tl, th):
    """Pivot-stream rows of the search's operands at a small tile shape
    (tl x th), planted 5-LUT targets on even lanes."""
    mask = tt.mask_table(8)
    _, w_tab, m_tab = sweeps.lut5_split_tables()
    jw, jm = sweeps.as_words(w_tab, CPU), sweeps.as_words(m_tab, CPU)
    rows = []
    for i, g in enumerate(gs):
        st = rand_state(rng, 8, g)
        t = st.live_tables()
        if i % 2 == 0:
            outer = tt.eval_lut(0x2D, t[1], t[g - 4], t[g - 2])
            target = tt.eval_lut(0xB4, outer, t[3], t[g - 1]) & mask
        else:
            target = rng.integers(0, 2**32, 8, dtype=np.uint32) & mask
        tabs = np.zeros((64, 8), np.uint32)
        tabs[:g] = t
        ops = PivotOperands(g, tl, th, [2] if i == 1 else [],
                            sweeps.as_words(tabs, CPU), target, mask, CPU)
        rows.append((*ops.stream_args(), 0, ops.t_real, jw, jm,
                     int(rng.integers(0, 2**31)) if i != 3 else -1))
    return rows


def test_pivot_stream_lanes_match_single_lane_calls(monkeypatch):
    """K1's lane form drives the lanes' pivot sweeps: ragged gate counts,
    an exclusion, a deterministic lane, a lane that starts at its end, and
    window caps of 1 and 4 tiles per lane."""
    rng = np.random.default_rng(12)
    tl = th = 16
    rows = _pivot_rows(rng, (12, 13, 12, 14, 12), tl, th)
    rows[4] = rows[4][:7] + (rows[4][8], rows[4][8]) + rows[4][9:]
    single = [sweeps.lut5_pivot_stream(*r, tl=tl, th=th) for r in rows]
    assert any(s[0] == 1 for s in single) and any(s[0] == 0 for s in single)
    for cap in (5, 20):
        monkeypatch.setattr(sweeps, "PIVOT_WINDOW_TILES", cap)
        before = pivot_tile.launches["lanes"]
        out = sweeps.lut5_pivot_stream_lanes(rows, tl=tl, th=th)
        assert pivot_tile.launches["lanes"] == before  # CPU: plain version
        for a, b in zip(single, out):
            np.testing.assert_array_equal(a, b)
    # A "pre" row (int8 lanes) takes K1's lane form on its words.
    pre = [(r[0], *(pivot_tile.expand_lanes(x) for x in r[1:4]), *r[4:])
           for r in rows[:2]]
    for a, b in zip(single[:2],
                    sweeps.lut5_pivot_stream_lanes(pre, tl=tl, th=th,
                                              backend="pre")):
        np.testing.assert_array_equal(a, b)


def test_pivot_pair_cells_lanes():
    rng = np.random.default_rng(13)
    rows = []
    for g in (12, 12, 12):
        tabs = np.zeros((64, 8), np.uint32)
        tabs[:g] = rand_state(rng, 8, g).live_tables()
        lows, highs, _ = sweeps.pivot_pair_grids(g)
        rows.append((sweeps.as_words(tabs, CPU), torch.from_numpy(lows).long(),
                     torch.from_numpy(highs).long(),
                     sweeps.as_words(rng.integers(0, 2**32, 8, dtype=np.uint32),
                                     CPU),
                     sweeps.as_words(tt.mask_table(8), CPU)))
    for r, o in zip(rows, sweeps.pivot_pair_cells_lanes(rows)):
        same(sweeps.pivot_pair_cells(*r), o)


def test_k3_lane_form_plain_matches_single_lane_plain():
    rng = np.random.default_rng(14)
    lanes, n, b = 4, 300, 64
    tables = torch.from_numpy(
        rng.integers(0, 2**32, (lanes, b, 8), dtype=np.uint32).view(np.int32))
    combos = torch.from_numpy(rng.integers(0, b, (lanes, n, 5)).astype(np.int32))
    target = torch.from_numpy(
        rng.integers(0, 2**32, (lanes, 8), dtype=np.uint32).view(np.int32))
    mask = torch.from_numpy(
        rng.integers(0, 2**32, (lanes, 8), dtype=np.uint32).view(np.int32))
    r1, r0 = lut5_filter.lut5_filter_cells_lanes(tables, combos, target, mask)
    for i in range(lanes):
        s1, s0 = lut5_filter.lut5_filter_cells(tables[i], combos[i], target[i],
                                               mask[i])
        assert torch.equal(r1[i], s1) and torch.equal(r0[i], s0)


def test_k1_lane_form_plain_matches_single_lane_plain():
    """Ragged windows: lane 0 mid-list, lane 1 cut by its t_end, lane 2
    inert (t0 == t_end)."""
    rng = np.random.default_rng(15)
    tl = th = 16
    rows = _pivot_rows(rng, (12, 12, 12), tl, th)
    lanes = len(rows)
    stack = lambda j: sweeps._pad_rows([r[j] for r in rows], 0 if j > 3 else 1)  # noqa: E731
    tmax = max(r[6].shape[0] for r in rows)
    descs = torch.zeros((lanes, tmax, 5), dtype=torch.int32)
    for i, r in enumerate(rows):
        descs[i, : r[6].shape[0]] = torch.from_numpy(r[6])
    te = [r[8] for r in rows]
    t0 = [2, te[1] - 2, te[2]]
    t_end = list(te)
    n = 4
    out = pivot_tile.pivot_window_lanes(
        stack(0), stack(1), stack(2), stack(3), stack(4), stack(5), descs, t0,
        n, t_end, tl, th)
    for i in range(lanes):
        single = pivot_tile.pivot_window(
            rows[i][0], stack(1)[i], stack(2)[i], stack(3)[i], stack(4)[i],
            stack(5)[i], descs[i], t0[i], n, t_end[i], tl, th)
        for a, b in zip(out, single):
            assert torch.equal(a[i], b)
    assert int(out[3][2].sum()) == 0 and bool((out[0][2] == -1).all())


def test_k1_lane_launch_charges_the_swept_tiles():
    """The attribution of a K1 lane-form launch (the registry's roofline
    row and the dispatch span's cost) counts the tiles its lanes sweep, not
    the slots of lanes cut at their t_end or done; the inert slots add only
    the words and flags they write."""
    from sboxgates_tpu_torch.telemetry import attribution as tattr

    rng = np.random.default_rng(20)
    tl = th = 16
    rows = _pivot_rows(rng, (12, 12, 12), tl, th)
    stack = lambda j: sweeps._pad_rows([r[j] for r in rows], 0 if j > 3 else 1)  # noqa: E731
    descs = sweeps._pad_rows([torch.from_numpy(r[6]) for r in rows], 0)
    te = [r[8] for r in rows]
    t0, t_end, n = [0, te[1] - 1, te[2]], list(te), 4
    ctx = _ctx(True)
    ctx.dispatch("pivot_window_lanes", lambda: pivot_tile.pivot_window_lanes(
        stack(0), stack(1), stack(2), stack(3), stack(4), stack(5), descs, t0,
        n, t_end, tl, th))
    swept = 4 + 1 + 0
    got = tattr.annotation("pivot_window_lanes", f"{swept}of3x{n}x{tl}x{th}")
    full = tattr.window_cost(swept, tl, th, "packed")
    assert got == {"ops": full["ops"], "tc_ops": full["tc_ops"],
                   "bytes": full["bytes"] + (3 * n - swept) * (9 * tl * th + 4)}


def _feasible_rows(rng, k, n_lanes, rows):
    """Per lane, the req words of the first ``rows`` feasible k-tuples of a
    planted target (padded with all-ones rows), as the solvers get them."""
    mask = tt.mask_table(8)
    binom = sweeps.binom_device(CPU)
    out = []
    for i in range(n_lanes):
        st = rand_state(rng, 8, 11)
        t = st.live_tables()
        if k == 5:
            outer = tt.eval_lut(0x2D, t[1], t[4], t[9])
            target = tt.eval_lut(0xB4, outer, t[3], t[10])
        else:
            outer = tt.eval_lut(0x6A, t[0], t[4], t[9])
            mid = tt.eval_lut(0x3C, t[1], t[2], t[8])
            target = tt.eval_lut(0xCA, outer, mid, t[5 + i % 3])
        tabs = np.zeros((64, 8), np.uint32)
        tabs[:11] = t
        _, feas, r1, r0 = sweeps.feasible_stream(
            sweeps.as_words(tabs, CPU), binom, 11,
            sweeps.as_words(target & mask, CPU), sweeps.as_words(mask, CPU),
            torch.full((8,), -1, dtype=torch.int32), 0, math.comb(11, k),
            k=k, chunk=1 << 12)
        keep = torch.nonzero(feas).flatten()[: rows - 2 * i]
        pad = lambda x: torch.cat([x[keep], torch.full(  # noqa: E731
            (rows - keep.shape[0],) + tuple(x.shape[1:]), -1, dtype=torch.int32)])
        out.append((pad(r1), pad(r0)))
    return out


def test_solver_lanes_match_single_lane_calls():
    """lut5_solve and lut7_solve: the lane forms against the single-lane
    solves, lanes with their own req rows and seeds (one deterministic)."""
    rng = np.random.default_rng(16)
    _, w_tab, m_tab = sweeps.lut5_split_tables()
    jw, jm = sweeps.as_words(w_tab, CPU), sweeps.as_words(m_tab, CPU)
    rows5 = [(r1, r0, jw, jm, seed) for (r1, r0), seed in zip(
        _feasible_rows(rng, 5, 4, 32), (11, -1, 2**31 - 5, 40))]
    idx, pp = (torch.from_numpy(x) for x in sweeps.lut7_pair_tables())
    rows7 = [(r1, r0, idx, pp, seed) for (r1, r0), seed in zip(
        _feasible_rows(rng, 7, 3, 16), (3, -1, 77))]
    for name, rows in (("lut5_solve", rows5), ("lut7_solve", rows7)):
        single = [getattr(sweeps, name)(*r) for r in rows]
        assert any(v[0] for v in single)
        for a, b in zip(single, warmup.KERNELS[name].lanes(rows)):
            np.testing.assert_array_equal(a, b)


def test_pivot_tile_lanes_match_single_lane_calls():
    """The re-drive's one-tile sweep: K1's lane form (plain on the CPU)
    over lanes with their own operands and tiles, against the single-lane
    calls on each backend's operands."""
    rng = np.random.default_rng(17)
    tl = th = 16
    rows = _pivot_rows(rng, (12, 13, 12), tl, th)
    tiles = [(r[:7] + (t,)) for r, t in zip(rows, (3, 0, 7))]
    single = [sweeps.lut5_pivot_tile(*r, tl=tl, th=th) for r in tiles]
    assert any(bool(s[0].any()) for s in single)
    for a, b in zip(single, sweeps.lut5_pivot_tile_lanes(tiles, tl=tl, th=th)):
        same(a, b)
    pre = [(r[0], *(pivot_tile.expand_lanes(x) for x in r[1:4]), *r[4:])
           for r in tiles]
    for a, b in zip(single, sweeps.lut5_pivot_tile_lanes(pre, tl=tl, th=th,
                                                          backend="pre")):
        same(a, b)


def test_pivot_redrive_and_solves_dispatch_through_the_registry(monkeypatch):
    """A pivot tile that overflows the in-stream solver is re-driven and
    its tuples solved through ``stream_dispatch`` (merged under a fleet, as
    in the JAX package), each call's lane form equal to the single call.
    The stream is patched to report its hit tile as an overflow."""
    rng = np.random.default_rng(18)
    ctx = _ctx(True, seed=6)
    mask = tt.mask_table(8)
    stream = sweeps.lut5_pivot_stream

    def overflowing(*a, **k):
        v = stream(*a, **k).copy()
        v[0] = 2 if v[0] == 1 else v[0]
        return v

    monkeypatch.setattr(sweeps, "lut5_pivot_stream", overflowing)
    calls = []
    for _ in range(2):
        st = rand_state(rng, 8, 12)
        t = st.live_tables()
        outer = tt.eval_lut(0x2D, t[1], t[6], t[10])
        target = tt.eval_lut(0xB4, outer, t[3], t[11]) & mask
        calls += capture(ctx, lutmod._lut5_search_pivot, ctx, st, target, mask,
                         [])
    names = [c[0] for c in calls]
    assert {"lut5_pivot_stream", "lut5_pivot_tile", "lut5_solve"} <= set(names)
    check_lanes([c for c in calls if c[0] != "lut5_pivot_stream"])


def test_one_merged_round_syncs_once_for_all_lanes():
    """The host syncs (as the CPU sync guard counts them) of one lockstep
    round are the same for 1 and for 6 lanes: one for a 5-LUT stream chunk
    (filter and solve of every lane); for a pivot window of every lane's
    hit tile, one counts read and one solve round for all lanes, beside the
    plain K1's one read of the descriptors (the CPU runs the plain
    version)."""
    from sboxgates_tpu_torch.utils.guards import sync_guard

    rng = np.random.default_rng(19)
    mask = sweeps.as_words(tt.mask_table(8), CPU)
    binom = sweeps.binom_device(CPU)
    _, w_tab, m_tab = sweeps.lut5_split_tables()
    jw, jm = sweeps.as_words(w_tab, CPU), sweeps.as_words(m_tab, CPU)
    rows = []
    for i in range(6):
        tabs = np.zeros((64, 8), np.uint32)
        g = 10 + i % 2
        tabs[:g] = rand_state(rng, 8, g).live_tables()
        rows.append((sweeps.as_words(tabs, CPU), binom, g,
                     sweeps.as_words(rng.integers(0, 2**32, 8, dtype=np.uint32),
                                     CPU),
                     mask, torch.full((8,), -1, dtype=torch.int32), 0,
                     math.comb(g, 5), jw, jm, 5 + i))
    prow = []
    for r in _pivot_rows(rng, (12,) * 12, 16, 16)[::2]:     # planted lanes
        hit = int(sweeps.lut5_pivot_stream(*r, tl=16, th=16)[8]) - 1
        prow.append(r[:7] + (hit, hit + 1) + r[9:])
    counts = {}
    for lanes in (1, 6):
        for name, fn, sub in (
                ("lut5", lambda r: sweeps.lut5_stream_lanes(r, chunk=1024), rows),
                ("pivot", lambda r: sweeps.lut5_pivot_stream_lanes(
                    r, tl=16, th=16), prow)):
            with sync_guard(action="count") as rep:
                fn(sub[:lanes])
            counts[name, lanes] = rep.syncs
    assert counts == {("lut5", 1): 1, ("lut5", 6): 1,
                      ("pivot", 1): 3, ("pivot", 6): 3}, counts


# -------------------------------------------------------------------------
# C2: concurrent mux branches
# -------------------------------------------------------------------------


def test_parallel_mux_resolves_like_the_jax_package():
    assert SearchContext(Options(device="cpu")).rdv is None
    assert SearchContext(Options(device="cpu", parallel_mux=True)).rdv is not None
    assert SearchContext(Options(device="cpu", parallel_mux=False)).rdv is None


@pytest.mark.parametrize("case", ["mux_crypto1_fa", "mux_des_s1_dev",
                                  "serial_mux_crypto1_fa"])
def test_port_with_the_accelerator_mux_writes_the_jax_packages_files(
        case, tmp_path):
    """C2: the port with the mux on (what ``--device cuda`` resolves to)
    against the JAX CLI's files with its mux on; run twice, the same
    files (determinism).  ``--serial-mux`` turns it off in both."""
    argv, env = golden_case(case)
    for k in range(2 if case == "mux_crypto1_fa" else 1):
        d = tmp_path / f"run{k}"
        run_port_cli(argv, env, str(d), parallel_mux=True)
        compare_run(case, str(d))


@pytest.mark.parametrize("case", ["bi_crypto1_fa_o0", "bi_crypto1_fc_all",
                                  "bi_des_s1_lut_o0"])
def test_batch_iterations_writes_the_jax_clis_files(case, tmp_path):
    argv, env = golden_case(case)
    run_port_cli(argv, env, str(tmp_path / "d"))
    compare_run(case, str(tmp_path / "d"))


def test_batch_iterations_killed_inside_the_batch_reruns_it(tmp_path):
    """A crash at the batch's second checkpoint write: the batch is the
    journal's unit, so the resume reruns it from the recorded PRNG state
    and writes the uninterrupted run's files."""
    import subprocess
    import sys

    argv, env = golden_case("bi_crypto1_fa_o0")
    d = str(tmp_path / "d")

    def port(args, faults=None):
        e = dict(os.environ, PYTHONPATH=ROOT)
        for k in ("SBG_DISABLE_NATIVE", "SBG_FAULTS", "SBG_ENGINE_MUX_THREADS"):
            e.pop(k, None)
        e.update(env)
        if faults:
            e["SBG_FAULTS"] = faults
        return subprocess.run(
            [sys.executable, "-m", "sboxgates_tpu_torch", *args, "--device",
             "cpu"], env=e, capture_output=True, text=True).returncode

    assert port([*argv, "--output-dir", d], "ckpt.write:crash@2") == 17
    assert port(["--resume-run", d]) == 0
    compare_run("bi_crypto1_fa_o0", d)


def test_engine_mux_threads_write_the_jax_clis_files(tmp_path):
    """SBG_ENGINE_MUX_THREADS=4: the native LUT engine fans its outermost
    mux over threads, a randomized stream of its own (the JAX CLI's file
    for the same variable)."""
    argv, env = golden_case("emt4_des_s1_lut_o0")
    run_port_cli(argv, env, str(tmp_path / "d"))
    compare_run("emt4_des_s1_lut_o0", str(tmp_path / "d"))


def test_engine_mux_threads_keep_the_unrandomized_results():
    """Without randomization the threaded engine mux finds the serial
    engine's circuits, as in the JAX package (its threads change only the
    randomized stream)."""
    from sboxgates_tpu_torch.search import generate_graph_one_output
    from sboxgates_tpu_torch.utils.sbox import load_sbox

    from torch_cli_helpers import box, environ

    sbox, n = load_sbox(box("des_s1"))
    targets = [tt.target_table(sbox, b) for b in range(8)]
    sigs = []
    for threads in ("1", "4"):
        with environ({"SBG_ENGINE_MUX_THREADS": threads}):
            ctx = SearchContext(Options(device="cpu", lut_graph=True,
                                        randomize=False, seed=1))
            res = generate_graph_one_output(ctx, State.init_inputs(n), targets,
                                            0, save_dir=None,
                                            log=lambda s: None)
            assert ctx.engine_mux_threads() == int(threads)
        sigs.append([(s.num_gates, s.live_tables().tobytes()) for s in res])
    assert sigs[0] == sigs[1] and sigs[0]
