"""Each ported sweep against its jitted JAX counterpart, bit for bit.

Inputs are built with numpy from a seed and handed to both packages; the
port runs on the CPU (its kernels' plain versions).  Tolerance: exact
equality everywhere — all arithmetic is integer or bitwise, and the 7-LUT
solver's products count at most 8192 pairs, exact in float32.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sboxgates_tpu.core import boolfunc as jbf
from sboxgates_tpu.core import ttable as jtt
from sboxgates_tpu.graph.state import GATES, State
from sboxgates_tpu.ops import combinatorics as jcomb
from sboxgates_tpu.ops import sweeps as jsw
from sboxgates_tpu.search import context as jctx
from sboxgates_tpu.search.lut import PivotOperands as JPivotOperands

from sboxgates_tpu_torch.ops import sweeps as tsw
from sboxgates_tpu_torch.search import context as tctx
from sboxgates_tpu_torch.search.lut import PivotOperands as TPivotOperands

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from planted import (  # noqa: E402
    build_planted_lut5,
    build_planted_lut5_small,
    build_planted_lut7,
)

# The suite runs several worker processes on shared cores; torch's
# intra-op thread pool in each of them oversubscribes the host.
torch.set_num_threads(1)

CPU = torch.device("cpu")
SEEDS = [-1, 0, 12345, 2**31 - 1]


def T(a):
    return tsw.as_words(a, CPU)


def padded(st, b=64):
    t = np.zeros((b, 8), np.uint32)
    t[: st.num_gates] = st.live_tables()
    return t


def excl_np(bits=()):
    e = np.full(8, -1, np.int32)
    e[: len(bits)] = bits
    return e


def Ti(a):
    return torch.from_numpy(np.asarray(a, np.int32))


def random_state(g, seed, n_in=8):
    rng = np.random.default_rng(seed)
    st = State.init_inputs(n_in)
    funs = (jbf.AND, jbf.OR, jbf.XOR, jbf.A_AND_NOT_B)
    while st.num_gates < g:
        a, b = rng.choice(st.num_gates, size=2, replace=False)
        st.add_gate(funs[int(rng.integers(len(funs)))], int(a), int(b), GATES)
    return st


# -- priorities and unranking ---------------------------------------------


@pytest.mark.parametrize("seed", SEEDS + [-5, 0x5BD1 ^ 77, 2**31 - 1 ^ 0x9E37])
@pytest.mark.parametrize("det_newest", [False, True])
def test_priority_matches(seed, det_newest):
    want = np.asarray(jsw._priority(5000, seed, det_newest=det_newest)).astype(np.int64)
    got = tsw._priority(5000, seed, det_newest=det_newest).numpy()
    np.testing.assert_array_equal(got, want)
    if seed >= 0:
        assert (want >> 31).any()


@pytest.mark.parametrize("g,k", [(12, 3), (40, 5), (30, 7), (3, 3), (13, 7), (500, 3),
                                 (512, 3)])
def test_unrank_narrow_matches(g, k):
    rng = np.random.default_rng(g)
    total = jcomb.n_choose_k(g, k)
    ranks = np.concatenate([[0, total - 1], rng.integers(0, total, size=300)])
    want = np.asarray(jsw._unrank_combos(
        jnp.asarray(jsw.binom_table()), g, k, jnp.asarray(ranks.astype(np.int32))
    ))
    got = tsw._unrank_combos(tsw.binom_device(CPU), g, k, torch.from_numpy(ranks))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("g,k", [(200, 5), (99, 7), (500, 7)])
def test_unrank_wide_matches(g, k):
    rng = np.random.default_rng(g)
    total = jcomb.n_choose_k(g, k)
    ranks = np.concatenate([[0, total - 1, 2**31, 2**32 + 5],
                            rng.integers(0, total, size=200, dtype=np.int64)])
    ranks = ranks[ranks < total].astype(np.uint64)
    blo, bhi = jsw.binom_table_wide()
    want = np.asarray(jsw._unrank_combos_wide(
        jnp.asarray(blo), jnp.asarray(bhi), g, k,
        jnp.asarray((ranks & 0xFFFFFFFF).astype(np.uint32)),
        jnp.asarray((ranks >> np.uint64(32)).astype(np.uint32)),
    ))
    got = tsw._unrank_combos_wide(
        tsw.binom_wide_device(CPU), g, k, torch.from_numpy(ranks.astype(np.int64))
    )
    np.testing.assert_array_equal(got.numpy(), want)


# -- node-head sweeps -----------------------------------------------------


def _head_cases():
    st = random_state(20, 3)
    t = st.live_tables()
    mask = jtt.mask_table(8)
    rng = np.random.default_rng(8)
    small = random_state(24, 9)
    s = small.live_tables()
    tgt5 = jtt.eval_lut(0xB4, jtt.eval_lut(0x2D, s[0], s[3], s[5]), s[6], s[7])
    des = random_state(14, 5, n_in=6)
    from sboxgates_tpu.utils.sbox import load_sbox

    sbox, _ = load_sbox(os.path.join(os.path.dirname(__file__), "data", "des_s1.txt"))
    return [
        ("existing", st, t[13].copy(), mask),
        ("complement", st, ~t[17], mask),
        ("pair", st, t[4] ^ t[15], mask),
        ("lut3", st, jtt.eval_lut(0x6B, t[2], t[9], t[18]), mask),
        ("lut5", small, tgt5, mask),
        ("none", st, rng.integers(0, 2**32, size=8, dtype=np.uint64).astype(np.uint32), mask),
        ("des", des, jtt.target_table(sbox, 0), jtt.mask_table(6)),
    ]


HEAD_CASES = _head_cases()


@pytest.mark.parametrize("case", HEAD_CASES, ids=[c[0] for c in HEAD_CASES])
@pytest.mark.parametrize("seed", [-1, 4242])
def test_lut_step_stream_matches(case, seed):
    _, st, target, mask = case
    g = st.num_gates
    b = jctx.bucket_size(g)
    tabs = padded(st, b)
    i, j = np.triu_indices(b, k=1)
    combos = np.stack([i, j], axis=1).astype(np.int32)
    ptab, _ = jctx._build_pair_table(jbf.create_avail_gates(jbf.DEFAULT_AVAILABLE))
    _, w_tab, m_tab = jsw.lut5_split_tables()
    total3, total5 = jcomb.n_choose_k(g, 3), jcomb.n_choose_k(g, 5)
    has5 = jctx.lut_head_has5(g)
    chunk3 = jctx.pick_chunk(max(total3, 1), jctx.STREAM_CHUNK[3])
    chunk5 = jctx.pick_chunk(max(total5, 1), jctx.STREAM_CHUNK[5]) if has5 else 1024
    excl = excl_np([2])
    want = np.asarray(jsw.lut_step_stream(
        jnp.asarray(tabs), jnp.arange(b) < g, jnp.asarray(combos),
        jnp.asarray((combos < g).all(axis=1)), jnp.asarray(jsw.binom_table()), g,
        jnp.asarray(target), jnp.asarray(mask), jnp.asarray(excl), total3, total5,
        jnp.asarray(ptab), jnp.asarray(w_tab), jnp.asarray(m_tab), seed,
        chunk3=chunk3, chunk5=chunk5, has5=has5, solve_rows=1024,
    ))
    tcomb = torch.from_numpy(combos.astype(np.int64))
    got = tsw.lut_step_stream(
        T(tabs), torch.arange(b) < g, tcomb, (tcomb < g).all(dim=1),
        tsw.binom_device(CPU), g, T(target), T(mask), Ti(excl), total3, total5,
        torch.from_numpy(ptab.astype(np.int64)), T(w_tab), T(m_tab), seed,
        chunk3=chunk3, chunk5=chunk5, has5=has5, solve_rows=1024,
    )
    np.testing.assert_array_equal(got, want)


def test_lut_step_cases_cover_every_step():
    steps = set()
    for _, st, target, mask in HEAD_CASES:
        ctx = tctx.SearchContext(tctx.Options(seed=1, lut_graph=True, device="cpu"))
        steps.add(int(ctx.lut_step(st, target, mask, [])[0]))
    assert {0, 1, 2, 3, 4, 5} <= steps


@pytest.mark.parametrize("seed", [-1, 99])
def test_match_scan_matches(seed):
    st = random_state(30, 4)
    tabs = padded(st)
    valid = np.arange(64) < 30
    for target in (tabs[7], ~tabs[21], tabs[3] ^ tabs[4]):
        want = np.asarray(jsw.match_scan(
            jnp.asarray(tabs), jnp.asarray(valid), jnp.asarray(target),
            jnp.asarray(jtt.mask_table(8)), seed,
        ))
        got = tsw.match_scan(
            T(tabs), torch.from_numpy(valid), T(target), T(jtt.mask_table(8)), seed
        )
        np.testing.assert_array_equal(got, want)


# -- streams ---------------------------------------------------------------


def _stream_case(seed=0):
    st, target, mask = build_planted_lut5_small(24)
    return st, padded(st), target, mask


@pytest.mark.parametrize("seed", [-1, 7, 2**31 - 1])
def test_lut3_stream_matches(seed):
    st = random_state(30, 6)
    t = st.live_tables()
    tabs = padded(st)
    g = 30
    total = jcomb.n_choose_k(g, 3)
    for target in (jtt.eval_lut(0xE8, t[20], t[25], t[29]),
                   np.random.default_rng(seed & 0xFF).integers(0, 2**32, 8, dtype=np.uint64).astype(np.uint32)):
        for start, chunk in ((0, 1024), (1500, 1024), (0, 1 << 15)):
            want = np.asarray(jsw.lut3_stream(
                jnp.asarray(tabs), jnp.asarray(jsw.binom_table()), g,
                jnp.asarray(target), jnp.asarray(jtt.mask_table(8)),
                jnp.asarray(excl_np()), start, total, seed, chunk=chunk,
            ))
            got = tsw.lut3_stream(
                T(tabs), tsw.binom_device(CPU), g, T(target),
                T(jtt.mask_table(8)), Ti(excl_np()), start, total, seed, chunk=chunk,
            )
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [-1, 31337])
@pytest.mark.parametrize("solve_rows", [1024, 4])
def test_lut5_stream_matches(seed, solve_rows):
    st, tabs, target, mask = _stream_case()
    g = st.num_gates
    total = jcomb.n_choose_k(g, 5)
    _, w_tab, m_tab = jsw.lut5_split_tables()
    for excl, start in ((excl_np(), 0), (excl_np([9]), 0), (excl_np(), 20000)):
        want = np.asarray(jsw.lut5_stream(
            jnp.asarray(tabs), jnp.asarray(jsw.binom_table()), g,
            jnp.asarray(target), jnp.asarray(mask), jnp.asarray(excl), start,
            total, jnp.asarray(w_tab), jnp.asarray(m_tab), seed, chunk=1024,
            solve_rows=solve_rows,
        ))
        got = tsw.lut5_stream(
            T(tabs), tsw.binom_device(CPU), g, T(target), T(mask), Ti(excl),
            start, total, T(w_tab), T(m_tab), seed, chunk=1024,
            solve_rows=solve_rows,
        )
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("k", [5, 7])
def test_feasible_stream_matches(k):
    if k == 5:
        st, tabs, target, mask = _stream_case()
    else:
        st, target, mask = build_planted_lut7(22)
        tabs = padded(st)
    g = st.num_gates
    total = jcomb.n_choose_k(g, k)
    chunk = 1024 if k == 5 else 1 << 15
    for start in (0, 3 * chunk):
        want = jsw.feasible_stream(
            jnp.asarray(tabs), jnp.asarray(jsw.binom_table()), g,
            jnp.asarray(target), jnp.asarray(mask), jnp.asarray(excl_np([3])),
            start, total, k=k, chunk=chunk,
        )
        got = tsw.feasible_stream(
            T(tabs), tsw.binom_device(CPU), g, T(target), T(mask),
            Ti(excl_np([3])), start, total, k=k, chunk=chunk,
        )
        np.testing.assert_array_equal(got[0], np.asarray(want[0]))
        assert got[0][0] == 1
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        for a, b in zip(got[2:], want[2:]):
            np.testing.assert_array_equal(a.numpy().view(np.uint32), np.asarray(b))


@pytest.mark.parametrize("k,start", [(5, 0), (5, 40 * 1024), (7, 0)])
def test_feasible_stream_wide_matches(k, start):
    if k == 5:
        st, tabs, target, mask = _stream_case()
        chunk = 1024
    else:
        st, target, mask = build_planted_lut7(22)
        tabs = padded(st)
        chunk = 1 << 15
    g = st.num_gates
    total = jcomb.n_choose_k(g, k)
    blo, bhi = jsw.binom_table_wide()
    want = jsw.feasible_stream_wide(
        jnp.asarray(tabs), jnp.asarray(blo), jnp.asarray(bhi), g,
        jnp.asarray(target), jnp.asarray(mask), jnp.asarray(excl_np()),
        np.uint32(start & 0xFFFFFFFF), np.uint32(start >> 32),
        np.uint32(total & 0xFFFFFFFF), np.uint32(total >> 32), k=k, chunk=chunk,
    )
    got = tsw.feasible_stream_wide(
        T(tabs), tsw.binom_wide_device(CPU), g, T(target), T(mask),
        Ti(excl_np()), start, total, k=k, chunk=chunk,
    )
    np.testing.assert_array_equal(got[0], np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    for a, b in zip(got[2:], want[2:]):
        np.testing.assert_array_equal(a.numpy().view(np.uint32), np.asarray(b))


def test_lut5_filter_matches():
    st, tabs, target, mask = _stream_case()
    rng = np.random.default_rng(1)
    combos = jcomb.unrank_combinations(
        rng.integers(0, jcomb.n_choose_k(24, 5), 2048), 24, 5
    )
    valid = rng.random(2048) < 0.9
    want = jsw.lut5_filter(
        jnp.asarray(tabs), jnp.asarray(combos), jnp.asarray(valid),
        jnp.asarray(target), jnp.asarray(mask),
    )
    got = tsw.lut5_filter(
        T(tabs), torch.from_numpy(combos), torch.from_numpy(valid), T(target), T(mask)
    )
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    for a, b in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(a.numpy().view(np.uint32), np.asarray(b))


@pytest.mark.parametrize("k", [5, 7])
def test_lut_filter_matches(k):
    st, tabs, target, mask = _stream_case()
    rng = np.random.default_rng(k)
    combos = jcomb.unrank_combinations(
        rng.integers(0, jcomb.n_choose_k(24, k), 1024), 24, k
    )
    valid = rng.random(1024) < 0.9
    want = jsw.lut_filter(
        jnp.asarray(tabs), jnp.asarray(combos), jnp.asarray(valid),
        jnp.asarray(target), jnp.asarray(mask),
    )
    got = tsw.lut_filter(
        T(tabs), torch.from_numpy(combos), torch.from_numpy(valid), T(target), T(mask)
    )
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    assert np.asarray(want[0]).any()
    for a, b in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(a.numpy().view(np.uint32), np.asarray(b))


# -- solvers ---------------------------------------------------------------


def _feasible_rows(st, target, mask, k, cap, around=None):
    """Up to ``cap`` feasible rows of the chunk holding rank ``around``
    (the first feasible chunk when None), centred on that rank."""
    g = st.num_gates
    total = jcomb.n_choose_k(g, k)
    chunk = 1 << 15
    start = 0 if around is None else (around // chunk) * chunk
    v, feas, r1, r0 = jsw.feasible_stream(
        jnp.asarray(padded(st)), jnp.asarray(jsw.binom_table()), g,
        jnp.asarray(target), jnp.asarray(mask), jnp.asarray(excl_np()), start,
        total, k=k, chunk=chunk,
    )
    rows = np.nonzero(np.asarray(feas))[0]
    if around is not None:
        assert int(v[1]) == start
        mid = int(np.searchsorted(rows, around - start))
        rows = rows[max(0, mid - cap // 2):][:cap]
    else:
        rows = rows[:cap]
    return np.asarray(r1)[rows], np.asarray(r0)[rows]


@pytest.mark.parametrize("seed", [-1, 5, 2**30])
def test_lut5_solve_matches(seed):
    st, _, target, mask = _stream_case()
    r1, r0 = _feasible_rows(st, target, mask, 5, 200)
    _, w_tab, m_tab = jsw.lut5_split_tables()
    for n in (len(r1), 1):
        p1 = np.concatenate([r1[:n], np.full(256 - n, 0xFFFFFFFF, np.uint32)])
        p0 = np.concatenate([r0[:n], np.full(256 - n, 0xFFFFFFFF, np.uint32)])
        want = np.asarray(jsw.lut5_solve(
            jnp.asarray(p1), jnp.asarray(p0), jnp.asarray(w_tab), jnp.asarray(m_tab), seed
        ))
        got = tsw.lut5_solve(T(p1), T(p0), T(w_tab), T(m_tab), seed)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [-1, 77])
def test_lut7_solve_matches(seed):
    st, target, mask = build_planted_lut7(22)
    planted = jcomb.combination_rank(sorted((9, 12, 17, 10, 15, 21, 19)), 22)
    r1, r0 = _feasible_rows(st, target, mask, 7, 256, around=planted)
    assert len(r1) > 1
    idx_tab, pp_tab = jsw.lut7_pair_tables()
    p1 = np.concatenate([r1, np.full((256 - len(r1), 4), 0xFFFFFFFF, np.uint32)])
    p0 = np.concatenate([r0, np.full((256 - len(r0), 4), 0xFFFFFFFF, np.uint32)])
    want = np.asarray(jsw.lut7_solve(
        jnp.asarray(p1), jnp.asarray(p0), jnp.asarray(idx_tab),
        jnp.asarray(pp_tab), seed,
    ))
    got = tsw.lut7_solve(
        T(p1), T(p0), torch.from_numpy(idx_tab.astype(np.int64)),
        torch.from_numpy(pp_tab), seed,
    )
    np.testing.assert_array_equal(got, want)
    assert want[0] == 1


def _planted_lut7_small(g=17):
    st = random_state(g, 21)
    t = st.live_tables()
    o = jtt.eval_lut(0x96, t[9], t[12], t[15])
    m = jtt.eval_lut(0xE8, t[10], t[13], t[16])
    return st, jtt.eval_lut(0xCA, o, m, t[11]), jtt.mask_table(8)


@pytest.mark.parametrize("seed", [-1, 1234])
def test_lut7_step_stream_matches(seed):
    st, target, mask = _planted_lut7_small()
    g = st.num_gates
    total7 = jcomb.n_choose_k(g, 7)
    chunk7 = jctx.pick_chunk(total7, jctx.STREAM_CHUNK[7])
    idx_tab, pp_tab = jsw.lut7_pair_tables()
    tabs = padded(st)
    want = np.asarray(jsw.lut7_step_stream(
        jnp.asarray(tabs), jnp.asarray(jsw.binom_table()), g, jnp.asarray(target),
        jnp.asarray(mask), jnp.asarray(excl_np()), total7, jnp.asarray(idx_tab),
        jnp.asarray(pp_tab), seed, chunk7=chunk7, solve7=256,
    ))
    got = tsw.lut7_step_stream(
        T(tabs), tsw.binom_device(CPU), g, T(target), T(mask), Ti(excl_np()),
        total7, torch.from_numpy(idx_tab.astype(np.int64)),
        torch.from_numpy(pp_tab), seed, chunk7=chunk7, solve7=256,
    )
    np.testing.assert_array_equal(got, want)
    assert want[0] in (1, 2)


# -- the pivot sweep -------------------------------------------------------


def _pivot_ops(tl, th, excl=(), backend="packed"):
    st, target, mask = build_planted_lut5()
    g = st.num_gates
    b = jctx.bucket_size(g)
    tabs = padded(st, b)
    jops = JPivotOperands(g, tl, th, list(excl), jnp.asarray(tabs), target, mask, jnp.asarray)
    tops = TPivotOperands(g, tl, th, list(excl), T(tabs), target, mask, CPU,
                          backend=backend)
    return jops, tops


def test_pivot_pair_cells_match():
    jops, tops = _pivot_ops(256, 512)
    p2 = jops.lows.shape[0]
    for a, b in zip((tops.lc1, tops.lc0, tops.hc), (jops.lc1, jops.lc0, jops.hc)):
        np.testing.assert_array_equal(
            a[:, :p2].numpy().view(np.uint32), np.asarray(b)[:, :p2]
        )
    np.testing.assert_array_equal(tops.descs, jops.descs)


@pytest.mark.parametrize("seed", [-1, 2024])
@pytest.mark.parametrize("backend", ["packed", "pre"])
def test_lut5_pivot_stream_matches(seed, backend):
    """The planted G = 50 state, just past the pivot threshold."""
    tl, th = 256, 512
    jops, tops = _pivot_ops(tl, th, backend=backend)
    _, w_tab, m_tab = jsw.lut5_split_tables()
    want = np.asarray(jsw.lut5_pivot_stream(
        *jops.stream_args(), 0, jops.t_real, jnp.asarray(w_tab),
        jnp.asarray(m_tab), seed, tl=tl, th=th,
    ))
    got = tsw.lut5_pivot_stream(
        *tops.stream_args(), 0, tops.t_real, T(w_tab), T(m_tab), seed,
        tl=tl, th=th, backend=backend,
    )
    np.testing.assert_array_equal(got, want)
    assert want[0] == 1


def test_lut5_pivot_stream_overflow_and_tile_match():
    """A tiny solver-row budget forces status 2; the resume tile and the
    re-drive tile's words match too."""
    tl, th = 256, 512
    jops, tops = _pivot_ops(tl, th, excl=(5,))
    _, w_tab, m_tab = jsw.lut5_split_tables()
    start = int(np.searchsorted(jops.descs[:, 0], 24))
    want = np.asarray(jsw.lut5_pivot_stream(
        *jops.stream_args(), start, jops.t_real, jnp.asarray(w_tab),
        jnp.asarray(m_tab), 99, tl=tl, th=th, solve_rows=1,
    ))
    got = tsw.lut5_pivot_stream(
        *tops.stream_args(), start, tops.t_real, T(w_tab), T(m_tab), 99,
        tl=tl, th=th, solve_rows=1,
    )
    np.testing.assert_array_equal(got, want)
    t = int(want[8]) - 1
    jf = jsw.lut5_pivot_tile(*jops.stream_args(), t, tl=tl, th=th)
    tf = tsw.lut5_pivot_tile(*tops.stream_args(), t, tl=tl, th=th)
    np.testing.assert_array_equal(tf[0].numpy(), np.asarray(jf[0]))
    for a, b in zip(tf[1:], jf[1:]):
        np.testing.assert_array_equal(a.numpy().view(np.uint32), np.asarray(b))
