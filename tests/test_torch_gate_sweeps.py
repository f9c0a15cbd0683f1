"""The gate-mode sweeps of the port against their jitted JAX counterparts.

``tuple_match_sweep``, ``match_stream`` and ``gate_step_stream`` get the
same inputs, built with numpy from a seed (random AND/OR/XOR/NOT gate
states, the construction of tests/test_native.py), in both packages; the
port runs on the CPU.  Tolerance: exact equality — all arithmetic is
integer or bitwise.  ``gate_step_stream`` verdicts are bit-identical on a
hit; on a miss the step and the triple stream's examined count agree (the
JAX kernel's payload is then its last chunk's argmax, unspecified).
"""

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

from sboxgates_tpu_torch.core import boolfunc as tbf
from sboxgates_tpu_torch.ops import sweeps as tsw
from sboxgates_tpu_torch.search import context as tctx

# The suite runs several worker processes on shared cores; torch's
# intra-op thread pool in each of them oversubscribes the host.
torch.set_num_threads(1)

CPU = torch.device("cpu")


def T(a):
    return tsw.as_words(a, CPU)


def rand_gate_state(rng, num_inputs, extra):
    """tests/test_native.py's random gate state: AND/OR/XOR gates and, one
    time in four, a NOT."""
    st = State.init_inputs(num_inputs)
    while st.num_gates < num_inputs + extra:
        a, b = rng.choice(st.num_gates, size=2, replace=False)
        if rng.integers(0, 4) == 0:
            st.add_not_gate(int(a), GATES)
        else:
            st.add_gate(
                int(rng.choice([jbf.AND, jbf.OR, jbf.XOR])), int(a), int(b), GATES
            )
    return st


def _tables(try_nots, bitfield=jbf.DEFAULT_AVAILABLE):
    """(pair, not, triple) match tables of the JAX package."""
    avail = jbf.create_avail_gates(bitfield)
    nots = jbf.get_not_functions(avail) if try_nots else []
    pair, _ = jctx._build_pair_table(avail)
    not_t = jctx._build_pair_table(nots)[0] if nots else None
    tri, _ = jctx._build_triple_table(jbf.get_3_input_function_list(avail, try_nots))
    return pair, not_t, tri


def _cases():
    """(name, state, target, mask): targets that stop the node head at
    each step, in both pair buckets (64 and 512 rows)."""
    rng = np.random.default_rng(99)
    out = []
    for bucket_g in (14, 70):
        st = rand_gate_state(rng, 6, bucket_g - 6)
        t = st.live_tables()
        mask = np.asarray(jtt.mask_table(6))
        half = mask & ~t[2]
        out += [
            (f"g{bucket_g}_existing", st, t[bucket_g - 3] & mask, mask),
            (f"g{bucket_g}_complement", st, ~t[bucket_g - 5] & mask, mask),
            (f"g{bucket_g}_pair", st, (t[1] ^ t[4]) & mask, mask),
            (f"g{bucket_g}_not_pair", st,
             np.asarray(jtt.eval_gate2(jbf.NAND, t[0], t[3])) & mask, mask),
            (f"g{bucket_g}_triple", st, ((t[0] & t[1]) ^ t[5]) & mask, mask),
            (f"g{bucket_g}_random", st,
             rng.integers(0, 2**32, size=8, dtype=np.uint64).astype(np.uint32) & mask,
             mask),
            (f"g{bucket_g}_half_mask", st,
             rng.integers(0, 2**32, size=8, dtype=np.uint64).astype(np.uint32) & half,
             half),
        ]
    return out


CASES = _cases()


def _pair_operands(st):
    g = st.num_gates
    b = jctx.bucket_size(g)
    tabs = np.zeros((b, 8), np.uint32)
    tabs[:g] = st.live_tables()
    i, j = np.triu_indices(b, k=1)
    combos = np.stack([i, j], axis=1).astype(np.int32)
    return g, b, tabs, combos, (combos < g).all(axis=1)


def test_match_tables_match():
    """The port builds the JAX package's match tables and entries."""
    for try_nots in (False, True):
        for bitfield in (jbf.DEFAULT_AVAILABLE, 150, 0xFFFF):
            avail_j = jbf.create_avail_gates(bitfield)
            avail_t = tbf.create_avail_gates(bitfield)
            for funs_j, funs_t, build_j, build_t in (
                (avail_j, avail_t, jctx._build_pair_table, tctx._build_pair_table),
                (jbf.get_not_functions(avail_j), tbf.get_not_functions(avail_t),
                 jctx._build_pair_table, tctx._build_pair_table),
                (jbf.get_3_input_function_list(avail_j, try_nots),
                 tbf.get_3_input_function_list(avail_t, try_nots),
                 jctx._build_triple_table, tctx._build_triple_table),
            ):
                if not funs_j:
                    continue
                wt, we = build_j(funs_j)
                gt, ge = build_t(funs_t)
                np.testing.assert_array_equal(gt, wt)
                assert [(e.fun.fun, e.fun.fun1, e.fun.fun2, e.perm) for e in ge] == [
                    (e.fun.fun, e.fun.fun1, e.fun.fun2, e.perm) for e in we
                ]


@pytest.mark.parametrize("case", CASES[:7:2] + CASES[7::3], ids=lambda c: c[0])
@pytest.mark.parametrize("seed", [-1, 4242])
def test_tuple_match_sweep_matches(case, seed):
    _, st, target, mask = case
    g, b, tabs, combos, valid = _pair_operands(st)
    pair, not_t, tri = _tables(True)
    for table in (pair, not_t):
        want = np.asarray(jsw.tuple_match_sweep(
            jnp.asarray(tabs), jnp.asarray(combos), jnp.asarray(valid),
            jnp.asarray(target), jnp.asarray(mask), jnp.asarray(table), seed,
            num_cells=4,
        ))
        got = tsw.tuple_match_sweep(
            T(tabs), torch.from_numpy(combos.astype(np.int64)),
            torch.from_numpy(valid), T(target), T(mask),
            torch.from_numpy(table.astype(np.int64)), seed, num_cells=4,
        )
        np.testing.assert_array_equal(got, want)
    # Triples as an explicit combination list (num_cells 8).
    trip = jcomb.unrank_combinations(np.arange(jcomb.n_choose_k(g, 3)), g, 3)
    trip = trip.astype(np.int32)
    tvalid = np.ones(len(trip), bool)
    want = np.asarray(jsw.tuple_match_sweep(
        jnp.asarray(tabs), jnp.asarray(trip), jnp.asarray(tvalid),
        jnp.asarray(target), jnp.asarray(mask), jnp.asarray(tri), seed,
        num_cells=8,
    ))
    got = tsw.tuple_match_sweep(
        T(tabs), torch.from_numpy(trip.astype(np.int64)), torch.from_numpy(tvalid),
        T(target), T(mask), torch.from_numpy(tri.astype(np.int64)), seed,
        num_cells=8,
    )
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", [c for c in CASES if c[0].endswith(
    ("triple", "random", "half_mask"))], ids=lambda c: c[0])
@pytest.mark.parametrize("seed,chunk,start", [(-1, 1024, 0), (77, 1024, 1500),
                                              (2**31 - 1, 1 << 15, 0)])
def test_match_stream_matches(case, seed, chunk, start):
    """The triple stream: same first hit in chunk order, same examined
    count; on a miss the same last-chunk payload."""
    _, st, target, mask = case
    g = st.num_gates
    b = jctx.bucket_size(g)
    tabs = np.zeros((b, 8), np.uint32)
    tabs[:g] = st.live_tables()
    total = jcomb.n_choose_k(g, 3)
    _, _, tri = _tables(False)
    excl = np.full(8, -1, np.int32)
    want = np.asarray(jsw.match_stream(
        jnp.asarray(tabs), jnp.asarray(jsw.binom_table()), g, jnp.asarray(target),
        jnp.asarray(mask), jnp.asarray(excl), start, total, jnp.asarray(tri), seed,
        k=3, chunk=chunk, num_cells=8,
    ))
    got = tsw.match_stream(
        T(tabs), tsw.binom_device(CPU), g, T(target), T(mask),
        torch.from_numpy(excl), start, total,
        torch.from_numpy(tri.astype(np.int64)), seed,
        k=3, chunk=chunk, num_cells=8,
    )
    np.testing.assert_array_equal(got, want)


def _gate_step_pair(st, target, mask, seed, try_nots, chunk3=None):
    g, b, tabs, combos, valid = _pair_operands(st)
    pair, not_t, tri = _tables(try_nots)
    has_not = not_t is not None
    total3 = jcomb.n_choose_k(g, 3)
    if chunk3 is None:
        chunk3 = jctx.pick_chunk(max(total3, 1), jctx.STREAM_CHUNK[3])
    excl = np.full(8, -1, np.int32)
    want = np.asarray(jsw.gate_step_stream(
        jnp.asarray(tabs), jnp.arange(b) < g, jnp.asarray(combos),
        jnp.asarray(valid), jnp.asarray(jsw.binom_table()), g,
        jnp.asarray(target), jnp.asarray(mask), jnp.asarray(excl), total3,
        jnp.asarray(pair), jnp.asarray(not_t if has_not else pair),
        jnp.asarray(tri), seed, chunk3=chunk3, has_not=has_not, has_triple=True,
    ))
    tt_ = lambda t: torch.from_numpy(t.astype(np.int64))  # noqa: E731
    got = tsw.gate_step_stream(
        T(tabs), torch.arange(b) < g, tt_(combos), torch.from_numpy(valid),
        tsw.binom_device(CPU), g, T(target), T(mask), torch.from_numpy(excl),
        total3, tt_(pair), tt_(not_t if has_not else pair), tt_(tri), seed,
        chunk3=chunk3, has_not=has_not, has_triple=True,
    )
    return got, want


@pytest.mark.parametrize("case", CASES, ids=lambda c: c[0])
@pytest.mark.parametrize("seed", [-1, 4242])
@pytest.mark.parametrize("try_nots", [False, True])
def test_gate_step_stream_matches(case, seed, try_nots):
    _, st, target, mask = case
    got, want = _gate_step_pair(st, target, mask, seed, try_nots)
    assert got[0] == want[0]
    if want[0] == 0:
        assert got[3] == want[3]
    else:
        np.testing.assert_array_equal(got, want)


def test_gate_step_cases_cover_every_step():
    """The cases above reach every step of the verdict, NOT pairs with
    try-nots on, and a triple stream of several chunks."""
    steps = set()
    for _, st, target, mask in CASES:
        for try_nots in (False, True):
            got, _ = _gate_step_pair(st, target, mask, 4242, try_nots, chunk3=1024)
            steps.add(int(got[0]))
            if got[0] in (0, 5) and st.num_gates > 64:
                assert got[3] > 1024 or got[0] == 5
    assert steps == {0, 1, 2, 3, 4, 5}, steps
