"""The port's spectral candidate ordering against the JAX package's.

Held bit for bit on the CPU, on numpy-seeded inputs: the Walsh machinery of
``ops/spectral.py`` (the Walsh-score kernel K5's plain version against the
XLA path and the Pallas kernel in interpret mode, on real and on random
spectra), the per-chunk score stream, the tier segments, the three ordered
drivers on the planted states of ``tests/planted.py`` (the 5-LUT stream
chunk shrunk to 1024 as in ``tests/test_order.py``).  The CLI's
``--candidate-order`` runs are in tests/test_torch_spectral_cli.py.  K5
itself is held against the plain version on a
card in tests/test_torch_cuda.py and chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from planted import build_planted_lut5_small, build_planted_lut7
from sboxgates_tpu.ops import combinatorics as jcomb
from sboxgates_tpu.ops import spectral as jspec
from sboxgates_tpu.ops import sweeps as jsw
from sboxgates_tpu.search import context as jctx
from sboxgates_tpu.search import lut as jlut

from sboxgates_tpu_torch.graph.state import State
from sboxgates_tpu_torch.ops import combinatorics as tcomb
from sboxgates_tpu_torch.ops import spectral as tspec
from sboxgates_tpu_torch.ops import sweeps as tsw
from sboxgates_tpu_torch.search import context as tctx
from sboxgates_tpu_torch.search import lut as tlut

# The suite runs several worker processes on shared cores; torch's
# intra-op thread pool in each of them oversubscribes the host.
torch.set_num_threads(1)


def _words(rng, *shape):
    """Random uint32 words, every other one with bit 31 set."""
    w = rng.integers(0, 2**32, size=shape, dtype=np.uint64).astype(np.uint32)
    w.reshape(-1)[::2] |= np.uint32(0x80000000)
    return w


def _t(a):
    """uint32 (or int32) numpy -> int32 CPU tensor (bit patterns)."""
    a = np.ascontiguousarray(a)
    return torch.from_numpy(a.view(np.int32).copy() if a.dtype == np.uint32 else a.copy())


def _port_state(jst):
    """The JAX package's state as the port's (same gates and tables)."""
    gates = [(g.type, g.in1, g.in2, g.in3, g.function) for g in jst.gates]
    return State.from_numpy(gates, jst.live_tables(), jst.outputs,
                            max_gates=jst.max_gates,
                            max_sat_metric=jst.max_sat_metric,
                            sat_metric=jst.sat_metric)


# -- Walsh machinery -------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1])
def test_unpack_wht_and_target_spectrum_match(seed):
    rng = np.random.default_rng(seed)
    words = _words(rng, 5, 8)
    np.testing.assert_array_equal(
        tspec.unpack_signs(_t(words)).numpy(),
        np.asarray(jspec.unpack_signs(jnp.asarray(words))),
    )
    x = rng.integers(-200, 200, size=(3, 256)).astype(np.int32)
    np.testing.assert_array_equal(
        tspec.wht(torch.from_numpy(x)).numpy(), np.asarray(jspec.wht(jnp.asarray(x)))
    )
    target, mask = _words(rng, 8), _words(rng, 8)
    np.testing.assert_array_equal(
        tspec.target_spectrum(_t(target), _t(mask)).numpy(),
        np.asarray(jspec.target_spectrum(jnp.asarray(target), jnp.asarray(mask))),
    )


@pytest.mark.parametrize("b", [64, 512])
@pytest.mark.parametrize("spectrum", ["target", "random", "extreme"])
def test_gate_scores_plain_matches_xla_and_pallas(b, spectrum):
    """K5's plain version (one transform of the spectrum, then a masked sum
    per gate) equals ``_gate_scores_xla`` and the Pallas kernel (interpret
    mode) word for word; a random int32 spectrum, and an extreme one of
    entries +-(2^31 - 1), exercise the wrapping sums and the floor division
    of negative sums."""
    rng = np.random.default_rng(b)
    tables = _words(rng, b, 8)
    if spectrum == "target":
        spec = np.array(jspec.target_spectrum(
            jnp.asarray(_words(rng, 8)), jnp.asarray(_words(rng, 8))))
    elif spectrum == "random":
        spec = rng.integers(-2**31, 2**31, size=256, dtype=np.int64).astype(np.int32)
    else:
        spec = (rng.choice([-1, 1], size=256) * (2**31 - 1)).astype(np.int32)
    xla = np.asarray(jspec._gate_scores_xla(jnp.asarray(tables), jnp.asarray(spec)))
    pal = np.asarray(jspec._gate_scores_pallas(
        jnp.asarray(tables), jnp.asarray(spec), interpret=True))
    got = tspec.gate_scores_plain(_t(tables), torch.from_numpy(spec)).numpy()
    np.testing.assert_array_equal(got, xla)
    np.testing.assert_array_equal(got, pal)
    before = tspec.launches
    np.testing.assert_array_equal(
        tspec.gate_scores_kernel(_t(tables), torch.from_numpy(spec)).numpy(), xla
    )
    assert tspec.launches == before  # a CPU tensor runs the plain version
    if spectrum == "random":
        assert (xla > 256).any()
    if spectrum != "target":
        # The exact correlations leave int32 (the sums wrap), and some
        # wrapped ones are negative and not multiples of 256 (the division
        # floors).
        x = np.asarray(jspec.wht(jspec.unpack_signs(jnp.asarray(tables)))).astype(np.int64)
        exact = x @ spec.astype(np.int64)
        wrapped = (exact + 2**31) % 2**32 - 2**31
        assert (np.abs(exact) >= 2**31).any()
        assert ((wrapped < 0) & (wrapped % 256 != 0)).any()


def test_gate_scores_match_jax():
    rng = np.random.default_rng(7)
    tables, target, mask = _words(rng, 64, 8), _words(rng, 8), _words(rng, 8)
    np.testing.assert_array_equal(
        tspec.gate_scores(_t(tables), _t(target), _t(mask)).numpy(),
        np.asarray(jspec.gate_scores(
            jnp.asarray(tables), jnp.asarray(target), jnp.asarray(mask))),
    )


@pytest.mark.parametrize("k", [2, 3, 5])
def test_cell_counts_and_span_scores_match(k):
    rng = np.random.default_rng(10 + k)
    tabs = _words(rng, k, 8, 33)
    target, mask = _words(rng, 8), _words(rng, 8)
    jargs = (jnp.asarray(tabs), jnp.asarray(target), jnp.asarray(mask))
    targs = (_t(tabs), _t(target), _t(mask))
    np.testing.assert_array_equal(
        tspec.cell_counts(*targs).numpy(), np.asarray(jspec.cell_counts(*jargs))
    )
    np.testing.assert_array_equal(
        tspec.span_scores(*targs).numpy(), np.asarray(jspec.span_scores(*jargs))
    )


def test_quantize_tiers_matches():
    rng = np.random.default_rng(4)
    for s in (rng.integers(-1, 1200, size=37), np.full(5, 9)):
        np.testing.assert_array_equal(
            tspec.quantize_tiers(s), jspec.quantize_tiers(s)
        )


# -- score stream and tier segments ------------------------------------------


@pytest.mark.parametrize("k,g,chunk,n_excl", [
    (5, 24, 1024, 0), (5, 24, 1024, 2), (7, 20, 4096, 0), (7, 20, 4096, 3),
])
@pytest.mark.parametrize("batch", ["whole", "three_chunks"])
def test_spectral_score_stream_matches(k, g, chunk, n_excl, batch, monkeypatch):
    if batch == "three_chunks":
        monkeypatch.setattr(tsw, "SCORE_BATCH_RANKS", 3 * chunk)
    rng = np.random.default_rng(k * 100 + n_excl)
    tables = np.zeros((64, 8), np.uint32)
    tables[:g] = _words(rng, g, 8)
    target, mask = _words(rng, 8), _words(rng, 8)
    excl = np.full(8, -1, np.int32)
    excl[:n_excl] = rng.choice(g, size=n_excl, replace=False)
    total = jcomb.n_choose_k(g, k)
    n_pad = 8
    while n_pad < -(-total // chunk):
        n_pad *= 2
    n_pad *= 2  # chunks past the space come back -1
    want = np.asarray(jsw.spectral_score_stream(
        jnp.asarray(tables), jnp.asarray(jsw.binom_table()), g,
        jnp.asarray(target), jnp.asarray(mask), jnp.asarray(excl), total,
        k=k, chunk=chunk, n_chunks=n_pad,
    ))
    got = tsw.spectral_score_stream(
        _t(tables), tsw.binom_device("cpu"), g, _t(target), _t(mask),
        torch.from_numpy(excl), total, k=k, chunk=chunk, n_chunks=n_pad,
    )
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    n_real = -(-total // chunk)
    assert (want[n_real:] == -1).all() and (want[:n_real] >= 0).any()


def test_tier_segments_match():
    rng = np.random.default_rng(3)
    for _ in range(40):
        n = int(rng.integers(1, 40))
        scores = rng.integers(-1, 1200, size=n + 3)
        assert tcomb.tier_segments(scores, n) == jcomb.tier_segments(scores, n)
    assert tcomb.tier_segments(np.full(7, 42), 7) == [(0, 7, 0)]
    assert tcomb.tier_segments([], 0) == []
    with pytest.raises(AssertionError):
        tcomb.tier_segments([1, 2], 3)


# -- ordered drivers -----------------------------------------------------------


@pytest.fixture
def small_chunks(monkeypatch):
    """The 5-LUT stream chunk at 1024 in both packages, so the planted
    G = 24 space (C(24,5) = 42504) spans many chunks."""
    monkeypatch.setitem(jctx.STREAM_CHUNK, 5, 1024)
    monkeypatch.setitem(tctx.STREAM_CHUNK, 5, 1024)


def _contexts(order, seed=7):
    jc = jctx.SearchContext(jctx.Options(seed=seed, candidate_order=order))
    tc = tctx.SearchContext(tctx.Options(seed=seed, lut_graph=True, device="cpu",
                                         candidate_order=order))
    return jc, tc


STAT_KEYS = ("lut5_candidates", "order_tier_dispatches", "order_first_hit_tier")


def _jstat(ctx, key):
    """A JAX context's counter (unset counters read 0, as the port's do)."""
    try:
        return ctx.stats[key]
    except KeyError:
        return 0


@pytest.mark.parametrize("order", ["lex", "spectral"])
def test_lut5_stream_driver_same_hit(order, small_chunks):
    """The 5-LUT stream driver: the same first hit, candidate count and
    tier statistics as the JAX package's, for both orders."""
    jst, target, mask = build_planted_lut5_small()
    jc, tc = _contexts(order)
    want = jlut.lut5_search(jc, jst, target, mask, [])
    got = tlut.lut5_search(tc, _port_state(jst), target, mask, [])
    assert want is not None and got is not None
    assert tuple(got["gates"]) == tuple(want["gates"])
    assert (got["func_outer"], got["func_inner"]) == (
        want["func_outer"], want["func_inner"])
    for key in STAT_KEYS:
        assert tc.stats[key] == _jstat(jc, key), key
    if order == "spectral":
        assert tc.stats["order_tier_dispatches"] >= 1


def test_lut5_stream_lex_and_spectral_exhaust_identically(small_chunks):
    """An unrealizable target sweeps the whole space under both orders."""
    jst, _, mask = build_planted_lut5_small()
    target = np.random.default_rng(99).integers(0, 2**32, size=8, dtype=np.uint32)
    counts = {}
    for order in ("lex", "spectral"):
        _, tc = _contexts(order)
        assert tlut.lut5_search(tc, _port_state(jst), target, mask, []) is None
        counts[order] = tc.stats["lut5_candidates"]
    assert counts["lex"] == counts["spectral"] == tcomb.n_choose_k(24, 5)


def test_lut7_stage_a_spectral_matches_jax_and_lex_hit_set():
    """7-LUT stage A under spectral order collects the JAX package's hits
    in its order, and the same hit set as the lexicographic sweep
    (C(22,7) = 170544 spans six stream chunks)."""
    jst, target, mask = build_planted_lut7(22)
    tst = _port_state(jst)
    sets = {}
    for order in ("lex", "spectral"):
        jc, tc = _contexts(order)
        got = tlut._lut7_collect_hits(tc, tst, target, mask, [])
        assert 0 < len(got[0]) < tctx.LUT7_CAP
        if order == "spectral":
            want = jlut._lut7_collect_hits(jc, jst, target, mask, [])
            for a, b in zip(got, want):
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
            for key in ("lut7_candidates", "order_tier_dispatches",
                        "order_first_hit_tier"):
                assert tc.stats[key] == _jstat(jc, key), key
            assert tc.stats["order_tier_dispatches"] >= 2
        sets[order] = {
            (tuple(int(x) for x in c), a.tobytes(), b.tobytes())
            for c, a, b in zip(*got)
        }
    assert sets["lex"] == sets["spectral"]
