"""The pivot sweep in windows of tiles against the JAX package's stream.

The port's ``lut5_pivot_stream`` sweeps its tiles in windows of K1 (packed
backend) or K2 (pre backend), 1, 2, 4, ... tiles up to a cap, one launch
each; the JAX package's sweeps every tile of a segment in one device loop,
``tile_batch`` tiles per step.  Both solve the tiles with a feasible
candidate in tile order, each with seed ``seed ^ tile``, so the verdict
must not depend on the backend, the window cap nor ``tile_batch``.  On the
CPU each window kernel runs its plain version, which is also held tile by
tile against the JAX package: K1's against ``lut5_pivot_tile``, K2's
against ``_pivot_tile_expanded_operands`` and ``pivot_constraints_pallas_pre``
in interpret mode.  Inputs: the planted G = 50 state of tests/planted.py
(its 5-LUT lies in tile 18 of 112 at 256 x 512 tiles).  Tolerance: exact
equality.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sboxgates_tpu.ops import sweeps as jsw
from sboxgates_tpu.search import context as jctx
from sboxgates_tpu.search.lut import PivotOperands as JPivotOperands

from sboxgates_tpu_torch.ops import combinatorics as tcomb
from sboxgates_tpu_torch.ops import pivot_tile
from sboxgates_tpu_torch.ops import sweeps as tsw
from sboxgates_tpu_torch.search.lut import ORDER_TIERS
from sboxgates_tpu_torch.search.lut import PivotOperands as TPivotOperands

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from planted import build_planted_lut5  # noqa: E402

torch.set_num_threads(1)

CPU = torch.device("cpu")
TL, TH = 256, 512
CAPS = [1, 3, 8]
#: The JAX package's tile batch held beside tile_batch=1.
JAX_BATCH = 4


def _w(a):
    return tsw.as_words(a, CPU)


_OPS = {}


def _ops(excl=(), backend="packed"):
    """(JAX, port) pivot operands of the planted G = 50 state, the port's
    built for ``backend``."""
    key = (excl, backend)
    if key not in _OPS:
        st, target, mask = build_planted_lut5()
        g = st.num_gates
        tabs = np.zeros((jctx.bucket_size(g), 8), np.uint32)
        tabs[:g] = st.live_tables()
        _OPS[key] = (
            JPivotOperands(g, TL, TH, list(excl), jnp.asarray(tabs), target, mask,
                           jnp.asarray),
            TPivotOperands(g, TL, TH, list(excl), _w(tabs), target, mask, CPU,
                           backend=backend),
            target, mask,
        )
    return _OPS[key]


def _split_tabs():
    _, w_tab, m_tab = jsw.lut5_split_tables()
    return w_tab, m_tab


def _jax_stream(jops, start, stop, seed, solve_rows, tile_batch):
    w_tab, m_tab = _split_tabs()
    return np.asarray(jsw.lut5_pivot_stream(
        *jops.stream_args(), start, stop, jnp.asarray(w_tab), jnp.asarray(m_tab),
        seed, tl=TL, th=TH, solve_rows=solve_rows, tile_batch=tile_batch,
    ))


def _port_stream(tops, start, stop, seed, solve_rows, backend):
    w_tab, m_tab = _split_tabs()
    return tsw.lut5_pivot_stream(
        *tops.stream_args(), start, stop, _w(w_tab), _w(m_tab), seed,
        tl=TL, th=TH, solve_rows=solve_rows, backend=backend,
    )


def _drive(stream, segments):
    """The pivot driver's walk over ``segments`` (search/lut.py): one
    stream per segment window, on to the next segment when it is exhausted,
    past an overflow tile, to the end at a hit.  Returns every verdict,
    each with the end of its range."""
    verdicts = []
    for lo, hi in segments:
        start = lo
        while start < hi:
            v = stream(start, hi)
            verdicts.append((hi, v.tolist()))
            if v[0] == 0:
                break
            if v[0] == 1:
                return verdicts
            start = int(v[8])
    return verdicts


def _spectral_segments(tops, target, mask):
    scores = tsw.spectral_gate_scores(tops.tables, _w(target), _w(mask)).numpy()
    return [
        (lo, hi) for lo, hi, _ in tcomb.tier_segments(
            scores[tops.descs[:, 0]], tops.t_real, ORDER_TIERS)
    ]


#: case -> (excluded gates, seed, solver rows, segments or None for one
#: (start, stop) range given by the lambda over t_real).
CASES = {
    # tiles 14-17 solve to status 0 before the hit at 18, which lies inside
    # a window for caps 3 and 8
    "hit_mid_window": ((), 2024, 64, lambda t: [(13, t)]),
    # exhausted: the range ends inside the window the schedule would take
    "t_end_in_window": ((), 2024, 64, lambda t: [(0, 17)]),
    # more feasible candidates than solver rows: status 2 at tile 11, then
    # the resume past it
    "overflow_in_window": ((), 99, 1, lambda t: [(0, t)]),
    # pivot 5 has no tiles, and every pair holding gate 5 is invalid
    "excluded_pivot": ((5,), -1, 64, lambda t: [(0, t)]),
    # the score tiers' segments, best first (search/lut.py's spectral walk)
    "spectral_segments": ((), 7, 64, None),
}

_JAX = {}


def _jax_verdicts(case, tile_batch):
    key = (case, tile_batch)
    if key not in _JAX:
        excl, seed, rows, segs = CASES[case]
        jops, tops, target, mask = _ops(excl)
        segments = (_spectral_segments(tops, target, mask) if segs is None
                    else segs(tops.t_real))
        _JAX[key] = _drive(
            lambda a, b: _jax_stream(jops, a, b, seed, rows, tile_batch), segments)
    return _JAX[key]


@pytest.mark.parametrize("backend", tsw.PIVOT_BACKENDS)
@pytest.mark.parametrize("cap", CAPS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_windowed_stream_matches_jax(case, cap, backend, monkeypatch):
    monkeypatch.setattr(tsw, "PIVOT_WINDOW_TILES", cap)
    excl, seed, rows, segs = CASES[case]
    _, tops, target, mask = _ops(excl, backend)
    segments = (_spectral_segments(tops, target, mask) if segs is None
                else segs(tops.t_real))
    got = _drive(lambda a, b: _port_stream(tops, a, b, seed, rows, backend),
                 segments)
    assert got == _jax_verdicts(case, 1)
    assert _read(got) == _read(_jax_verdicts(case, JAX_BATCH))


def _read(verdicts):
    """The fields of each verdict that depend on neither the window cap nor
    the JAX package's tile_batch: all nine of a hit or an overflow; the
    status of an exhausted range and its end.  At tile_batch > 1 the JAX
    package's exhausted verdict holds the solve of the first tile of its
    last batch in fields 1-7 (of the last tile at tile_batch=1), and that
    batch's start + tile_batch as next_tile, which can pass the range's
    end; no driver reads those fields of an exhausted range."""
    return [v if v[0] != 0 else [0, min(v[8], stop)] for stop, v in verdicts]


def test_jax_tile_batch_differs_only_in_unread_fields():
    """Why :func:`_read` exists: the JAX package's own verdicts at
    tile_batch=1 and tile_batch=4 differ in an exhausted segment of the
    spectral walk, and only there."""
    one = _jax_verdicts("spectral_segments", 1)
    four = _jax_verdicts("spectral_segments", JAX_BATCH)
    assert one != four
    assert _read(one) == _read(four)


def test_stream_cases_cover_their_verdicts():
    """The cases reach what their names say: a hit, an exhausted range, an
    overflow then a hit, and a multi-segment walk."""
    hit = _jax_verdicts("hit_mid_window", 1)
    assert hit[-1][1][0] == 1 and hit[-1][1][8] == 19
    exhausted = _jax_verdicts("t_end_in_window", 1)
    assert len(exhausted) == 1 and exhausted[0][1][0] == 0
    assert exhausted[0][1][8] == 17
    statuses = [v[0] for _, v in _jax_verdicts("overflow_in_window", 1)]
    assert statuses[0] == 2 and statuses[-1] in (1, 2)
    assert len(_jax_verdicts("spectral_segments", 1)) > 1


@pytest.mark.parametrize("n", [1, 3, 8])
def test_window_plain_matches_jax_tiles(n):
    """The window kernel's plain version: each tile of a window that starts
    at tile 9 and ends one tile past ``t_end`` against the JAX package's
    ``lut5_pivot_tile``, with the pivot-5 exclusion."""
    jops, tops, _, _ = _ops((5,))
    t0 = 9
    t_end = t0 + max(1, n - 1)
    descs = torch.from_numpy(tops.descs)
    before = dict(pivot_tile.launches)
    req1, req0, feas, counts = pivot_tile.pivot_window(
        tops.tables, tops.lc1, tops.lc0, tops.hc, tops.jlv, tops.jhv, descs,
        t0, n, t_end, TL, TH,
    )
    assert pivot_tile.launches == before  # the CPU path launches nothing
    assert req1.shape == (n, TL, TH) and feas.dtype == torch.bool
    for z in range(n):
        t = t0 + z
        if t >= t_end:
            assert not bool(feas[z].any()) and int(counts[z]) == 0
            assert bool((req1[z] == -1).all()) and bool((req0[z] == -1).all())
            continue
        jf, j1, j0 = jsw.lut5_pivot_tile(*jops.stream_args(), t, tl=TL, th=TH)
        np.testing.assert_array_equal(feas[z].reshape(-1).numpy(), np.asarray(jf))
        np.testing.assert_array_equal(req1[z].reshape(-1).numpy().view(np.uint32),
                                      np.asarray(j1))
        np.testing.assert_array_equal(req0[z].reshape(-1).numpy().view(np.uint32),
                                      np.asarray(j0))
        assert int(counts[z]) == int(np.asarray(jf).sum())
    assert int(counts.sum()) > 0


@pytest.mark.parametrize("n", [1, 3])
def test_pre_window_plain_matches_jax_pallas_pre(n):
    """K2's window, plain version: each tile of a window from tile 12 (it
    holds feasible candidates) to one tile past ``t_end``, with the
    pivot-5 exclusion, against the JAX package's per-tile
    ``_pivot_tile_expanded_operands`` and ``pivot_constraints_pallas_pre``
    in interpret mode (one block per tile), and its validity mask."""
    from sboxgates_tpu.ops import pallas_pivot

    jops, tops, _, _ = _ops((5,), "pre")
    t0 = 12
    t_end = t0 + max(1, n - 1)
    before = dict(pivot_tile.launches)
    req1, req0, feas, counts = pivot_tile.pivot_pre_window(
        *tops.stream_args()[:6], torch.from_numpy(tops.descs), t0, n, t_end, TL, TH,
    )
    assert pivot_tile.launches == before  # the CPU path launches nothing
    for z in range(n):
        t = t0 + z
        if t >= t_end:
            assert not bool(feas[z].any()) and int(counts[z]) == 0
            assert bool((req1[z] == -1).all()) and bool((req0[z] == -1).all())
            continue
        *operands, valid = jsw._pivot_tile_expanded_operands(
            *jops.stream_args()[:6], jops.descs[t], TL, TH)
        j1, j0 = pallas_pivot.pivot_constraints_pallas_pre(
            *operands, tl=TL, th=TH, bl=TL, bh=TH, interpret=True)
        np.testing.assert_array_equal(req1[z].numpy().view(np.uint32), np.asarray(j1))
        np.testing.assert_array_equal(req0[z].numpy().view(np.uint32), np.asarray(j0))
        want = np.asarray(valid) & ((np.asarray(j1) & np.asarray(j0)) == 0)
        np.testing.assert_array_equal(feas[z].numpy(), want)
        assert int(counts[z]) == int(want.sum())
    assert int(counts.sum()) > 0


def test_window_rejects_bad_operands():
    _, tops, _, _ = _ops()
    descs = torch.from_numpy(tops.descs)
    args = (tops.tables, tops.lc1, tops.lc0, tops.hc, tops.jlv, tops.jhv)
    with pytest.raises(ValueError):
        pivot_tile.pivot_window(*args, descs.long(), 0, 1, 1, TL, TH)
    with pytest.raises(ValueError):
        pivot_tile.pivot_window(*args, descs, 0, 1, descs.shape[0] + 1, TL, TH)
    with pytest.raises(ValueError):
        pivot_tile.pivot_window(*args[:4], args[4].int(), args[5], descs, 0, 1, 1,
                                TL, TH)
