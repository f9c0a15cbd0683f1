"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here is marked ``cuda`` and skips without a usable card.  The
file imports neither JAX nor the JAX package, so it also runs on a GPU host
that has no JAX, with the repository's JAX-pinning conftest left out:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

The plain versions are held against the JAX package's Pallas kernels on the
CPU in tests/test_torch_kernels.py.
"""

import os
import sys

import numpy as np
import pytest
import torch

from sboxgates_tpu_torch.core import ttable as tt
from sboxgates_tpu_torch.ops import combinatorics as comb
from sboxgates_tpu_torch.ops import lut5_filter, pivot_tile, sweeps

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_states import mixed_state  # noqa: E402


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _words(rng, *shape):
    """Random uint32 words, every other one with bit 31 set."""
    w = rng.integers(0, 2**32, size=shape, dtype=np.uint64).astype(np.uint32)
    w.reshape(-1)[::2] |= np.uint32(0x80000000)
    return w


def _t(a):
    """uint32 numpy -> int32 CPU tensor (bit patterns)."""
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32).copy())


def _pivot_operands(seed, tl, th):
    """Sparse packed low/high cell words, so both set and clear verdict
    bits occur."""
    rng = np.random.default_rng(seed)
    l1 = tt.from_bits(rng.random((4, tl, 256)) < 0.025)
    l0 = tt.from_bits(rng.random((4, tl, 256)) < 0.025)
    hcs = tt.from_bits(rng.random((4, th, 256)) < 0.15)
    return l1, l0, hcs, _words(rng, 8)


@pytest.mark.cuda
@pytest.mark.parametrize("b", [64, 512])
def test_cuda_lut5_filter_matches_plain(b):
    dev = _cuda()
    rng = np.random.default_rng(b)
    tables = _t(_words(rng, b, 8)).to(dev)
    combos = torch.from_numpy(rng.integers(0, b, size=(5000, 5)).astype(np.int32)).to(dev)
    target, mask = _t(_words(rng, 8)).to(dev), _t(_words(rng, 8)).to(dev)
    before = lut5_filter.launches
    got = lut5_filter.lut5_filter_cells(tables, combos, target, mask)
    assert lut5_filter.launches == before + 1
    want = lut5_filter.lut5_filter_cells_plain(tables, combos, target, mask)
    for a, w in zip(got, want):
        assert torch.equal(a, w)


@pytest.mark.cuda
@pytest.mark.parametrize("tl,th", [(256, 512), (512, 512), (40, 130)])
def test_cuda_pivot_kernels_match_plain(tl, th):
    dev = _cuda()
    l1, l0, hcs, pm = _pivot_operands(tl + th, tl, th)
    l1, l0, hcs = (_t(x).to(dev) for x in (l1, l0, hcs))
    pmw = _t(np.stack([~pm, pm])).to(dev)
    got = pivot_tile.pivot_constraints(l1, l0, hcs, pmw)
    want = pivot_tile.pivot_constraints_plain(l1, l0, hcs, pmw)
    for a, w in zip(got, want):
        assert torch.equal(a, w)
    assert bool((want[0] != 0).any()) and bool((want[0] != -1).any())
    pmb = pivot_tile.expand_lanes(pmw[1])
    pmsel = torch.stack([1 - pmb, pmb])
    lhs1 = (pivot_tile.expand_lanes(l1)[None] * pmsel[:, None, None, :]).contiguous()
    lhs0 = (pivot_tile.expand_lanes(l0)[None] * pmsel[:, None, None, :]).contiguous()
    rhsb = pivot_tile.expand_lanes(hcs).contiguous()
    got2 = pivot_tile.pivot_constraints_pre(lhs1, lhs0, rhsb)
    for a, w in zip(got2, want):
        assert torch.equal(a, w)


def _planted_pivot(device, excl=(), backend="packed", seed=5, g=50):
    """Pivot operands of a planted state of ``g`` XOR gates (G = 50 at the
    default seed: the state of tests/planted.py), built with the port (8
    inputs, the 5-LUT 0xB4(0x2D(g12, g26, g41), g19, g33) as the target),
    on ``device``."""
    from sboxgates_tpu_torch.core import boolfunc as bf
    from sboxgates_tpu_torch.graph.state import GATES, State
    from sboxgates_tpu_torch.search.lut import PivotOperands

    rng = np.random.default_rng(seed)
    st = State.init_inputs(8)
    while st.num_gates < g:
        a, b = rng.choice(st.num_gates, size=2, replace=False)
        st.add_gate(bf.XOR, int(a), int(b), GATES)
    outer = tt.eval_lut(0x2D, st.table(12), st.table(26), st.table(41))
    target = tt.eval_lut(0xB4, outer, st.table(19), st.table(33))
    tabs = np.zeros((64, 8), np.uint32)
    tabs[:g] = st.live_tables()
    return PivotOperands(g, 256, 512, list(excl), sweeps.as_words(tabs, device),
                         target, tt.mask_table(8), device, backend=backend)


WINDOWS = {"packed": ("pivot_window", "pivot_window_plain"),
           "pre": ("pivot_pre_window", "pivot_pre_window_plain")}


@pytest.mark.cuda
@pytest.mark.parametrize("backend", sorted(WINDOWS))
@pytest.mark.parametrize("t0,n,t_end", [(18, 1, 112), (0, 64, 112), (60, 64, 100)])
def test_cuda_pivot_window_matches_plain(t0, n, t_end, backend):
    """The window kernel of each backend (K1 on words, K2 on int8 lanes)
    against its plain version on the same card inputs: req words, feasible
    flags and counts, for one tile, a full window and a window crossing
    t_end (tiles past it are all-ones and infeasible)."""
    dev = _cuda()
    ops = _planted_pivot(dev, excl=(5,), backend=backend)
    args = (*ops.stream_args()[:6], torch.from_numpy(ops.descs).to(dev), t0, n,
            min(t_end, ops.t_real), 256, 512)
    kern, plain = (getattr(pivot_tile, f) for f in WINDOWS[backend])
    before = dict(pivot_tile.launches), dict(pivot_tile.tiles)
    got = kern(*args)
    assert pivot_tile.launches[backend] == before[0][backend] + 1
    assert pivot_tile.tiles[backend] == before[1][backend] + n
    want = plain(*args)
    for a, w in zip(got, want):
        assert torch.equal(a, w)
    if t0 <= 18 < t0 + n:
        assert int(got[3].sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("backend", sorted(WINDOWS))
@pytest.mark.parametrize("cap", [1, 64])
@pytest.mark.parametrize("solve_rows", [64, 1])
def test_cuda_pivot_stream_matches_cpu(cap, solve_rows, backend, monkeypatch):
    """The windowed stream on the card gives the CPU's verdict (a hit, or
    an overflow with solve_rows=1) on either backend, and launches one
    window per window."""
    dev = _cuda()
    monkeypatch.setattr(sweeps, "PIVOT_WINDOW_TILES", cap)
    _, w_tab, m_tab = sweeps.lut5_split_tables()
    out = []
    for d in (torch.device("cpu"), dev):
        ops = _planted_pivot(d, backend=backend)
        before = pivot_tile.launches[backend]
        out.append(sweeps.lut5_pivot_stream(
            *ops.stream_args(), 0, ops.t_real, sweeps.as_words(w_tab, d),
            sweeps.as_words(m_tab, d), 2024, tl=256, th=512,
            solve_rows=solve_rows, backend=backend,
        ))
    assert pivot_tile.launches[backend] > before
    np.testing.assert_array_equal(out[0], out[1])
    assert out[1][0] == (1 if solve_rows == 64 else 2)


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [1, 8, 64])
def test_cuda_lut5_filter_lanes_matches_plain(lanes):
    """K3's lane form against its plain version (every lane its own
    tables, combos, target and mask), one launch per call."""
    dev = _cuda()
    rng = np.random.default_rng(lanes)
    n, b = 5000, 64
    tables = _t(_words(rng, lanes, b, 8)).to(dev)
    combos = torch.from_numpy(
        np.sort(rng.integers(0, b, size=(lanes, n, 5)), axis=2).astype(np.int32)
    ).to(dev)
    target, mask = _t(_words(rng, lanes, 8)).to(dev), _t(_words(rng, lanes, 8)).to(dev)
    before = lut5_filter.lane_launches
    got = lut5_filter.lut5_filter_cells_lanes(tables, combos, target, mask)
    assert lut5_filter.lane_launches == before + 1
    want = lut5_filter.lut5_filter_cells_lanes_plain(tables, combos, target, mask)
    for a, w in zip(got, want):
        assert torch.equal(a, w)


@pytest.mark.cuda
@pytest.mark.parametrize("width", [1, 4, 8])
def test_cuda_pivot_window_lanes_matches_plain(width):
    """K1's lane form against its plain version: 6 lanes, each with its own
    planted state (its own tables, pair cells, validity and descriptors:
    G = 50, 49 and 48, one lane with an excluded pivot, the pair arrays
    padded to the longest), at their own windows: one at its planted hit's
    tile, one cut by its t_end, one done (t0 = t_end).  One launch, and
    the swept tiles counted."""
    dev = _cuda()
    lanes = 6
    ops = [_planted_pivot(dev, excl=(5,) if i == 2 else (), seed=5 + i,
                          g=50 - i % 3) for i in range(lanes)]
    _, w_tab, m_tab = sweeps.lut5_split_tables()
    hit = int(sweeps.lut5_pivot_stream(
        *ops[1].stream_args(), 0, ops[1].t_real, sweeps.as_words(w_tab, dev),
        sweeps.as_words(m_tab, dev), 7, tl=256, th=512)[8]) - 1
    pad = lambda j: sweeps._pad_rows(  # noqa: E731
        [o.stream_args()[j] for o in ops], 1 if j < 4 else 0)
    tmax = max(o.t_real for o in ops)
    descs = torch.zeros((lanes, tmax, 5), dtype=torch.int32)
    for i, o in enumerate(ops):
        descs[i, : o.t_real] = torch.from_numpy(o.descs)
    args = (pad(0), pad(1), pad(2), pad(3), pad(4), pad(5), descs.to(dev))
    real = [o.t_real for o in ops]
    t0 = [0, hit, 40, real[3] - 2, 30, 60]
    t_end = [real[0], real[1], 41, real[3], 30, real[5]]
    swept = sum(max(0, min(width, e - s)) for s, e in zip(t0, t_end))
    before = pivot_tile.launches["lanes"], pivot_tile.tiles["lanes"]
    got = pivot_tile.pivot_window_lanes(*args, t0, width, t_end, 256, 512)
    assert (pivot_tile.launches["lanes"], pivot_tile.tiles["lanes"]) == (
        before[0] + 1, before[1] + swept)
    want = pivot_tile.pivot_window_lanes_plain(*args, t0, width, t_end, 256, 512)
    for a, w in zip(got, want):
        assert torch.equal(a, w)
    assert int(got[3][1].sum()) > 0 and int(got[3][4].sum()) == 0
    assert len({o.tables.cpu().numpy().tobytes() for o in ops}) == lanes


@pytest.mark.cuda
@pytest.mark.parametrize("tl,th", [(203, 301), (256, 512)])
def test_cuda_pivot_window_lanes_64_lanes_match_plain(tl, th):
    """K1's lane form at 64 lanes of 4 tiles against its plain version, at
    the sweep's 256 x 512 and at 203 x 301, whose rows end inside the
    kernel's blocks (32 low, 128 high rows) and inside a warp's 16 high
    rows: every lane its own planted state (G = 48-50, every seventh with
    an excluded pivot), ragged (lanes cut by their t_end, so their last
    slots are inert; done lanes; one lane at its planted hit's tile), one
    launch."""
    dev = _cuda()
    lanes, width = 64, 4
    ops = [_planted_pivot(dev, excl=(5,) if i % 7 == 3 else (), seed=5 + i,
                          g=50 - i % 3) for i in range(lanes)]
    _, w_tab, m_tab = sweeps.lut5_split_tables()
    hit = int(sweeps.lut5_pivot_stream(
        *ops[1].stream_args(), 0, ops[1].t_real, sweeps.as_words(w_tab, dev),
        sweeps.as_words(m_tab, dev), 7, tl=256, th=512)[8]) - 1
    pad = lambda j: sweeps._pad_rows(  # noqa: E731
        [o.stream_args()[j] for o in ops], 1 if j < 4 else 0)
    real = [o.t_real for o in ops]
    descs = torch.zeros((lanes, max(real), 5), dtype=torch.int32)
    for i, o in enumerate(ops):
        descs[i, : real[i]] = torch.from_numpy(o.descs)
    args = (pad(0), pad(1), pad(2), pad(3), pad(4), pad(5), descs.to(dev))
    t0 = [(7 * i) % (real[i] - 1) for i in range(lanes)]
    t_end = list(real)
    for i in range(0, lanes, 4):
        t_end[i] = t0[i] + 2                                   # cut
    for i in range(2, lanes, 5):
        t0[i] = t_end[i]                                       # done
    t0[1] = hit
    before = pivot_tile.launches["lanes"]
    got = pivot_tile.pivot_window_lanes(*args, t0, width, t_end, tl, th)
    assert pivot_tile.launches["lanes"] == before + 1
    want = pivot_tile.pivot_window_lanes_plain(*args, t0, width, t_end, tl, th)
    for a, w in zip(got, want):
        assert torch.equal(a, w)
    if (tl, th) == (256, 512):
        assert int(got[3][1].sum()) > 0
    assert int(got[3][2].sum()) == 0 and bool((got[0][0, 2:] == -1).all())


@pytest.mark.cuda
def test_cuda_pivot_stream_lanes_match_cpu():
    """The lanes' pivot sweeps on the card (K1's lane form) give the CPU's
    verdicts, and the single-lane sweeps'."""
    dev = _cuda()
    _, w_tab, m_tab = sweeps.lut5_split_tables()
    out = []
    for d in (torch.device("cpu"), dev):
        ops = _planted_pivot(d)
        rows = [(*ops.stream_args(), s, ops.t_real, sweeps.as_words(w_tab, d),
                 sweeps.as_words(m_tab, d), seed)
                for s, seed in ((0, 2024), (10, 7), (30, -1), (0, 99))]
        out.append(sweeps.lut5_pivot_stream_lanes(rows, tl=256, th=512))
        if d.type == "cuda":
            single = [sweeps.lut5_pivot_stream(*r, tl=256, th=512) for r in rows]
    for a, b, c in zip(out[0], out[1], single):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(b, c)


@pytest.mark.cuda
def test_cuda_streams_match_cpu():
    """A whole sweep on the card gives the CPU's verdict."""
    dev = _cuda()
    rng = np.random.default_rng(11)
    g = 30
    tables = _words(rng, 64, 8)
    target, mask = _words(rng, 8), np.full(8, 0xFFFFFFFF, np.uint32)
    _, w_tab, m_tab = sweeps.lut5_split_tables()
    out = []
    for d in (torch.device("cpu"), dev):
        w = lambda a: sweeps.as_words(a, d)  # noqa: E731
        out.append(sweeps.lut5_stream(
            w(tables), sweeps.binom_device(d), g, w(target), w(mask),
            torch.full((8,), -1, dtype=torch.int32, device=d), 0,
            comb.n_choose_k(g, 5), w(w_tab), w(m_tab), 77, chunk=1 << 17,
        ))
    np.testing.assert_array_equal(out[0], out[1])


@pytest.mark.cuda
@pytest.mark.parametrize("b", [64, 512, 1000, 300000])
@pytest.mark.parametrize("spectrum", ["target", "random", "extreme"])
def test_cuda_walsh_score_matches_plain(b, spectrum):
    """K5 against its plain version; a random int32 spectrum, and an
    extreme one of entries +-(2^31 - 1), exercise the wrapping sums and the
    floor division of negative sums; B = 300000 makes every block of the
    grid stride over several gates."""
    from sboxgates_tpu_torch.ops import spectral

    dev = _cuda()
    rng = np.random.default_rng(b)
    tables = _t(_words(rng, b, 8)).to(dev)
    if spectrum == "target":
        spec = spectral.target_spectrum(_t(_words(rng, 8)).to(dev), _t(_words(rng, 8)).to(dev))
    elif spectrum == "random":
        spec = torch.from_numpy(
            rng.integers(-2**31, 2**31, size=256).astype(np.int32)).to(dev)
    else:
        spec = torch.from_numpy(
            (rng.choice([-1, 1], size=256) * (2**31 - 1)).astype(np.int32)).to(dev)
    before = spectral.launches
    got = spectral.gate_scores_kernel(tables, spec)
    assert spectral.launches == before + 1
    assert torch.equal(got, spectral.gate_scores_plain(tables, spec))


@pytest.mark.cuda
@pytest.mark.parametrize("w", [1, 2, 300, 4096 + 13])
def test_cuda_circuit_eval_matches_plain(w):
    """K4 against the plain evaluator on a G = 200 state of NOT, 2-input
    gates of every function and 3-LUTs, 8 outputs, at ragged widths."""
    from sboxgates_tpu_torch.codegen import compile_circuit, compile_cuda, cuda_kernel

    dev = _cuda()
    st = mixed_state(seed=w)
    rng = np.random.default_rng(w)
    x = _t(_words(rng, 8, w)).to(dev)
    before = cuda_kernel.launches
    got = compile_cuda(st, dev)(x)
    assert cuda_kernel.launches == before + 1
    assert torch.equal(got, compile_circuit(st)(x))


@pytest.mark.cuda
def test_cuda_eval_sbox_reproduces_an_example():
    import os

    from sboxgates_tpu_torch.codegen import cuda_kernel, eval_sbox
    from sboxgates_tpu_torch.graph.xmlio import load_state
    from sboxgates_tpu_torch.utils.sbox import load_sbox

    _cuda()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    st = load_state(os.path.join(root, "examples", "des_s1_bit0_lut_best.xml"))
    sbox, n = load_sbox(os.path.join(root, "sboxes", "des_s1.txt"))
    before = cuda_kernel.launches
    got = eval_sbox(st, "cuda")
    assert cuda_kernel.launches == before + 1
    np.testing.assert_array_equal(got & 1, sbox[: 1 << n] & 1)


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [1, 6])
def test_cuda_one_merged_round_syncs_once(lanes):
    """One lockstep round of the lanes' 5-LUT streams (one chunk each: K3
    and the solve of every lane) makes one host sync on the card, as CUDA's
    sync debug mode counts them, for one lane and for six."""
    import math

    from sboxgates_tpu_torch.utils.guards import sync_guard

    dev = _cuda()
    rng = np.random.default_rng(21)
    _, w_tab, m_tab = sweeps.lut5_split_tables()
    jw, jm = sweeps.as_words(w_tab, dev), sweeps.as_words(m_tab, dev)
    rows = []
    for i in range(lanes):
        g = 14 + i
        tabs = _words(rng, 64, 8)
        rows.append((sweeps.as_words(tabs, dev), sweeps.binom_device(dev), g,
                     sweeps.as_words(tabs[0] ^ tabs[g - 1], dev),
                     sweeps.as_words(np.full(8, 0xFFFFFFFF, np.uint32), dev),
                     torch.full((8,), -1, dtype=torch.int32, device=dev), 0,
                     math.comb(g, 5), jw, jm, 3 + i))
    want = sweeps.lut5_stream_lanes(rows, chunk=1 << 14)
    with sync_guard(action="count", device=dev) as rep:
        got = sweeps.lut5_stream_lanes(rows, chunk=1 << 14)
    assert rep.syncs == 1, rep.events
    for a, b in zip(want, got):
        np.testing.assert_array_equal(a, b)
