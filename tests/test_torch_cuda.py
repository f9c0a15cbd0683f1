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


def _planted_pivot(device, excl=(), backend="packed"):
    """Pivot operands of the planted G = 50 state of tests/planted.py,
    built with the port (8 inputs, XOR gates, the 5-LUT 0xB4(0x2D(g12,
    g26, g41), g19, g33) as the target), on ``device``."""
    from sboxgates_tpu_torch.core import boolfunc as bf
    from sboxgates_tpu_torch.graph.state import GATES, State
    from sboxgates_tpu_torch.search.lut import PivotOperands

    rng = np.random.default_rng(5)
    st = State.init_inputs(8)
    while st.num_gates < 50:
        a, b = rng.choice(st.num_gates, size=2, replace=False)
        st.add_gate(bf.XOR, int(a), int(b), GATES)
    outer = tt.eval_lut(0x2D, st.table(12), st.table(26), st.table(41))
    target = tt.eval_lut(0xB4, outer, st.table(19), st.table(33))
    tabs = np.zeros((64, 8), np.uint32)
    tabs[:50] = st.live_tables()
    return PivotOperands(50, 256, 512, list(excl), sweeps.as_words(tabs, device),
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
