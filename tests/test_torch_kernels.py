"""The port's kernel modules against the JAX package's Pallas kernels.

On the CPU the wrappers run their plain versions; those are held bit for
bit against the Pallas kernels as the JAX tests run them (interpret mode),
at small shapes with words that have bit 31 set.  The CUDA kernels are
held against these plain versions on a card in tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

from sboxgates_tpu.ops import combinatorics as jcomb
from sboxgates_tpu.ops import pallas_filter, pallas_pivot

from sboxgates_tpu_torch.ops import lut5_filter, pivot_tile

# The suite runs several worker processes on shared cores; torch's
# intra-op thread pool in each of them oversubscribes the host.
torch.set_num_threads(1)

TL = TH = 64


def _words(rng, *shape):
    w = rng.integers(0, 2**32, size=shape, dtype=np.uint64).astype(np.uint32)
    w.reshape(-1)[::2] |= np.uint32(0x80000000)
    return w


def _t(a):
    """uint32 numpy -> int32 CPU tensor (bit patterns)."""
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32).copy())


def _u(t):
    return t.numpy().view(np.uint32)


def _pivot_operands(seed, tl=TL, th=TH, density=0.5):
    """Packed low/high cell words like real pair cells: sparse-ish masks so
    both set and clear verdict bits occur."""
    rng = np.random.default_rng(seed)
    keep = lambda *s: (rng.random(s + (256,)) < density)  # noqa: E731
    from sboxgates_tpu.core import ttable as jtt

    l1 = jtt.from_bits(keep(4, tl) & (rng.random((4, tl, 256)) < 0.05))
    l0 = jtt.from_bits(keep(4, tl) & (rng.random((4, tl, 256)) < 0.05))
    hcs = jtt.from_bits(keep(4, th) & (rng.random((4, th, 256)) < 0.3))
    pm = _words(rng, 8)
    return l1, l0, hcs, pm


def _pmsel(pm):
    from sboxgates_tpu.core import ttable as jtt

    b = jtt.to_bits(pm).astype(np.int8)
    return np.stack([1 - b, b])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pivot_packed_plain_matches_pallas(seed):
    import jax.numpy as jnp

    l1, l0, hcs, pm = _pivot_operands(seed)
    want = pallas_pivot.pivot_constraints_pallas(
        jnp.asarray(l1), jnp.asarray(l0), jnp.asarray(hcs),
        jnp.asarray(_pmsel(pm)), tl=TL, th=TH, bl=64, bh=64, interpret=True,
    )
    pmw = np.stack([~pm, pm])
    got = pivot_tile.pivot_constraints(_t(l1), _t(l0), _t(hcs), _t(pmw))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_u(g), np.asarray(w))
    w1 = np.asarray(want[0])
    assert (w1 != 0).any() and (w1 != 0xFFFFFFFF).any() and (w1 >> 31).any()


@pytest.mark.parametrize("seed", [3, 4])
def test_pivot_pre_plain_matches_pallas(seed):
    import jax.numpy as jnp
    from sboxgates_tpu.core import ttable as jtt

    l1, l0, hcs, pm = _pivot_operands(seed)
    pmsel = _pmsel(pm)
    lhs1 = (jtt.to_bits(l1).astype(np.int8)[None] * pmsel[:, None, None, :])
    lhs0 = (jtt.to_bits(l0).astype(np.int8)[None] * pmsel[:, None, None, :])
    rhsb = jtt.to_bits(hcs).astype(np.int8)
    want = pallas_pivot.pivot_constraints_pallas_pre(
        jnp.asarray(lhs1), jnp.asarray(lhs0), jnp.asarray(rhsb),
        tl=TL, th=TH, bl=64, bh=64, interpret=True,
    )
    got = pivot_tile.pivot_constraints_pre(
        torch.from_numpy(lhs1), torch.from_numpy(lhs0), torch.from_numpy(rhsb)
    )
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_u(g), np.asarray(w))
    # The two entry points agree on the same tile.
    packed = pivot_tile.pivot_constraints(
        _t(l1), _t(l0), _t(hcs), _t(np.stack([~pm, pm]))
    )
    for a, b in zip(got, packed):
        assert torch.equal(a, b)


def test_pivot_accepts_row_slices_of_larger_arrays():
    l1, l0, hcs, pm = _pivot_operands(5, tl=96, th=80)
    big = lambda a: _t(np.concatenate([a, a[:, :7]], axis=1))  # noqa: E731
    pmw = _t(np.stack([~pm, pm]))
    got = pivot_tile.pivot_constraints(
        big(l1)[:, 3:67], big(l0)[:, 3:67], big(hcs)[:, 5:69], pmw
    )
    want = pivot_tile.pivot_constraints(
        _t(l1[:, 3:67]), _t(l0[:, 3:67]), _t(hcs[:, 5:69]), pmw
    )
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("seed", [0, 1])
def test_lut5_filter_plain_matches_pallas(seed):
    """N = 1024 candidates at g = 40, the JAX package's own parity shape."""
    import jax.numpy as jnp

    rng = np.random.default_rng(seed)
    g, n = 40, 1024
    tables = _words(rng, g, 8)
    target = _words(rng, 8)
    mask = np.full(8, 0xFFFFFFFF, np.uint32)
    mask[5] = 0x0F0F0F0F
    ranks = rng.integers(0, jcomb.n_choose_k(g, 5), size=n)
    combos = jcomb.unrank_combinations(ranks, g, 5)
    # Low-degree target so some tuples are feasible: a 5-LUT of 5 gates.
    a, b, c, d, e = combos[7]
    bits = [
        np.unpackbits(tables[x].view(np.uint8), bitorder="little").astype(np.int64)
        for x in (a, b, c, d, e)
    ]
    idx = bits[0] * 16 + bits[1] * 8 + bits[2] * 4 + bits[3] * 2 + bits[4]
    target = np.packbits(
        ((0x2DB4A5C3 >> idx) & 1).astype(np.uint8), bitorder="little"
    ).view(np.uint32)
    tabs = np.transpose(tables[combos], (1, 2, 0))
    want = pallas_filter.lut5_filter_cells(
        jnp.asarray(tabs), jnp.asarray(target), jnp.asarray(mask), interpret=True
    )
    before = lut5_filter.launches
    got = lut5_filter.lut5_filter_cells(
        _t(tables), torch.from_numpy(combos.astype(np.int32)), _t(target), _t(mask)
    )
    assert lut5_filter.launches == before  # the CPU path launches nothing
    for gw, w in zip(got, want):
        np.testing.assert_array_equal(_u(gw), np.asarray(w))
    r1, r0 = (np.asarray(x) for x in want)
    assert ((r1 & r0) == 0).any() and (r1 >> 31).any()


def test_wrappers_reject_bad_operands():
    t = torch.zeros((8, 8), dtype=torch.int32)
    c = torch.zeros((4, 5), dtype=torch.int32)
    w = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(TypeError):
        lut5_filter.lut5_filter_cells(t.long(), c, w, w)
    with pytest.raises(ValueError):
        lut5_filter.lut5_filter_cells(t, c[:, :4].contiguous(), w, w)
    with pytest.raises(ValueError):
        lut5_filter.lut5_filter_cells(torch.zeros((600, 8), dtype=torch.int32), c, w, w)
    l = torch.zeros((4, 16, 8), dtype=torch.int32)
    with pytest.raises(ValueError):
        pivot_tile.pivot_constraints(l, l, l, torch.zeros((2, 7), dtype=torch.int32))
    with pytest.raises(ValueError):
        pivot_tile.pivot_constraints_pre(
            torch.zeros((2, 4, 16, 256), dtype=torch.int8),
            torch.zeros((2, 4, 16, 256), dtype=torch.int8),
            torch.zeros((4, 16, 255), dtype=torch.int8),
        )


def test_expand_and_pack_lanes_round_trip():
    rng = np.random.default_rng(9)
    w = _t(_words(rng, 3, 5, 8))
    lanes = pivot_tile.expand_lanes(w)
    assert lanes.dtype == torch.int8 and lanes.shape == (3, 5, 256)
    packed = np.packbits(lanes.numpy().astype(np.uint8), axis=-1, bitorder="little")
    np.testing.assert_array_equal(packed.view(np.int32), w.numpy())
    import jax.numpy as jnp
    from sboxgates_tpu.ops import sweeps as jsw

    want = jsw._expand_bits_i8(jnp.asarray(w.numpy().view(np.uint32)))
    np.testing.assert_array_equal(lanes.numpy(), np.asarray(want))
