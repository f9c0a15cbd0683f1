"""5-LUT stage-A filter: packed Karnaugh-cell constraints of 5-tuples.

Replaces the TPU kernel ``sboxgates_tpu/ops/pallas_filter.py:58``
(``lut5_filter_cells``).  The TPU kernel took the gathered rows
``tables[combos]`` from XLA; here the gather is fused into the kernel
(``csrc/lut5_filter.cu``): the wrapper takes the gate tables and the combos.

For each 5-tuple the 32 cells of its gathered table rows come from the
doubling recurrence (input 0 on the cell-index MSB), each cell is
intersected with ``need1 = mask & target`` and ``need0 = mask & ~target``,
OR-reduced over the 8 words, and bit j of ``req1``/``req0`` records cell j.
Bound on the H100: integer logic operations (about 1.1k per candidate
against 28 B of memory traffic); see the source's header for the design.

Words are int32 bit patterns throughout.  On a CUDA tensor the wrapper
launches the kernel or raises; the plain version runs only for CPU
tensors (and in the comparisons of the tests and ``chip_smoke.py``).
"""

from __future__ import annotations

import torch

from .. import _kernels
from ..telemetry import attribution as _tattr

#: Kernel launches by :func:`lut5_filter_cells` (the plain version and the
#: CPU path do not count).
launches = 0

#: Kernel launches by the lane form :func:`lut5_filter_cells_lanes`.
lane_launches = 0

#: Largest gate-table height the kernel stages in shared memory.
MAX_TABLES = 512


def _live_words(mask: torch.Tensor):
    """Word indices that can carry a requirement (in any lane of a [..., W]
    mask).  On the CPU the zero-mask words are skipped (a host check costs
    nothing there); words outside the mask meet neither need set, so the
    result is the same either way."""
    if mask.is_cuda:
        return range(mask.shape[-1])
    live = (mask != 0).reshape(-1, mask.shape[-1]).any(dim=0)
    return [int(w) for w in torch.nonzero(live).flatten()]


def cells_t(tabs: torch.Tensor) -> torch.Tensor:
    """[k, W, N] int32 table rows -> [2^k, W, N] cell masks by the doubling
    recurrence (reverse input order so input 0 lands on the cell MSB)."""
    cells = torch.full(
        (1,) + tuple(tabs.shape[1:]), -1, dtype=torch.int32, device=tabs.device
    )
    for i in range(tabs.shape[0] - 1, -1, -1):
        t = tabs[i][None]
        cells = torch.cat([cells & ~t, cells & t], dim=0)
    return cells


def cell_requirements(tabs: torch.Tensor, target, mask):
    """[k, ..., W, N] rows against ``target``/``mask`` [..., W] -> (req1,
    req0) bool [2^k, ..., N]: the cells that must map to 1 / to 0 (the
    leading dimensions are lanes, each with its own target and mask).
    Reduces one word at a time, so the [2^k, ..., W, N] cell masks are
    never held at once."""
    k, n = tabs.shape[0], tabs.shape[-1]
    need1 = (mask & target)[..., None]
    need0 = (mask & ~target)[..., None]
    req1 = torch.zeros((1 << k,) + tuple(tabs.shape[1:-2]) + (n,),
                       dtype=torch.bool, device=tabs.device)
    req0 = torch.zeros_like(req1)
    for w in _live_words(mask):
        cells = cells_t(tabs[..., w, :])
        req1 |= (cells & need1[..., w, :]) != 0
        req0 |= (cells & need0[..., w, :]) != 0
    return req1, req0


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """[C, ...] bool -> [...] int32 words for C <= 32 (bit j = row j), and
    [..., C/32] for C > 32 (bit j of word i = row 32 i + j).  The rows are
    disjoint bits, so the int32 sum is their OR, bit 31 included."""
    c = bits.shape[0]
    if c <= 32:
        sh = torch.arange(c, dtype=torch.int32, device=bits.device).reshape(
            (c,) + (1,) * (bits.dim() - 1)
        )
        return (bits.to(torch.int32) << sh).sum(dim=0, dtype=torch.int32)
    assert c % 32 == 0
    r = bits.reshape((c // 32, 32) + tuple(bits.shape[1:]))
    sh = torch.arange(32, dtype=torch.int32, device=bits.device).reshape(
        (32,) + (1,) * (bits.dim() - 1)
    )
    w = (r.to(torch.int32) << sh).sum(dim=1, dtype=torch.int32)
    return torch.movedim(w, 0, -1).contiguous()


def lut5_filter_cells_plain(tables, combos, target, mask):
    """Plain PyTorch version of the kernel: gather, recurrence, pack."""
    tabs = tables[combos.long()].permute(1, 2, 0)      # [5, W, N]
    req1, req0 = cell_requirements(tabs, target, mask)
    return pack_bits(req1), pack_bits(req0)


def _check(tables, combos, target, mask):
    for name, t in (("tables", tables), ("combos", combos),
                    ("target", target), ("mask", mask)):
        if t.dtype != torch.int32:
            raise TypeError(f"lut5_filter_cells: {name} must be int32")
        if not t.is_contiguous():
            raise ValueError(f"lut5_filter_cells: {name} must be contiguous")
        if t.device != tables.device:
            raise ValueError("lut5_filter_cells: operands on different devices")
    if tables.dim() != 2 or tables.shape[1] != 8:
        raise ValueError(f"tables must be [B, 8], got {tuple(tables.shape)}")
    if not 5 <= tables.shape[0] <= MAX_TABLES:
        raise ValueError(f"tables height {tables.shape[0]} outside [5, 512]")
    if combos.dim() != 2 or combos.shape[1] != 5:
        raise ValueError(f"combos must be [N, 5], got {tuple(combos.shape)}")
    if target.shape != (8,) or mask.shape != (8,):
        raise ValueError("target and mask must be [8]")


def lut5_filter_cells(tables, combos, target, mask):
    """(req1, req0) int32[N] for the 5-tuples ``combos`` int32[N, 5] over
    ``tables`` int32[B, 8] (B <= 512), against ``target``/``mask`` int32[8].

    Gate ids must lie in [0, B).  Bit-identical to the JAX package's
    ``lut5_filter_cells(tables[combos] transposed, target, mask)``."""
    global launches
    _check(tables, combos, target, mask)
    n, b = combos.shape[0], tables.shape[0]
    timed = _tattr.launch("lut5_filter", f"{n}x{b}",
                          lambda: _tattr.filter_cost(n, b), tables)
    if not tables.is_cuda:
        with timed:
            return lut5_filter_cells_plain(tables, combos, target, mask)
    req1 = torch.empty(n, dtype=torch.int32, device=tables.device)
    req0 = torch.empty_like(req1)
    fn, args = _kernels.lib().sbgt_lut5_filter, (
        tables.data_ptr(), b, combos.data_ptr(), n, target.data_ptr(),
        mask.data_ptr(), req1.data_ptr(), req0.data_ptr(),
        _kernels.stream_ptr(tables.device),
    )
    with timed as events:
        _kernels.check(fn(*args, *events), "lut5_filter_cells")
    launches += 1
    return req1, req0


def lut5_filter_cells_lanes_plain(tables, combos, target, mask):
    """Plain version of the lane form: each lane through
    :func:`lut5_filter_cells_plain`."""
    outs = [
        lut5_filter_cells_plain(tables[i], combos[i], target[i], mask[i])
        for i in range(tables.shape[0])
    ]
    if not outs:
        empty = torch.zeros((0, combos.shape[1]), dtype=torch.int32,
                            device=tables.device)
        return empty, empty.clone()
    return (torch.stack([o[0] for o in outs]),
            torch.stack([o[1] for o in outs]))


def lut5_filter_cells_lanes(tables, combos, target, mask):
    """The lane form of :func:`lut5_filter_cells`: ``lanes`` independent
    filters in one launch (``csrc/lut5_filter.cu``,
    ``sbgt_lut5_filter_lanes``).  ``tables`` int32[lanes, B, 8] (B <= 512),
    ``combos`` int32[lanes, N, 5], ``target``/``mask`` int32[lanes, 8];
    returns (req1, req0) int32[lanes, N], lane l equal to
    ``lut5_filter_cells(tables[l], combos[l], target[l], mask[l])``."""
    global lane_launches
    for name, t in (("tables", tables), ("combos", combos),
                    ("target", target), ("mask", mask)):
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"lut5_filter_cells_lanes: {name} must be "
                             "contiguous int32")
        if t.device != tables.device:
            raise ValueError("lut5_filter_cells_lanes: operands on different "
                             "devices")
    lanes = tables.shape[0]
    if (tables.dim() != 3 or tables.shape[2] != 8 or combos.dim() != 3
            or combos.shape[0] != lanes or combos.shape[2] != 5
            or target.shape != (lanes, 8) or mask.shape != (lanes, 8)):
        raise ValueError("lut5_filter_cells_lanes: shapes must be tables "
                         "[L, B, 8], combos [L, N, 5], target/mask [L, 8]")
    if not 5 <= tables.shape[1] <= MAX_TABLES:
        raise ValueError(f"tables height {tables.shape[1]} outside [5, 512]")
    n, b = combos.shape[1], tables.shape[1]
    timed = _tattr.launch(
        "lut5_filter_lanes", f"{lanes}x{n}x{b}",
        lambda: _tattr.lanes_cost(_tattr.filter_cost(n, b), lanes), tables,
    )
    if not tables.is_cuda:
        with timed:
            return lut5_filter_cells_lanes_plain(tables, combos, target, mask)
    req1 = torch.empty((lanes, n), dtype=torch.int32, device=tables.device)
    req0 = torch.empty_like(req1)
    fn, args = _kernels.lib().sbgt_lut5_filter_lanes, (
        tables.data_ptr(), b, combos.data_ptr(), n, lanes, target.data_ptr(),
        mask.data_ptr(), req1.data_ptr(), req0.data_ptr(),
        _kernels.stream_ptr(tables.device),
    )
    with timed as events:
        _kernels.check(fn(*args, *events), "lut5_filter_cells_lanes")
    lane_launches += 1
    return req1, req0
