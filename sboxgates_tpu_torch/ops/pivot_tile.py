"""Pivot 5-LUT tile: packed cell constraints of one (low x high) tile.

Replaces the TPU kernels ``sboxgates_tpu/ops/pallas_pivot.py:133``
(``pivot_constraints_pallas``, packed operands: K1) with
``csrc/pivot_tile.cu`` and ``:218`` (``pivot_constraints_pallas_pre``,
operands pre-expanded to int8 lanes: K2) with ``csrc/pivot_pre.cu``.  The
pivot sweep runs either as a window of tiles per launch, each tile's
validity, conflict test and feasible count fused into the kernel:
:func:`pivot_window` (K1, ``--pivot-backend packed``) or
:func:`pivot_pre_window` (K2, ``pre``).  The single-tile
:func:`pivot_constraints` and :func:`pivot_constraints_pre` are launched by
no search path.

For low row l, high row h and cell (s, j, c2), bit ``(j << 3) | (s << 2) |
c2`` of ``req[l, h]`` is set when the low pair's cell j (pre-intersected
with the required positions), the pivot polarity s and the high pair's
cell c2 share a position.  K2 counts those intersections with int8 matrix
products on the tensor cores and tests ``> 0``, as the TPU kernels do;
K1 evaluates the same predicate as an AND-OR chain on the integer pipe,
with no count matrix.  Bounds on the H100: K2 by int8 tensor-core
operations, K1 by 32-bit logic operations (about 580 per candidate against
8 B of output); see the sources' headers for the designs.

Words are int32 bit patterns.  On a CUDA tensor the wrappers launch the
kernel or raise; the plain versions run only for CPU tensors (and in the
comparisons of the tests and ``chip_smoke.py``).  Each window launch (or,
on the CPU, plain-version call) is timed by
:func:`telemetry.attribution.launch` when a search dispatch records it: on
the card the entry point records the event pair around its launch.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _kernels
from ..telemetry import attribution as _tattr

#: Kernel launches: ``"packed"`` by :func:`pivot_window` (K1 as the sweep
#: runs it, one launch per window of tiles), ``"pre"`` by
#: :func:`pivot_pre_window` (K2 as the sweep runs it), ``"lanes"`` by K1's
#: lane form :func:`pivot_window_lanes` (one launch per window of every
#: lane), and ``"tile"`` / ``"pre_tile"`` by the single-tile
#: :func:`pivot_constraints` / :func:`pivot_constraints_pre`.
launches = {"packed": 0, "pre": 0, "tile": 0, "pre_tile": 0, "lanes": 0}

#: Window launches of :func:`pivot_window` and :func:`pivot_pre_window` by
#: mesh shard (the ``shard`` the sharded pivot stream passes: its global
#: shard index), counted with ``launches``.
shard_launches: dict = {}

#: Tiles swept by the window launches (a window of n tiles adds n to its
#: backend's count; a lane-form launch adds the tiles its lanes sweep, not
#: the inert slots of lanes cut at their t_end), and tiles of any that the
#: pivot sweep handed to its decomposition solve (``"solved"``).
tiles = {"packed": 0, "pre": 0, "lanes": 0, "solved": 0}

# Packed-cell bit position for (pivot polarity s, low cell j, high cell c2):
# (j << 3) | (s << 2) | c2 — the 32-cell key order shared with the 5-LUT
# decomposition solver tables.
PIVOT_CELLBITS = (
    (np.arange(4)[None, :, None] << 3)
    | (np.arange(2)[:, None, None] << 2)
    | np.arange(4)[None, None, :]
).astype(np.uint32)

#: Low rows per plain-version step: K1's bounds its [2, 4, rows, 4, th, 8]
#: intermediate, K2's its [2, 4, rows, 4, th] counts.
_PLAIN_ROWS = 16
_PLAIN_PRE_ROWS = 64


def _tile_plain(lw1, lw0, hw):
    """Shared plain body: ``lw1``/``lw0`` int32[2, 4, tl, 8] pivot-masked
    low words, ``hw`` int32[4, th, 8] high words -> (req1, req0)
    int32[tl, th]."""
    tl, th = lw1.shape[2], hw.shape[1]
    sh = torch.as_tensor(
        PIVOT_CELLBITS.astype(np.int32), device=hw.device
    )[:, :, None, :, None]                                  # [2, 4, 1, 4, 1]
    outs = []
    for lw in (lw1, lw0):
        rows = []
        for r in range(0, tl, _PLAIN_ROWS):
            x = lw[:, :, r : r + _PLAIN_ROWS, None, None, :] & hw[None, None, None]
            hit = (x != 0).any(dim=-1)                      # [2, 4, rows, 4, th]
            rows.append(
                (hit.to(torch.int32) << sh).sum(dim=(0, 1, 3), dtype=torch.int32)
            )
        outs.append(
            torch.cat(rows, dim=0) if rows
            else torch.zeros((0, th), dtype=torch.int32, device=hw.device)
        )
    return outs[0], outs[1]


def expand_lanes(x: torch.Tensor) -> torch.Tensor:
    """[..., W] int32 words -> [..., W*32] int8 0/1 lanes, LSB first (the
    arithmetic shift sign-extends bit 31, and ``& 1`` keeps only the lane)."""
    sh = torch.arange(32, dtype=torch.int32, device=x.device)
    b = (x[..., :, None] >> sh) & 1
    return b.to(torch.int8).reshape(x.shape[:-1] + (x.shape[-1] * 32,))


def pivot_constraints_plain(l1, l0, hcs, pmw):
    """Plain version of K1: ``l1``/``l0`` int32[4, tl, 8], ``hcs``
    int32[4, th, 8], ``pmw`` int32[2, 8] polarity selector words
    (row 0 = inverted pivot table, row 1 = pivot table)."""
    lw1 = l1[None] & pmw[:, None, None, :]
    lw0 = l0[None] & pmw[:, None, None, :]
    return _tile_plain(lw1, lw0, hcs)


def pivot_constraints_pre_plain(lhs1, lhs0, rhsb):
    """Plain version of K2, by its arithmetic: ``lhs1``/``lhs0``
    int8[2, 4, tl, 256] polarity-masked low lanes, ``rhsb`` int8[4, th, 256]
    high lanes; each count ``sum_k lhs[s, j, l, k] * rhsb[c2, h, k]`` (a
    float32 matrix product, exact: at most 256 products of 0/1) becomes its
    cell bit when > 0."""
    tl, th = lhs1.shape[2], rhsb.shape[1]
    sh = torch.as_tensor(
        PIVOT_CELLBITS.astype(np.int32), device=rhsb.device
    )[:, :, None, :, None]                                  # [2, 4, 1, 4, 1]
    rhs = rhsb.reshape(4 * th, 256).to(torch.float32).T     # [256, 4 th]
    outs = []
    for lhs in (lhs1, lhs0):
        rows = []
        for r in range(0, tl, _PLAIN_PRE_ROWS):
            a = lhs[:, :, r : r + _PLAIN_PRE_ROWS].to(torch.float32)
            c = (a.reshape(-1, 256) @ rhs).reshape(2, 4, a.shape[2], 4, th)
            rows.append(
                ((c > 0).to(torch.int32) << sh).sum(dim=(0, 1, 3), dtype=torch.int32)
            )
        outs.append(
            torch.cat(rows, dim=0) if rows
            else torch.zeros((0, th), dtype=torch.int32, device=rhsb.device)
        )
    return outs[0], outs[1]


def _check_words(name, t, shape_tail, device):
    if t.dtype != torch.int32:
        raise TypeError(f"{name} must be int32")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if tuple(t.shape[1:]) != shape_tail or t.shape[0] != 4:
        raise ValueError(f"{name} must be [4, rows, 8], got {tuple(t.shape)}")
    if t.stride(2) != 1 or t.stride(1) != 8:
        raise ValueError(f"{name} rows must be dense 8-word rows")


def pivot_constraints(l1, l0, hcs, pmw):
    """K1: (req1, req0) int32[tl, th] for one tile from packed operands.

    ``l1``/``l0`` int32[4, tl, 8] and ``hcs`` int32[4, th, 8] may be row
    slices of larger [4, P, 8] arrays (any plane stride; rows dense);
    ``pmw`` int32[2, 8].  Bit-identical to the JAX package's
    ``pivot_constraints_pallas`` with ``pmsel`` = the lanes of ``pmw``."""
    dev = l1.device
    tl, th = l1.shape[1], hcs.shape[1]
    _check_words("l1", l1, (tl, 8), dev)
    _check_words("l0", l0, (tl, 8), dev)
    _check_words("hcs", hcs, (th, 8), dev)
    if l0.stride(0) != l1.stride(0):
        raise ValueError("l1 and l0 must share a plane stride")
    if pmw.dtype != torch.int32 or tuple(pmw.shape) != (2, 8) or (
        not pmw.is_contiguous() or pmw.device != dev
    ):
        raise ValueError("pmw must be a contiguous int32[2, 8] on the tile's device")
    if not l1.is_cuda:
        return pivot_constraints_plain(l1, l0, hcs, pmw)
    req1 = torch.empty((tl, th), dtype=torch.int32, device=dev)
    req0 = torch.empty_like(req1)
    err = _kernels.lib().sbgt_pivot_packed(
        l1.data_ptr(), l0.data_ptr(), l1.stride(0), hcs.data_ptr(),
        hcs.stride(0), pmw.data_ptr(), tl, th, req1.data_ptr(),
        req0.data_ptr(), _kernels.stream_ptr(dev),
    )
    _kernels.check(err, "pivot_constraints")
    launches["tile"] += 1
    return req1, req0


def pivot_constraints_pre(lhs1, lhs0, rhsb):
    """K2 on one tile: (req1, req0) int32[tl, th] from int8 lane operands
    (0/1 lanes): ``lhs1``/``lhs0`` int8[2, 4, tl, 256], ``rhsb``
    int8[4, th, 256].  Bit-identical to the JAX package's
    ``pivot_constraints_pallas_pre``; the sweep runs
    :func:`pivot_pre_window`."""
    dev = lhs1.device
    tl, th = lhs1.shape[2], rhsb.shape[1]
    for name, t, shape in (
        ("lhs1", lhs1, (2, 4, tl, 256)),
        ("lhs0", lhs0, (2, 4, tl, 256)),
        ("rhsb", rhsb, (4, th, 256)),
    ):
        if t.dtype != torch.int8 or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be int8{list(shape)}")
        if not t.is_contiguous() or t.device != dev:
            raise ValueError(f"{name} must be contiguous on {dev}")
        if t.is_cuda and t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if not lhs1.is_cuda:
        return pivot_constraints_pre_plain(lhs1, lhs0, rhsb)
    req1 = torch.empty((tl, th), dtype=torch.int32, device=dev)
    req0 = torch.empty_like(req1)
    err = _kernels.lib().sbgt_pivot_pre(
        lhs1.data_ptr(), lhs0.data_ptr(), rhsb.data_ptr(), tl, th,
        req1.data_ptr(), req0.data_ptr(), _kernels.stream_ptr(dev),
    )
    _kernels.check(err, "pivot_constraints_pre")
    launches["pre_tile"] += 1
    return req1, req0


def _window_plain(tile_words, lowvalid, highvalid, descs, t0, n, t_end, tl,
                  th, out, dev):
    """The window kernels' plain body: ``tile_words(m, lo0, hi0)`` gives one
    tile's (req1, req0); validity, the conflict test and the counts follow
    the kernels' contract (:func:`pivot_window`).  ``descs`` may be the
    descriptor rows as host lists."""
    if out is None:
        out = window_buffers(n, tl, th, dev)
    req1, req0, feas = (b[:n] for b in out)
    req1.fill_(-1)
    req0.fill_(-1)
    feas.fill_(False)
    rows_l = torch.arange(tl, device=dev)
    rows_h = torch.arange(th, device=dev)
    if isinstance(descs, torch.Tensor):
        descs = descs[t0 : max(t0, min(t0 + n, t_end))].tolist()
        t_end, t0 = t_end - t0, 0
    for z in range(n):
        t = t0 + z
        if t >= t_end:
            continue
        m, lo0, lo_end, hi0, hi_end = (int(x) for x in descs[t])
        r1, r0 = tile_words(m, lo0, hi0)
        lv = (lo0 + rows_l < lo_end) & lowvalid[lo0 : lo0 + tl]
        hv = (hi0 + rows_h < hi_end) & highvalid[hi0 : hi0 + th]
        req1[z], req0[z] = r1, r0
        feas[z] = lv[:, None] & hv[None, :] & ((r1 & r0) == 0)
    counts = feas.reshape(n, -1).sum(dim=1, dtype=torch.int32)
    return req1, req0, feas, counts


def pivot_window_plain(tables, lc1, lc0, hc, lowvalid, highvalid, descs,
                       t0, n, t_end, tl, th, out=None):
    """Plain version of the window kernel: see :func:`pivot_window`."""

    def tile_words(m, lo0, hi0):
        pm = tables[m]
        return pivot_constraints_plain(
            lc1[:, lo0 : lo0 + tl], lc0[:, lo0 : lo0 + tl],
            hc[:, hi0 : hi0 + th], torch.stack([~pm, pm]),
        )

    return _window_plain(tile_words, lowvalid, highvalid, descs, t0, n, t_end,
                         tl, th, out, lc1.device)


def _check_window(lowvalid, highvalid, descs, t0, t_end, dev):
    for name, t in (("lowvalid", lowvalid), ("highvalid", highvalid)):
        if t.dtype != torch.bool or t.device != dev or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous bool vector on {dev}")
    if (descs.dtype != torch.int32 or descs.device != dev
            or not descs.is_contiguous() or descs.shape[-1] != 5):
        raise ValueError("descs must be a contiguous int32[*, 5] on the tiles' device")
    if t0 < 0 or t_end > descs.shape[0]:
        raise ValueError("the window's descriptors are out of range")


def _count_shard(shard) -> None:
    if shard is not None:
        shard_launches[shard] = shard_launches.get(shard, 0) + 1


def window_buffers(n, tl, th, device):
    """(req1, req0, feas) buffers for windows of up to ``n`` tiles."""
    req1 = torch.empty((n, tl, th), dtype=torch.int32, device=device)
    return (req1, torch.empty_like(req1),
            torch.empty((n, tl, th), dtype=torch.bool, device=device))


def pivot_window(tables, lc1, lc0, hc, lowvalid, highvalid, descs, t0, n,
                 t_end, tl, th, out=None, shard=None):
    """K1 over a window of tiles ``[t0, t0 + n)`` of ``descs``, one launch:
    (req1, req0) int32[n, tl, th] (the raw words of
    :func:`pivot_constraints` for each tile), ``feas`` bool[n, tl, th] and
    ``counts`` int32[n], the feasible candidates of each tile.

    ``descs`` int32[*, 5] (m, lo0, lo_end, hi0, hi_end) on the tiles'
    device; only rows below ``t_end`` are read, and tiles at or past it
    have no feasible candidate and all-ones words.  ``tables`` int32[B, 8],
    ``lc1``/``lc0``/``hc`` int32[4, P, 8] and ``lowvalid``/``highvalid``
    bool[P] are :class:`PivotOperands`' arrays, padded so every tile's rows
    are in range.  A candidate is feasible when its low and high rows are
    in the tile's range and valid and ``req1 & req0 == 0``.  ``out`` may
    hold :func:`window_buffers` of at least ``n`` tiles, used in place
    (also by the plain version on the CPU)."""
    dev = lc1.device
    for name, t in (("tables", tables), ("lc1", lc1), ("lc0", lc0), ("hc", hc)):
        if t.dtype != torch.int32 or t.device != dev or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous int32 on {dev}")
        if t.shape[-1] != 8:
            raise ValueError(f"{name} must hold 8-word rows")
    if lc1.shape != lc0.shape or lc1.shape[0] != 4 or hc.shape[0] != 4:
        raise ValueError("lc1/lc0/hc must be [4, rows, 8]")
    _check_window(lowvalid, highvalid, descs, t0, t_end, dev)
    if out is None:
        out = window_buffers(n, tl, th, dev)
    req1, req0, feas = (b[:n] for b in out)
    if req1.shape != (n, tl, th) or feas.dtype != torch.bool:
        raise ValueError("window buffers do not fit the window")
    timed = _tattr.launch("pivot_window", f"{n}x{tl}x{th}",
                          lambda: _tattr.window_cost(n, tl, th, "packed"), lc1)
    if not lc1.is_cuda:
        with timed:
            return pivot_window_plain(
                tables, lc1, lc0, hc, lowvalid, highvalid, descs, t0, n, t_end,
                tl, th, out=out,
            )
    counts = torch.empty(n, dtype=torch.int32, device=dev)
    fn, args = _kernels.lib().sbgt_pivot_window, (
        tables.data_ptr(), lc1.data_ptr(), lc0.data_ptr(), lc1.stride(0),
        hc.data_ptr(), hc.stride(0), lowvalid.data_ptr(), highvalid.data_ptr(),
        descs.data_ptr(), t0, n, t_end, tl, th, req1.data_ptr(),
        req0.data_ptr(), feas.data_ptr(), counts.data_ptr(),
        _kernels.stream_ptr(dev),
    )
    with timed as events:
        _kernels.check(fn(*args, *events), "pivot_window")
    launches["packed"] += 1
    tiles["packed"] += n
    _count_shard(shard)
    return req1, req0, feas, counts


def pivot_pre_window_plain(tables, l1, l0, hc, lowvalid, highvalid, descs,
                           t0, n, t_end, tl, th, out=None):
    """Plain version of K2's window: see :func:`pivot_pre_window`.  Each
    tile's lanes are sliced and the pivot polarity folded into the low ones
    as the JAX package's ``_pivot_tile_expanded_operands`` does, then
    counted by :func:`pivot_constraints_pre_plain`."""

    def tile_words(m, lo0, hi0):
        pmb = expand_lanes(tables[m])
        pmsel = torch.stack([1 - pmb, pmb])[:, None, None, :]     # [2, 1, 1, 256]
        return pivot_constraints_pre_plain(
            l1[None, :, lo0 : lo0 + tl] * pmsel, l0[None, :, lo0 : lo0 + tl] * pmsel,
            hc[:, hi0 : hi0 + th],
        )

    return _window_plain(tile_words, lowvalid, highvalid, descs, t0, n, t_end,
                         tl, th, out, l1.device)


def pivot_pre_window(tables, l1, l0, hc, lowvalid, highvalid, descs, t0, n,
                     t_end, tl, th, out=None, shard=None):
    """K2 over a window of tiles ``[t0, t0 + n)`` of ``descs``, one launch:
    :func:`pivot_window`'s contract and results, from the pair cells
    expanded to int8 0/1 lanes once per node: ``l1``/``l0``/``hc``
    int8[4, P, 256] (:func:`expand_lanes` of :class:`PivotOperands`'
    words).  The pivot polarity comes from ``tables[m]`` in the kernel."""
    dev = l1.device
    for name, t in (("l1", l1), ("l0", l0), ("hc", hc)):
        if t.dtype != torch.int8 or t.device != dev or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous int8 lanes on {dev}")
        if t.dim() != 3 or t.shape[0] != 4 or t.shape[-1] != 256:
            raise ValueError(f"{name} must be [4, rows, 256]")
        if t.is_cuda and t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if l1.shape != l0.shape or l1.shape != hc.shape:
        raise ValueError("l1/l0/hc must share their shape")
    if (tables.dtype != torch.int32 or tables.device != dev
            or not tables.is_contiguous() or tables.shape[-1] != 8):
        raise ValueError(f"tables must be contiguous int32[*, 8] on {dev}")
    _check_window(lowvalid, highvalid, descs, t0, t_end, dev)
    if out is None:
        out = window_buffers(n, tl, th, dev)
    req1, req0, feas = (b[:n] for b in out)
    if req1.shape != (n, tl, th) or feas.dtype != torch.bool:
        raise ValueError("window buffers do not fit the window")
    timed = _tattr.launch("pivot_pre_window", f"{n}x{tl}x{th}",
                          lambda: _tattr.window_cost(n, tl, th, "pre"), l1)
    if not l1.is_cuda:
        with timed:
            return pivot_pre_window_plain(
                tables, l1, l0, hc, lowvalid, highvalid, descs, t0, n, t_end,
                tl, th, out=out,
            )
    counts = torch.empty(n, dtype=torch.int32, device=dev)
    fn, args = _kernels.lib().sbgt_pivot_pre_window, (
        tables.data_ptr(), l1.data_ptr(), l0.data_ptr(), hc.data_ptr(),
        l1.shape[1], lowvalid.data_ptr(), highvalid.data_ptr(),
        descs.data_ptr(), t0, n, t_end, tl, th, req1.data_ptr(),
        req0.data_ptr(), feas.data_ptr(), counts.data_ptr(),
        _kernels.stream_ptr(dev),
    )
    with timed as events:
        _kernels.check(fn(*args, *events), "pivot_pre_window")
    launches["pre"] += 1
    tiles["pre"] += n
    _count_shard(shard)
    return req1, req0, feas, counts


def window_lanes_buffers(lanes, n, tl, th, device):
    """(req1, req0, feas) buffers for lane windows of up to ``n`` tiles:
    flat [lanes * n, tl, th], so a window of fewer tiles is a dense view of
    their head (:func:`_lane_views`)."""
    return window_buffers(lanes * n, tl, th, device)


def _lane_views(out, lanes, n):
    """The dense [lanes, n, tl, th] views of flat lane-window buffers."""
    if out[0].shape[0] < lanes * n:
        raise ValueError("lane window buffers do not fit the window")
    return tuple(b[: lanes * n].view((lanes, n) + tuple(b.shape[1:]))
                 for b in out)


def pivot_window_lanes_plain(tables, lc1, lc0, hc, lowvalid, highvalid, descs,
                             t0, n, t_end, tl, th, out=None):
    """Plain version of the lane form: each lane through
    :func:`pivot_window_plain`, a lane with ``t0 >= t_end`` inert."""
    lanes = tables.shape[0]
    dev = lc1.device
    if out is None:
        out = window_lanes_buffers(lanes, n, tl, th, dev)
    req1, req0, feas = _lane_views(out, lanes, n)
    rows = descs.tolist()
    counts = []
    for i in range(lanes):
        _, _, _, c = pivot_window_plain(
            tables[i], lc1[i], lc0[i], hc[i], lowvalid[i], highvalid[i],
            rows[i], int(t0[i]), n, int(t_end[i]), tl, th,
            out=(req1[i], req0[i], feas[i]),
        )
        counts.append(c)
    return req1, req0, feas, torch.stack(counts) if counts else torch.zeros(
        (0, n), dtype=torch.int32, device=dev)


def pivot_window_lanes(tables, lc1, lc0, hc, lowvalid, highvalid, descs, t0,
                       n, t_end, tl, th, out=None):
    """K1's lane form: one launch sweeps a window of ``n`` tiles of every
    lane (``csrc/pivot_tile.cu``, ``sbgt_pivot_window_lanes``).

    Lane l is :func:`pivot_window` over its own operands — ``tables``
    int32[L, B, 8], ``lc1``/``lc0``/``hc`` int32[L, 4, P, 8],
    ``lowvalid``/``highvalid`` bool[L, P], ``descs`` int32[L, T, 5] — for
    tiles ``[t0[l], t0[l] + n)`` cut at ``t_end[l]`` (a lane with ``t0 >=
    t_end`` does no work).  ``t0`` and ``t_end`` are the lanes' host
    ints: the wrapper copies them to the card behind the stream, and counts
    and charges the tiles the lanes sweep (a lane's slots past its
    ``t_end`` are written inert, with no work).  Returns (req1, req0) int32[L, n, tl, th], feas
    bool[L, n, tl, th] and counts int32[L, n]; ``out`` may hold
    :func:`window_lanes_buffers` of at least ``lanes * n`` tiles."""
    dev = lc1.device
    lanes = tables.shape[0]
    for name, t in (("tables", tables), ("lc1", lc1), ("lc0", lc0), ("hc", hc)):
        if t.dtype != torch.int32 or t.device != dev or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous int32 on {dev}")
        if t.shape[-1] != 8 or t.shape[0] != lanes:
            raise ValueError(f"{name} must be [lanes, ..., 8]")
    if lc1.shape != lc0.shape or lc1.shape[1] != 4 or hc.shape[1] != 4:
        raise ValueError("lc1/lc0/hc must be [lanes, 4, rows, 8]")
    for name, t in (("lowvalid", lowvalid), ("highvalid", highvalid)):
        if (t.dtype != torch.bool or t.device != dev or not t.is_contiguous()
                or t.shape != (lanes, lowvalid.shape[1])):
            raise ValueError(f"{name} must be a contiguous bool [lanes, P] on "
                             f"{dev}")
    if (descs.dtype != torch.int32 or descs.device != dev
            or not descs.is_contiguous() or descs.dim() != 3
            or descs.shape[0] != lanes or descs.shape[2] != 5):
        raise ValueError("descs must be a contiguous int32[lanes, T, 5]")
    t0, t_end = [int(x) for x in t0], [int(x) for x in t_end]
    if len(t0) != lanes or len(t_end) != lanes:
        raise ValueError("t0 and t_end must hold one tile index per lane")
    if min(t0 + [0]) < 0 or max(t_end + [0]) > descs.shape[1]:
        raise ValueError("the lanes' descriptors are out of range")
    swept = sum(max(0, min(n, e - s)) for s, e in zip(t0, t_end))
    if out is None:
        out = window_lanes_buffers(lanes, n, tl, th, dev)
    req1, req0, feas = _lane_views(out, lanes, n)
    if req1.shape != (lanes, n, tl, th) or feas.dtype != torch.bool:
        raise ValueError("lane window buffers do not fit the window")
    timed = _tattr.launch(
        "pivot_window_lanes", f"{swept}of{lanes}x{n}x{tl}x{th}",
        lambda: _tattr.window_lanes_cost(swept, lanes * n, tl, th), lc1,
    )
    if not lc1.is_cuda:
        with timed:
            return pivot_window_lanes_plain(
                tables, lc1, lc0, hc, lowvalid, highvalid, descs, t0, n,
                t_end, tl, th, out=out,
            )
    counts = torch.empty((lanes, n), dtype=torch.int32, device=dev)
    bounds = _kernels.upload([t0, t_end], torch.int32, dev)
    fn, args = _kernels.lib().sbgt_pivot_window_lanes, (
        tables.data_ptr(), tables.stride(0), lc1.data_ptr(), lc0.data_ptr(),
        lc1.stride(1), lc1.stride(0), hc.data_ptr(), hc.stride(1),
        hc.stride(0), lowvalid.data_ptr(), highvalid.data_ptr(),
        lowvalid.stride(0), descs.data_ptr(), descs.stride(0),
        bounds[0].data_ptr(), bounds[1].data_ptr(), lanes, n, tl, th,
        req1.data_ptr(), req0.data_ptr(), feas.data_ptr(), counts.data_ptr(),
        _kernels.stream_ptr(dev),
    )
    with timed as events:
        _kernels.check(fn(*args, *events), "pivot_window_lanes")
    launches["lanes"] += 1
    tiles["lanes"] += swept
    return req1, req0, feas, counts
