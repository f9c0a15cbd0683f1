"""Batched candidate sweeps — the device compute core of the search.

PyTorch counterpart of the JAX package's ``ops/sweeps.py`` for the
LUT-mode and gate-mode paths.  The formulation is the same (see that module's docstring): a tuple of
k gate tables groups the 256 truth-table positions into 2^k Karnaugh cells,
and a function of the tuple realizes the target under the mask iff no cell
mixes required-1 and required-0 positions.  Every tuple reduces to two
packed words ``req1``/``req0``; function matching and LUT decomposition
become integer tests on those words.

Conventions:

- Truth-table words travel as **int32 bit patterns** (``~``, ``>>`` and
  ``max`` are missing for ``torch.uint32`` on the CPU).  Right shifts that
  must be logical are masked; hashes run in int64 masked to 32 bits.
- Every sweep is written once, with a leading *lanes* axis (the job axis):
  ``<sweep>_lanes(rows, **statics)`` takes the single-lane call's
  positional operands, one row per lane, and returns one verdict per lane;
  ``<sweep>(*row, **statics)`` is that function on one row.  The JAX
  package merges concurrent jobs' sweeps with ``jax.vmap``
  (``search/batched.py``, ``search/fleet.py``); here the axis is written
  out, and a lane's verdict is the one-row call's with that lane's seed
  (priorities, tie orders and chunk boundaries are per lane).
- Every ``while_loop`` stream of the JAX package is a Python loop over
  chunks or tiles here, in lockstep over the lanes: a round does the device
  work of every lane still running and fetches ONE small verdict row per
  lane in one host sync; a lane that found its hit, or ran out of ranks or
  tiles, drops out and does no more work.  The host values of a round
  reach the card in one copy behind the stream (``_kernels.upload``), not
  a sync.  The loops keep the JAX package's status codes, resume values
  and "first hit in chunk (tile) order", and each stream takes ONE seed per
  lane from its caller, exactly where the JAX package makes one dispatch —
  so a seeded search draws the same host random stream in both packages.
- ``torch.argmax`` returns the first maximal index, as ``jnp.argmax`` does;
  :func:`_topk_lanes` and :func:`_extract_top_rows_lanes` reproduce the JAX
  tie orders of ``lax.top_k`` and of iterated argmax.
- The k=5 cell constraints run the hand-written filter kernel K3
  (:mod:`.lut5_filter`) and the pivot tiles the pivot window kernels
  (:mod:`.pivot_tile`) on the card: a call of one row launches the
  single-lane kernels, a merged call of several rows their lane forms, one
  launch for all lanes.  The 7-LUT solver's small products stay
  ``torch.matmul``: its counts are small integers, exact in bf16 and
  float32.
- A fleet of several job or candidate shards (:func:`job_shards`)
  launches those lane forms split by job shard, each shard's lanes in one
  launch per candidate shard on that shard's device, over its contiguous
  piece of the candidates; the rest of the round runs on the call's
  device, still one sync per round for all lanes.
"""

from __future__ import annotations

import contextlib
import functools
import sys
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .._kernels import upload
from . import combinatorics, pivot_tile, spectral
from .lut5_filter import (
    cell_requirements,
    lut5_filter_cells,
    lut5_filter_cells_lanes,
    pack_bits,
)
from .pivot_tile import (
    PIVOT_CELLBITS,
    pivot_pre_window,
    pivot_window,
    pivot_window_lanes,
    window_buffers,
    window_lanes_buffers,
)

M32 = 0xFFFFFFFF
_I32 = torch.int32
_I64 = torch.int64

# -------------------------------------------------------------------------
# Word helpers
# -------------------------------------------------------------------------


def as_words(a, device) -> torch.Tensor:
    """numpy uint32 words -> int32 bit-pattern tensor on ``device``."""
    # torchlint: ignore[R2x] host word arrays normalized for the upload; the copy is the upload, not a device pull
    arr = np.ascontiguousarray(np.asarray(a, dtype=np.uint32)).view(np.int32)
    return torch.from_numpy(arr.copy()).to(device)


def to_u32(t: torch.Tensor) -> np.ndarray:
    """int32 bit-pattern tensor -> numpy uint32 array."""
    # torchlint: ignore[R2x] deliberate sync by contract: callers convert a resolved chunk's words only after its verdict said hit (one pull per feasible chunk)
    return t.detach().cpu().numpy().astype(np.int32).view(np.uint32)


def _wrap32(x: int) -> int:
    """A Python int as the int32 value the JAX kernels see."""
    return ((int(x) + 2**31) & M32) - 2**31


def eq_mask(a, b, mask):
    """Masked equality over the last (word) axis."""
    return ~(((a ^ b) & mask) != 0).any(dim=-1)


def _cell_constraints(tabs, target, mask):
    """tabs: [N, k, W] -> (req1, req0) bool [2^k, N]."""
    return cell_requirements(tabs.permute(1, 2, 0), target, mask)


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for int64 x in [0, 2^32) without int64 overflow."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & M32


# -------------------------------------------------------------------------
# Lane primitives
# -------------------------------------------------------------------------


def _priority_lanes(n: int, seeds: Sequence[int], *, det_newest: bool = False,
                    device=None) -> torch.Tensor:
    """[L, n] hashed per-row priorities (never zero) for tie-breaking,
    int64 in [1, 2^32), row l with the host seed ``seeds[l]``.  A negative
    seed selects deterministically in scan order (newest first with
    ``det_newest``).  The seeds' signs are known on the host, so a call
    computes only the forms its lanes use."""
    seeds = [_wrap32(s) for s in seeds]
    ar = torch.arange(n, dtype=_I64, device=device)[None, :]
    neg = [s < 0 for s in seeds]
    if any(neg):
        det = (ar + 1) if det_newest else (n - ar)
        if all(neg):
            return det.expand(len(seeds), n)
    if len(seeds) == 1:
        off = seeds[0] & M32
    else:
        off = upload([s & M32 for s in seeds], _I64, device)[:, None]
    x = (ar + off) & M32
    x = _mul32(x ^ (x >> 16), 0x7FEB352D)
    x = _mul32(x ^ (x >> 15), 0x846CA68B)
    x = (x ^ (x >> 16)) | 1
    if not any(neg):
        return x
    return torch.where(upload(neg, torch.bool, device)[:, None], det, x)


def _priority(n: int, seed, *, det_newest: bool = False, device=None):
    """One row of :func:`_priority_lanes`."""
    return _priority_lanes(n, [seed], det_newest=det_newest, device=device)[0]


def _topk_lanes(prio: torch.Tensor, rows: int):
    """(values, indices) [L, rows] of each lane's ``rows`` largest
    priorities, ties broken by the lower index first — the order of
    ``jax.lax.top_k``."""
    n = prio.shape[1]
    key = prio * (1 << 20) + (
        (1 << 20) - 1 - torch.arange(n, dtype=_I64, device=prio.device)
    )
    top = torch.topk(key, rows, dim=1, sorted=True).values
    return top >> 20, (1 << 20) - 1 - (top & ((1 << 20) - 1))


def _extract_top_rows_lanes(prio: torch.Tensor, rows: int) -> torch.Tensor:
    """Per lane, the indices chosen by ``rows`` rounds of argmax-and-clear
    (the JAX pivot solver's selection): positives in descending order, ties
    by the lower index, then index 0 once the positives run out."""
    n = prio.shape[1]
    vals, idx = _topk_lanes(prio, min(rows, n))
    idx = torch.where(vals > 0, idx, torch.zeros_like(idx))
    if rows > n:
        idx = torch.cat([idx, idx.new_zeros((idx.shape[0], rows - n))], dim=1)
    return idx


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[l, idx[l]] for every lane (idx [lanes] or [lanes, k])."""
    if idx.dim() == 1:
        return torch.gather(x, 1, idx[:, None])[:, 0]
    return torch.gather(x, 1, idx)


def _stack(rows, j):
    """Operand ``j`` of every row, stacked on a leading lanes axis (a view
    for one row)."""
    if len(rows) == 1:
        return rows[0][j][None]
    return torch.stack([r[j] for r in rows])


# -------------------------------------------------------------------------
# Match tables
# -------------------------------------------------------------------------


def build_match_table(funs_cellorder: Sequence[int], num_cells: int) -> np.ndarray:
    """Lookup table over (R, C) constraint keys -> smallest matching
    function slot s with ``(funs[s] ^ R) & C == 0``, or -1
    (key = R | C << num_cells)."""
    assert num_cells in (4, 8)
    size = 1 << num_cells
    funs = np.asarray(list(funs_cellorder), dtype=np.int64)
    table = np.full(size * size, -1, dtype=np.int16)
    r = np.arange(size, dtype=np.int64)
    for cbits in range(size):
        valid = (r & ~cbits) == 0
        keys = r[valid] + (cbits << num_cells)
        best = np.full(keys.shape, -1, dtype=np.int16)
        for s in range(len(funs) - 1, -1, -1):
            hit = ((funs[s] ^ r[valid]) & cbits) == 0
            best[hit] = s
        table[keys] = best
    return table


# -------------------------------------------------------------------------
# Node-head sweeps
# -------------------------------------------------------------------------


def _tuple_match_lanes(tables, combos, valid, target, mask, match_table, seeds,
                       num_cells):
    """The k-tuple function-match sweep of every lane (combos [N, k]
    shared, tables [L, G, W], valid [L, N], target/mask [L, W]): (found,
    best index, slot, num_feasible) [L] device tensors."""
    tabs = tables[:, combos.long()]                     # [L, N, k, W]
    req1, req0 = cell_requirements(tabs.permute(2, 0, 3, 1), target, mask)
    feasible = valid & ~(req1 & req0).any(dim=0)
    r = pack_bits(req1).long()
    c = pack_bits(req1 | req0).long()
    slot = match_table[r + (c << num_cells)].long()
    ok = feasible & (slot >= 0)
    prio = torch.where(
        ok, _priority_lanes(ok.shape[1], seeds, device=ok.device), 0
    )
    best = torch.argmax(prio, dim=1)
    return ok.any(dim=1).long(), best, _take(slot, best), feasible.sum(dim=1)


def tuple_match_sweep(tables, combos, valid, target, mask, match_table, seed, *, num_cells):
    """k-tuple sweep against an available-function match table (tables
    [G, W], combos [N, k], valid [N] bool, match_table [4^num_cells]).
    Returns int32[4] [found, index, slot, num_feasible] for a
    priority-selected match."""
    v = torch.stack(_tuple_match_lanes(
        tables[None], combos, valid[None], target[None], mask[None],
        match_table, [seed], num_cells,
    ), dim=1)[0]
    return np.asarray(v.tolist(), np.int32)


def match_scan(tables, valid, target, mask, seed):
    """Existing gate or its complement matching the target
    (sboxgates.c:301-321): [found, index, inverted]."""
    eq = eq_mask(tables, target, mask) & valid
    neq = eq_mask(~tables, target, mask) & valid
    prio = _priority(valid.shape[0], seed, det_newest=True, device=valid.device)
    direct = torch.where(eq, prio, 0)
    inverted = torch.where(neq, prio, 0)
    use_inv = ~eq.any()
    score = torch.where(use_inv, inverted, direct)
    best = torch.argmax(score)
    v = torch.stack([(eq.any() | neq.any()).long(), best, use_inv.long()])
    return np.asarray(v.tolist(), dtype=np.int32)


def lut_filter(tables, combos, valid, target, mask):
    """5/7-LUT stage A: (feasible, req1 packed, req0 packed)."""
    if combos.shape[1] == 5:
        return lut5_filter(tables, combos, valid, target, mask)
    tabs = tables[combos.long()]
    req1, req0 = _cell_constraints(tabs, target, mask)
    feasible = valid & ~(req1 & req0).any(dim=0)
    return feasible, pack_bits(req1), pack_bits(req0)


def lut5_filter(tables, combos, valid, target, mask):
    """Stage-A filter specialized to 5-tuples, through the filter kernel:
    (feasible, req1, req0)."""
    r1, r0 = lut5_filter_cells(tables, combos.to(_I32).contiguous(), target, mask)
    return valid & ((r1 & r0) == 0), r1, r0


# -------------------------------------------------------------------------
# 5/7-LUT solvers
# -------------------------------------------------------------------------

#: Lanes per block of the 5-LUT solver's [lanes, 10, 256, rows] conflict
#: tensors.
SOLVE_LANE_BLOCK = 16


def _lut5_solve_lanes(req1p, req0p, w_tab, m_tab, seeds):
    """5-LUT stage B of every lane: (found [L], best_t [L], sel [L] =
    split * 256 + outer_func) device tensors, no sync.  req1p/req0p [L, T]
    int32, w_tab [10, 256] and m_tab [10, 4] int32, ``seeds`` one host
    int per lane.  Runs in blocks of :data:`SOLVE_LANE_BLOCK` lanes."""
    seeds = [_wrap32(x) for x in seeds]
    outs = [
        _lut5_solve_block(req1p[lo : lo + SOLVE_LANE_BLOCK],
                          req0p[lo : lo + SOLVE_LANE_BLOCK], w_tab, m_tab,
                          seeds[lo : lo + SOLVE_LANE_BLOCK])
        for lo in range(0, req1p.shape[0], SOLVE_LANE_BLOCK)
    ]
    return tuple(torch.cat([o[i] for o in outs]) for i in range(3))


def _lut5_solve_block(req1p, req0p, w_tab, m_tab, seeds):
    dev = req1p.device
    lanes, t = req1p.shape
    r1 = req1p[:, None, None, :]
    r0 = req0p[:, None, None, :]
    w = w_tab[None, :, :, None]
    conflict = torch.zeros((lanes,) + tuple(w_tab.shape) + (t,),
                           dtype=torch.bool, device=dev)
    for m in range(4):
        mm = m_tab[None, :, m, None, None]
        for o in (0, 1):
            cells = (w if o else ~w) & mm
            conflict |= ((r1 & cells) != 0) & ((r0 & cells) != 0)
    ok = ~conflict                                      # [L, 10, 256, T]
    any_t = ok.any(dim=2).any(dim=1)                    # [L, T]
    prio = torch.where(any_t, _priority_lanes(t, seeds, device=dev), 0)
    best_t = torch.argmax(prio, dim=1)
    flat_ok = ok.permute(0, 3, 1, 2)[
        torch.arange(lanes, device=dev), best_t
    ].reshape(lanes, -1)
    flat_prio = torch.where(
        flat_ok, _priority_lanes(flat_ok.shape[1], [x ^ 0x5BD1 for x in seeds],
                                 device=dev), 0
    )
    return any_t.any(dim=1), best_t, torch.argmax(flat_prio, dim=1)


def lut5_solve_lanes(rows):
    """Lane form of :func:`lut5_solve`; rows (req1p, req0p, w_tab, m_tab,
    seed) of one row count, the split tables shared."""
    found, best_t, sel = _lut5_solve_lanes(
        _stack(rows, 0), _stack(rows, 1), rows[0][2], rows[0][3],
        [r[4] for r in rows],
    )
    v = torch.stack([found.long(), best_t, sel], dim=1).tolist()
    return [np.asarray(x, np.int32) for x in v]


def lut5_solve(req1p, req0p, w_tab, m_tab, seed):
    """5-LUT stage B: [found, best_t, sel] int32[3], sel = split * 256 +
    outer_func.  req1p/req0p: [T] int32; w_tab [10, 256], m_tab [10, 4]
    int32."""
    return lut5_solve_lanes([(req1p, req0p, w_tab, m_tab, seed)])[0]


def _unpack_words_to_bits(words):
    """[..., W] int32 -> [..., W*32] 0/1 int32, bit b of word w at w*32+b."""
    sh = torch.arange(32, dtype=_I32, device=words.device)
    b = (words[..., None] >> sh) & 1
    return b.reshape(tuple(words.shape[:-1]) + (words.shape[-1] * 32,))


#: Rows of the 7-LUT solver per product block (bounds the [rows, 256, 256]
#: conflict counts).
_LUT7_ROWS = 256


def _lut7_counts(bits1, bits0, idx, pp):
    """[T, 256, 256] conflicting-pair counts C = PP · B · PPᵀ for one
    ordering; entries are small nonnegative integers, exact in ``pp``'s
    dtype (bf16 on the card, float32 on the CPU)."""
    t = bits1.shape[0]
    a1 = bits1[:, idx].reshape(t, 2, 8, 8).to(pp.dtype)
    a0 = bits0[:, idx].reshape(t, 2, 8, 8).to(pp.dtype)
    b = torch.einsum("txpq,txrs->tprqs", a1, a0).reshape(t, 64, 64)
    ppb = torch.matmul(pp, b)                          # [T, 256, 64]
    return torch.matmul(ppb, pp.t())                   # [T, 256, 256]


def _lut7_solve_lanes(req1p, req0p, idx_tab, pp_tab, seeds):
    """Pair-agreement 7-LUT solver of every lane: one (found, best_t,
    sigma, fo*256+fm) of Python ints per lane.  req1p/req0p: [L, T, 4]
    int32, ``seeds`` host ints.  The lanes' rows are solved together, in
    blocks of :data:`_LUT7_ROWS`; each ordering that gives a row of any
    lane its first hit costs one sync for all lanes."""
    dev = req1p.device
    lanes, num_t = req1p.shape[:2]
    pp = pp_tab.to(torch.bfloat16 if dev.type == "cuda" else torch.float32)
    r1 = req1p.reshape(lanes * num_t, -1)
    r0 = req0p.reshape(lanes * num_t, -1)
    # A row with a cell required both ways conflicts under every (fo, fm):
    # the pair of that cell with itself always agrees.  Only the other rows
    # are counted; the callers' all-ones padding rows are among the skipped.
    live = torch.nonzero(((r1 & r0) == 0).all(dim=1)).flatten()
    lane_of = live // num_t
    bits1 = _unpack_words_to_bits(r1[live])
    bits0 = _unpack_words_to_bits(r0[live])
    found = torch.zeros(lanes * num_t, dtype=torch.bool, device=dev)
    sel_sigma = torch.full((lanes * num_t,), -1, dtype=_I64, device=dev)
    sel_flat = torch.zeros(lanes * num_t, dtype=_I64, device=dev)
    s32 = [_wrap32(s) for s in seeds]
    for sigma in range(idx_tab.shape[0]):
        idx = idx_tab[sigma].long()
        any_t = torch.zeros_like(found)
        flat = torch.zeros_like(sel_flat)
        blocks = []
        for lo in range(0, live.shape[0], _LUT7_ROWS):
            hi = lo + _LUT7_ROWS
            ok = _lut7_counts(bits1[lo:hi], bits0[lo:hi], idx, pp) == 0
            blocks.append((live[lo:hi], lane_of[lo:hi], ok))
            any_t[live[lo:hi]] = ok.flatten(1).any(dim=1)
        newly = any_t & ~found
        if bool(newly.any()):
            fprio = _priority_lanes(256 * 256, [s ^ (sigma * 2 + 1) for s in s32],
                                    device=dev)
            for rows, lane, ok in blocks:
                flat[rows] = torch.argmax(
                    torch.where(ok.flatten(1), fprio[lane], 0), dim=-1
                )
        sel_sigma = torch.where(newly, sigma, sel_sigma)
        sel_flat = torch.where(newly, flat, sel_flat)
        found |= any_t
    found = found.view(lanes, num_t)
    prio = torch.where(found, _priority_lanes(num_t, s32, device=dev), 0)
    best_t = torch.argmax(prio, dim=1)
    out = torch.stack([
        found.any(dim=1).long(), best_t, _take(sel_sigma.view(lanes, num_t), best_t),
        _take(sel_flat.view(lanes, num_t), best_t),
    ], dim=1)
    return [tuple(int(x) for x in v) for v in out.tolist()]


def lut7_solve_lanes(rows):
    """Lane form of :func:`lut7_solve`; rows (req1p, req0p, idx_tab,
    pp_tab, seed) of one row count, the tables shared."""
    return [np.asarray(v, np.int32) for v in _lut7_solve_lanes(
        _stack(rows, 0), _stack(rows, 1), rows[0][2], rows[0][3],
        [r[4] for r in rows],
    )]


def lut7_solve(req1p, req0p, idx_tab, pp_tab, seed):
    """7-LUT stage B: [found, best_t, sigma, fo*256+fm] int32[4].
    req1p/req0p: [T, 4] int32."""
    return lut7_solve_lanes([(req1p, req0p, idx_tab, pp_tab, seed)])[0]


# -------------------------------------------------------------------------
# Device-resident combination streaming
# -------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def binom_table(max_n: int = 513, max_k: int = 8) -> np.ndarray:
    """C(n, k) for n < max_n, k <= max_k, saturating at uint32 max."""
    t = np.zeros((max_n, max_k + 1), dtype=np.uint64)
    t[:, 0] = 1
    for n in range(1, max_n):
        t[n, 1:] = t[n - 1, : max_k] + t[n - 1, 1:]
        np.minimum(t[n], np.uint64(0xFFFFFFFF), out=t[n])
    return t.astype(np.uint32)


@functools.lru_cache(maxsize=None)
def binom_table_wide(max_n: int = 513, max_k: int = 8):
    """Exact C(n, k) as two uint32 planes (lo, hi)."""
    t = combinatorics._binom_u64(max_n - 1, max_k)
    lo = (t & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    hi = (t >> np.uint64(32)).astype(np.uint32)
    return lo, hi


def binom_device(device) -> torch.Tensor:
    """The saturating table as the int64 values of its int32 bit patterns
    (the JAX streams read it through ``astype(int32)``)."""
    return torch.from_numpy(binom_table().view(np.int32).astype(np.int64)).to(device)


def binom_wide_device(device) -> torch.Tensor:
    """The exact table as int64 (every entry is below 2^59)."""
    lo, hi = binom_table_wide()
    t = lo.astype(np.int64) | (hi.astype(np.int64) << 32)
    return torch.from_numpy(t).to(device)


def device_rank_limit(g: int, k: int) -> bool:
    """True when C(g, k) fits int32 rank arithmetic."""
    import math

    return g < 513 and math.comb(g, k) < 2**31


def _ranks(start: int, chunk: int, device) -> torch.Tensor:
    return start + torch.arange(chunk, dtype=_I64, device=device)


def _unrank_lanes(binom, g, gmax: int, k: int, ranks):
    """Vectorized lexicographic unranking of every lane: ``binom`` int64
    [513, 9], ``g`` int64 [L] the lanes' gate counts on the device (host
    maximum ``gmax``), ``ranks`` int64 [L, N] (each < C(g_l, k)) -> combos
    int64 [k, L, N].

    Position p takes the largest value v >= lo (lo one past the previous
    value) whose preceding blocks fit the remaining rank: the combinations
    with element p in [lo, v) number C(g-lo, r) - C(g-v, r), r = k - p
    (the hockey-stick sum of the C(g-u-1, r-1) blocks).  Found by a binary
    search of ``gmax.bit_length()`` steps per position, so the device work
    is k log g steps, not g; a lane with fewer gates has converged by its
    own count and stays put."""
    gcol = g[:, None]
    rem = ranks.clone()
    lo = torch.zeros_like(ranks)
    out = torch.empty((k,) + tuple(ranks.shape), dtype=_I64, device=ranks.device)
    for p in range(k):
        r = k - p
        col = binom[:, r]
        below = col[gcol - lo]                  # C(g-lo, r)
        a, b = lo, (gcol - r).expand_as(lo)     # v always fits at a
        for _ in range(int(gmax).bit_length()):
            mid = (a + b + 1) >> 1
            fits = below - col[gcol - mid] <= rem
            a = torch.where(fits, mid, a)
            b = torch.where(fits, b, mid - 1)
        out[p] = a
        rem = rem - (below - col[gcol - a])
        lo = a + 1
    return out


def _unrank_combos(binom, g, k, ranks):
    """One lane of :func:`_unrank_lanes`: ``ranks`` int64 [N] -> combos
    int64 [k, N]."""
    gt = torch.full((1,), int(g), dtype=_I64, device=ranks.device)
    return _unrank_lanes(binom, gt, int(g), k, ranks[None])[:, 0]


def _unrank_combos_wide(binom_wide, g, k, ranks):
    """64-bit twin of :func:`_unrank_combos` (exact binomials)."""
    return _unrank_combos(binom_wide, g, k, ranks)


# -------------------------------------------------------------------------
# Job shards: a fleet's lane-form launches split by job and candidate shard
# -------------------------------------------------------------------------

_JOBS = threading.local()

#: Lane-form launches of job shards (:func:`job_shards`), by kernel
#: (``"lut5_filter_lanes"``, ``"pivot_window_lanes"``) and job shard.
JOB_SHARD_LAUNCHES: Dict[str, Dict[int, int]] = {}

#: The same launches by kernel and local shard ``j * C + c`` of the
#: (job shard j, candidate shard c) that made them.
CANDIDATE_SHARD_LAUNCHES: Dict[str, Dict[int, int]] = {}


@contextlib.contextmanager
def job_shards(devices, candidates=None):
    """Runs the block's lane-form launches split by job shard, as the JAX
    package's ``P("jobs")`` places a fleet's lanes: of an n-row lane-form
    call, job shard j (of J = ``len(devices)``) owns the rows [j * ceil(n /
    J), (j + 1) * ceil(n / J)), and its lanes of each K1 or K3 lane-form
    launch run on its own devices, their operands copied there and their
    outputs back to the call's device.  ``candidates[j]`` lists job shard
    j's C candidate shards' devices (default: ``[devices[j]]``, C = 1):
    the launch's candidate dimension (K3's 5-tuples, K1's window of tiles)
    is cut into C contiguous pieces (:func:`candidate_pieces`), piece c
    one launch on ``candidates[j][c]``.  The split is by shard, not by
    device: shards that share a device launch once each."""
    devices = list(devices)
    if candidates is None:
        candidates = [[d] for d in devices]
    prev = getattr(_JOBS, "shards", None)
    _JOBS.shards = (devices, [list(c) for c in candidates])
    try:
        yield
    finally:
        _JOBS.shards = prev


def job_blocks(rows: Sequence[int], n: int):
    """(job shard, device, lo, hi) of each run of a launch's lanes that one
    job shard owns, in lane order, lane i being row ``rows[i]`` of an
    n-row call; None outside :func:`job_shards`."""
    shards = getattr(_JOBS, "shards", None)
    if shards is None:
        return None
    devices = shards[0]
    per = -(-n // len(devices))
    out: List[list] = []
    for i, r in enumerate(rows):
        j = int(r) // per
        if out and out[-1][0] == j:
            out[-1][3] = i + 1
        else:
            out.append([j, devices[j], i, i + 1])
    return [tuple(b) for b in out]


def candidate_pieces(n: int, parts: int):
    """(c, lo, hi) of the ``parts`` contiguous pieces of a candidate range
    of n: piece c is [c * per, min((c + 1) * per, n)), per = ceil(n /
    parts); empty pieces are left out."""
    per = -(-n // parts)
    return [(c, c * per, min((c + 1) * per, n))
            for c in range(parts) if c * per < n]


def _candidate_devices(shard: int):
    """Job shard ``shard``'s candidate shards' devices (inside
    :func:`job_shards`)."""
    return _JOBS.shards[1][shard]


def candidate_blocks(shard: int, n: int):
    """(candidate shard, device, lo, hi) of job shard ``shard``'s pieces of
    an n-long candidate range (inside :func:`job_shards`)."""
    devs = _candidate_devices(shard)
    return [(c, devs[c], lo, hi) for c, lo, hi in candidate_pieces(n, len(devs))]


def device_ctx(dev):
    """The current-device context of a launch on ``dev`` (a kernel
    launches on the current card, whatever its pointers' device)."""
    if dev.type == "cuda":
        return torch.cuda.device(dev)
    return contextlib.nullcontext()


def _join(parts, dim: int):
    """``torch.cat(parts, dim)``; a single part as it is (C = 1)."""
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim)


def _job_launch(kernel: str, shard: int, cand: int, dev, fn, *args, **kw):
    """``fn(*args, **kw)``, a lane-form launch of candidate shard ``cand``
    of job shard ``shard``, on ``dev``; counted in
    :data:`JOB_SHARD_LAUNCHES` and :data:`CANDIDATE_SHARD_LAUNCHES`."""
    with device_ctx(dev):
        out = fn(*args, **kw)
    by = JOB_SHARD_LAUNCHES.setdefault(kernel, {})
    by[shard] = by.get(shard, 0) + 1
    local = shard * len(_candidate_devices(shard)) + cand
    by = CANDIDATE_SHARD_LAUNCHES.setdefault(kernel, {})
    by[local] = by.get(local, 0) + 1
    return out


def _filter5(tables, combos, target, mask, merged: bool, rows=None, n=0):
    """K3 over the lanes' 5-tuples (tables [L, B, 8], combos int32 [L, N,
    5]): its lane form for a merged call, else (one lane) the single-lane
    kernel.  Under :func:`job_shards`, lane i being row ``rows[i]`` of the
    n-row call, one lane-form launch per job shard and piece of the N
    5-tuples.  Returns (req1, req0) int32 [L, N] on the operands' device."""
    if merged:
        ops = (tables, combos, target.contiguous(), mask.contiguous())
        blocks = None if rows is None else job_blocks(rows, n)
        if blocks is None:
            return lut5_filter_cells_lanes(*ops)
        outs = [[_job_launch("lut5_filter_lanes", j, c, d,
                             lut5_filter_cells_lanes, tables[lo:hi].to(d),
                             combos[lo:hi, a:b].contiguous().to(d),
                             *(x[lo:hi].to(d) for x in ops[2:]))
                 for c, d, a, b in candidate_blocks(j, combos.shape[1])]
                for j, _, lo, hi in blocks]
        return tuple(torch.cat([_join([o[k].to(tables.device)
                                       for o in parts], 1)
                                for parts in outs])
                     for k in (0, 1))
    r1, r0 = lut5_filter_cells(tables[0], combos[0], target[0].contiguous(),
                               mask[0].contiguous())
    return r1[None], r0[None]


def _chunk_constraints_lanes(tables, binom, g, gmax, k, target, mask, excl,
                             ranks, total, merged, rows=None, n=0):
    """Per-chunk work of every lane: unrank -> exclusion mask -> cell
    constraints.  tables [L, B, 8], g/total int64 [L], target/mask/excl
    [L, W], ranks int64 [L, N] -> (feasible [L, N] bool, req1, req0) with
    req [L, N] (k <= 5) or [L, N, 2^k/32] packed; lane i is row
    ``rows[i]`` of an n-row call (:func:`_filter5`)."""
    tot = total[:, None]
    valid = ranks < tot
    ranks = torch.minimum(ranks, tot - 1)
    combos = _unrank_lanes(binom, g, gmax, k, ranks)    # [k, L, N]
    hit = (combos[..., None] == excl.long()[None, :, None, :]).any(dim=3)
    valid = valid & ~hit.any(dim=0)
    if k == 5:
        r1, r0 = _filter5(tables, combos.permute(1, 2, 0).to(_I32).contiguous(),
                          target, mask, merged, rows, n)
        return valid & ((r1 & r0) == 0), r1, r0
    li = torch.arange(tables.shape[0], device=tables.device)[None, :, None]
    tabs = tables[li, combos].permute(0, 1, 3, 2)       # [k, L, W, N]
    req1, req0 = cell_requirements(tabs, target, mask)
    feasible = valid & ~(req1 & req0).any(dim=0)
    return feasible, pack_bits(req1), pack_bits(req0)


class _Lanes:
    """The stacked operands of the lanes' combination streams (tables
    [L, B, 8], gate counts, target, mask and exclusions [L, W]) and the
    chunk of one lockstep round.  ``merged`` (a call of several rows) runs
    the 5-tuples through K3's lane form, else through K3."""

    def __init__(self, tables, g: Sequence[int], target, mask, excl, binom,
                 merged: bool):
        self.tables, self.target, self.mask, self.excl = (
            tables, target, mask, excl
        )
        self.binom, self.merged = binom, merged
        self.dev = tables.device
        self.g_host = [int(x) for x in g]
        self.g = upload(self.g_host, _I64, self.dev)

    def chunk(self, idx, starts, totals, seeds, k: int, chunk: int):
        """One round of lanes ``idx``: ranks [starts[i], starts[i] + chunk)
        cut at totals[i], their host values copied up in one copy.  Returns
        (feasible [R, chunk], req1, req0, ranks, the seeds wrapped to
        int32)."""
        up = upload([list(starts), list(totals), list(idx)], _I64, self.dev)
        if list(idx) == list(range(self.tables.shape[0])):
            pick = lambda x: x  # noqa: E731
        else:
            pick = lambda x: x[up[2]]  # noqa: E731
        ranks = up[0][:, None] + torch.arange(chunk, dtype=_I64, device=self.dev)
        feasible, r1, r0 = _chunk_constraints_lanes(
            pick(self.tables), self.binom, pick(self.g),
            max(self.g_host[j] for j in idx), k, pick(self.target),
            pick(self.mask), pick(self.excl), ranks, up[1], self.merged,
            idx, self.tables.shape[0],
        )
        return feasible, r1, r0, ranks, [_wrap32(s) for s in seeds]


def _stream_lanes(rows) -> _Lanes:
    """_Lanes of the common stream operands (tables, binom, g, target,
    mask, excl) at positions 0-5 of every row."""
    return _Lanes(_stack(rows, 0), [r[2] for r in rows], _stack(rows, 3),
                  _stack(rows, 4), _stack(rows, 5), rows[0][1], len(rows) > 1)


def _feasible_lanes(ln: _Lanes, starts, totals, k, chunk):
    """Lockstep feasibility streams of every lane of ``ln``: each sweeps
    ranks [start, total) to the first chunk holding a feasible k-tuple.
    Returns per lane (found, chunk_start, next_rank, (feasible [chunk],
    req1, req0) of its last chunk)."""
    dev = ln.dev
    n = len(starts)
    nxt, cstart, found = list(starts), list(starts), [False] * n
    shape = (chunk,) if k <= 5 else (chunk, (1 << k) // 32)
    zero = torch.zeros(shape, dtype=_I32, device=dev)
    last = [(torch.zeros(chunk, dtype=torch.bool, device=dev), zero, zero)] * n
    live = [j for j in range(n) if nxt[j] < totals[j]]
    while live:
        feas, r1, r0, _, _ = ln.chunk(live, [nxt[j] for j in live],
                                      [totals[j] for j in live], [0] * len(live),
                                      k, chunk)
        # torchlint: ignore[R2] deliberate sync: one any-feasible flag per live lane per chunk, the lane stream's only sync point
        anyf = feas.any(dim=1).tolist()
        nxt_live = []
        for i, j in enumerate(live):
            last[j] = (feas[i], r1[i], r0[i])
            found[j] = bool(anyf[i])
            cstart[j], nxt[j] = nxt[j], nxt[j] + chunk
            if not found[j] and nxt[j] < totals[j]:
                nxt_live.append(j)
        live = nxt_live
    return [(found[j], cstart[j], nxt[j], last[j]) for j in range(n)]


def feasible_stream_lanes(rows, *, k, chunk):
    """Lane form of :func:`feasible_stream`; rows (tables, binom, g,
    target, mask, excl, start, total)."""
    starts = [int(r[6]) for r in rows]
    totals = [int(r[7]) for r in rows]
    out = _feasible_lanes(_stream_lanes(rows), starts, totals, k, chunk)
    return [
        (np.asarray([int(f), cs, min(nx, tot) - s], np.int32), *last)
        for (f, cs, nx, last), s, tot in zip(out, starts, totals)
    ]


def feasible_stream(tables, binom, g, target, mask, excl, start, total, *, k, chunk):
    """Sweeps ranks [start, total) chunk by chunk, stopping at the first
    chunk containing a feasible k-tuple.  Returns (verdict int32[3]
    [found, chunk_start, examined], feasible [chunk], req1, req0) —
    candidate ranks are chunk_start + arange(chunk)."""
    return feasible_stream_lanes(
        [(tables, binom, g, target, mask, excl, start, total)], k=k, chunk=chunk
    )[0]


#: Ranks unranked at once by :func:`spectral_score_stream` (whole chunks).
SCORE_BATCH_RANKS = 1 << 20


def spectral_score_stream(tables, binom, g, target, mask, excl, total, *, k, chunk,
                          n_chunks):
    """Per-chunk spectral scores of the whole rank space: int32[n_chunks].

    The best-first prepass: the gate tables are Walsh-scored against the
    masked target (kernel K5 on the card, :func:`spectral.gate_scores`),
    then every chunk of combination ranks is unranked and reduced to
    ``max over combos of (sum of element gate scores)``; excluded and
    out-of-range rows score -1, and chunks past ``ceil(total / chunk)``
    come back -1.  The JAX package walks the chunks one at a time; here
    they go in batches of whole chunks, with the same result."""
    dev = tables.device
    total = int(total)
    gscores = spectral.gate_scores(tables, target, mask)
    out = torch.full((n_chunks,), -1, dtype=_I32, device=dev)
    n_real = min(-(-total // chunk), n_chunks)
    per = max(1, SCORE_BATCH_RANKS // chunk)
    ex = excl.long()[None, None, :]
    for c0 in range(0, n_real, per):
        c1 = min(c0 + per, n_real)
        ranks = _ranks(c0 * chunk, (c1 - c0) * chunk, dev)
        combos = _unrank_combos(binom, g, k, torch.clamp(ranks, max=total - 1))
        keep = (ranks < total) & ~(combos[:, :, None] == ex).any(dim=2).any(dim=0)
        s = gscores[combos].sum(dim=0, dtype=_I32)             # <= k * 256
        s = torch.where(keep, s, torch.full_like(s, -1))
        out[c0:c1] = s.reshape(c1 - c0, chunk).amax(dim=1)
    return out


#: The pivot sweep's tile scorer runs the gate-score stage alone (tiles key
#: on their pivot gate, so per-gate scores tier them with no rank arithmetic).
spectral_gate_scores = spectral.gate_scores


def _lut3_lanes(ln: _Lanes, idx, starts, totals, seeds, chunk):
    """Lockstep whole-space 3-LUT streams of lanes ``idx`` of ``ln``: one
    (found, rank, req1, req0, examined) per lane."""
    n = len(idx)
    nxt = [int(s) for s in starts]
    res = [[0, 0, 0, 0] for _ in range(n)]
    live = [j for j in range(n) if nxt[j] < totals[j]]
    while live:
        feasible, r1, r0, ranks, cseeds = ln.chunk(
            [idx[j] for j in live], [nxt[j] for j in live],
            [totals[j] for j in live],
            [_wrap32(seeds[j]) ^ nxt[j] for j in live], 3, chunk,
        )
        prio = torch.where(feasible, _priority_lanes(chunk, cseeds, device=ln.dev), 0)
        best = torch.argmax(prio, dim=1)
        # torchlint: ignore[R2] deliberate sync: one compact verdict row per live lane per chunk, the lane stream's only sync point
        rows = torch.stack([
            feasible.any(dim=1).long(), _take(ranks, best),
            _take(r1, best).long(), _take(r0, best).long(),
        ], dim=1).tolist()
        nxt_live = []
        for j, row in zip(live, rows):
            res[j] = row
            nxt[j] += chunk
            if not row[0] and nxt[j] < totals[j]:
                nxt_live.append(j)
        live = nxt_live
    return [
        (*res[j], min(nxt[j], totals[j]) - int(starts[j])) for j in range(n)
    ]


def lut3_stream_lanes(rows, *, chunk):
    """Lane form of :func:`lut3_stream`; rows (tables, binom, g, target,
    mask, excl, start, total, seed)."""
    out = _lut3_lanes(_stream_lanes(rows), list(range(len(rows))),
                      [r[6] for r in rows], [int(r[7]) for r in rows],
                      [r[8] for r in rows], chunk)
    return [np.asarray(v, np.int32) for v in out]


def lut3_stream(tables, binom, g, target, mask, excl, start, total, seed, *, chunk):
    """Whole-space 3-LUT search (reference: lut.c:501-523): int32[5]
    [found, rank, req1, req0, examined]."""
    return lut3_stream_lanes(
        [(tables, binom, g, target, mask, excl, start, total, seed)], chunk=chunk
    )[0]


def _lut5_lanes(ln: _Lanes, idx, starts, totals, w_tab, m_tab, seeds, chunk,
                solve_rows):
    """Lockstep whole-space 5-LUT streams of lanes ``idx`` of ``ln``: one
    (status, rank, sigma, func_outer, req1, req0, cstart, examined) per
    lane.  Each round filters every running lane's chunk (one K3 launch)
    and solves the lanes' top rows together, in one sync for all."""
    n = len(idx)
    nxt = [int(s) for s in starts]
    cstart = list(nxt)
    res = [(0, 0, 0, 0, 0, 0) for _ in range(n)]
    live = [j for j in range(n) if nxt[j] < totals[j]]
    while live:
        feasible, r1, r0, ranks, cseeds = ln.chunk(
            [idx[j] for j in live], [nxt[j] for j in live],
            [totals[j] for j in live],
            [_wrap32(seeds[j]) ^ nxt[j] for j in live], 5, chunk,
        )
        prio = torch.where(feasible, _priority_lanes(chunk, cseeds, device=ln.dev), 0)
        topv, topi = _topk_lanes(prio, solve_rows)
        fsel = topv > 0
        sr1 = torch.where(fsel, torch.gather(r1, 1, topi), -1)
        sr0 = torch.where(fsel, torch.gather(r0, 1, topi), -1)
        found, best_t, sel = _lut5_solve_lanes(sr1, sr0, w_tab, m_tab,
                                               [x ^ 0x9E37 for x in cseeds])
        # torchlint: ignore[R2] deliberate sync: one compact verdict row per live lane per chunk, the lane stream's only sync point
        rows = torch.stack([
            feasible.any(dim=1).long(), found.long(), feasible.sum(dim=1),
            _take(ranks, _take(topi, best_t)), sel,
            _take(sr1, best_t).long(), _take(sr0, best_t).long(),
        ], dim=1).tolist()
        nxt_live = []
        for j, (anyf, fnd, nfeas, rank, sl, r1b, r0b) in zip(live, rows):
            if anyf:
                overflow = nfeas > solve_rows and not fnd
                status = 1 if fnd else (2 if overflow else 0)
                res[j] = (status, rank, sl // 256, sl % 256, r1b, r0b)
            else:
                res[j] = (0, 0, 0, 0, 0, 0)
            cstart[j], nxt[j] = nxt[j], nxt[j] + chunk
            if res[j][0] == 0 and nxt[j] < totals[j]:
                nxt_live.append(j)
        live = nxt_live
    return [
        (*res[j], cstart[j], min(nxt[j], totals[j]) - int(starts[j]))
        for j in range(n)
    ]


def lut5_stream_lanes(rows, *, chunk, solve_rows=1024):
    """Lane form of :func:`lut5_stream`; rows (tables, binom, g, target,
    mask, excl, start, total, w_tab, m_tab, seed), the split tables
    shared."""
    out = _lut5_lanes(_stream_lanes(rows), list(range(len(rows))),
                      [r[6] for r in rows], [int(r[7]) for r in rows],
                      rows[0][8], rows[0][9], [r[10] for r in rows], chunk,
                      solve_rows)
    return [np.asarray(v, np.int32) for v in out]


def lut5_stream(
    tables, binom, g, target, mask, excl, start, total, w_tab, m_tab, seed,
    *, chunk, solve_rows=1024,
):
    """Whole-space 5-LUT search (reference: search_5lut, lut.c:116-249):
    int32[8] [status, rank, sigma, func_outer, req1, req0, cstart, examined]
    with status 0 = exhausted, 1 = found, 2 = a chunk had more than
    ``solve_rows`` feasible tuples and none of the solved subset decomposed
    (re-drive it via feasible_stream, then resume at cstart + chunk)."""
    return lut5_stream_lanes(
        [(tables, binom, g, target, mask, excl, start, total, w_tab, m_tab, seed)],
        chunk=chunk, solve_rows=solve_rows,
    )[0]


def _match_lanes(ln: _Lanes, idx, starts, totals, seeds, match_table, k, chunk,
                 num_cells):
    """Lockstep streaming tuple-match sweeps of lanes ``idx`` of ``ln``:
    one (found, abs_rank, slot, examined) per lane.  A lane stops after the
    first chunk holding a match; on a miss the rank and slot are its last
    chunk's argmax, as in the JAX package."""
    n = len(idx)
    nxt = [int(s) for s in starts]
    res = [(0, 0, -1) for _ in range(n)]
    live = [j for j in range(n) if nxt[j] < totals[j]]
    while live:
        feasible, r1, r0, _, cseeds = ln.chunk(
            [idx[j] for j in live], [nxt[j] for j in live],
            [totals[j] for j in live],
            [_wrap32(seeds[j]) ^ nxt[j] for j in live], k, chunk,
        )
        # packing is per-cell bitwise, so pack(req1 | req0) == r1 | r0
        slots = match_table[r1.long() + ((r1 | r0).long() << num_cells)].long()
        ok = feasible & (slots >= 0)
        prio = torch.where(ok, _priority_lanes(chunk, cseeds, device=ln.dev), 0)
        best = torch.argmax(prio, dim=1)
        # torchlint: ignore[R2] deliberate sync: one compact verdict row per live lane per chunk, the lane stream's only sync point
        rows = torch.stack(
            [ok.any(dim=1).long(), best, _take(slots, best)], dim=1
        ).tolist()
        nxt_live = []
        for j, (found, b, slot) in zip(live, rows):
            res[j] = (found, nxt[j] + b, slot)
            nxt[j] += chunk
            if not found and nxt[j] < totals[j]:
                nxt_live.append(j)
        live = nxt_live
    return [
        (*res[j], min(nxt[j], totals[j]) - int(starts[j])) for j in range(n)
    ]


def match_stream(
    tables, binom, g, target, mask, excl, start, total, match_table, seed,
    *, k, chunk, num_cells,
):
    """Streaming :func:`tuple_match_sweep` over ranks [start, total), to the
    first chunk where a valid tuple matches an available function.
    Returns int32[4] [found, abs_rank, slot, examined]."""
    ln = _stream_lanes([(tables, binom, g, target, mask, excl)])
    return np.asarray(_match_lanes(ln, [0], [start], [int(total)], [seed],
                                   match_table, k, chunk, num_cells)[0], np.int32)


# -------------------------------------------------------------------------
# Pivot-structured 5-LUT sweep
#
# Every 5-set {a<b<m<d<e} is (low pair (a,b)) x (pivot m) x (high pair
# (d,e)).  Pair cell masks are computed once per search; low pairs sorted by
# (max, min) put all pairs below a pivot in a contiguous prefix and high
# pairs sorted by (min, max) put all pairs above it in a contiguous suffix,
# so a tile of candidates is two row slices and a candidate is (pivot, row,
# col) — no gathers, no rank arithmetic.
# -------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def pivot_pair_grids(g: int):
    """(lowgrid [P2,2] sorted by (b,a), highgrid [P2,2] sorted by (d,e),
    high_offsets [g+1]): pairs with d >= m start at high_offsets[m]."""
    lows = np.array(
        [(a, b) for b in range(g) for a in range(b)], dtype=np.int32
    ).reshape(-1, 2)
    highs = np.array(
        [(d, e) for d in range(g) for e in range(d + 1, g)], dtype=np.int32
    ).reshape(-1, 2)
    offs = np.zeros(g + 1, dtype=np.int64)
    for m in range(1, g + 1):
        offs[m] = offs[m - 1] + (g - 1 - (m - 1))
    return lows, highs, offs


def pivot_tile_descs(g: int, tl: int, th: int, excl=()) -> np.ndarray:
    """Tile descriptors [T, 5]: (pivot m, lo0, lo_end, hi0, hi_end) covering
    every 5-set exactly once (lo/hi are absolute rows into the grids)."""
    _, _, offs = pivot_pair_grids(g)
    excl = set(int(b) for b in excl)
    descs = []
    for m in range(2, g - 2):
        if m in excl:
            continue
        nlo = m * (m - 1) // 2
        hi_base = int(offs[m + 1])
        nhi = (g - 1 - m) * (g - 2 - m) // 2
        for lo0 in range(0, nlo, tl):
            lo_end = min(nlo, lo0 + tl)
            for h0 in range(0, nhi, th):
                descs.append(
                    (m, lo0, lo_end, hi_base + h0, hi_base + min(nhi, h0 + th))
                )
    if not descs:
        return np.zeros((0, 5), dtype=np.int32)
    return np.asarray(descs, dtype=np.int32)


def pivot_pair_cells_lanes(rows):
    """Lane form of :func:`pivot_pair_cells`; rows (tables, lowgrid,
    highgrid, target, mask).  Returns one (lc1, lc0, hc) per lane."""
    tables, lg, hg = _stack(rows, 0), _stack(rows, 1), _stack(rows, 2)
    target, mask = _stack(rows, 3), _stack(rows, 4)
    li = torch.arange(tables.shape[0], device=tables.device)[:, None]
    need1 = (mask & target)[:, None, None, :]
    need0 = (mask & ~target)[:, None, None, :]

    def cells(grid):
        tx = tables[li, grid[..., 0].long()]
        ty = tables[li, grid[..., 1].long()]
        return torch.stack([~tx & ~ty, ~tx & ty, tx & ~ty, tx & ty], dim=1)

    lc = cells(lg)
    lc1, lc0, hc = lc & need1, lc & need0, cells(hg)
    return [(lc1[i], lc0[i], hc[i]) for i in range(len(rows))]


def pivot_pair_cells(tables, lowgrid, highgrid, target, mask):
    """Per-pair cell masks: (lc1, lc0) [4, P2, W] for low pairs (cells
    pre-intersected with the required-1/required-0 positions) and hc
    [4, P2, W] for high pairs.  Cell j of a pair (x, y) is the positions
    where (x, y) take the bit pattern (j>>1, j&1)."""
    return pivot_pair_cells_lanes([(tables, lowgrid, highgrid, target, mask)])[0]


_PIVOT_CELLBITS = PIVOT_CELLBITS

#: The pivot sweep's window kernel of each ``--pivot-backend``.
PIVOT_WINDOWS = {"packed": pivot_window, "pre": pivot_pre_window}
PIVOT_BACKENDS = tuple(PIVOT_WINDOWS)

#: Most tiles in one window of the pivot sweep.  The
#: windows start at one tile and double up to this cap, so a hit in the
#: first tiles costs what one tile costs, and a long sweep runs full
#: windows (buffers: 64 x 2 MB of req words and 64 x 256 KB of feasible
#: flags at 512 x 512 tiles).
PIVOT_WINDOW_TILES = 64




def pack_lanes(x: torch.Tensor) -> torch.Tensor:
    """[..., W*32] int8 0/1 lanes -> [..., W] int32 words (the inverse of
    :func:`.pivot_tile.expand_lanes`)."""
    b = x.reshape(x.shape[:-1] + (x.shape[-1] // 32, 32)).to(_I32)
    sh = torch.arange(32, dtype=_I32, device=x.device)
    return (b << sh).sum(dim=-1, dtype=_I32)


_JOB_AXIS_NOTED = False


def job_axis_backend(backend: str) -> str:
    """The pivot backend of a sweep with a job axis: K1's lane form,
    whatever ``--pivot-backend`` says (there is no lane form of K2); a
    ``pre`` setting is noted once on stderr.  The verdicts are the same."""
    global _JOB_AXIS_NOTED
    if backend not in PIVOT_BACKENDS:
        raise ValueError(f"unknown pivot backend {backend!r}")
    if backend != "packed" and not _JOB_AXIS_NOTED:
        _JOB_AXIS_NOTED = True
        print(
            f"sboxgates_tpu_torch: --pivot-backend {backend} is single-lane "
            "only; pivot sweeps with a job axis run K1's lane form "
            "(bit-identical results)",
            file=sys.stderr, flush=True,
        )
    return "packed"


def _pad_rows(ts: List[torch.Tensor], dim: int, fill=0) -> torch.Tensor:
    """Stacks per-lane tensors, padding ``dim`` (of each) to the longest."""
    size = max(t.shape[dim] for t in ts)
    out = []
    for t in ts:
        if t.shape[dim] < size:
            pad_shape = list(t.shape)
            pad_shape[dim] = size - t.shape[dim]
            t = torch.cat([t, torch.full(pad_shape, fill, dtype=t.dtype,
                                         device=t.device)], dim=dim)
        out.append(t)
    return torch.stack(out)


class _PivotLanes:
    """The lanes' pivot operands and their window launches.  Rows are
    (tables, lc1, lc0, hc, lowvalid, highvalid, descs, ...) as
    :class:`PivotOperands` gives them; lane l sweeps tiles [base[l],
    t_end[l]) of its host descriptor array, of which that range goes to the
    card, one copy for all lanes.  A merged call (several rows) stacks the
    lanes, padding the pair arrays to the longest (pad rows invalid), and
    launches K1's lane form on words (a ``pre`` row's int8 lanes are packed
    back), under :func:`job_shards` one launch per job shard and piece of
    the window's tiles on its candidate shard's device, each shard's lanes'
    operands copied once to each of its devices; a call of one row
    launches the backend's window kernel (:data:`PIVOT_WINDOWS`) on the
    row's own operands."""

    def __init__(self, rows, base, t_end, backend: str, tl: int, th: int):
        self.tl, self.th = tl, th
        self.lanes = len(rows)
        self.merged = self.lanes > 1
        self.blocks = None
        self.dev = rows[0][1].device
        self.descs = [np.asarray(r[6], np.int32).reshape(-1, 5) for r in rows]
        self.t_end = [int(e) for e in t_end]
        self.base = [min(int(b), e) for b, e in zip(base, self.t_end)]
        span = max([e - b for b, e in zip(self.base, self.t_end)] + [1])
        dd = np.zeros((self.lanes, span, 5), np.int32)
        for i, d in enumerate(self.descs):
            part = d[self.base[i] : self.t_end[i]]
            dd[i, : part.shape[0]] = part
        if self.merged:
            job_axis_backend(backend)

            def words(x):
                return pack_lanes(x) if x.dtype == torch.int8 else x

            self.ops = (
                _stack(rows, 0),
                *(_pad_rows([words(r[j]) for r in rows], 1) for j in (1, 2, 3)),
                *(_pad_rows([r[j] for r in rows], 0, fill=False) for j in (4, 5)),
            )
            self.blocks = job_blocks(range(self.lanes), self.lanes)
            if self.blocks is None:
                self.ddescs = upload(dd, _I32, self.dev)
            else:
                # Each job shard's operands on each of its candidate
                # shards' devices, once per device.
                self.block_ops = []
                for j, _, lo, hi in self.blocks:
                    on = {}
                    for d in _candidate_devices(j):
                        if d not in on:
                            on[d] = (*(x[lo:hi].to(d) for x in self.ops),
                                     upload(dd[lo:hi], _I32, d))
                    self.block_ops.append(on)
        else:
            if backend not in PIVOT_BACKENDS:
                raise ValueError(f"unknown pivot backend {backend!r}")
            self.window = PIVOT_WINDOWS[backend]
            self.ops = tuple(rows[0][:6])
            self.ddescs = upload(dd[0], _I32, self.dev)

    def buffers(self, n: int):
        if self.blocks is not None:
            # Piece c of a window exists only for c < its width <= n, and
            # holds at most ceil(n / C) tiles.
            out = []
            for j, _, lo, hi in self.blocks:
                devs = _candidate_devices(j)
                per = -(-n // len(devs))
                out.append([window_lanes_buffers(hi - lo, per, self.tl,
                                                 self.th, d)
                            for d in devs[:n]])
            return out
        if self.merged:
            return window_lanes_buffers(self.lanes, n, self.tl, self.th, self.dev)
        return window_buffers(n, self.tl, self.th, self.dev)

    def launch(self, w0, width: int, out):
        """One window: tiles [w0[l], w0[l] + width) of every lane, cut at
        its t_end, one launch.  Returns (req1, req0, feas), tile z of lane
        l being :meth:`tile` (x, l, z), and the reader of the counts
        [lanes][tiles] (:func:`_counts_reader`); split by job shard, req1,
        req0 and feas are lists of the shards' blocks, each a list of its
        candidate shards' pieces of the window (:func:`candidate_blocks`:
        piece c tiles [w0 + c * per, w0 + min((c + 1) * per, width)), per =
        ceil(width / C)), the counts gathered on the call's device in lane
        and tile order for one read."""
        t0 = [w - b for w, b in zip(w0, self.base)]
        te = [e - b for e, b in zip(self.t_end, self.base)]
        if self.blocks is not None:
            outs = [[_job_launch("pivot_window_lanes", j, c, d,
                                 pivot_window_lanes, *ops[d],
                                 [x + a for x in t0[lo:hi]], b - a, te[lo:hi],
                                 self.tl, self.th, out=bufs[c])
                     for c, d, a, b in candidate_blocks(j, width)]
                    for (j, _, lo, hi), ops, bufs in zip(self.blocks,
                                                         self.block_ops, out)]
            counts = torch.cat([_join([o[3].to(self.dev) for o in parts], 1)
                                for parts in outs])
            return (*([[o[k] for o in parts] for parts in outs]
                      for k in range(3)), _counts_reader(counts))
        if self.merged:
            req1, req0, feas, counts = pivot_window_lanes(
                *self.ops, self.ddescs, t0, width, te, self.tl, self.th, out=out)
            return req1, req0, feas, _counts_reader(counts)
        n = min(width, te[0] - t0[0])
        req1, req0, feas, counts = self.window(
            *self.ops, self.ddescs, t0[0], n, te[0], self.tl, self.th, out=out)
        read = _counts_reader(counts)
        return req1, req0, feas, lambda: [read()]

    def tile(self, x, lane: int, z: int):
        """Tile ``z`` of lane ``lane`` of a window's words or flags, on the
        call's device."""
        if self.blocks is None:
            return x[lane, z] if self.merged else x[z]
        for (_, _, lo, hi), xb in zip(self.blocks, x):
            if lo <= lane < hi:
                per = xb[0].shape[1]
                return xb[z // per][lane - lo, z % per].to(self.dev)
        raise IndexError(lane)


def _counts_reader(counts):
    """Starts the copy of a window's tile counts to the host; returns the
    function that waits for it and gives them as a list.  On the card the
    copy goes to pinned memory behind an event, so the host can launch the
    next window before it waits."""
    if not counts.is_cuda:
        return counts.tolist
    host = torch.empty(counts.shape, dtype=counts.dtype, pin_memory=True)
    host.copy_(counts, non_blocking=True)
    copied = torch.cuda.Event()
    copied.record(torch.cuda.current_stream(counts.device))

    def read():
        copied.synchronize()
        return host.tolist()

    return read


def _pivot_solve_lanes(feas, req1, req0, seeds_t, w_tab, m_tab, solve_rows):
    """Decomposition solve of one pivot tile of each lane: feas bool
    [L, N], req1/req0 int32 [L, N], ``seeds_t`` the tiles' seeds -> rows
    (found, nfeas, flat, sel, req1, req0), one sync."""
    s = [_wrap32(x) for x in seeds_t]
    nfeas = feas.sum(dim=1)
    prio = torch.where(feas, _priority_lanes(feas.shape[1], s, device=feas.device), 0)
    topi = _extract_top_rows_lanes(prio, solve_rows)
    fsel = torch.gather(feas, 1, topi)
    fr1 = torch.where(fsel, torch.gather(req1, 1, topi), -1)
    fr0 = torch.where(fsel, torch.gather(req0, 1, topi), -1)
    found, best_t, sel = _lut5_solve_lanes(fr1, fr0, w_tab, m_tab,
                                           [x ^ 0x9E37 for x in s])
    # torchlint: ignore[R2x] deliberate compact-verdict sync: the solved tiles' rows reach the host in one pull per solve, to decide stop, overflow and re-drive
    return torch.stack([
        found.long(), nfeas, _take(topi, best_t), sel,
        _take(fr1, best_t).long(), _take(fr0, best_t).long(),
    ], dim=1).tolist()


def _pivot_stream(pl: _PivotLanes, start_t, w_tab, m_tab, seeds, solve_rows):
    """The lanes' pivot sweeps over tiles [start_t[l], t_end[l]) of ``pl``:
    int32[L, 9], row l the :func:`lut5_pivot_stream` verdict of lane l.

    Windows of 1, 2, 4, ... tiles per lane, doubling up to ``max(1,
    PIVOT_WINDOW_TILES // L)`` (one launch never sweeps more tiles than a
    single-lane window), each one launch for every lane still sweeping (a
    lane's window is its own next tiles; lanes that stopped are inert) and
    one copy of all lanes' counts, launched one window ahead of the host
    over two buffer sets, so the card does not wait for the host between
    windows.  The feasible tiles of a window are then solved in rounds:
    each round solves the next feasible tile of every lane that has one, in
    one sync.  Tiles are solved in order, each with seed ``seed ^ tile``,
    so the verdicts do not depend on the backend, the lanes or the window
    sizes.  The tiles of a window past a lane's hit, and the window
    launched after it, are swept and dropped."""
    lanes, th = pl.lanes, pl.th
    seeds = [_wrap32(s) for s in seeds]
    t_end = pl.t_end
    t = [int(x) for x in start_t]
    start = list(t)
    out: List = [None] * lanes
    rest = [(0,) * 7 for _ in range(lanes)]
    cap = max(1, PIVOT_WINDOW_TILES // lanes)
    span = max([te - s for s, te in zip(t, t_end)] + [0])
    ncap = max(1, min(cap, span))

    def running(i):
        return out[i] is None and t[i] < t_end[i]

    if not any(running(i) for i in range(lanes)):
        bufs = []
    else:
        bufs = [pl.buffers(ncap) for _ in range(2)]

    def launch(k, width):
        w0 = [t[i] if running(i) else t_end[i] for i in range(lanes)]
        ns = [max(0, min(width, t_end[i] - w0[i])) for i in range(lanes)]
        req1, req0, feas, read = pl.launch(w0, width, bufs[k % 2])
        for i in range(lanes):
            t[i] = w0[i] + ns[i]
        return (w0, ns, req1, req0, feas, read)

    def consume(win):
        w0, ns, req1, req0, feas, read = win
        counts = read()
        pending = {
            i: [z for z in range(ns[i]) if counts[i][z]]
            for i in range(lanes) if out[i] is None and ns[i] > 0
        }
        while True:
            heads = [(i, zs[0]) for i, zs in pending.items()
                     if zs and out[i] is None]
            if not heads:
                return
            tiles_t = [w0[i] + z for i, z in heads]
            pivot_tile.tiles["solved"] += len(heads)
            solved = _pivot_solve_lanes(
                *(torch.stack([pl.tile(x, i, z).reshape(-1) for i, z in heads])
                  for x in (feas, req1, req0)),
                [seeds[i] ^ tt for (i, _), tt in zip(heads, tiles_t)],
                w_tab, m_tab, solve_rows,
            )
            for (i, _), tt, (fnd, nfeas, flat, sel, r1b, r0b) in zip(
                    heads, tiles_t, solved):
                pending[i].pop(0)
                overflow = nfeas > solve_rows and not fnd
                status = 1 if fnd else (2 if overflow else 0)
                d = pl.descs[i][tt]
                outs = (status, int(d[0]), int(d[1]) + flat // th,
                        int(d[3]) + flat % th, sel // 256, sel % 256, r1b, r0b)
                if status != 0:
                    out[i] = [*outs, tt + 1]
                elif tt == t_end[i] - 1:
                    rest[i] = outs[1:]

    width, k, pending_win = 1, 0, None
    while any(running(i) for i in range(lanes)):
        win = launch(k, min(width, ncap))
        k += 1
        if pending_win is not None:
            consume(pending_win)
        pending_win = win
        width = min(2 * width, ncap)
    if pending_win is not None:
        consume(pending_win)
    return np.asarray([
        out[i] if out[i] is not None
        else [0, *rest[i], max(start[i], t_end[i])]
        for i in range(lanes)
    ], np.int32).reshape(lanes, 9)


def lut5_pivot_stream_lanes(rows, *, tl, th, solve_rows=64, backend="packed"):
    """Lane form of :func:`lut5_pivot_stream`; rows (tables, lc1, lc0, hc,
    lowvalid, highvalid, descs, start_t, t_end, w_tab, m_tab, seed), the
    split tables shared.  A merged call runs K1's lane form whatever the
    backend (:func:`job_axis_backend`)."""
    pl = _PivotLanes(rows, [r[7] for r in rows], [r[8] for r in rows],
                     backend, tl, th)
    return list(_pivot_stream(pl, [r[7] for r in rows], rows[0][9],
                              rows[0][10], [r[11] for r in rows], solve_rows))


def lut5_pivot_stream(
    tables, lc1, lc0, hc, lowvalid, highvalid, descs, start_t, t_end,
    w_tab, m_tab, seed, *, tl, th, solve_rows=64, backend="packed",
):
    """Whole-space 5-LUT search over pivot tiles [start_t, t_end).

    ``descs`` is the host array of :func:`pivot_tile_descs`.  Returns
    int32[9] [status, m, lo_abs, hi_abs, sigma, func_outer, req1, req0,
    next_tile] — status as in :func:`lut5_stream` (the tile concerned is
    next_tile - 1); when the range is exhausted, fields 1-7 are the solve
    of its last tile (zeros when that tile had no feasible candidate).
    ``backend`` picks the window kernel: ``"packed"`` (K1, with ``lc1``,
    ``lc0`` and ``hc`` the int32 words [4, P, 8]) or ``"pre"`` (K2, with
    them int8 lanes [4, P, 256]): :class:`PivotOperands` built for the
    backend gives both.  Either sweeps windows of up to
    :data:`PIVOT_WINDOW_TILES` tiles (:func:`_pivot_stream`), so the
    verdict is the same for every backend and window cap."""
    return lut5_pivot_stream_lanes(
        [(tables, lc1, lc0, hc, lowvalid, highvalid, descs, start_t, t_end,
          w_tab, m_tab, seed)],
        tl=tl, th=th, solve_rows=solve_rows, backend=backend,
    )[0]


def lut5_pivot_tile_lanes(rows, *, tl, th, backend="packed"):
    """Lane form of :func:`lut5_pivot_tile`; rows (tables, lc1, lc0, hc,
    lowvalid, highvalid, descs, t): one window of one tile per lane, one
    launch."""
    ts = [int(r[7]) for r in rows]
    pl = _PivotLanes(rows, ts, [t + 1 for t in ts], backend, tl, th)
    req1, req0, feas, _ = pl.launch(ts, 1, pl.buffers(1))
    return [tuple(pl.tile(x, i, 0).reshape(-1) for x in (feas, req1, req0))
            for i in range(len(rows))]


def lut5_pivot_tile(tables, lc1, lc0, hc, lowvalid, highvalid, descs, t, *, tl, th,
                    backend="packed"):
    """Feasibility + packed constraints of ONE tile (the overflow
    re-drive): (feasible [tl*th], req1, req0) — a window of one tile on
    the backend's kernel."""
    return lut5_pivot_tile_lanes(
        [(tables, lc1, lc0, hc, lowvalid, highvalid, descs, t)],
        tl=tl, th=th, backend=backend,
    )[0]


# -------------------------------------------------------------------------
# Fused node heads
# -------------------------------------------------------------------------


def _head_lanes(rows, seeds):
    """Steps 1-2 of every lane: (direct, inverted, direct best, inverted
    best) [L] device tensors, and the stacked operands."""
    tables, valid_g = _stack(rows, 0), _stack(rows, 1)
    target, mask = _stack(rows, 6), _stack(rows, 7)
    eq = eq_mask(tables, target[:, None], mask[:, None]) & valid_g
    neq = eq_mask(~tables, target[:, None], mask[:, None]) & valid_g
    sprio = _priority_lanes(valid_g.shape[1], seeds, det_newest=True,
                            device=tables.device)
    cols = [
        eq.any(dim=1).long(), neq.any(dim=1).long(),
        torch.argmax(torch.where(eq, sprio, 0), dim=1),
        torch.argmax(torch.where(neq, sprio, 0), dim=1),
    ]
    return cols, (tables, valid_g, target, mask)


def gate_step_stream_lanes(rows, *, chunk3, has_not, has_triple):
    """Lane form of :func:`gate_step_stream`; rows (tables, valid_g,
    pair_combos, pair_valid, binom, g, target, mask, excl, total3,
    pair_table, not_table, triple_table, seed) of one bucket shape.  Steps
    1-2 and the pair and NOT-pair sweeps of every lane come back in one
    sync; the lanes that miss them run the triple stream in lockstep."""
    seeds = [_wrap32(r[13]) for r in rows]
    dev = rows[0][0].device
    head, (tables, _, target, mask) = _head_lanes(rows, seeds)
    combos, pair_valid = rows[0][2], _stack(rows, 3)
    pair = _tuple_match_lanes(tables, combos, pair_valid, target, mask,
                              rows[0][10], [s ^ 0x3D4A for s in seeds], 4)
    if has_not:
        npair = _tuple_match_lanes(tables, combos, pair_valid, target, mask,
                                   rows[0][11], [s ^ 0x11C9 for s in seeds], 4)
    else:
        z = torch.zeros(len(rows), dtype=_I64, device=dev)
        npair = (z, z, z, z)
    vals = torch.stack(head + list(pair[:3]) + list(npair[:3]),
                       dim=1).tolist()
    out: List = [None] * len(rows)
    need3 = []
    for j, (direct, inv, dbest, ibest, pf, pi, ps, nf, ni, ns) in enumerate(vals):
        if direct or inv:
            out[j] = (1 if direct else 2, dbest if direct else ibest, 0, 0)
        elif pf:
            out[j] = (3, pi, ps, 0)
        elif nf:
            out[j] = (4, ni, ns, 0)
        elif not has_triple:
            out[j] = (0, 0, 0, 0)
        else:
            need3.append(j)
    if need3:
        ln = _Lanes(tables, [r[5] for r in rows], target, mask, _stack(rows, 8),
                    rows[0][4], len(rows) > 1)
        trip = _match_lanes(
            ln, need3, [0] * len(need3), [int(rows[j][9]) for j in need3],
            [seeds[j] ^ 0x7777 for j in need3], rows[0][12], 3, chunk3, 8,
        )
        for j, (tf, rank, slot, ex) in zip(need3, trip):
            out[j] = (5 if tf else 0, rank, slot, ex)
    return [np.asarray(v, np.int32) for v in out]


def gate_step_stream(
    tables, valid_g, pair_combos, pair_valid, binom, g, target, mask, excl,
    total3, pair_table, not_table, triple_table, seed,
    *, chunk3, has_not, has_triple,
):
    """ALL of one gate-mode search node's sweeps (sboxgates.c:301-435) for
    ONE seed.  Steps 1-2 and the pair and NOT-pair sweeps (at most one
    512-row bucket of pairs) run together and come back in one small
    verdict; the triple stream runs only when they all miss.

    Returns int32[4] [step, x0, x1, examined3] with step
      0 = nothing found; 1 = existing gate (x0 = gate id); 2 = complement
      (x0 = gate id); 3 = pair x available function (x0 = pair index,
      x1 = slot); 4 = pair x NOT-augmented function (likewise); 5 = triple
      x 3-input function (x0 = rank, x1 = slot).
    On a miss only the step is specified (the JAX kernel's payload is its
    last chunk's argmax)."""
    return gate_step_stream_lanes(
        [(tables, valid_g, pair_combos, pair_valid, binom, g, target, mask,
          excl, total3, pair_table, not_table, triple_table, seed)],
        chunk3=chunk3, has_not=has_not, has_triple=has_triple,
    )[0]


def lut_step_stream_lanes(rows, *, chunk3, chunk5, has5, solve_rows=1024):
    """Lane form of :func:`lut_step_stream`; rows (tables, valid_g,
    pair_combos, pair_valid, binom, g, target, mask, excl, total3, total5,
    pair_table, w_tab, m_tab, seed) of one bucket and chunk shape.  Steps
    1-3 of every lane in one sync, then the 3-LUT and 5-LUT streams of the
    lanes that missed, in lockstep."""
    seeds = [_wrap32(r[14]) for r in rows]
    head, (tables, _, target, mask) = _head_lanes(rows, seeds)
    pair = _tuple_match_lanes(tables, rows[0][2], _stack(rows, 3), target,
                              mask, rows[0][11], [s ^ 0x3D4A for s in seeds], 4)
    vals = torch.stack(head + list(pair[:3]), dim=1).tolist()
    out: List = [None] * len(rows)

    def pack(step, x0=0, x1=0, x2=0, x3=0, x4=0, ex3=0, ex5=0):
        return (step, x0, x1, x2, x3, x4, ex3, ex5)

    rest = []
    for j, (direct, inv, dbest, ibest, pf, pi, ps) in enumerate(vals):
        if direct or inv:
            out[j] = pack(1 if direct else 2, dbest if direct else ibest)
        elif pf:
            out[j] = pack(3, pi, ps)
        else:
            rest.append(j)
    if rest:
        g = [r[5] for r in rows]
        excl = _stack(rows, 8)
        binom = rows[0][4]
        merged = len(rows) > 1
        ln3 = _Lanes(tables, g, target, mask, torch.full_like(excl, -1), binom,
                     merged)
        l3 = _lut3_lanes(ln3, rest, [0] * len(rest),
                         [int(rows[j][9]) for j in rest],
                         [seeds[j] ^ 0x55D3 for j in rest], chunk3)
        need5 = []
        for j, (f3, rank3, r1c, r0c, ex3) in zip(rest, l3):
            if f3:
                out[j] = pack(4, rank3, r1c, r0c, ex3=ex3)
            elif not has5:
                out[j] = pack(0, ex3=ex3)
            else:
                need5.append((j, ex3))
        if need5:
            js = [j for j, _ in need5]
            ln5 = _Lanes(tables, g, target, mask, excl, binom, merged)
            l5 = _lut5_lanes(ln5, js, [0] * len(js),
                             [int(rows[j][10]) for j in js], rows[0][12],
                             rows[0][13], [seeds[j] ^ 0x1BF5 for j in js],
                             chunk5, solve_rows)
            for (j, ex3), (status, rank, sigma, fo, sr1, sr0, cst, ex5) in zip(
                    need5, l5):
                step = 5 if status == 1 else (6 if status == 2 else 0)
                x0 = cst if status == 2 else rank
                out[j] = pack(step, x0, sigma, fo, sr1, sr0, ex3, ex5)
    return [np.asarray(v, np.int32) for v in out]


def lut_step_stream(
    tables, valid_g, pair_combos, pair_valid, binom, g, target, mask, excl,
    total3, total5, pair_table, w_tab, m_tab, seed,
    *, chunk3, chunk5, has5, solve_rows=1024,
):
    """ALL of one LUT-mode search node's head sweeps for ONE seed: steps 1-3
    (existing gate / complement / pair x function), then the whole-space
    3-LUT stream, then (``has5``) the whole-space 5-LUT stream.  Later
    sweeps run only when earlier ones miss.

    Returns int32[8]: [step, x0, x1, x2, x3, x4, ex3, ex5]
      step 0: nothing found; 1: existing gate (x0 = gate id); 2: complement
      (x0 = gate id); 3: pair x function (x0 = pair index, x1 = slot);
      4: 3-LUT (x0 = rank, x1 = req1, x2 = req0); 5: 5-LUT (x0 = rank,
      x1 = sigma, x2 = func_outer, x3 = req1, x4 = req0); 6: 5-LUT solver
      overflow at chunk start x0.
    ex3/ex5: candidate ranks examined by the 3/5-LUT streams."""
    return lut_step_stream_lanes(
        [(tables, valid_g, pair_combos, pair_valid, binom, g, target, mask,
          excl, total3, total5, pair_table, w_tab, m_tab, seed)],
        chunk3=chunk3, chunk5=chunk5, has5=has5, solve_rows=solve_rows,
    )[0]


#: Lanes per block of the 7-LUT stage A (bounds its [128, lanes, chunk]
#: cell masks).
LUT7_LANE_BLOCK = 8


def lut7_step_stream_lanes(rows, *, chunk7, solve7=256):
    """Lane form of :func:`lut7_step_stream`; rows (tables, binom, g,
    target, mask, excl, total7, idx_tab, pp_tab, seed).  Stage A of every
    lane (blocks of :data:`LUT7_LANE_BLOCK`) and one sync for all lanes'
    feasible counts, then the stage-B solve of the lanes with feasible
    tuples together (:func:`_lut7_solve_lanes`)."""
    ln = _stream_lanes(rows)
    dev = ln.dev
    n = len(rows)
    seeds = [_wrap32(r[9]) ^ 0x77A1 for r in rows]
    totals = [int(r[6]) for r in rows]
    staged = []
    for lo in range(0, n, LUT7_LANE_BLOCK):
        js = list(range(lo, min(n, lo + LUT7_LANE_BLOCK)))
        feasible, r1, r0, _, cseeds = ln.chunk(
            js, [0] * len(js), [totals[j] for j in js], [seeds[j] for j in js],
            7, chunk7,
        )
        prio = torch.where(feasible, _priority_lanes(chunk7, cseeds, device=dev), 0)
        topv, topi = _topk_lanes(prio, solve7)
        fsel = (topv > 0)[:, :, None]
        li = torch.arange(len(js), device=dev)[:, None]
        staged.append((feasible.sum(dim=1), topi,
                       torch.where(fsel, r1[li, topi], -1),
                       torch.where(fsel, r0[li, topi], -1)))
    nfeas = torch.cat([s[0] for s in staged]).tolist()
    topi, sr1, sr0 = (torch.cat([s[i] for s in staged]) for i in (1, 2, 3))
    out = [np.zeros(14, np.int32) for _ in range(n)]
    for j in range(n):
        out[j][4] = min(totals[j], chunk7)
    hit = [j for j in range(n) if nfeas[j]]
    if hit:
        hi = upload(hit, _I64, dev)
        solved = _lut7_solve_lanes(sr1[hi], sr0[hi], rows[0][7], rows[0][8],
                                   [seeds[j] for j in hit])
        best = upload([b for _, b, _, _ in solved], _I64, dev)
        words = torch.cat([_take(topi[hi], best)[:, None],
                           sr1[hi, best], sr0[hi, best]], dim=1).tolist()
        for j, (found, _, sigma, flat), w in zip(hit, solved, words):
            v = out[j]
            v[0] = 1 if found else (2 if nfeas[j] > solve7 else 0)
            v[1] = w[0]            # the rank (the chunk starts at 0)
            v[2] = sigma
            v[3] = flat
            v[5] = min(nfeas[j], solve7)
            v[6:14] = w[1:]
    return out


def lut7_step_stream(
    tables, binom, g, target, mask, excl, total7, idx_tab, pp_tab, seed,
    *, chunk7, solve7=256,
):
    """Single-chunk 7-LUT search for ONE seed: stage-A filter over C(g,7)
    (one chunk) + stage-B solve of the top ``solve7`` hits (reference:
    search_7lut, lut.c:256-487).  Returns int32[14]
    [status, rank, sigma, fo*256+fm, ex7, solved, r7_1[4], r7_0[4]] with
    status 0 = no decomposition, 1 = found, 2 = more than ``solve7``
    feasible tuples and none of the solved subset decomposed."""
    return lut7_step_stream_lanes(
        [(tables, binom, g, target, mask, excl, total7, idx_tab, pp_tab, seed)],
        chunk7=chunk7, solve7=solve7,
    )[0]


# -------------------------------------------------------------------------
# Host-side split tables for the 5/7-LUT solvers
# -------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def lut5_split_tables() -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(splits[10, 5], w_tab[10, 256], m_tab[10, 4]): the reference's 10
    order[] configurations (lut.c:189-230).  Cell j of a 5-tuple has input
    i value (j >> (4-i)) & 1."""
    import itertools

    cells = np.arange(32, dtype=np.uint64)
    x = [(cells >> np.uint64(4 - i)) & np.uint64(1) for i in range(5)]
    splits, w_rows, m_rows = [], [], []
    for outer in itertools.combinations(range(5), 3):
        inner = [i for i in range(5) if i not in outer]
        a, b, c = outer
        d, e = inner
        splits.append((a, b, c, d, e))
        idx_outer = x[a] * np.uint64(4) + x[b] * np.uint64(2) + x[c]
        g = np.arange(256, dtype=np.uint64)
        bits = (g[:, None] >> idx_outer[None, :]) & np.uint64(1)
        w_rows.append(
            ((bits << cells[None, :]).sum(axis=1) & 0xFFFFFFFF).astype(np.uint32)
        )
        idx_inner = x[d] * np.uint64(2) + x[e]
        m_rows.append(
            np.array(
                [
                    int((np.uint64(1) << cells[idx_inner == m]).sum()) & 0xFFFFFFFF
                    for m in range(4)
                ],
                dtype=np.uint32,
            )
        )
    return (
        # torchlint: ignore[R2x] host-built python list of split positions; nothing device-resident flows in
        np.asarray(splits, dtype=np.int32),
        np.stack(w_rows).astype(np.uint32),
        np.stack(m_rows).astype(np.uint32),
    )


@functools.lru_cache(maxsize=None)
def lut7_split_tables() -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """(orders[70, 7], wo_tab[70, 256, 4], wm_tab[70, 256, 4], g_tab[70, 4]):
    the 70 splits of 7 inputs into outer, middle (interchangeable) and free
    (the reference's order[] table, lut.c:396-415)."""
    import itertools

    cells = np.arange(128, dtype=np.uint64)
    x = [(cells >> np.uint64(6 - i)) & np.uint64(1) for i in range(7)]

    def pack128(bits):
        b = bits.reshape(bits.shape[:-1] + (4, 32)).astype(np.uint64)
        return (b << np.arange(32, dtype=np.uint64)).sum(axis=-1).astype(np.uint32)

    orders, wo_rows, wm_rows, g_rows = [], [], [], []
    for outer in itertools.combinations(range(7), 3):
        rest = [i for i in range(7) if i not in outer]
        for middle in itertools.combinations(rest, 3):
            if outer[0] > middle[0]:
                continue
            free = [i for i in rest if i not in middle][0]
            orders.append(tuple(outer) + tuple(middle) + (free,))
            g = np.arange(256, dtype=np.uint64)
            u = np.uint64
            idx_o = x[outer[0]] * u(4) + x[outer[1]] * u(2) + x[outer[2]]
            idx_m = x[middle[0]] * u(4) + x[middle[1]] * u(2) + x[middle[2]]
            wo_rows.append(pack128((g[:, None] >> idx_o[None, :]) & u(1)))
            wm_rows.append(pack128((g[:, None] >> idx_m[None, :]) & u(1)))
            g_rows.append(pack128((x[free] & 1)[None, :])[0])
    return (
        # torchlint: ignore[R2x] host-built python list of decode orders; nothing device-resident flows in
        np.asarray(orders, dtype=np.int32),
        np.stack(wo_rows),
        np.stack(wm_rows),
        np.stack(g_rows),
    )


@functools.lru_cache(maxsize=None)
def lut7_pair_tables() -> Tuple[np.ndarray, np.ndarray]:
    """(idx_tab[70, 128] int32, pp_tab[256, 64] float32) for
    :func:`lut7_solve`: idx_tab[s, x*64 + p*8 + q] is the cell whose
    ordered outer pattern is p, middle pattern q, free bit x; pp_tab[f,
    p1*8 + p0] = 1 iff bits p1 and p0 of the 8-bit function f agree."""
    orders, _, _, _ = lut7_split_tables()
    cells = np.arange(128)
    x = [(cells >> (6 - i)) & 1 for i in range(7)]
    idx_rows = []
    for o in orders:
        p = x[o[0]] * 4 + x[o[1]] * 2 + x[o[2]]
        q = x[o[3]] * 4 + x[o[4]] * 2 + x[o[5]]
        pos = x[o[6]] * 64 + p * 8 + q
        row = np.zeros(128, np.int32)
        row[pos] = cells
        idx_rows.append(row)
    f = np.arange(256)
    fb = (f[:, None] >> np.arange(8)[None, :]) & 1
    pp = (fb[:, :, None] == fb[:, None, :]).reshape(256, 64)
    return np.stack(idx_rows), pp.astype(np.float32)


def solve_inner_function(
    req1_cells: np.ndarray,
    req0_cells: np.ndarray,
    groups: np.ndarray,
    rng: Optional[np.random.Generator],
) -> Optional[int]:
    """Host side: the n-input function for grouped cells (groups[j] = the
    function cell constraint cell j belongs to), don't-cares randomized;
    None on a conflict (reference: get_lut_function, lut.c:79-109)."""
    num_f = int(groups.max()) + 1 if groups.size else 0
    func = 0
    setmask = 0
    for j in range(num_f):
        sel = groups == j
        has1 = bool(req1_cells[sel].any())
        has0 = bool(req0_cells[sel].any())
        if has1 and has0:
            return None
        if has1:
            func |= 1 << j
        if has1 or has0:
            setmask |= 1 << j
    if rng is not None:
        free = ~setmask & ((1 << num_f) - 1)
        func |= int(rng.integers(0, 1 << num_f)) & free
    return func


# -------------------------------------------------------------------------
# Wide (64-bit) rank streaming
# -------------------------------------------------------------------------


def feasible_stream_wide(
    tables, binom_wide, g, target, mask, excl, start, total, *, k, chunk,
):
    """64-bit-rank sibling of :func:`feasible_stream` over ranks
    [start, total) (Python ints up to 2^63; ``binom_wide`` the exact int64
    table).  Returns (verdict int32[3] [found, cstart_lo, cstart_hi] with
    the halves as int32 bit patterns, feasible [chunk], req1, req0)."""
    ln = _stream_lanes([(tables, binom_wide, g, target, mask, excl)])
    found, cstart, _, last = _feasible_lanes(
        ln, [int(start)], [int(total)], k, chunk)[0]
    lo, hi = cstart & M32, (cstart >> 32) & M32
    verdict = np.asarray([int(found), lo, hi], np.uint32).view(np.int32)
    return (verdict, *last)


# -------------------------------------------------------------------------
# Fused multi-round search driver
#
# The JAX package's round_driver keeps a chain of greedy rounds on the
# device in one lax.while_loop and syncs once per window.  Here the window
# is stepped from the host, round by round, in lockstep over the lanes: a
# round's head (match scan) comes back in one sync for every lane, the
# lanes that miss it run the 3-LUT stream and then the 5-LUT stream (K3 on
# the card) with one sync per chunk round, and a hit's new gate rows are
# computed on the device from its operand rows and written into the
# lane's table array there.  The verdicts and the hit journal are the JAX
# driver's, row for row.
# -------------------------------------------------------------------------


def _eval_lut_words(func: int, ta, tb, tc):
    """Device twin of :func:`..core.ttable.eval_lut` for int32 word rows:
    bit k of ``func`` (a host int) is the output for inputs
    k = A<<2 | B<<1 | C."""
    out = torch.zeros_like(ta)
    for j in range(8):
        if (func >> j) & 1:
            out = out | ((ta if (j >> 2) & 1 else ~ta)
                         & (tb if (j >> 1) & 1 else ~tb)
                         & (tc if j & 1 else ~tc))
    return out


def _lut5_inner_function(sigma: int, fo: int, r1: int, r0: int, dc: int) -> int:
    """The inner-LUT byte of a 5-LUT hit: group j = 4*o + m holds the cells
    where the outer output is o and the (d, e) pattern is m; a group with a
    required 1 sets its bit, a group with only required 0s clears it, and
    the don't-care byte ``dc`` fills the rest (the JAX driver's grouping)."""
    _, w_tab, m_tab = lut5_split_tables()
    w = int(w_tab[sigma, fo])
    r1, r0 = r1 & M32, r0 & M32
    func = 0
    for j in range(8):
        o, m = j >> 2, j & 3
        cells = int(m_tab[sigma, m]) & (w if o else ~w & M32)
        if r1 & cells:
            bit = 1
        elif (r1 | r0) & cells:
            bit = 0
        else:
            bit = (dc >> j) & 1
        func |= bit << j
    return func


def round_driver_lanes(rows, *, chunk3, chunk5, has5, max_rounds,
                       solve_rows=1024):
    """Lane form of :func:`round_driver`; rows (tables, binom, g0, targets,
    masks, excl, seeds, dc_draws, n_rounds, total5_cap, splits, w_tab,
    m_tab), the split tables and the cap shared.  Each lane runs up to its
    ``n_rounds`` rounds; a lane that misses (or overflows the head solver)
    freezes there while the others go on.  Host syncs: one per round for
    the heads of every running lane, and one per chunk round of the 3-LUT
    and 5-LUT streams of the lanes that reach them."""
    n = len(rows)
    tabs = _stack(rows, 0).clone()                   # [L, B, W]
    dev = tabs.device
    bsz = tabs.shape[1]
    binom = rows[0][1]
    targets, masks = _stack(rows, 3), _stack(rows, 4)
    excl = rows[0][5][None].expand(n, -1)
    seeds = [np.asarray(r[6]).astype(np.int64) for r in rows]
    dcs = [np.asarray(r[7]).astype(np.int64) for r in rows]
    cap = int(rows[0][9])
    w_tab, m_tab = rows[0][11], rows[0][12]
    splits = np.asarray(lut5_split_tables()[0])
    bt = binom_table()
    g = [int(r[2]) for r in rows]
    hits = np.zeros((n, max_rounds + 1, 8), np.int32)
    done = [0] * n
    live = [j for j in range(n) if int(rows[j][8]) > 0]
    merged = n > 1
    ar = torch.arange(bsz, device=dev)
    r = 0
    while live:
        sd = [_wrap32(int(seeds[j][r])) for j in live]
        up = upload([live, [g[j] for j in live]], _I64, dev)
        tl, gl = tabs[up[0]], up[1]
        tgt, msk = targets[up[0], r], masks[up[0], r]
        valid = ar[None, :] < gl[:, None]
        eq = eq_mask(tl, tgt[:, None], msk[:, None]) & valid
        neq = eq_mask(~tl, tgt[:, None], msk[:, None]) & valid
        sprio = _priority_lanes(bsz, sd, det_newest=True, device=dev)
        # torchlint: ignore[R2] deliberate sync: one compact head row per live lane per round, the round driver's only sync point
        head = torch.stack([
            eq.any(dim=1).long(), neq.any(dim=1).long(),
            torch.argmax(torch.where(eq, sprio, 0), dim=1),
            torch.argmax(torch.where(neq, sprio, 0), dim=1),
        ], dim=1).tolist()
        row = {}
        rest = []
        for j, s, (direct, inv, dbest, ibest) in zip(live, sd, head):
            if direct:
                row[j] = (1, dbest)
            elif inv:
                row[j] = (2, ibest)
                tabs[j, g[j]] = ~tabs[j, ibest]
                g[j] += 1
            else:
                rest.append(j)
        if rest:
            ln = _Lanes(tabs, g, targets[:, r], masks[:, r], excl, binom,
                        merged)
            l3 = _lut3_lanes(
                ln, rest, [0] * len(rest),
                [int(bt[g[j], 3]) for j in rest],
                [_wrap32(int(seeds[j][r])) ^ 0x55D3 for j in rest], chunk3)
            need5 = []
            for j, (f3, rank3, r1c, r0c, ex3) in zip(rest, l3):
                if not f3:
                    if has5:
                        need5.append((j, ex3))
                    else:
                        row[j] = (0, 0, 0, 0, 0, ex3)
                    continue
                dc = int(dcs[j][r])
                func = (r1c | (dc & ~(r1c | r0c))) & 0xFF
                a, b, c = (int(x) for x in
                           combinatorics.unrank_combination(rank3, g[j], 3))
                tabs[j, g[j]] = _eval_lut_words(func, tabs[j, a], tabs[j, b],
                                                tabs[j, c])
                g[j] += 1
                row[j] = (3, rank3, func, 0, 0, ex3)
            if need5:
                js = [j for j, _ in need5]
                totals = [int(bt[g[j], 5]) if g[j] >= 5 and int(bt[g[j], 5]) < cap
                          else 0 for j in js]
                l5 = _lut5_lanes(
                    ln, js, [0] * len(js), totals, w_tab, m_tab,
                    [_wrap32(int(seeds[j][r])) ^ 0x1BF5 for j in js], chunk5,
                    solve_rows)
                for (j, ex3), (status, rank5, sigma, fo, sr1, sr0, cst,
                               ex5) in zip(need5, l5):
                    if status != 1:
                        row[j] = ((5, cst) if status == 2 else (0, 0)) + (
                            0, 0, 0, ex3, ex5)
                        continue
                    combo = combinatorics.unrank_combination(rank5, g[j], 5)
                    ga, gb, gc, gd, ge = (int(combo[p]) for p in splits[sigma])
                    fi = _lut5_inner_function(sigma, fo, sr1, sr0,
                                              int(dcs[j][r]))
                    outer = _eval_lut_words(fo, tabs[j, ga], tabs[j, gb],
                                            tabs[j, gc])
                    tabs[j, g[j]] = outer
                    tabs[j, g[j] + 1] = _eval_lut_words(fi, outer, tabs[j, gd],
                                                        tabs[j, ge])
                    g[j] += 2
                    row[j] = (4, rank5, sigma, fo, fi, ex3, ex5)
        nxt = []
        for j in live:
            v = row[j]
            hits[j, r, :len(v)] = v
            if v[0] in (0, 5):
                continue
            done[j] = r + 1
            if r + 1 < int(rows[j][8]):
                nxt.append(j)
        live = nxt
        r += 1
    for j in range(n):
        hits[j, max_rounds, 0], hits[j, max_rounds, 1] = done[j], g[j]
    return list(hits)


def round_driver(
    tables, binom, g0, targets, masks, excl, seeds, dc_draws, n_rounds,
    total5_cap, splits, w_tab, m_tab,
    *, chunk3, chunk5, has5, max_rounds, solve_rows=1024,
):
    """Up to ``n_rounds`` greedy search rounds in one call (the JAX
    package's ``round_driver``).  Round r tries, against the current table
    array: (1) an existing gate matching targets[r] under masks[r] (newest
    first, the :func:`match_scan` order), (2) the complement of one
    (appends a NOT row), (3) the whole-space 3-LUT stream (appends one LUT
    row), and (4, with ``has5``) the 5-LUT stream when C(g, 5) is below
    ``total5_cap`` (appends the outer and inner LUT rows).  A miss, or a
    head-solver overflow, ends the window there: the host runs that round.

    tables: [B, W] int32 words zero-padded to the gate bucket (the caller
    guarantees g0 + 2 * n_rounds <= B); targets/masks: [max_rounds, W];
    seeds/dc_draws: [max_rounds] host int32, drawn in one block per chain
    segment.  Returns int32 [max_rounds + 1, 8]: row r = [kind, x0, x1,
    x2, x3, ex3, ex5, 0] with kind 0 miss, 1 existing gate (x0 = gate),
    2 complement (x0 = gate), 3 3-LUT (x0 = rank, x1 = function), 4 5-LUT
    (x0 = rank, x1 = sigma, x2 = outer, x3 = inner function), 5 solver
    overflow (x0 = chunk start); ex3/ex5 the ranks the round's streams
    examined.  The last row is [rounds_done, g_final, 0, ...]."""
    return round_driver_lanes(
        [(tables, binom, g0, targets, masks, excl, seeds, dc_draws, n_rounds,
          total5_cap, splits, w_tab, m_tab)],
        chunk3=chunk3, chunk5=chunk5, has5=has5, max_rounds=max_rounds,
        solve_rows=solve_rows,
    )[0]


def fleet_round_driver(
    tables, binom, g0s, targets, masks, excl, seeds, dc_draws, n_rounds,
    total5_cap, splits, w_tab, m_tab,
    *, chunk3, chunk5, has5, max_rounds, solve_rows=1024,
):
    """Stacked form of :func:`round_driver` (the JAX package's
    ``fleet_round_driver``): the jobs axis leads tables [L, B, W], g0s and
    n_rounds [L], targets and masks [L, max_rounds, W], seeds and dc_draws
    [L, max_rounds]; the other operands are shared.  A lane with
    ``n_rounds`` 0 does no work.  Returns int32 [L, max_rounds + 1, 8],
    lane by lane the one-row call's journal."""
    rows = [
        (tables[i], binom, int(g0s[i]), targets[i], masks[i], excl,
         seeds[i], dc_draws[i], int(n_rounds[i]), total5_cap, splits, w_tab,
         m_tab)
        for i in range(tables.shape[0])
    ]
    return np.stack(round_driver_lanes(
        rows, chunk3=chunk3, chunk5=chunk5, has5=has5, max_rounds=max_rounds,
        solve_rows=solve_rows,
    ))
