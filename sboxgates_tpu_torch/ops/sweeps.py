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
- Every ``while_loop`` stream of the JAX package is a Python loop over
  chunks or tiles here, with a small device verdict fetched per step.  The
  loops keep the JAX package's status codes, resume values and "first hit
  in chunk (tile) order", and each stream takes ONE seed from its caller,
  exactly where the JAX package makes one dispatch — so a seeded search
  draws the same host random stream in both packages.
- ``torch.argmax`` returns the first maximal index, as ``jnp.argmax`` does;
  :func:`_topk_index` and :func:`_extract_top_rows` reproduce the JAX tie
  orders of ``lax.top_k`` and of iterated argmax.
- The k=5 cell constraints run the hand-written filter kernel
  (:mod:`.lut5_filter`) and the pivot tiles the pivot kernels
  (:mod:`.pivot_tile`) on the card.  The 7-LUT solver's small products
  stay ``torch.matmul``: its counts are small integers, exact in bf16 and
  float32.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..core import ttable as tt
from . import combinatorics, pivot_tile, spectral
from .lut5_filter import cell_requirements, lut5_filter_cells, pack_bits
from .pivot_tile import PIVOT_CELLBITS, pivot_pre_window, pivot_window, window_buffers

M32 = 0xFFFFFFFF
_I32 = torch.int32
_I64 = torch.int64

# -------------------------------------------------------------------------
# Word helpers
# -------------------------------------------------------------------------


def as_words(a, device) -> torch.Tensor:
    """numpy uint32 words -> int32 bit-pattern tensor on ``device``."""
    arr = np.ascontiguousarray(np.asarray(a, dtype=np.uint32)).view(np.int32)
    return torch.from_numpy(arr.copy()).to(device)


def to_u32(t: torch.Tensor) -> np.ndarray:
    """int32 bit-pattern tensor -> numpy uint32 array."""
    return t.detach().cpu().numpy().astype(np.int32).view(np.uint32)


def _wrap32(x: int) -> int:
    """A Python int as the int32 value the JAX kernels see."""
    return ((int(x) + 2**31) & M32) - 2**31


def eq_mask(a, b, mask):
    """Masked equality over the last (word) axis."""
    return ~(((a ^ b) & mask) != 0).any(dim=-1)


# -------------------------------------------------------------------------
# Cell constraints
# -------------------------------------------------------------------------


def _cell_constraints_t(tabs, target, mask):
    """tabs: [k, W, N] int32 -> (req1, req0) bool [2^k, N]."""
    return cell_requirements(tabs, target, mask)


def _cell_constraints(tabs, target, mask):
    """tabs: [N, k, W] -> (req1, req0) bool [2^k, N]."""
    return _cell_constraints_t(tabs.permute(1, 2, 0), target, mask)


_pack_bits_t = pack_bits


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for int64 x in [0, 2^32) without int64 overflow."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & M32


def _priority(n: int, seed, *, det_newest: bool = False, device=None):
    """Hashed per-row priority (never zero) for match tie-breaking, int64
    in [1, 2^32).  A negative seed selects deterministically in scan order
    (newest first with ``det_newest``)."""
    s = _wrap32(seed)
    if s < 0:
        if det_newest:
            return torch.arange(1, n + 1, dtype=_I64, device=device)
        return torch.arange(n, 0, -1, dtype=_I64, device=device)
    x = (torch.arange(n, dtype=_I64, device=device) + (s & M32)) & M32
    x = _mul32(x ^ (x >> 16), 0x7FEB352D)
    x = _mul32(x ^ (x >> 15), 0x846CA68B)
    x = x ^ (x >> 16)
    return x | 1


def _topk_index(prio: torch.Tensor, rows: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the ``rows`` largest priorities, ties broken by
    the lower index first — the order of ``jax.lax.top_k``."""
    n = prio.shape[0]
    key = prio * (1 << 20) + ((1 << 20) - 1 - torch.arange(n, dtype=_I64, device=prio.device))
    top = torch.topk(key, rows, sorted=True).values
    return top >> 20, (1 << 20) - 1 - (top & ((1 << 20) - 1))


def _extract_top_rows(prio: torch.Tensor, rows: int) -> torch.Tensor:
    """Indices chosen by ``rows`` rounds of argmax-and-clear (the JAX
    pivot solver's selection): positives in descending order, ties by the
    lower index, then index 0 once the positives run out."""
    vals, idx = _topk_index(prio, min(rows, prio.shape[0]))
    idx = torch.where(vals > 0, idx, torch.zeros_like(idx))
    if rows > prio.shape[0]:
        idx = torch.cat([idx, idx.new_zeros(rows - prio.shape[0])])
    return idx


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


def _tuple_match_core(tables, combos, valid, target, mask, match_table, seed, num_cells):
    """(found, best index, slot, num_feasible) of the k-tuple
    function-match sweep — device scalars."""
    tabs = tables[combos.long()]                       # [N, k, W]
    req1, req0 = _cell_constraints(tabs, target, mask)
    feasible = valid & ~(req1 & req0).any(dim=0)
    r = _pack_bits_t(req1).long()
    c = _pack_bits_t(req1 | req0).long()
    slot = match_table[r + (c << num_cells)].long()
    ok = feasible & (slot >= 0)
    prio = torch.where(ok, _priority(ok.shape[0], seed, device=ok.device), 0)
    best = torch.argmax(prio)
    return ok.any().long(), best, slot[best], feasible.sum()


def tuple_match_sweep(tables, combos, valid, target, mask, match_table, seed, *, num_cells):
    """k-tuple sweep against an available-function match table (tables
    [G, W], combos [N, k], valid [N] bool, match_table [4^num_cells]).
    Returns int32[4] [found, index, slot, num_feasible] for a
    priority-selected match."""
    v = torch.stack(_tuple_match_core(
        tables, combos, valid, target, mask, match_table, _wrap32(seed), num_cells
    ))
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
    return feasible, _pack_bits_t(req1), _pack_bits_t(req0)


def lut5_filter(tables, combos, valid, target, mask):
    """Stage-A filter specialized to 5-tuples, through the filter kernel:
    (feasible, req1, req0)."""
    r1, r0 = lut5_filter_cells(tables, combos.to(_I32).contiguous(), target, mask)
    return valid & ((r1 & r0) == 0), r1, r0


# -------------------------------------------------------------------------
# 5/7-LUT solvers
# -------------------------------------------------------------------------


def _lut5_solve_core(req1p, req0p, w_tab, m_tab, seed):
    """5-LUT stage B: (found, best_t, sel = split * 256 + outer_func) as
    device scalars.  req1p/req0p: [T] int32; w_tab [10, 256], m_tab [10, 4]
    int32."""
    r1 = req1p[None, None, :]
    r0 = req0p[None, None, :]
    w = w_tab[:, :, None]
    conflict = torch.zeros(
        tuple(w_tab.shape) + (r1.shape[-1],), dtype=torch.bool, device=r1.device
    )
    for m in range(4):
        mm = m_tab[:, m, None, None]
        for o in (0, 1):
            cells = (w if o else ~w) & mm
            conflict |= ((r1 & cells) != 0) & ((r0 & cells) != 0)
    ok = ~conflict                                      # [10, 256, T]
    any_t = ok.any(dim=1).any(dim=0)
    prio = torch.where(any_t, _priority(any_t.shape[0], seed, device=r1.device), 0)
    best_t = torch.argmax(prio)
    flat_ok = ok[:, :, best_t].reshape(-1)
    flat_prio = torch.where(
        flat_ok, _priority(flat_ok.shape[0], _wrap32(seed) ^ 0x5BD1, device=r1.device), 0
    )
    sel = torch.argmax(flat_prio)
    return any_t.any(), best_t, sel


def lut5_solve(req1p, req0p, w_tab, m_tab, seed):
    """[found, best_t, sel] int32[3]."""
    found, best_t, sel = _lut5_solve_core(req1p, req0p, w_tab, m_tab, seed)
    return np.asarray(torch.stack([found.long(), best_t, sel]).tolist(), np.int32)


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


def _lut7_solve_core(req1p, req0p, idx_tab, pp_tab, seed):
    """Pair-agreement 7-LUT solver: (found, best_t, sigma, fo*256+fm) as
    Python ints.  req1p/req0p: [T, 4] int32."""
    dev = req1p.device
    num_t = req1p.shape[0]
    pp = pp_tab.to(torch.bfloat16 if dev.type == "cuda" else torch.float32)
    # A row with a cell required both ways conflicts under every (fo, fm):
    # the pair of that cell with itself always agrees.  Only the other rows
    # are counted; the callers' all-ones padding rows are among the skipped.
    live = torch.nonzero(((req1p & req0p) == 0).all(dim=1)).flatten()
    bits1 = _unpack_words_to_bits(req1p[live])
    bits0 = _unpack_words_to_bits(req0p[live])
    found = torch.zeros(num_t, dtype=torch.bool, device=dev)
    sel_sigma = torch.full((num_t,), -1, dtype=_I64, device=dev)
    sel_flat = torch.zeros(num_t, dtype=_I64, device=dev)
    s32 = _wrap32(seed)
    for sigma in range(idx_tab.shape[0]):
        idx = idx_tab[sigma].long()
        any_t = torch.zeros(num_t, dtype=torch.bool, device=dev)
        flat = torch.zeros(num_t, dtype=_I64, device=dev)
        blocks = []
        for lo in range(0, live.shape[0], _LUT7_ROWS):
            rows = live[lo : lo + _LUT7_ROWS]
            ok = _lut7_counts(
                bits1[lo : lo + _LUT7_ROWS], bits0[lo : lo + _LUT7_ROWS], idx, pp
            ) == 0
            blocks.append((rows, ok))
            any_t[rows] = ok.flatten(1).any(dim=1)
        newly = any_t & ~found
        if bool(newly.any()):
            fprio = _priority(256 * 256, s32 ^ (sigma * 2 + 1), device=dev)
            for rows, ok in blocks:
                flat[rows] = torch.argmax(
                    torch.where(ok.flatten(1), fprio[None, :], 0), dim=-1
                )
        sel_sigma = torch.where(newly, sigma, sel_sigma)
        sel_flat = torch.where(newly, flat, sel_flat)
        found |= any_t
    prio = torch.where(found, _priority(num_t, seed, device=dev), 0)
    best_t = torch.argmax(prio)
    out = torch.stack([found.any().long(), best_t, sel_sigma[best_t], sel_flat[best_t]])
    return tuple(int(x) for x in out.tolist())


def lut7_solve(req1p, req0p, idx_tab, pp_tab, seed):
    """7-LUT stage B: [found, best_t, sigma, fo*256+fm] int32[4]."""
    return np.asarray(_lut7_solve_core(req1p, req0p, idx_tab, pp_tab, seed), np.int32)


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


def _unrank_combos(binom, g, k, ranks):
    """Vectorized lexicographic unranking: ``binom`` int64 [513, 9],
    ``ranks`` int64 [N] (each < C(g, k)) -> combos int64 [k, N].

    Position p takes the largest value v >= lo (lo one past the previous
    value) whose preceding blocks fit the remaining rank: the combinations
    with element p in [lo, v) number C(g-lo, r) - C(g-v, r), r = k - p
    (the hockey-stick sum of the C(g-u-1, r-1) blocks).  Found by a binary
    search of ``g.bit_length()`` steps per position, so the device work is
    k log g steps, not g."""
    n = ranks.shape[0]
    dev = ranks.device
    rem = ranks.clone()
    lo = torch.zeros(n, dtype=_I64, device=dev)
    out = torch.empty((k, n), dtype=_I64, device=dev)
    for p in range(k):
        r = k - p
        col = binom[:, r]
        below = col[g - lo]                     # C(g-lo, r)
        a, b = lo, torch.full_like(lo, g - r)   # v always fits at a
        for _ in range(int(g).bit_length()):
            mid = (a + b + 1) >> 1
            fits = below - col[g - mid] <= rem
            a = torch.where(fits, mid, a)
            b = torch.where(fits, b, mid - 1)
        out[p] = a
        rem = rem - (below - col[g - a])
        lo = a + 1
    return out


def _unrank_combos_wide(binom_wide, g, k, ranks):
    """64-bit twin of :func:`_unrank_combos` (exact binomials)."""
    return _unrank_combos(binom_wide, g, k, ranks)


def _stream_chunk_constraints(tables, binom, g, k, target, mask, excl, ranks, total):
    """Per-chunk work: unrank -> exclusion mask -> cell constraints.
    Returns (feasible [N] bool, req1 packed, req0 packed)."""
    valid = ranks < total
    ranks = torch.clamp(ranks, max=total - 1)
    combos = _unrank_combos(binom, g, k, ranks)
    hit_excl = (combos[:, :, None] == excl.long()[None, None, :]).any(dim=2).any(dim=0)
    valid = valid & ~hit_excl
    if k == 5:
        r1, r0 = lut5_filter_cells(
            tables, combos.t().to(_I32).contiguous(), target, mask
        )
        return valid & ((r1 & r0) == 0), r1, r0
    tabs = tables[combos].permute(0, 2, 1)             # [k, W, N]
    req1, req0 = _cell_constraints_t(tabs, target, mask)
    feasible = valid & ~(req1 & req0).any(dim=0)
    return feasible, _pack_bits_t(req1), _pack_bits_t(req0)


def _ranks(start: int, chunk: int, device) -> torch.Tensor:
    return start + torch.arange(chunk, dtype=_I64, device=device)


def feasible_stream(tables, binom, g, target, mask, excl, start, total, *, k, chunk):
    """Sweeps ranks [start, total) chunk by chunk, stopping at the first
    chunk containing a feasible k-tuple.  Returns (verdict int32[3]
    [found, chunk_start, examined], feasible [chunk], req1, req0) —
    candidate ranks are chunk_start + arange(chunk)."""
    dev = tables.device
    nxt, found, cstart = int(start), False, int(start)
    feas = torch.zeros(chunk, dtype=torch.bool, device=dev)
    r1 = torch.zeros((chunk,) if k <= 5 else (chunk, (1 << k) // 32), dtype=_I32, device=dev)
    r0 = r1
    while not found and nxt < total:
        feas, r1, r0 = _stream_chunk_constraints(
            tables, binom, g, k, target, mask, excl, _ranks(nxt, chunk, dev), total
        )
        found = bool(feas.any())
        cstart, nxt = nxt, nxt + chunk
    examined = min(nxt, total) - int(start)
    return np.asarray([int(found), cstart, examined], np.int32), feas, r1, r0


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


def _lut3_stream_core(tables, binom, g, target, mask, excl, start, total, seed, chunk):
    """Whole-space 3-LUT stream: (found, rank, req1, req0, examined)."""
    dev = tables.device
    seed = _wrap32(seed)
    found, nxt, rank, r1b, r0b = 0, int(start), 0, 0, 0
    while not found and nxt < total:
        ranks = _ranks(nxt, chunk, dev)
        feasible, r1, r0 = _stream_chunk_constraints(
            tables, binom, g, 3, target, mask, excl, ranks, total
        )
        prio = torch.where(feasible, _priority(chunk, seed ^ nxt, device=dev), 0)
        best = torch.argmax(prio)
        found, rank, r1b, r0b = torch.stack(
            [feasible.any().long(), ranks[best], r1[best].long(), r0[best].long()]
        ).tolist()
        nxt += chunk
    examined = min(nxt, total) - int(start)
    return found, rank, r1b, r0b, examined


def lut3_stream(tables, binom, g, target, mask, excl, start, total, seed, *, chunk):
    """Whole-space 3-LUT search (reference: lut.c:501-523): int32[5]
    [found, rank, req1, req0, examined]."""
    return np.asarray(
        _lut3_stream_core(tables, binom, g, target, mask, excl, start, total, seed, chunk),
        np.int32,
    )


def _lut5_stream_core(
    tables, binom, g, target, mask, excl, start, total, w_tab, m_tab, seed,
    chunk, solve_rows,
):
    """Whole-space 5-LUT stream: (status, rank, sigma, func_outer, req1,
    req0, cstart, examined) — see :func:`lut5_stream`."""
    dev = tables.device
    seed = _wrap32(seed)
    status, nxt = 0, int(start)
    rank = sigma = fo = r1b = r0b = 0
    cstart = int(start)
    while status == 0 and nxt < total:
        ranks = _ranks(nxt, chunk, dev)
        feasible, r1, r0 = _stream_chunk_constraints(
            tables, binom, g, 5, target, mask, excl, ranks, total
        )
        if bool(feasible.any()):
            nfeas = feasible.sum()
            prio = torch.where(feasible, _priority(chunk, seed ^ nxt, device=dev), 0)
            topv, topi = _topk_index(prio, solve_rows)
            fsel = topv > 0
            sr1 = torch.where(fsel, r1[topi], -1)
            sr0 = torch.where(fsel, r0[topi], -1)
            found, best_t, sel = _lut5_solve_core(sr1, sr0, w_tab, m_tab, seed ^ nxt ^ 0x9E37)
            found, nfeas, rank, sel, r1b, r0b = torch.stack([
                found.long(), nfeas, ranks[topi[best_t]], sel,
                sr1[best_t].long(), sr0[best_t].long(),
            ]).tolist()
            overflow = nfeas > solve_rows and not found
            status = 1 if found else (2 if overflow else 0)
            sigma, fo = sel // 256, sel % 256
        else:
            status = rank = sigma = fo = r1b = r0b = 0
        cstart, nxt = nxt, nxt + chunk
    examined = min(nxt, total) - int(start)
    return status, rank, sigma, fo, r1b, r0b, cstart, examined


def lut5_stream(
    tables, binom, g, target, mask, excl, start, total, w_tab, m_tab, seed,
    *, chunk, solve_rows=1024,
):
    """Whole-space 5-LUT search (reference: search_5lut, lut.c:116-249):
    int32[8] [status, rank, sigma, func_outer, req1, req0, cstart, examined]
    with status 0 = exhausted, 1 = found, 2 = a chunk had more than
    ``solve_rows`` feasible tuples and none of the solved subset decomposed
    (re-drive it via feasible_stream, then resume at cstart + chunk)."""
    return np.asarray(
        _lut5_stream_core(
            tables, binom, g, target, mask, excl, start, total, w_tab, m_tab,
            seed, chunk, solve_rows,
        ),
        np.int32,
    )


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


def pivot_pair_cells(tables, lowgrid, highgrid, target, mask):
    """Per-pair cell masks: (lc1, lc0) [4, P2, W] for low pairs (cells
    pre-intersected with the required-1/required-0 positions) and hc
    [4, P2, W] for high pairs.  Cell j of a pair (x, y) is the positions
    where (x, y) take the bit pattern (j>>1, j&1)."""
    need1 = mask & target
    need0 = mask & ~target

    def cells(grid):
        tx = tables[grid[:, 0].long()]
        ty = tables[grid[:, 1].long()]
        return torch.stack([~tx & ~ty, ~tx & ty, tx & ~ty, tx & ty])

    lc = cells(lowgrid)
    return lc & need1, lc & need0, cells(highgrid)


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


def _desc_rows(descs, lo, hi, device):
    """Descriptor rows [lo, hi) of the host array, on ``device``."""
    return torch.as_tensor(np.ascontiguousarray(descs[lo:hi], np.int32), device=device)


def lut5_pivot_tile(tables, lc1, lc0, hc, lowvalid, highvalid, descs, t, *, tl, th,
                    backend="packed"):
    """Feasibility + packed constraints of ONE tile (the overflow
    re-drive): (feasible [tl*th], req1, req0) — a window of one tile on
    the backend's kernel."""
    req1, req0, feas, _ = PIVOT_WINDOWS[backend](
        tables, lc1, lc0, hc, lowvalid, highvalid,
        _desc_rows(descs, t, t + 1, lc1.device), 0, 1, 1, tl, th,
    )
    return feas.reshape(-1), req1.reshape(-1), req0.reshape(-1)


def _pivot_tile_solve(feasible, req1, req0, d, w_tab, m_tab, seed_t, th, solve_rows):
    """Decomposition solve of one pivot tile: (status, m, lo_abs, hi_abs,
    sigma, func_outer, req1, req0) — status 0 none / 1 found / 2
    solver-row overflow."""
    dev = feasible.device
    n = feasible.shape[0]
    nfeas = feasible.sum()
    prio = torch.where(feasible, _priority(n, seed_t, device=dev), 0)
    topi = _extract_top_rows(prio, solve_rows)
    fsel = feasible[topi]
    fr1 = torch.where(fsel, req1.reshape(-1)[topi], -1)
    fr0 = torch.where(fsel, req0.reshape(-1)[topi], -1)
    found, best_t, sel = _lut5_solve_core(fr1, fr0, w_tab, m_tab, _wrap32(seed_t) ^ 0x9E37)
    found, nfeas, flat, sel, r1b, r0b = torch.stack([
        found.long(), nfeas, topi[best_t], sel, fr1[best_t].long(),
        fr0[best_t].long(),
    ]).tolist()
    overflow = nfeas > solve_rows and not found
    status = 1 if found else (2 if overflow else 0)
    return (
        status, int(d[0]), int(d[1]) + flat // th, int(d[3]) + flat % th,
        sel // 256, sel % 256, r1b, r0b,
    )


def pivot_window_schedule(t, t_end):
    """The windows (first tile, tiles) that sweep [t, t_end): 1, 2, 4, ...
    tiles, doubling up to :data:`PIVOT_WINDOW_TILES`, the last one cut at
    t_end."""
    n = 1
    while t < t_end:
        n = min(n, t_end - t)
        yield t, n
        t += n
        n = min(2 * n, PIVOT_WINDOW_TILES)


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


def _window_feasible_tiles(window, tables, lc1, lc0, hc, lowvalid, highvalid,
                           descs, t, t_end, tl, th):
    """(tile, feasible, req1, req0) of every tile of [t, t_end) with a
    feasible candidate, in order, from the windows of
    :func:`pivot_window_schedule`: each one launch of ``window`` (the
    backend's kernel, :data:`PIVOT_WINDOWS`) and one copy of its counts to
    the host.  Each window is launched before the previous one's
    counts are read (two buffer sets), so the card does not wait for the
    host between windows.  The tiles of a window past the one the caller
    stops at, and the window after it, are swept and dropped."""
    if t >= t_end:
        return
    dev = lc1.device
    ddescs = _desc_rows(descs, t, t_end, dev)       # row i = tile t + i
    bufs = [window_buffers(min(PIVOT_WINDOW_TILES, t_end - t), tl, th, dev)
            for _ in range(2)]
    pending = None
    for i, (w0, n) in enumerate(pivot_window_schedule(t, t_end)):
        req1, req0, feas, counts = window(
            tables, lc1, lc0, hc, lowvalid, highvalid, ddescs, w0 - t, n,
            t_end - t, tl, th, out=bufs[i % 2],
        )
        launched = (w0, req1, req0, feas, _counts_reader(counts))
        if pending is not None:
            yield from _counted_tiles(*pending)
        pending = launched
    if pending is not None:
        yield from _counted_tiles(*pending)


def _counted_tiles(w0, req1, req0, feas, read_counts):
    """The tiles of one window with a feasible candidate, in order."""
    for z in np.flatnonzero(read_counts()):
        yield w0 + int(z), feas[z].reshape(-1), req1[z], req0[z]


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
    :data:`PIVOT_WINDOW_TILES` tiles; the tiles are solved in order, each
    with seed ``seed ^ tile``, so the verdict is the same for every backend
    and window cap."""
    if backend not in PIVOT_BACKENDS:
        raise ValueError(f"unknown pivot backend {backend!r}")
    seed = _wrap32(seed)
    start_t, t_end = int(start_t), int(t_end)
    tiles = _window_feasible_tiles(
        PIVOT_WINDOWS[backend], tables, lc1, lc0, hc, lowvalid, highvalid,
        descs, start_t, t_end, tl, th,
    )
    rest = (0,) * 7
    for t, feasible, req1, req0 in tiles:
        pivot_tile.tiles["solved"] += 1
        outs = _pivot_tile_solve(
            feasible, req1, req0, descs[t], w_tab, m_tab, seed ^ t, th, solve_rows
        )
        if outs[0] != 0:
            return np.asarray([*outs, t + 1], np.int32)
        rest = outs[1:] if t == t_end - 1 else rest
    return np.asarray([0, *rest, max(start_t, t_end)], np.int32)


# -------------------------------------------------------------------------
# Fused node heads
# -------------------------------------------------------------------------


def _match_stream_core(
    tables, binom, g, target, mask, excl, start, total, match_table, seed,
    k, chunk, num_cells,
):
    """Streaming tuple-match sweep: (found, abs_rank, slot, examined).
    Stops after the first chunk holding a match; on a miss the rank and
    slot are the last chunk's argmax, as in the JAX package."""
    dev = tables.device
    seed = _wrap32(seed)
    found, nxt, rank, slot = 0, int(start), 0, -1
    while not found and nxt < total:
        ranks = _ranks(nxt, chunk, dev)
        feasible, r1, r0 = _stream_chunk_constraints(
            tables, binom, g, k, target, mask, excl, ranks, total
        )
        # packing is per-cell bitwise, so pack(req1 | req0) == r1 | r0
        slots = match_table[r1.long() + ((r1 | r0).long() << num_cells)].long()
        ok = feasible & (slots >= 0)
        prio = torch.where(ok, _priority(chunk, seed ^ nxt, device=dev), 0)
        best = torch.argmax(prio)
        found, best, slot = torch.stack([ok.any().long(), best, slots[best]]).tolist()
        rank = nxt + best
        nxt += chunk
    examined = min(nxt, total) - int(start)
    return found, rank, slot, examined


def match_stream(
    tables, binom, g, target, mask, excl, start, total, match_table, seed,
    *, k, chunk, num_cells,
):
    """Streaming :func:`tuple_match_sweep` over ranks [start, total), to the
    first chunk where a valid tuple matches an available function.
    Returns int32[4] [found, abs_rank, slot, examined]."""
    return np.asarray(_match_stream_core(
        tables, binom, g, target, mask, excl, start, total, match_table, seed,
        k, chunk, num_cells,
    ), np.int32)


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
    dev = tables.device
    seed = _wrap32(seed)
    eq = eq_mask(tables, target, mask) & valid_g
    neq = eq_mask(~tables, target, mask) & valid_g
    sprio = _priority(valid_g.shape[0], seed, det_newest=True, device=dev)
    pf, pi, ps, _ = _tuple_match_core(
        tables, pair_combos, pair_valid, target, mask, pair_table,
        seed ^ 0x3D4A, 4,
    )
    if has_not:
        nf, ni, ns, _ = _tuple_match_core(
            tables, pair_combos, pair_valid, target, mask, not_table,
            seed ^ 0x11C9, 4,
        )
    else:
        nf = ni = ns = torch.zeros((), dtype=_I64, device=dev)
    direct, inv, dbest, ibest, pf, pi, ps, nf, ni, ns = torch.stack([
        eq.any().long(), neq.any().long(),
        torch.argmax(torch.where(eq, sprio, 0)),
        torch.argmax(torch.where(neq, sprio, 0)),
        pf, pi, ps, nf, ni, ns,
    ]).tolist()
    if direct or inv:
        v = (1 if direct else 2, dbest if direct else ibest, 0, 0)
    elif pf:
        v = (3, pi, ps, 0)
    elif nf:
        v = (4, ni, ns, 0)
    elif not has_triple:
        v = (0, 0, 0, 0)
    else:
        tf, rank, slot, ex = _match_stream_core(
            tables, binom, g, target, mask, excl, 0, total3, triple_table,
            seed ^ 0x7777, 3, chunk3, 8,
        )
        v = (5 if tf else 0, rank, slot, ex)
    return np.asarray(v, np.int32)


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
    dev = tables.device
    seed = _wrap32(seed)

    def pack(step, x0=0, x1=0, x2=0, x3=0, x4=0, ex3=0, ex5=0):
        return np.asarray([step, x0, x1, x2, x3, x4, ex3, ex5], np.int32)

    eq = eq_mask(tables, target, mask) & valid_g
    neq = eq_mask(~tables, target, mask) & valid_g
    sprio = _priority(valid_g.shape[0], seed, det_newest=True, device=dev)
    direct, inv, dbest, ibest = torch.stack([
        eq.any().long(), neq.any().long(),
        torch.argmax(torch.where(eq, sprio, 0)),
        torch.argmax(torch.where(neq, sprio, 0)),
    ]).tolist()
    if direct or inv:
        return pack(1 if direct else 2, dbest if direct else ibest)
    pf, pi, ps, _ = (
        int(x) for x in torch.stack(_tuple_match_core(
            tables, pair_combos, pair_valid, target, mask, pair_table,
            seed ^ 0x3D4A, 4,
        )).tolist()
    )
    if pf:
        return pack(3, pi, ps)
    no_excl = torch.full_like(excl, -1)
    f3, rank3, r1c, r0c, ex3 = _lut3_stream_core(
        tables, binom, g, target, mask, no_excl, 0, total3, seed ^ 0x55D3, chunk3
    )
    if f3:
        return pack(4, rank3, r1c, r0c, ex3=ex3)
    if not has5:
        return pack(0, ex3=ex3)
    status, rank, sigma, fo, sr1, sr0, cstart, ex5 = _lut5_stream_core(
        tables, binom, g, target, mask, excl, 0, total5, w_tab, m_tab,
        seed ^ 0x1BF5, chunk5, solve_rows,
    )
    step = 5 if status == 1 else (6 if status == 2 else 0)
    x0 = cstart if status == 2 else rank
    return pack(step, x0, sigma, fo, sr1, sr0, ex3, ex5)


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
    dev = tables.device
    seed = _wrap32(seed)
    ranks = torch.arange(chunk7, dtype=_I64, device=dev)
    feasible, r1, r0 = _stream_chunk_constraints(
        tables, binom, g, 7, target, mask, excl, ranks, total7
    )
    ex7 = min(total7, chunk7)
    v = np.zeros(14, np.int32)
    v[4] = ex7
    if not bool(feasible.any()):
        return v
    nfeas = int(feasible.sum())
    prio = torch.where(feasible, _priority(chunk7, seed ^ 0x77A1, device=dev), 0)
    topv, topi = _topk_index(prio, solve7)
    fsel = (topv > 0)[:, None]
    sr1 = torch.where(fsel, r1[topi], -1)
    sr0 = torch.where(fsel, r0[topi], -1)
    found, best_t, sigma, flat = _lut7_solve_core(sr1, sr0, idx_tab, pp_tab, seed ^ 0x77A1)
    overflow = nfeas > solve7 and not found
    v[0] = 1 if found else (2 if overflow else 0)
    v[1] = int(ranks[topi[best_t]])
    v[2] = sigma
    v[3] = flat
    v[5] = min(nfeas, solve7)
    v[6:10] = sr1[best_t].cpu().numpy()
    v[10:14] = sr0[best_t].cpu().numpy()
    return v


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
    dev = tables.device
    nxt, found, cstart = int(start), False, int(start)
    feas = torch.zeros(chunk, dtype=torch.bool, device=dev)
    r1 = torch.zeros((chunk,) if k <= 5 else (chunk, (1 << k) // 32), dtype=_I32, device=dev)
    r0 = r1
    while not found and nxt < total:
        feas, r1, r0 = _stream_chunk_constraints(
            tables, binom_wide, g, k, target, mask, excl, _ranks(nxt, chunk, dev), total
        )
        found = bool(feas.any())
        cstart, nxt = nxt, nxt + chunk
    lo, hi = cstart & M32, (cstart >> 32) & M32
    verdict = np.asarray([int(found), lo, hi], np.uint32).view(np.int32)
    return verdict, feas, r1, r0
