"""Combination-space enumeration (host side).

The LUT searches sweep C(G, k) combinations of gates in lexicographic rank
order, the order of the reference's get_nth_combination (lut.c:635-662) and
next_combination (lut.c:743-758).  The device streams unrank their own
chunks (:mod:`sboxgates_tpu_torch.ops.sweeps`); the helpers here decode the
ranks a device verdict names and enumerate small spaces on the host.
"""

from __future__ import annotations

import functools
import itertools
from math import comb
from typing import Iterator, Optional

import numpy as np


def n_choose_k(n: int, k: int) -> int:
    if n < 0 or k < 0 or k > n:
        return 0
    return comb(n, k)


def unrank_combination(rank: int, n: int, k: int) -> np.ndarray:
    """The rank'th k-combination of {0..n-1} in lexicographic order."""
    assert 0 <= rank < n_choose_k(n, k)
    out = np.empty(k, dtype=np.int32)
    e = 0
    for pos in range(k):
        while True:
            cnt = n_choose_k(n - e - 1, k - pos - 1)
            if rank < cnt:
                break
            rank -= cnt
            e += 1
        out[pos] = e
        e += 1
    return out


@functools.lru_cache(maxsize=8)
def _binom_u64(n: int, k: int) -> np.ndarray:
    """Exact C(i, j) for i <= n, j <= k as uint64 (fits through
    C(512, 8) ~ 4.2e17)."""
    t = np.zeros((n + 1, k + 1), dtype=np.uint64)
    t[:, 0] = 1
    for i in range(1, n + 1):
        t[i, 1:] = t[i - 1, :k] + t[i - 1, 1:]
    return t


def unrank_combinations(ranks, n: int, k: int) -> np.ndarray:
    """Vectorized :func:`unrank_combination` over a batch of ranks (uint64
    safe).  Returns [N, k] int32."""
    ranks = np.asarray(ranks, dtype=np.uint64)
    m = ranks.shape[0]
    if m == 0:
        return np.zeros((0, k), np.int32)
    tbl = _binom_u64(n, k)
    pos = np.zeros(m, np.int64)
    rem = ranks.copy()
    out = np.zeros((k, m), np.int32)
    lanes = np.arange(k, dtype=np.int64)[:, None]
    for v in range(n):
        c = tbl[max(n - v - 1, 0), np.clip(k - 1 - pos, 0, k)]
        active = pos < k
        take = active & (rem < c)
        out = np.where((lanes == pos[None, :]) & take[None, :], v, out)
        sub = active & ~take
        rem[sub] -= c[sub]
        pos[take] += 1
    return np.ascontiguousarray(out.T)


class CombinationStream:
    """Streams C(n, k) combinations as [chunk, k] int32 arrays, from rank
    ``start`` up to ``stop`` (the reference's per-rank ranges,
    lut.c:138-149)."""

    def __init__(self, n: int, k: int, start: int = 0, stop: Optional[int] = None):
        self.n = n
        self.k = k
        self.total = n_choose_k(n, k)
        self.stop = self.total if stop is None else min(stop, self.total)
        self.pos = min(start, self.stop)
        if self.pos >= self.total:
            self._it: Iterator = iter(())
        elif self.pos == 0:
            self._it = itertools.combinations(range(n), k)
        else:
            self._it = self._resume_iter(unrank_combination(self.pos, n, k))

    def _resume_iter(self, first: np.ndarray):
        combo = list(int(x) for x in first)
        n, k = self.n, self.k
        while True:
            yield tuple(combo)
            i = k - 1
            while i >= 0 and combo[i] + k - i >= n:
                i -= 1
            if i < 0:
                return
            combo[i] += 1
            for j in range(i + 1, k):
                combo[j] = combo[j - 1] + 1

    @property
    def remaining(self) -> int:
        return self.stop - self.pos

    def next_chunk(self, chunk: int) -> Optional[np.ndarray]:
        """Up to ``chunk`` combinations, or None when exhausted."""
        take = min(chunk, self.remaining)
        if take <= 0:
            return None
        rows = list(itertools.islice(self._it, take))
        self.pos += len(rows)
        if not rows:
            return None
        return np.asarray(rows, dtype=np.int32)


def pad_rows(a: np.ndarray, size: int, fill: int = 0) -> tuple:
    """Pads axis 0 to ``size``; returns (padded, valid_count)."""
    valid = a.shape[0]
    assert valid <= size
    if valid == size:
        return a, valid
    pad = np.full((size - valid,) + a.shape[1:], fill, dtype=a.dtype)
    return np.concatenate([a, pad], axis=0), valid


def tier_segments(chunk_scores, n_chunks: int, tiers: int = 4) -> list:
    """Best-first dispatch order over chunk ranges, as contiguous segments.

    The per-chunk scores of ``sweeps.spectral_score_stream`` are quantized
    into ``tiers`` integer tiers, and each maximal run of same-tier chunks
    becomes one segment ``(lo_chunk, hi_chunk, tier)``; the list is ordered
    tier descending, then lo ascending.  The streams sweep each segment
    through their ordinary (start, stop) operands, so chunk boundaries —
    and the per-chunk verdicts — never move.  The segments PARTITION
    ``[0, n_chunks)`` (asserted: scores reorder the sweep, they never
    shrink it), and are a pure function of the scores."""
    from .spectral import quantize_tiers

    s = np.asarray(chunk_scores, dtype=np.int64)[:n_chunks]
    assert s.shape[0] == n_chunks, (s.shape, n_chunks)
    if n_chunks <= 0:
        return []
    tier = quantize_tiers(s, tiers)
    runs = []
    lo = 0
    for i in range(1, n_chunks):
        if tier[i] != tier[lo]:
            runs.append((lo, i, int(tier[lo])))
            lo = i
    runs.append((lo, n_chunks, int(tier[lo])))
    runs.sort(key=lambda r: (-r[2], r[0]))
    covered = sorted((a, b) for a, b, _ in runs)
    assert covered[0][0] == 0 and covered[-1][1] == n_chunks and all(
        covered[i][1] == covered[i + 1][0] for i in range(len(covered) - 1)
    ), f"tier_segments must partition [0, {n_chunks}): {covered}"
    return runs
