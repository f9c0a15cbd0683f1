"""Combination-space enumeration (host side).

The LUT searches sweep C(G, k) combinations of gates in lexicographic rank
order, the order of the reference's get_nth_combination (lut.c:635-662) and
next_combination (lut.c:743-758).  The device streams unrank their own
chunks (:mod:`sboxgates_tpu_torch.ops.sweeps`); the helpers here decode the
ranks a device verdict names and enumerate spaces on the host: the
:class:`ChunkPrefetcher` feeds the host chunk stream that a tripped device
breaker degrades the big 5/7-LUT sweeps to (``search.lut``).
"""

from __future__ import annotations

import functools
import itertools
import queue as _queue
import threading
import time
from math import comb
from typing import Callable, Iterator, Optional, Sequence, Tuple

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


_native_ok: Optional[bool] = None
_native_probe_lock = threading.Lock()


def _native_stream_available() -> bool:
    """True when the native host runtime (csrc/runtime.cpp) builds: its
    combination generator then makes the chunks, with the Python iterator
    as the fallback.  Probed once per process."""
    global _native_ok
    if _native_ok is None:
        with _native_probe_lock:
            if _native_ok is None:
                from .. import native

                _native_ok = native.available()
    return _native_ok


def combination_rank(combo: Sequence[int], n: int) -> int:
    """Inverse of :func:`unrank_combination`."""
    k = len(combo)
    rank = 0
    prev = -1
    for pos, e in enumerate(combo):
        for x in range(prev + 1, e):
            rank += n_choose_k(n - x - 1, k - pos - 1)
        prev = e
    return rank


class CombinationStream:
    """Streams C(n, k) combinations as [chunk, k] int32 arrays, from rank
    ``start`` up to ``stop`` (the reference's per-rank ranges,
    lut.c:138-149): from the native runtime's generator when it builds,
    else from a Python iterator (the same rows)."""

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
        if _native_stream_available():
            from .. import native

            rows_arr = native.combinations_from_rank(self.n, self.k, self.pos, take)
            self.pos += rows_arr.shape[0]
            if rows_arr.shape[0] == 0:
                return None
            return rows_arr
        rows = list(itertools.islice(self._it, take))
        self.pos += len(rows)
        if not rows:
            return None
        # torchlint: ignore[R2x] host-built list of combination tuples from the pure-Python iterator; no device value can flow here
        return np.asarray(rows, dtype=np.int32)


def filter_exclude(combos: np.ndarray, exclude: Sequence[int]) -> np.ndarray:
    """Drops the rows holding any excluded element."""
    if len(exclude) == 0 or combos.size == 0:
        return combos
    bad = np.isin(combos, np.asarray(list(exclude), dtype=np.int32)).any(axis=1)
    return combos[~bad]


def pad_rows(a: np.ndarray, size: int, fill: int = 0) -> tuple:
    """Pads axis 0 to ``size``; returns (padded, valid_count)."""
    valid = a.shape[0]
    assert valid <= size
    if valid == size:
        return a, valid
    pad = np.full((size - valid,) + a.shape[1:], fill, dtype=a.dtype)
    return np.concatenate([a, pad], axis=0), valid


class ChunkPrefetcher:
    """Background producer of the host chunk streams.

    Runs ``CombinationStream.next_chunk`` + :func:`filter_exclude` +
    :func:`pad_rows` in a worker thread, up to ``depth`` chunks ahead of the
    consumer (a bounded queue), so the host makes the next chunks while the
    card filters the last ones.  ``depth <= 1`` produces inline, with no
    thread.  Chunk boundaries, contents, order and padding are the same at
    every depth: the producer is the stream's only reader and the queue
    keeps order.

    ``get()`` returns ``(padded [chunk, k] int32, valid_count)`` tuples,
    then None forever once the stream ends.  An exception in the producer
    is raised by the ``get()`` that would have returned the failed chunk.
    ``close()`` (also on ``__exit__``) stops the worker and is idempotent.
    One consumer thread per instance.

    ``on_produce(start, end)`` receives each chunk's production span
    (``perf_counter`` times, on the producer thread) and ``on_stall(start,
    end)`` each ``get()``'s blocked span: the profiler's overlap
    accounting.
    """

    def __init__(
        self,
        stream: CombinationStream,
        chunk_size: int,
        exclude: Sequence[int] = (),
        depth: int = 2,
        on_produce: Optional[Callable[[float, float], None]] = None,
        on_stall: Optional[Callable[[float, float], None]] = None,
    ):
        self.stream = stream
        self.on_produce = on_produce
        self.on_stall = on_stall
        self.chunk_size = chunk_size
        self.exclude = [int(b) for b in exclude]
        self.depth = max(1, int(depth))
        self._done = False
        self._inline = self.depth <= 1
        self._close_lock = threading.Lock()
        self._closed_flag = False
        if not self._inline:
            self._q: _queue.Queue = _queue.Queue(maxsize=self.depth)
            self._stop = threading.Event()
            self._exc: Optional[BaseException] = None
            self._thread = threading.Thread(
                target=self._work, name="sbg-chunk-prefetch", daemon=True
            )
            self._thread.start()

    def _produce_one(self) -> Optional[Tuple[np.ndarray, int]]:
        # Fault site: one hit per produced chunk.
        from ..resilience.faults import fault_point

        fault_point("prefetch.produce")
        t0 = time.perf_counter()
        chunk = self.stream.next_chunk(self.chunk_size)
        item = None if chunk is None else pad_rows(
            filter_exclude(chunk, self.exclude), self.chunk_size
        )
        if self.on_produce is not None:
            self.on_produce(t0, time.perf_counter())
        return item

    def _work(self) -> None:
        try:
            while not self._stop.is_set():
                item = self._produce_one()
                self._put(item)
                if item is None:
                    return
        except BaseException as e:  # raised by the consumer's get()
            self._exc = e
            self._put(None)

    def _put(self, item) -> None:
        # A put that stays responsive to close(): a plain blocking put
        # would deadlock the join once the consumer stops reading.
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.05)
                return
            except _queue.Full:
                continue

    def get(self) -> Optional[Tuple[np.ndarray, int]]:
        """Next (padded, valid_count) in stream order; None at the end."""
        if self._done:
            return None
        t0 = time.perf_counter()
        item = self._produce_one() if self._inline else self._q.get()
        if self.on_stall is not None:
            self.on_stall(t0, time.perf_counter())
        if item is None:
            self._done = True
            if not self._inline and self._exc is not None:
                exc, self._exc = self._exc, None
                raise exc
        return item

    def close(self) -> None:
        """Stops the worker and joins it; drains the queue before and after
        the join (the producer may complete one more put) and leaves a
        None for a consumer blocked in ``get()``."""
        with self._close_lock:
            already = self._closed_flag
            self._closed_flag = True
        self._done = True
        if self._inline or already:
            return
        self._stop.set()
        self._drain()
        self._thread.join(timeout=10.0)
        self._drain()
        try:
            self._q.put_nowait(None)
        except _queue.Full:  # pragma: no cover - depth >= 1 always fits
            pass

    def _drain(self) -> None:
        try:
            while True:
                self._q.get_nowait()
        except _queue.Empty:
            pass

    @property
    def closed(self) -> bool:
        """True once no worker thread runs (inline mode: always)."""
        return self._inline or not self._thread.is_alive()

    def __enter__(self) -> "ChunkPrefetcher":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False


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
