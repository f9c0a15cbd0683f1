"""Search context: options, derived function tables, and sweep drivers.

The host side of the engine: it owns the available-function lists
(reference: the ``options`` struct, sboxgates.h:49-66), the precomputed
constraint-match tables, the seeded numpy PRNG, the device copies of the
constant tables, and the per-node drivers that run the sweeps of
:mod:`sboxgates_tpu_torch.ops.sweeps` on ``Options.device``.

Seeds are drawn exactly as the JAX package draws them (``next_seed``, one
per sweep dispatch of that package), so a ``--seed`` run builds the same
circuit in both.
"""

from __future__ import annotations

import hashlib
from collections import OrderedDict
from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..core import boolfunc as bf
from ..graph.state import GATES, State
from ..ops import combinatorics as comb
from ..ops import sweeps

# Gate-count buckets: live tables are zero-padded up to the next bucket.  The
# pair sweep's index space is the bucket's pair grid, so the bucket shapes
# which pair a hashed priority picks — they match the JAX package's.
BUCKETS = (64, 512)

LUT5_CHUNK = 1 << 17
LUT5_SOLVE_CHUNK = 4096
LUT7_CHUNK = 1 << 17
LUT7_CAP = 100_000       # reference: 100k-hit buffer, lut.c:291,316
LUT7_SOLVE_SIZES = (256, 1024, 4096)
LUT7_SOLVE_CHUNK = LUT7_SOLVE_SIZES[-1]

# Per-arity chunk sizes of the streaming sweeps.  Chunk boundaries seed the
# per-chunk priorities, so these are part of the search's semantics.
STREAM_CHUNK = {2: 1 << 14, 3: 1 << 15, 5: 1 << 17, 7: 1 << 15}

# From this 5-LUT space size on, the pivot-structured sweep takes over from
# the rank-chunk stream (and the fused node head leaves the 5-LUT out).
PIVOT_MIN_TOTAL = 1 << 21

# Values of Options.candidate_order.
CANDIDATE_ORDERS = ("lex", "spectral")

# Rows the fused head's 5-LUT solver takes per chunk.
LUT5_HEAD_SOLVE_ROWS = 1024

# Rows the fused 7-LUT step's stage-B solver takes.
LUT7_HEAD_SOLVE_ROWS = 256


def lut_head_has5(g: int) -> bool:
    """True when the fused LUT head includes the 5-LUT stream (small
    spaces; pivot-sized ones run separately)."""
    return 5 <= g and comb.n_choose_k(g, 5) < PIVOT_MIN_TOTAL


def lut_head_has7(g: int) -> bool:
    """True when the single-chunk 7-LUT step applies."""
    return 7 <= g and comb.n_choose_k(g, 7) <= STREAM_CHUNK[7]


@dataclass
class Options:
    """User configuration (reference: options struct + defaults,
    sboxgates.c:1060-1078)."""

    iterations: int = 1
    permute: int = 0
    metric: int = GATES
    lut_graph: bool = False
    randomize: bool = True
    try_nots: bool = False
    avail_gates_bitfield: int = bf.DEFAULT_AVAILABLE
    verbosity: int = 0
    seed: int = None
    # Device every sweep runs on.  "cuda" launches the hand-written kernels;
    # "cpu" runs their plain versions and must be asked for.
    device: str = "cuda"
    # Pivot tile kernel: "packed" (K1, packed cell words) or "pre" (K2,
    # int8 lanes expanded once per node, tensor cores).  Identical results.
    pivot_backend: str = "packed"
    # Candidate sweep order (--candidate-order, ops/spectral.py): "lex"
    # sweeps rank chunks (and pivot tiles) in order; "spectral" sweeps their
    # Walsh-score tiers best-first.  Ordering only: an exhaustive sweep
    # visits the same hit set either way.
    candidate_order: str = "lex"


@dataclass(frozen=True)
class MatchEntry:
    """One effective function byte in a match table: the function to
    materialize and the operand order to apply it with."""

    fun: bf.BoolFunc
    perm: Tuple[int, ...]  # operand order: input slot i takes gate perm[i]


def _pair_cell_fun(fun_nibble: int, swapped: bool) -> int:
    """Nibble re-encoded to cell order: bit (a<<1 | b) = f(a, b)."""
    v = 0
    for a in (0, 1):
        for b in (0, 1):
            x, y = (b, a) if swapped else (a, b)
            v |= bf.get_val(fun_nibble, x, y) << ((a << 1) | b)
    return v


def _build_pair_table(funs: Sequence[bf.BoolFunc]):
    """Match table + entries for a 2-input sweep, including swapped operand
    orders for non-commutative functions (sboxgates.c:342-347)."""
    entries: List[MatchEntry] = []
    bytes_: List[int] = []
    seen = {}
    ranked = sorted(range(len(funs)), key=lambda i: funs[i].extra_gates)
    for i in ranked:
        f = funs[i]
        orders = [(0, 1)] if f.ab_commutative else [(0, 1), (1, 0)]
        for perm in orders:
            eff = _pair_cell_fun(f.fun, perm == (1, 0))
            if eff not in seen:
                seen[eff] = True
                entries.append(MatchEntry(f, perm))
                bytes_.append(eff)
    table = sweeps.build_match_table(bytes_, num_cells=4)
    return table, entries


def bucket_size(n: int) -> int:
    for b in BUCKETS:
        if n <= b:
            return b
    raise ValueError(f"too many gates: {n}")


CHUNK_SIZES = (1024, 1 << 17)


def pick_chunk(n: int, cap: int) -> int:
    """Smallest chunk size covering n, capped."""
    for c in CHUNK_SIZES:
        if c >= cap:
            return cap
        if n <= c:
            return c
    return cap


def resolve_device(name: str) -> torch.device:
    """The torch device for ``Options.device``.  A CUDA request without a
    usable card is an error, never a silent CPU run."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is false; "
            "pass --device cpu (Options.device='cpu') to run on the host"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {name!r}")
    return dev


class Stats(dict):
    """Run counters (candidates examined per sweep kind, nodes, ...)."""

    def inc(self, key: str, n: int = 1) -> None:
        self[key] = self.get(key, 0) + int(n)

    def __missing__(self, key):
        return 0


class SearchContext:
    """Derived state shared by every create_circuit call of one run."""

    #: Entries kept in the device-table cache.
    TABLE_CACHE_SLOTS = 8

    def __init__(self, opt: Options):
        self.opt = opt
        self.device = resolve_device(opt.device)
        if opt.pivot_backend not in sweeps.PIVOT_BACKENDS:
            raise ValueError(f"unknown pivot backend {opt.pivot_backend!r}")
        if opt.candidate_order not in CANDIDATE_ORDERS:
            raise ValueError(f"unknown candidate order {opt.candidate_order!r}")
        self.rng = np.random.default_rng(opt.seed)
        self.avail_gates = bf.create_avail_gates(opt.avail_gates_bitfield)
        self.avail_not = (
            bf.get_not_functions(self.avail_gates) if opt.try_nots else []
        )
        self.avail_3 = bf.get_3_input_function_list(self.avail_gates, opt.try_nots)
        self.pair_table_np, self.pair_entries = _build_pair_table(self.avail_gates)
        self.pair_table = torch.from_numpy(self.pair_table_np.astype(np.int64)).to(
            self.device
        )
        self._seed_buf = (np.empty(0, dtype=np.int64), 0)
        self._pair_combo_cache = {}
        self._table_cache: "OrderedDict" = OrderedDict()
        self._binom = None
        self._binom_wide = None
        self._lut5_tabs = None
        self._lut7_tabs = None
        self.stats = Stats()

    # -- helpers ----------------------------------------------------------

    def next_seed(self) -> int:
        """Per-dispatch kernel seed, drawn from the context PRNG in blocks of
        256 (the JAX package's draw pattern); -1 when not randomizing (the
        sweeps then select in scan order)."""
        if not self.opt.randomize:
            return -1
        buf, pos = self._seed_buf
        if pos >= len(buf):
            buf = self.rng.integers(0, 2**31, size=256)
            pos = 0
        self._seed_buf = (buf, pos + 1)
        return int(buf[pos])

    def words(self, a) -> torch.Tensor:
        """Host uint32 words -> int32 tensor on the context's device."""
        return sweeps.as_words(a, self.device)

    def device_tables(self, st: State) -> torch.Tensor:
        """Zero-padded [bucket, 8] int32 live tables on the device, memoized
        on (bucket, content digest)."""
        g = st.num_gates
        b = bucket_size(g)
        live = np.ascontiguousarray(st.live_tables())
        key = (b, hashlib.blake2b(live.tobytes(), digest_size=16).digest())
        hit = self._table_cache.get(key)
        if hit is not None:
            self._table_cache.move_to_end(key)
            return hit
        padded = np.zeros((b, 8), dtype=np.uint32)
        padded[:g] = live
        placed = self.words(padded)
        self._table_cache[key] = placed
        while len(self._table_cache) > self.TABLE_CACHE_SLOTS:
            self._table_cache.popitem(last=False)
        return placed

    def _pair_combos_np(self, bucket: int) -> np.ndarray:
        i, j = np.triu_indices(bucket, k=1)
        return np.stack([i, j], axis=1).astype(np.int32)

    def _pair_combos(self, bucket: int) -> torch.Tensor:
        if bucket not in self._pair_combo_cache:
            self._pair_combo_cache[bucket] = torch.from_numpy(
                self._pair_combos_np(bucket).astype(np.int64)
            ).to(self.device)
        return self._pair_combo_cache[bucket]

    @property
    def binom(self) -> torch.Tensor:
        """Device binomial table for the int32-rank streams."""
        if self._binom is None:
            self._binom = sweeps.binom_device(self.device)
        return self._binom

    @property
    def binom_wide(self) -> torch.Tensor:
        """Device exact binomial table for the 64-bit-rank streams."""
        if self._binom_wide is None:
            self._binom_wide = sweeps.binom_wide_device(self.device)
        return self._binom_wide

    def lut5_tabs(self):
        """(w_tab, m_tab) of the 5-LUT solver on the device."""
        if self._lut5_tabs is None:
            _, w_tab, m_tab = sweeps.lut5_split_tables()
            self._lut5_tabs = (self.words(w_tab), self.words(m_tab))
        return self._lut5_tabs

    def lut7_tabs(self):
        """(idx_tab, pp_tab) of the 7-LUT solver on the device."""
        if self._lut7_tabs is None:
            idx_tab, pp_tab = sweeps.lut7_pair_tables()
            self._lut7_tabs = (
                torch.from_numpy(idx_tab.astype(np.int64)).to(self.device),
                torch.from_numpy(pp_tab).to(self.device),
            )
        return self._lut7_tabs

    @staticmethod
    def excl_array(inbits) -> np.ndarray:
        """Mux-used input bits as a padded exclusion list (reference: the
        inbits rejection, lut.c:176-186)."""
        excl = np.full(8, -1, dtype=np.int32)
        for i, b in enumerate([b for b in inbits if b >= 0][:8]):
            excl[i] = b
        return excl

    def stream_args(self, st: State, target, mask, inbits, k: int):
        """Common operands of the streaming sweeps: returns
        ((tables, binom, g, target, mask, excl), total, chunk)."""
        g = st.num_gates
        total = comb.n_choose_k(g, k)
        chunk = pick_chunk(total, STREAM_CHUNK[k])
        return (
            (
                self.device_tables(st),
                self.binom,
                g,
                self.words(target),
                self.words(mask),
                torch.from_numpy(self.excl_array(inbits)).to(self.device),
            ),
            total,
            chunk,
        )

    def feasible_stream_driver(
        self, st: State, target, mask, inbits, k: int, start: int = 0,
        prebuilt=None, stop=None,
    ):
        """One stream sweeping combination ranks [start, total) to the first
        chunk with a feasible k-tuple; ``stop`` bounds it to [start, stop)
        (the best-first drivers sweep one tier segment at a time).  Returns
        (found, chunk_start, feasible, req1, req0, examined, chunk)."""
        if prebuilt is None:
            prebuilt = self.stream_args(st, target, mask, inbits, k)
        base_args, total, chunk = prebuilt
        if stop is not None:
            total = min(int(stop), total)
        verdict, feas, r1, r0 = sweeps.feasible_stream(
            *base_args, start, total, k=k, chunk=chunk
        )
        found, cstart, examined = (int(x) for x in verdict)
        return bool(found), cstart, feas, r1, r0, examined, chunk

    # -- node heads -------------------------------------------------------

    def lut_step(self, st: State, target, mask, inbits) -> np.ndarray:
        """Steps 1-3 plus the whole 3-LUT and (small-space) 5-LUT sweeps of
        one LUT-mode search node, for one seed (sweeps.lut_step_stream).
        Returns the int32[8] verdict."""
        g = st.num_gates
        b = bucket_size(g)
        tables = self.device_tables(st)
        valid_g = torch.arange(b, device=self.device) < g
        combos = self._pair_combos(b)
        pair_valid = (combos < g).all(dim=1)
        total3 = comb.n_choose_k(g, 3)
        total5 = comb.n_choose_k(g, 5)
        has5 = lut_head_has5(g)
        chunk3 = pick_chunk(max(total3, 1), STREAM_CHUNK[3])
        chunk5 = pick_chunk(max(total5, 1), STREAM_CHUNK[5]) if has5 else 1024
        jw, jm = self.lut5_tabs()
        v = sweeps.lut_step_stream(
            tables, valid_g, combos, pair_valid, self.binom, g,
            self.words(target), self.words(mask),
            torch.from_numpy(self.excl_array(inbits)).to(self.device),
            total3, total5, self.pair_table, jw, jm, self.next_seed(),
            chunk3=chunk3, chunk5=chunk5, has5=has5,
            solve_rows=LUT5_HEAD_SOLVE_ROWS,
        )
        step = int(v[0])
        if step == 0 or step >= 3:
            self.stats.inc("pair_candidates", g * (g - 1) // 2)
        self.stats.inc("lut3_candidates", int(v[6]))
        self.stats.inc("lut5_candidates", int(v[7]))
        return v

    def lut7_step(self, st: State, target, mask, inbits) -> np.ndarray:
        """Whole single-chunk 7-LUT search for one seed
        (sweeps.lut7_step_stream); only valid when ``lut_head_has7(g)``.
        Returns the int32[14] verdict."""
        g = st.num_gates
        total7 = comb.n_choose_k(g, 7)
        chunk7 = pick_chunk(max(total7, 1), STREAM_CHUNK[7])
        jidx, jpp = self.lut7_tabs()
        v = sweeps.lut7_step_stream(
            self.device_tables(st), self.binom, g, self.words(target),
            self.words(mask),
            torch.from_numpy(self.excl_array(inbits)).to(self.device),
            total7, jidx, jpp, self.next_seed(),
            chunk7=chunk7, solve7=LUT7_HEAD_SOLVE_ROWS,
        )
        self.stats.inc("lut7_candidates", int(v[4]))
        self.stats.inc("lut7_solved", int(v[5]))
        return v

    def decode_pair_hit(self, st: State, index: int, slot: int):
        """(gid1, gid2, entry) for a fused-head pair hit."""
        pair = self._pair_combos_np(bucket_size(st.num_gates))[index]
        entry = self.pair_entries[slot]
        gids = [int(pair[p]) for p in entry.perm]
        return gids[0], gids[1], entry
