"""Search context: options, derived function tables, and sweep drivers.

The host side of the engine: it owns the available-function lists
(reference: the ``options`` struct, sboxgates.h:49-66), the precomputed
constraint-match tables, the seeded numpy PRNG, the device copies of the
constant tables, and the per-node drivers that run the sweeps of
:mod:`sboxgates_tpu_torch.ops.sweeps` on ``Options.device`` or, by the
placement policy (``uses_native_step``), the same node heads on the native
host runtime (:mod:`sboxgates_tpu_torch.native`).

Seeds are drawn exactly as the JAX package draws them (``next_seed``, one
per sweep dispatch of that package), so a ``--seed`` run builds the same
circuit in both.
"""

from __future__ import annotations

import hashlib
import os
import threading
from collections import OrderedDict
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core import boolfunc as bf
from ..graph.state import GATES, State
from ..ops import combinatorics as comb
from ..ops import sweeps
from ..resilience import deadline as _deadline
from ..telemetry import attribution as _tattr
from ..telemetry import flight as _tflight
from ..telemetry import metrics as _tmetrics
from ..telemetry import trace as _ttrace
from ..utils.profile import PhaseProfiler
from . import warmup as _warmup

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
    # The native host runtime: node heads (steps 1-4, the LUT head, 7-LUT
    # stage A and B) run on the host instead of the device sweeps (same
    # verdicts), and the whole create_circuit recursion runs in a native
    # engine (the gate engine, or the LUT engine with its device-work
    # service).  The engine draws its randomized choices from its own PRNG
    # stream, seeded from the context's, so a seed gives other circuits
    # than the Python recursion (the JAX package's default files, which
    # the JAX package's host_small_steps and native_engine both select).
    # Off = every node on the device.  Falls back to the device, with a
    # warning, when the runtime does not build.
    native: bool = True
    # Chunks the host chunk stream (the fallback of the big 5/7-LUT sweeps)
    # produces ahead, and filter launches it keeps in flight; 1 = serial.
    # Identical results at every depth.
    pipeline_depth: int = 2
    # Hung-dispatch deadline of the guarded sweeps, in seconds (None = the
    # SBG_DISPATCH_TIMEOUT_S default, 0 = off): a breach retries with
    # backoff, then the driver degrades to the host chunk stream.
    dispatch_timeout_s: Optional[float] = None
    # --trace: the process tracer records spans while this context lives
    # (the CLI exports them at exit).  Observation only.
    trace: bool = False
    # --status-port: the CLI serves /status on this port (0: ephemeral).
    # Observation only.
    status_port: Optional[int] = None
    # Concurrent exploration of the step-5 mux's select bits (threads whose
    # sweeps rendezvous, search/batched.py): None = on when the device is
    # not the CPU, the JAX package's rule for its backend; --serial-mux
    # forces it off.  The branches draw their seeds from the context's
    # PRNG in one block, so a randomized search builds other circuits with
    # it on than off (each deterministic).
    parallel_mux: Optional[bool] = None
    # -i restarts as one concurrent batch (--batch-iterations).
    batch_restarts: bool = False
    # Fleet execution of job waves (--fleet, search/fleet.py).
    fleet: bool = False
    # Jobs per fleet wave; the per-job seeds are drawn one wave at a time.
    fleet_max_wave: int = 256
    # --chain-rounds: the all-outputs LUT search as one greedy chain of
    # rounds over one growing graph (search/rounds.py), up to this many
    # rounds per device call; 0 = the beam search.  Another driver, so
    # other circuits; the same circuits for every value above 0.
    chain_rounds: int = 0
    # --result-store: the content-addressed result store's directory
    # (store/): finished searches publish there, serve admission consults
    # it.  Never shapes the draw stream of a search that runs.  None = off.
    result_store: Optional[str] = None


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


def _build_triple_table(funs: Sequence[bf.BoolFunc]):
    """Match table + entries for the 3-input sweep.  Non-commutative operand
    orders become distinct effective function bytes (in place of the
    permutation re-evaluations at sboxgates.c:406-432; each function's own
    commutativity flags decide, as in the JAX package)."""
    entries: List[MatchEntry] = []
    bytes_: List[int] = []
    seen = {}
    ranked = sorted(range(len(funs)), key=lambda i: funs[i].extra_gates)
    for i in ranked:
        f = funs[i]
        orders = [(0, 1, 2)]
        if not f.ab_commutative:
            orders.append((1, 0, 2))
        if not f.ac_commutative:
            orders.append((2, 1, 0))
        if not f.bc_commutative:
            orders.append((0, 2, 1))
        for perm in orders:
            eff = bf.permute_fun3(f.fun, perm)
            if eff not in seen:
                seen[eff] = True
                entries.append(MatchEntry(f, perm))
                bytes_.append(eff)
    table = sweeps.build_match_table(bytes_, num_cells=8)
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
        # Match tables: numpy for the native runtime, int64 on the device.
        self.pair_table_np, self.pair_entries = _build_pair_table(self.avail_gates)
        self.pair_table = self._match_table(self.pair_table_np)
        if self.avail_not:
            self.not_table_np, self.not_entries = _build_pair_table(self.avail_not)
            self.not_table = self._match_table(self.not_table_np)
        else:
            self.not_table_np, self.not_table, self.not_entries = None, None, []
        self.triple_table_np, self.triple_entries = _build_triple_table(self.avail_3)
        self.triple_table = self._match_table(self.triple_table_np)
        self._native_probe = None
        self._gate_step_caller = None
        self._gate_engine_caller = None
        self._lut_engine_caller = None
        # (callback, pending) of the LUT engine's device-work service
        # (kwan._native_lut_engine_search), alive as long as the context.
        self.lut_engine_devcb = None
        self._seed_buf = (np.empty(0, dtype=np.int64), 0)
        self._pair_combo_cache = {}
        self._table_cache: "OrderedDict" = OrderedDict()
        # Shared by every thread's view of the context (mux branches,
        # restarts, fleet jobs).
        self._table_lock = threading.Lock()
        self._binom = None
        self._binom_wide = None
        self._lut5_tabs = None
        self._lut7_tabs = None
        # Run counters and histograms: the thread-safe registry
        # (telemetry.metrics), read like a dict; the declared schema is
        # telemetry.metrics.METRICS.
        self.stats = _tmetrics.context_registry()
        # Per-phase wall-clock timers (the -v -v report).
        self.prof = PhaseProfiler()
        if opt.trace:
            _ttrace.tracer().enabled = True
        # Attribution rows are drawn against the device's peaks; the
        # kernels' launch times land in self.stats through this timer.  The
        # cost store is process-wide: a new context (one per run) empties
        # it, so a run's rows hold its own launches only.
        _tattr.reset()
        _tattr.note_backend(self.device.type)
        self.launch_timer = _tattr.LaunchTimer(self.stats)
        # Gate count of the latest node sweep (device or host): the C(g, k)
        # denominator of /status coverage.  A plain attribute, not a
        # registry gauge (merge sums scalars).
        self.last_dispatch_gates: Optional[int] = None
        # Deadline policy of the guarded sweeps (guarded_dispatch).
        self.deadline_cfg = _deadline.config_from_env()
        if opt.dispatch_timeout_s is not None:
            self.deadline_cfg.budget_s = float(opt.dispatch_timeout_s)
        # Circuit breaker: set, for the rest of the run, the first time a
        # guarded sweep exhausts its retry schedule.  Later LUT sweeps then
        # go straight to the host chunk stream instead of re-probing a
        # known-dead device for budget * (retries + 1) seconds each.
        self.device_degraded = False
        # Rendezvous of concurrent mux-branch / restart threads (None: plain
        # dispatch): the JAX rule, on unless the device is the CPU.
        self.rdv = None
        want_mux = opt.parallel_mux
        if want_mux is None:
            want_mux = self.device.type != "cpu"
        if want_mux:
            from .batched import Rendezvous  # deferred: import cycle

            self.rdv = Rendezvous(1, timer=self.launch_timer)
        self._engine_mux_threads = None
        # The result store (Options.result_store), shared by reference with
        # every view of this context.  Deferred import: store/ imports no
        # search module.
        self.result_store = None
        if opt.result_store:
            from ..store import ResultStore

            self.result_store = ResultStore(opt.result_store, stats=self.stats)

    # -- helpers ----------------------------------------------------------

    def _match_table(self, table_np: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(table_np.astype(np.int64)).to(self.device)

    def rng_snapshot(self) -> dict:
        """The host PRNG position as JSON-able data: the numpy bit-generator
        state and the unconsumed tail of the 256-seed buffer (restoring the
        generator alone would shift every later :meth:`next_seed` draw).
        The journal's resume payload, the JAX package's format."""
        buf, pos = self._seed_buf
        return {
            "bg": self.rng.bit_generator.state,
            "seed_buf": [int(x) for x in buf[pos:]],
        }

    def rng_restore(self, snap: dict) -> None:
        """Inverse of :meth:`rng_snapshot`: every later draw matches the run
        the snapshot came from."""
        self.rng.bit_generator.state = snap["bg"]
        self._seed_buf = (np.asarray(snap["seed_buf"], dtype=np.int64), 0)

    def guarded_dispatch(self, fn, label: str):
        """Runs one blocking device sweep under the hung-dispatch deadline
        (:func:`resilience.deadline.dispatch_with_retry`): breach, retry
        with backoff, then :class:`DispatchTimeout` for the caller to
        degrade on.  Also the ``dispatch.sweep`` fault site, one hit per
        call (and per retry).  ``fn`` issues and resolves the sweep, so a
        retry re-issues it with buffers of its own.  Inline when no budget
        is set."""
        return _deadline.dispatch_with_retry(
            fn, self.deadline_cfg, stats=self.stats, label=label
        )

    def host_sync_deadline(self, fn, label: str):
        """Deadline-only guard (no retry, no fault site) of the host chunk
        stream's own device work: the fallback is the degradation target,
        so it never re-enters the retry and degrade ladder, but a dead
        device must not hang it forever either.  One window of the whole
        retry schedule's budget; a breach raises :class:`DispatchTimeout`
        and the search fails loudly."""
        cfg = self.deadline_cfg
        if not cfg.enabled:
            return fn()
        return _deadline.run_with_deadline(
            fn, cfg.budget_s * (cfg.retries + 1), label
        )

    def trip_device_breaker(self) -> None:
        """Flips the device circuit breaker for the rest of the run: later
        LUT sweeps go straight to the host chunk stream.  The trip is a
        flight-recorder incident: the dump holds the recent dispatch and
        deadline events and the counters."""
        self.device_degraded = True
        self.stats.inc("circuit_breaker_trips")
        _ttrace.instant("circuit_breaker.trip", "deadline", demoted_mesh=False)
        path = _tflight.flight_dump(
            "circuit_breaker", registry=self.stats,
            extra={"demoted_mesh": False},
        )
        if path is not None:
            self.stats.inc("flight_dumps")

    def dispatch(self, name: str, fn, g: Optional[int] = None):
        """One device sweep call of the search layer, ``fn()``, at the
        sites where the JAX package calls ``kernel_call``: the only place
        ``device_dispatches`` is counted, and one ``dispatch[<name>]`` span
        (kernel, gate count, and the kernel launches of the call with
        their summed analytic cost).  The launches of K1-K5 inside it are
        timed into this context's registry, gated by the deadline's
        attempt when it runs on one, and those that have completed by the
        time ``fn`` returns (after its own verdict sync) are read then."""
        self.stats.inc("device_dispatches")
        if g is not None:
            self.last_dispatch_gates = g
        with _ttrace.span(f"dispatch[{name}]", "dispatch", kernel=name,
                          g=g) as sp:
            with _tattr.recording(self.launch_timer,
                                  _deadline.current_attempt()) as launched:
                out = fn()
            if launched:
                sp.set(launches=len(launched), **self._launch_cost(launched))
        self.launch_timer.settle()
        return out

    @staticmethod
    def _launch_cost(launched) -> dict:
        total: dict = {}
        for kernel, bucket in launched:
            for k, v in (_tattr.annotation(kernel, bucket) or {}).items():
                total[k] = total.get(k, 0.0) + v
        return total

    def kernel_call(self, name: str, statics: dict, args: tuple, g=None):
        """One registry sweep (:mod:`.warmup`) from this thread:
        :meth:`dispatch` of ``KERNELS[name]`` with ``statics`` on ``args``."""
        fn = _warmup.kernel(name, statics)
        return self.dispatch(name, lambda: fn(*args), g=g)

    def _dispatch(self, name: str, statics: dict, args: tuple, g=None):
        """A fused node-head sweep: with a rendezvous attached and other
        live threads in its pool, it merges with their same-shaped sweeps
        into one lane-form call; otherwise :meth:`kernel_call`.  Reading
        ``live`` unlocked is safe: it exceeds 1 only while helper threads
        this thread spawned are attached."""
        if self.rdv is not None and self.rdv.live > 1:
            return self.rdv.submit(
                _warmup.warm_key(name, statics, args), name, statics, args,
                g=g, label=getattr(self, "dispatch_label", None),
            )
        return self.kernel_call(name, statics, args, g=g)

    def _merge_streams(self) -> bool:
        """True when a streaming sweep (pivot, 5-LUT, feasibility streams)
        should rendezvous with the other live threads: only under the
        fleet's rendezvous (``merges_streams``), and never under a
        hung-dispatch deadline (an abandoned attempt's entry would stall the
        pool) or once the device breaker has tripped, as in the JAX
        package."""
        return (
            self.rdv is not None
            and getattr(self.rdv, "merges_streams", False)
            and self.rdv.live > 1
            and not self.deadline_cfg.enabled
            and not self.device_degraded
        )

    def stream_dispatch(self, name: str, statics: dict, args: tuple, g=None):
        """Registry dispatch of a streaming sweep: merged through the fleet
        rendezvous when :meth:`_merge_streams` allows (a lane's verdict is
        the single-lane sweep's), else :meth:`kernel_call`."""
        if self._merge_streams():
            return self.rdv.submit(
                _warmup.warm_key(name, statics, args), name, statics, args,
                g=g, label=getattr(self, "dispatch_label", None),
            )
        return self.kernel_call(name, statics, args, g=g)

    def observe_job(self, name: str, t0: float, t1: float, found: bool) -> None:
        """Per-job telemetry: one ``job`` span and the ``job_seconds`` /
        ``job_time_to_first_hit_s`` histograms (the latter only for a job
        that found a circuit)."""
        dt = t1 - t0
        self.stats.observe("job_seconds", dt)
        if found:
            self.stats.observe("job_time_to_first_hit_s", dt)
        _ttrace.tracer().record(f"job[{name}]", "job", t0, t1, {"found": found})

    def engine_mux_threads(self) -> int:
        """Threads of the native LUT engine's outermost mux fan-out
        (``SBG_ENGINE_MUX_THREADS``, default 1 = serial).  Above 1 the
        branches' serviced device work overlaps, and the randomized stream
        differs (still seed-deterministic); without randomization the
        results are the same for every value, as in the JAX package."""
        if self._engine_mux_threads is None:
            self._engine_mux_threads = max(1, int(os.environ.get(
                "SBG_ENGINE_MUX_THREADS", "1"
            ) or "1"))
        return self._engine_mux_threads

    def close_telemetry(self) -> int:
        """Reads the launch times never synced by the search (a window
        swept past a hit), once the stream has finished them: polls, never
        waits.  Returns how many were dropped unread."""
        return self.launch_timer.drain()

    def status_state(self) -> dict:
        """Engine-state section of ``/status`` (read-only, lock-free)."""
        return {
            "device_degraded": self.device_degraded,
            "deadline_enabled": bool(self.deadline_cfg.enabled),
            "lut_graph": self.opt.lut_graph,
            "candidate_order": self.opt.candidate_order,
            "native": self.opt.native,
            "device": str(self.device),
            "last_dispatch_gates": self.last_dispatch_gates,
        }

    @property
    def pipeline_depth(self) -> int:
        """Prefetch and in-flight depth of the host chunk stream
        (``Options.pipeline_depth``, at least 1)."""
        return max(1, int(self.opt.pipeline_depth))

    def host_prefetcher(self, stream, chunk_size: int, exclude, phase: str):
        """A :class:`ops.combinatorics.ChunkPrefetcher` of this context's
        depth, its produce and stall spans recorded against ``phase`` in
        the profiler's overlap accounting, keyed on the calling (consumer)
        thread."""
        ckey = threading.get_ident()
        return comb.ChunkPrefetcher(
            stream, chunk_size, exclude, depth=self.pipeline_depth,
            on_produce=lambda t0, t1: self.prof.add_produce(
                phase, t0, t1, consumer=ckey),
            on_stall=lambda t0, t1: self.prof.add_stall(
                phase, t0, t1, consumer=ckey),
        )

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
        with self._table_lock:
            hit = self._table_cache.get(key)
            if hit is not None:
                self._table_cache.move_to_end(key)
                return hit
        padded = np.zeros((b, 8), dtype=np.uint32)
        padded[:g] = live
        placed = self.words(padded)
        with self._table_lock:
            # Two threads may place the same key: both hold the same words.
            self._table_cache[key] = placed
            while len(self._table_cache) > self.TABLE_CACHE_SLOTS:
                self._table_cache.popitem(last=False)
        return placed

    def fleet_device_tables(self, states, done=None, lanes: Optional[int] = None,
                            bucket: Optional[int] = None) -> torch.Tensor:
        """Stacked form of :meth:`device_tables`: the jobs' padded live
        tables as one int32 [lanes, bucket, 8] tensor (``lanes`` defaults to
        the fleet's jobs bucket); ``done`` jobs and pad lanes past the last
        job are zero rows."""
        from .fleet import fleet_bucket

        n = len(states)
        done = [False] * n if done is None else list(done)
        if bucket is None:
            bucket = max(bucket_size(st.num_gates) for st in states)
        if lanes is None:
            lanes = fleet_bucket(n)
        stacked = np.zeros((lanes, bucket, 8), dtype=np.uint32)
        for i, (st, d) in enumerate(zip(states, done)):
            if not d:
                live = np.ascontiguousarray(st.live_tables())
                stacked[i, : live.shape[0]] = live
        return self.words(stacked)

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
        (the best-first drivers sweep one tier segment at a time).  One
        :meth:`guarded_dispatch`.  Returns (found, chunk_start, feasible,
        req1, req0, examined, chunk)."""
        if prebuilt is None:
            prebuilt = self.stream_args(st, target, mask, inbits, k)
        base_args, total, chunk = prebuilt
        if stop is not None:
            total = min(int(stop), total)
        verdict, feas, r1, r0 = self.guarded_dispatch(
            lambda: self.stream_dispatch(
                "feasible_stream", dict(k=k, chunk=chunk),
                (*base_args, start, total), g=st.num_gates,
            ),
            f"feasible_stream k={k}",
        )
        found, cstart, examined = (int(x) for x in verdict)
        return bool(found), cstart, feas, r1, r0, examined, chunk

    # -- placement --------------------------------------------------------

    def _native_ok(self) -> bool:
        """Cached probe of the native host runtime.  Warns once when it
        does not build: every node then pays the device sweeps, which
        must never happen silently."""
        if self._native_probe is None:
            from .. import native

            self._native_probe = native.available()
            if not self._native_probe and self.opt.native:
                import warnings

                warnings.warn(
                    f"native host runtime unavailable ({native.build_error()}); "
                    "search nodes fall back to the device sweeps",
                    RuntimeWarning,
                )
        return self._native_probe

    def uses_native_step(self, st: State) -> bool:
        """True when this state's node head runs on the host
        (:meth:`_gate_step_native`, :meth:`_lut_step_native`,
        :meth:`_lut7_step_native`): the same verdict as the device
        sweeps, with no device work.  Every node does with
        ``Options.native``, as in the JAX package, whose size limit (512
        gates) lies above MAX_GATES."""
        return self.opt.native and self._native_ok()

    def node_host_only(self, st: State) -> bool:
        """True when a search node runs entirely on the host: gate mode,
        or a LUT node whose 5-LUT space is not pivot-sized."""
        if not self.uses_native_step(st):
            return False
        if not self.opt.lut_graph:
            return True
        g = st.num_gates
        return g < 5 or lut_head_has5(g)

    def uses_native_engine(self, st: State) -> bool:
        """True when the whole recursion from this node runs in a native
        engine.  Gate mode completes natively; the
        LUT engine hands its device-work nodes to the service of
        kwan._lut_engine_service and resumes in place — except while
        mux-concurrency threads are attached (``self.rdv``): a LUT node with
        device work then stays on the Python recursion, whose mux branches
        overlap their sweeps, as in the JAX package.  Verbose LUT runs
        stay on the Python recursion: the reference's find lines
        ("[   0] Found 5LUT: ...", lut.c:219-222) are printed by the
        Python decode paths the engine bypasses."""
        if self.opt.lut_graph and self.opt.verbosity >= 1:
            return False
        if not self.uses_native_step(st):
            return False
        if self.node_host_only(st):
            return True
        return self.opt.lut_graph and self.rdv is None

    def gate_engine_caller(self):
        if self._gate_engine_caller is None:
            from .. import native

            self._gate_engine_caller = native.GateEngineCaller(
                self.pair_table_np, self.pair_entries,
                self.not_table_np, self.not_entries,
                self.triple_table_np, self.triple_entries,
            )
        return self._gate_engine_caller

    def lut_engine_caller(self):
        if self._lut_engine_caller is None:
            from .. import native

            self._lut_engine_caller = native.LutEngineCaller(
                self.pair_table_np, self.pair_entries
            )
        return self._lut_engine_caller

    # -- node heads -------------------------------------------------------

    def _node_operands(self, st: State):
        """(tables, g, valid_g, combos, pair_valid) of a fused node head."""
        g = st.num_gates
        b = bucket_size(g)
        combos = self._pair_combos(b)
        return (
            self.device_tables(st), g,
            torch.arange(b, device=self.device) < g,
            combos, (combos < g).all(dim=1),
        )

    def _count_gate_step(self, g: int, has_triple: bool, v) -> Tuple[int, int, int]:
        step = int(v[0])
        if step == 0 or step >= 3:
            self.stats.inc("pair_candidates", g * (g - 1) // 2)
        if has_triple and step in (0, 5):
            self.stats.inc("triple_candidates", int(v[3]))
        return step, int(v[1]), int(v[2])

    def _gate_step_native(self, st: State, target, mask):
        """Host-native gate-mode node head (csrc sbg_gate_step): the
        device verdict without the device."""
        g = st.num_gates
        self.last_dispatch_gates = g
        has_not = bool(self.not_entries) and not self.opt.lut_graph
        has_triple = not self.opt.lut_graph and g >= 3
        total3 = comb.n_choose_k(g, 3) if has_triple else 0
        chunk3 = pick_chunk(max(total3, 1), STREAM_CHUNK[3])
        if self._gate_step_caller is None:
            from .. import native

            self._gate_step_caller = native.GateStepCaller(
                self.pair_table_np, self.not_table_np, self.triple_table_np
            )
        with self.prof.phase("gate_step_native"):
            v = self._gate_step_caller(
                np.ascontiguousarray(st.live_tables()), g, bucket_size(g),
                np.asarray(target), np.asarray(mask), has_not, has_triple,
                total3, chunk3, self.next_seed(),
            )
        return self._count_gate_step(g, has_triple, v)

    def gate_step(self, st: State, target, mask):
        """Steps 1-4 of one gate-mode search node for one seed
        (sweeps.gate_step_stream).  Returns (step, x0, x1); decode the
        payload with :meth:`decode_pair_hit` / :meth:`decode_triple_hit`.
        Routes to the host with :meth:`uses_native_step`."""
        if self.uses_native_step(st):
            return self._gate_step_native(st, target, mask)
        tables, g, valid_g, combos, pair_valid = self._node_operands(st)
        has_not = bool(self.not_entries) and not self.opt.lut_graph
        has_triple = not self.opt.lut_graph and g >= 3
        total3 = comb.n_choose_k(g, 3) if has_triple else 0
        chunk3 = pick_chunk(max(total3, 1), STREAM_CHUNK[3])
        args = (
            tables, valid_g, combos, pair_valid, self.binom, g,
            self.words(target), self.words(mask),
            torch.from_numpy(self.excl_array([])).to(self.device), total3,
            self.pair_table, self.not_table if has_not else self.pair_table,
            self.triple_table, self.next_seed(),
        )
        with self.prof.phase("gate_step"):
            v = self._dispatch("gate_step_stream", dict(
                chunk3=chunk3, has_not=has_not, has_triple=has_triple,
            ), args, g=g)
        return self._count_gate_step(g, has_triple, v)

    def _lut_head_sizes(self, g: int):
        total3 = comb.n_choose_k(g, 3)
        total5 = comb.n_choose_k(g, 5)
        has5 = lut_head_has5(g)
        chunk3 = pick_chunk(max(total3, 1), STREAM_CHUNK[3])
        chunk5 = pick_chunk(max(total5, 1), STREAM_CHUNK[5]) if has5 else 1024
        return total3, total5, has5, chunk3, chunk5

    def _count_lut_step(self, g: int, v) -> np.ndarray:
        step = int(v[0])
        if step == 0 or step >= 3:
            self.stats.inc("pair_candidates", g * (g - 1) // 2)
        self.stats.inc("lut3_candidates", int(v[6]))
        self.stats.inc("lut5_candidates", int(v[7]))
        return v

    def _lut_step_native(self, st: State, target, mask, inbits) -> np.ndarray:
        """Host-native LUT head (csrc sbg_lut_step): the device verdict
        without the device.  Pivot-sized 5-LUT sweeps and overflow
        re-drives still go to the device (lut_search_from_head)."""
        from .. import native

        g = st.num_gates
        self.last_dispatch_gates = g
        total3, total5, has5, chunk3, chunk5 = self._lut_head_sizes(g)
        _, w_tab, m_tab = sweeps.lut5_split_tables()
        with self.prof.phase("lut_step_native"):
            v = native.lut_step(
                np.ascontiguousarray(st.live_tables()), g, bucket_size(g),
                np.asarray(target), np.asarray(mask), self.pair_table_np,
                self.excl_array(inbits), total3, chunk3, has5, total5, chunk5,
                LUT5_HEAD_SOLVE_ROWS, w_tab, m_tab, self.next_seed(),
            )
        return self._count_lut_step(g, v)

    def lut_step(self, st: State, target, mask, inbits) -> np.ndarray:
        """Steps 1-3 plus the whole 3-LUT and (small-space) 5-LUT sweeps of
        one LUT-mode search node, for one seed (sweeps.lut_step_stream).
        Returns the int32[8] verdict.  Routes to the host with
        :meth:`uses_native_step`."""
        if self.uses_native_step(st):
            return self._lut_step_native(st, target, mask, inbits)
        tables, g, valid_g, combos, pair_valid = self._node_operands(st)
        total3, total5, has5, chunk3, chunk5 = self._lut_head_sizes(g)
        jw, jm = self.lut5_tabs()
        args = (
            tables, valid_g, combos, pair_valid, self.binom, g,
            self.words(target), self.words(mask),
            torch.from_numpy(self.excl_array(inbits)).to(self.device),
            total3, total5, self.pair_table, jw, jm, self.next_seed(),
        )
        with self.prof.phase("lut_step"):
            v = self._dispatch("lut_step_stream", dict(
                chunk3=chunk3, chunk5=chunk5, has5=has5,
                solve_rows=LUT5_HEAD_SOLVE_ROWS,
            ), args, g=g)
        return self._count_lut_step(g, v)

    def _lut7_step_native(self, st: State, target, mask, inbits) -> np.ndarray:
        """7-LUT step with stage A on the host (csrc sbg_lut7_stage_a, the
        device stream's feasibility and top-k order) and stage B on the
        host (csrc sbg_lut7_solve_small; stage A returns at most solve7 =
        LUT7_HEAD_SOLVE_ROWS rows, the host solver's cap).  Builds the
        int32[14] verdict of sweeps.lut7_step_stream."""
        from .. import native

        g = st.num_gates
        self.last_dispatch_gates = g
        total7 = comb.n_choose_k(g, 7)
        chunk7 = pick_chunk(max(total7, 1), STREAM_CHUNK[7])
        solve7 = LUT7_HEAD_SOLVE_ROWS
        seed = self.next_seed()
        with self.prof.phase("lut7_stage_a_native"):
            nfeas, ranks, r1, r0 = native.lut7_stage_a(
                np.ascontiguousarray(st.live_tables()), g, np.asarray(target),
                np.asarray(mask), self.excl_array(inbits), total7, chunk7,
                solve7, seed,
            )
        v = np.zeros(14, dtype=np.int32)
        v[4] = min(total7, chunk7)
        if nfeas:
            take = ranks.shape[0]
            sr1 = np.full((solve7, 4), 0xFFFFFFFF, dtype=np.uint32)
            sr0 = np.full((solve7, 4), 0xFFFFFFFF, dtype=np.uint32)
            sr1[:take] = r1
            sr0[:take] = r0
            idx_tab, _ = sweeps.lut7_pair_tables()
            with self.prof.phase("lut7_solve_native"):
                sol = native.lut7_solve_small(
                    r1, r0, solve7, idx_tab, seed ^ 0x77A1
                )
            found, best_t, sigma, flat = (int(x) for x in sol)
            overflow = nfeas > solve7 and not found
            v[0] = 1 if found else (2 if overflow else 0)
            v[1] = int(ranks[best_t]) if best_t < take else 0
            v[2] = sigma
            v[3] = flat
            v[5] = min(nfeas, solve7)
            v[6:10] = sr1[best_t].view(np.int32)
            v[10:14] = sr0[best_t].view(np.int32)
        self.stats.inc("lut7_candidates", int(v[4]))
        self.stats.inc("lut7_solved", int(v[5]))
        return v

    def lut7_step(self, st: State, target, mask, inbits) -> np.ndarray:
        """Whole single-chunk 7-LUT search for one seed
        (sweeps.lut7_step_stream); only valid when ``lut_head_has7(g)``.
        Returns the int32[14] verdict.  Routes stage A to the host with
        :meth:`uses_native_step`."""
        if self.uses_native_step(st):
            return self._lut7_step_native(st, target, mask, inbits)
        g = st.num_gates
        total7 = comb.n_choose_k(g, 7)
        chunk7 = pick_chunk(max(total7, 1), STREAM_CHUNK[7])
        jidx, jpp = self.lut7_tabs()
        args = (
            self.device_tables(st), self.binom, g, self.words(target),
            self.words(mask),
            torch.from_numpy(self.excl_array(inbits)).to(self.device),
            total7, jidx, jpp, self.next_seed(),
        )
        with self.prof.phase("lut7_step"):
            v = self._dispatch("lut7_step_stream", dict(
                chunk7=chunk7, solve7=LUT7_HEAD_SOLVE_ROWS,
            ), args, g=g)
        self.stats.inc("lut7_candidates", int(v[4]))
        self.stats.inc("lut7_solved", int(v[5]))
        return v

    def decode_pair_hit(self, st: State, index: int, slot: int, use_not: bool = False):
        """(gid1, gid2, entry) for a fused-head pair hit (``use_not``: a
        hit of the NOT-augmented table, step 4)."""
        entries = self.not_entries if use_not else self.pair_entries
        pair = self._pair_combos_np(bucket_size(st.num_gates))[index]
        entry = entries[slot]
        gids = [int(pair[p]) for p in entry.perm]
        return gids[0], gids[1], entry

    def decode_triple_hit(self, st: State, rank: int, slot: int):
        """(gids, entry) for a fused-head triple hit."""
        row = comb.unrank_combination(rank, st.num_gates, 3)
        entry = self.triple_entries[slot]
        return [int(row[p]) for p in entry.perm], entry
