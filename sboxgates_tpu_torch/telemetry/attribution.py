"""Performance attribution: the analytic cost of each launch of the
hand-written kernels K1-K5, their measured launch times, and the roofline
rows that join the two per ``(kernel, bucket)``.

The JAX package reads XLA's ``cost_analysis()`` off a compiled executable;
the port's kernels are written by hand, so their costs are counted from
their shapes here, once, and ``chip_smoke.py`` imports the same functions:

- :func:`window_cost` — K1 (``pivot_window``) and K2 (``pivot_pre_window``)
  over a window of pivot tiles;
- :func:`filter_cost` — K3 (``lut5_filter_cells``);
- :func:`walsh_cost` — K5 (``gate_scores_kernel``);
- :func:`circuit_cost` — K4 (the circuit kernel of ``compile_cuda``);
- :func:`bound` — the least time the card could take for one of them.

A bucket is the launch's shape, written as a label: ``"{tiles}x{tl}x{th}"``
for a window, ``"{candidates}x{table rows}"`` for K3, ``"{gates}"`` for
K5 and ``"{inputs}x{outputs}x{instructions}x{words}"`` for K4, so every
launch in one row has the same cost.

:func:`launch` times one launch inside a kernel wrapper.  It records only
while a :class:`LaunchTimer` is bound to the calling thread
(:func:`recording`, which ``SearchContext.dispatch`` opens around each
sweep call); elsewhere (the comparisons of the tests and ``chip_smoke``)
it does nothing.  On a CUDA tensor it hands the wrapper a pooled pair of
timing events, which the kernel's C entry point records on the launch's
stream immediately around its ``<<<>>>`` launch (csrc/launch_timing.cuh),
so the pair spans the kernel and the stream's start-up latency but not
the host's path into the entry point; the pair is left pending, and
:meth:`LaunchTimer.settle`
reads every pair whose end event has completed (``Event.query()``, which
never waits) into ``dispatch_latency_s[<kernel>/<bucket>]``, and the
search calls it only after the sync it already makes for those launches.
:meth:`LaunchTimer.drain` reads the launches never synced (a window swept
past a hit) at teardown by polling, again without a wait.  On the CPU the
time is the host wall time of the plain version.  A launch made on a
thread the dispatch deadline has abandoned records nothing once the
abandonment is decided (the ``gate`` of :func:`recording`).

:func:`table` joins the costs with the histograms into roofline rows
against :data:`PEAKS`; ``metrics.json`` carries them as its
``attribution`` section and ``/status`` serves them live.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, List, Optional, Tuple

#: Peak rates the rows are drawn against.  ``gpu``: NVIDIA H100 SXM
#: data-sheet peaks — HBM3 at 3.35 TB/s; 32-bit integer logic (LOP3) at 64
#: results per SM per clock on compute capability 9.0 (CUDA C++
#: Programming Guide, arithmetic instruction throughput) over 132 SMs at
#: the 1.98 GHz boost clock; int8 tensor-core operations at 1,979 T/s
#: (dense) — and one measured rate: NVIDIA publishes no 1-bit tensor-core
#: rate for Hopper, so ``b1_tc_ops_per_s`` is the tensor-core probe's
#: reading (``csrc/tc_probe.cu``, run by ``chip_smoke.py``: wgmma
#: m64n128k256 .b1 AND + POPC, the fastest 1-bit form it times, counted as
#: 2 M N K operations) on an "NVIDIA H100 80GB HBM3" at a 700.00 W power
#: limit.  ``cpu``: a round envelope for the CPU plain versions, which
#: tests run; not a tuning target.
PEAKS: Dict[str, Dict[str, float]] = {
    "gpu": {
        "bytes_per_s": 3.35e12,
        "int32_ops_per_s": 64 * 132 * 1.98e9,
        "int8_tc_ops_per_s": 1.979e15,
        "b1_tc_ops_per_s": 1.5187e16,
    },
    "cpu": {
        "bytes_per_s": 5.0e10,
        "int32_ops_per_s": 1.0e11,
        "int8_tc_ops_per_s": 1.0e11,
    },
}

#: What a row's launch times measure, by backend: its utilization is that
#: of the time so measured, not of the kernel alone.
TIMING = {
    "gpu": "CUDA events recorded around the launch in the kernel's entry "
           "point: the kernel plus the stream's start-up latency",
    "cpu": "host wall time of the plain version",
}

#: SMs of the H100 SXM: K5's grid size when no card is at hand.
H100_SMS = 132

#: A row whose mean launch time exceeds its bound by this factor is
#: ``dispatch-bound``: launch overhead, not the card's work, sets it.
DISPATCH_BOUND_FACTOR = 10.0

_LOCK = threading.Lock()
#: (kernel, bucket) -> cost record.
_COSTS: Dict[Tuple[str, Optional[str]], dict] = {}
_BACKEND: Optional[str] = None


# -- analytic costs -------------------------------------------------------


def window_cost(n: int, tl: int, th: int, backend: str) -> dict:
    """Bytes and operations of a window of ``n`` pivot tiles.  Bytes: per
    tile its descriptor, pivot table, low rows (2 x 4 cells) and high rows
    (4 cells), as 32 B of words on the packed backend and 256 B of int8
    lanes on pre, and validity bytes in; 9 B per candidate and a count out.
    Operations, one per formulation of the same function: K1's 576 AND-OR
    and pack steps and 4 of the fused epilogue per candidate on the integer
    pipe (``ops``), and the TPU's two GEMMs per tile, 2 x 2 x (8 tl) x
    (4 th) x 256, on the tensor cores (``tc_ops``: int8 multiply-adds over
    0/1 lanes, or as many 1-bit AND + POPC ones over the packed words)."""
    cand = tl * th
    row = 32 if backend == "packed" else 256
    per_tile_in = 20 + 32 + tl * 2 * 4 * row + th * 4 * row + tl + th
    return {"bytes": n * (per_tile_in + 9 * cand + 4),
            "ops": n * cand * (576 + 4),
            "tc_ops": n * 2 * 2 * (8 * tl) * (4 * th) * 256}


def filter_cost(n: int, b: int) -> dict:
    """Bytes and 32-bit operations of K3 over ``n`` 5-tuples of a ``b``-row
    table: the tuples, the table, target and mask in, two words per tuple
    out; per tuple, for each of the 8 words, 62 operations of the cell
    recurrence and 64 of the two requirement tests, and 64 of the pack."""
    return {"bytes": n * 5 * 4 + b * 8 * 4 + 2 * 8 * 4 + 2 * n * 4,
            "ops": n * ((62 + 64) * 8 + 64)}


WALSH_THREADS = 512     # csrc/walsh_score.cu: threads per block


def lanes_cost(cost: dict, lanes: int) -> dict:
    """The cost of a lane form: ``lanes`` times the single-lane ``cost``
    (every lane reads its own operands and writes its own outputs)."""
    return {k: lanes * v for k, v in cost.items()}


def window_lanes_cost(swept: int, slots: int, tl: int, th: int) -> dict:
    """The cost of a K1 lane-form launch of ``slots`` tile slots (lanes x
    window) of which the lanes sweep ``swept``: the swept tiles'
    :func:`window_cost`, and the all-ones words, empty flags and zero count
    each inert slot writes."""
    cost = window_cost(swept, tl, th, "packed")
    cost["bytes"] += (slots - swept) * (9 * tl * th + 4)
    return cost


def walsh_cost(b: int, sms: int) -> dict:
    """Bytes and 32-bit integer operations of K5 over ``b`` gates, as the
    kernel computes the function (one transform of the spectrum per block,
    then a byte-table sum per gate): 32 B of table in and 4 B of score out
    per gate plus the 1 KB spectrum; per block the 8 x 256 adds of
    WHT(spectrum) and 8,192 for its byte table (a lookup table of 32 x 256
    sums), per gate 32 lookups and 32 adds.  The grid has at most two
    blocks per SM (``sms`` of them)."""
    blocks = min((b + WALSH_THREADS - 1) // WALSH_THREADS, 2 * sms)
    return {"bytes": b * (32 + 4) + 256 * 4,
            "ops": blocks * (8 * 256 + 8192) + b * 64}


def circuit_cost(n_in: int, n_out: int, n_prog: int, w: int) -> dict:
    """Bytes and operations of K4 over ``w`` words: each input and output
    word once plus the 16 B-per-instruction program, and one 32-bit logic
    operation (a LOP3) per instruction (a gate an output needs) and
    word."""
    return {"bytes": 4 * (n_in + n_out) * w + 16 * n_prog,
            "ops": n_prog * w}


def bound(cost: dict, pk: Optional[Dict[str, float]] = None):
    """(bound_ms, bound_by, formulation) of one launch's ``cost``: the
    least time the card could take, the larger of its bytes over the memory
    rate and its operations over their peak rate.  Where the same function
    has several formulations (the pivot tile: 32-bit logic on the integer
    pipe, or its GEMMs on the tensor cores, ``tc_ops``, in int8 and, where
    ``pk`` has a ``b1_tc_ops_per_s``, in 1-bit AND + POPC), each is taken
    with the bytes and the smallest bound is the launch's.  ``pk``
    defaults to the H100 peaks."""
    pk = pk or PEAKS["gpu"]
    t_bytes = cost["bytes"] / pk["bytes_per_s"] * 1e3
    forms = [(cost["ops"] / pk["int32_ops_per_s"] * 1e3, "integer pipe")]
    if "tc_ops" in cost:
        forms.append((cost["tc_ops"] / pk["int8_tc_ops_per_s"] * 1e3,
                      "int8 tensor cores"))
        if "b1_tc_ops_per_s" in pk:
            forms.append((cost["tc_ops"] / pk["b1_tc_ops_per_s"] * 1e3,
                          "1-bit tensor cores"))
    t_ops, form = min(forms)
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations",
            form)


# -- backend and cost store -----------------------------------------------


def note_backend(name: Optional[str]) -> None:
    """Pins the backend the peaks are read for: ``"cuda"`` or ``"gpu"``
    draws against the H100 row (``SearchContext`` calls this with its
    device type)."""
    global _BACKEND
    if name:
        b = str(name).lower()
        _BACKEND = "gpu" if b in ("cuda", "gpu") else b


def backend() -> str:
    """The pinned backend, else ``cpu``."""
    return _BACKEND or "cpu"


def peaks(name: Optional[str] = None) -> Dict[str, float]:
    b = (name or backend()).lower()
    row = PEAKS.get(b, PEAKS["cpu"])
    return dict(row, backend=b)  # type: ignore[arg-type]


def have(kernel: str, bucket: Optional[str]) -> bool:
    return (kernel, bucket) in _COSTS


def capture(
    kernel: str, cost: dict, args=(), bucket: Optional[str] = None,
    source: str = "analytic",
) -> bool:
    """Records the analytic ``cost`` (``bytes``, ``ops``, optionally
    ``tc_ops``) of one launch under ``(kernel, bucket)``.  Never raises;
    returns False for a cost with no work.  ``args`` is unused: the JAX
    package's signature, where the bucket came from the operands."""
    del args
    try:
        nbytes = float(cost.get("bytes", 0) or 0)
        ops = float(cost.get("ops", 0) or 0)
        if nbytes <= 0 and ops <= 0:
            return False
        rec = {"kernel": kernel, "bucket": bucket, "bytes": nbytes,
               "ops": ops, "source": source}
        if cost.get("tc_ops"):
            rec["tc_ops"] = float(cost["tc_ops"])
        with _LOCK:
            prev = _COSTS.get((kernel, bucket))
            rec["captures"] = (prev["captures"] + 1) if prev else 1
            _COSTS[(kernel, bucket)] = rec
        return True
    except (TypeError, ValueError, AttributeError):
        return False


def annotation(kernel: str, bucket: Optional[str]) -> Optional[dict]:
    """Cost args of one launch for a trace span: one dict lookup."""
    rec = _COSTS.get((kernel, bucket))
    if rec is None:
        return None
    out = {"ops": rec["ops"], "bytes": rec["bytes"]}
    if "tc_ops" in rec:
        out["tc_ops"] = rec["tc_ops"]
    return out


def _row(rec: dict, lat: Optional[dict], pk: Dict[str, float]) -> dict:
    bound_ms, bound_by, form = bound(rec, pk)
    row = dict(rec)
    row["bound_s"] = bound_ms / 1e3
    row["bound_by"] = bound_by
    row["bound_formulation"] = form
    row["dispatches"] = int(lat["count"]) if lat else 0
    if lat and lat["count"]:
        mean = lat["total"] / lat["count"]
        row["mean_dispatch_latency_s"] = mean
        row["p99_dispatch_latency_s"] = lat.get("p99")
        if mean > 0:
            row["achieved_ops_per_s"] = rec["ops"] / mean
            row["achieved_bytes_per_s"] = rec["bytes"] / mean
            if mean > DISPATCH_BOUND_FACTOR * row["bound_s"]:
                row["roofline"] = "dispatch-bound"
            elif bound_by == "operations":
                row["roofline"] = "compute-bound"
            else:
                row["roofline"] = "memory-bound"
            row["roofline_utilization"] = row["bound_s"] / mean
    return row


def table(registry=None) -> List[dict]:
    """The joined rows, sorted by (kernel, bucket).  ``registry`` is a
    ``MetricsRegistry`` (anything with ``histograms()``); None gives
    cost-only rows."""
    hists = registry.histograms() if registry is not None else {}
    pk = peaks()
    with _LOCK:
        recs = [dict(v) for v in _COSTS.values()]
    rows = [
        _row(rec, hists.get(f"dispatch_latency_s[{rec['kernel']}/{rec['bucket']}]"),
             pk)
        for rec in recs
    ]
    rows.sort(key=lambda r: (r["kernel"], str(r["bucket"])))
    return rows


def snapshot(registry=None) -> dict:
    """The ``attribution`` section of ``metrics.json`` and ``/status``."""
    return {
        "backend": backend(),
        "timing": TIMING.get(backend(), TIMING["cpu"]),
        "peaks": peaks(),
        "dispatch_bound_factor": DISPATCH_BOUND_FACTOR,
        "rows": table(registry),
    }


def reset() -> None:
    """Drops every cost record and the pinned backend (``SearchContext``
    calls this at the start of each run)."""
    global _BACKEND
    with _LOCK:
        _COSTS.clear()
    _BACKEND = None


# -- per-launch timing ----------------------------------------------------


class LaunchTimer:
    """Pending launch timings of one registry: pooled CUDA event pairs
    (by device: an event records only on a stream of its own card) and
    the launches still waiting for their end event.  Thread-safe."""

    #: Most pending launches kept; older ones are dropped unread (a run
    #: that never settles must not grow without bound).
    MAX_PENDING = 4096

    def __init__(self, registry):
        self.registry = registry
        self._lock = threading.Lock()
        self._pending: List[tuple] = []
        self._pool: Dict[object, List[tuple]] = {}

    def _take_pair(self, stream):
        """(start, end, device) events for a launch on ``stream``."""
        with self._lock:
            pool = self._pool.get(stream.device)
            if pool:
                return pool.pop()
        import torch

        pair = (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True), stream.device)
        # torch creates an event's CUDA handle at its first record; the
        # kernel's entry point records the handle itself from then on.
        for ev in pair[:2]:
            ev.record(stream)
        return pair

    def _add_pending(self, key: str, pair, gate) -> None:
        with self._lock:
            self._pending.append((key, pair, gate))
            if len(self._pending) > self.MAX_PENDING:
                del self._pending[0]

    def observe(self, key: str, seconds: float, gate=None) -> None:
        """Records one launch time unless ``gate`` was abandoned."""
        if gate is not None:
            with gate.lock:
                if gate.abandoned:
                    return
                self.registry.observe(key, seconds)
            return
        self.registry.observe(key, seconds)

    def settle(self) -> int:
        """Reads every pending launch whose end event has completed (a
        query, never a wait); returns how many stay pending."""
        with self._lock:
            pending, self._pending = self._pending, []
        done, keep = [], []
        for item in pending:
            (done if item[1][1].query() else keep).append(item)
        with self._lock:
            self._pending = keep + self._pending
        for key, pair, gate in done:
            self.observe(key, pair[0].elapsed_time(pair[1]) / 1e3, gate)
            with self._lock:
                self._pool.setdefault(pair[2], []).append(pair)
        return len(keep)

    def drain(self, timeout_s: float = 5.0) -> int:
        """Teardown: settles until nothing is pending, polling (never
        waiting on the device) for at most ``timeout_s``; launches still
        pending then (a hung kernel) are dropped.  Returns how many were
        dropped."""
        t_end = time.monotonic() + timeout_s
        left = self.settle()
        while left and time.monotonic() < t_end:
            time.sleep(0.001)
            left = self.settle()
        with self._lock:
            self._pending.clear()
        return left


_TLS = threading.local()


@contextlib.contextmanager
def recording(timer: Optional[LaunchTimer], gate=None):
    """Binds ``timer`` to this thread while the block runs: the launches of
    K1-K5 inside it are timed into its registry (``gate``: an object with
    ``lock`` and ``abandoned``, the dispatch deadline's attempt).  Yields
    the list of (kernel, bucket) launched in the block."""
    prev = getattr(_TLS, "binding", None)
    launched: list = []
    _TLS.binding = None if timer is None else (timer, gate, launched)
    try:
        yield launched
    finally:
        _TLS.binding = prev


#: The timing events of a launch that is not timed (null handles).
NO_EVENTS = (None, None)


@contextlib.contextmanager
def launch(kernel: str, bucket: str, cost, like):
    """Times the one kernel launch (or plain-version call) in the block;
    ``cost`` is a zero-argument function giving its analytic cost, read on
    the first launch of each bucket, and ``like`` a tensor on the launch's
    device.  Yields the (start, end) CUDA event handles the block passes
    to the kernel's entry point, which records them around its launch
    (:data:`NO_EVENTS` when nothing is timed).  A launch whose block
    raises is not recorded.  A no-op unless :func:`recording` bound a
    timer here."""
    b = getattr(_TLS, "binding", None)
    if b is None:
        yield NO_EVENTS
        return
    timer, gate, launched = b
    if not have(kernel, bucket):
        capture(kernel, cost(), bucket=bucket)
    launched.append((kernel, bucket))
    key = f"dispatch_latency_s[{kernel}/{bucket}]"
    if not like.is_cuda:
        t0 = time.perf_counter()
        yield NO_EVENTS
        timer.observe(key, time.perf_counter() - t0, gate)
        return
    import torch

    stream = torch.cuda.current_stream(like.device)
    if gate is None:
        pair = timer._take_pair(stream)
    else:
        # The check and the pool's use under the attempt's lock: once the
        # deadline has abandoned the attempt, it takes no event pair.
        with gate.lock:
            pair = None if gate.abandoned else timer._take_pair(stream)
    if pair is None:
        yield NO_EVENTS
        return
    yield (pair[0].cuda_event, pair[1].cuda_event)
    timer._add_pending(key, pair, gate)
