"""ctypes binding of the native host runtime (``csrc/runtime.cpp``).

The repo's C++ runtime belongs to neither Python package: this module
builds it with the host's C++ compiler (``$CXX``, else ``g++``) into
``build/torch_native/libsbgt_runtime.so`` under the checkout root at first
use, keyed on a digest of the source and the flags, under an exclusive
file lock on the build directory (concurrent processes compile once),
through a temporary name moved into place atomically (no process loads a
half-written library).  Nothing is built at import time.

Exposed surface (the C ABI's):

- :func:`gate_step` / :class:`GateStepCaller` — one gate-mode node head
  (steps 1-4), the verdict of ``sweeps.gate_step_stream``;
- :func:`lut_step` — the LUT-mode head (steps 1-3, 3-LUT, small-space
  5-LUT), the verdict of ``sweeps.lut_step_stream``;
- :func:`lut7_stage_a` / :func:`lut7_solve_small` — the single-chunk
  7-LUT step's stage A and a small stage-B solve;
- :class:`GateEngineCaller` / :class:`LutEngineCaller` — the whole
  ``create_circuit`` recursion in C++; the LUT engine hands nodes that need
  device work to a Python service through :data:`ENG_DEVCB`
  (:func:`make_eng_devcb`) and resumes in place;
- :func:`execute_circuit` — the bitslice interpreter of a gate program;
- :func:`combinations_from_rank` — consecutive lexicographic
  k-combinations from a rank (the host chunk stream's generator).

Truth tables cross as ``uint64[..., 4]`` (:func:`tables32_to_64`): the same
bytes as the host's ``uint32[..., 8]`` rows on a little-endian host.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import platform
import shutil
import subprocess
import sys
import tempfile
import threading
from typing import Optional, Tuple

import numpy as np

from .._buildlock import build_lock

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(_PKG)
SRC_PATH = os.path.join(ROOT, "csrc", "runtime.cpp")
BUILD_DIR = os.path.join(ROOT, "build", "torch_native")
LIB_NAME = "libsbgt_runtime.so"
CXX_FLAGS = ["-O3", "-march=native", "-std=c++17", "-pthread", "-shared", "-fPIC"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_error: Optional[str] = None

#: Builds that compiled in this process (``utils.guards.recompile_guard``).
compiles = 0


_logger = logging.getLogger(__name__)

# Process-wide tally of device-work-service failures behind engine bails.
# The visibility line is a rate-limited stderr print keyed off this locked
# counter (a warning would be shown once per process by the default filter,
# hiding repeated degradations), as in the JAX package.
_SERVICE_FAILURES = 0
_SERVICE_FAIL_LOCK = threading.Lock()
_SERVICE_FAIL_PRINT_FIRST = 5
_SERVICE_FAIL_PRINT_EVERY = 100


class NativeUnavailable(RuntimeError):
    """The native runtime could not be built or loaded."""


def service_failure_count() -> int:
    """How many native-engine calls bailed in this process because their
    device-work service raised."""
    return _SERVICE_FAILURES


def _note_service_failure(exc: BaseException) -> None:
    global _SERVICE_FAILURES
    with _SERVICE_FAIL_LOCK:
        _SERVICE_FAILURES += 1
        n = _SERVICE_FAILURES
    # Structured telemetry beside the stderr line: a process-global counter
    # (heartbeat lines and metrics.json carry it under "process") and a
    # trace and flight-ring instant.
    from ..telemetry import metrics as _tmetrics
    from ..telemetry import trace as _ttrace

    _tmetrics.GLOBAL.inc("native_service_failures")
    _ttrace.instant(
        "native.service_failure", "fallback", error=repr(exc)[:200], n=n
    )
    if n <= _SERVICE_FAIL_PRINT_FIRST or n % _SERVICE_FAIL_PRINT_EVERY == 0:
        print(
            f"sboxgates_tpu_torch: device-work service failed inside the "
            f"native engine ({exc!r}); the search fell back to the Python "
            f"engine [failure #{n} this process]",
            file=sys.stderr,
            flush=True,
        )


# Device-work continuation callback of the LUT engine (the C side's
# sbg_eng_devcb): (handle, kind, tables*, g, target*, mask*, inbits*,
# n_inbits, arg0, rng, slot, resp*) -> rc.  csrc/runtime.cpp documents the
# kinds and the resp layout.
ENG_DEVCB = ctypes.CFUNCTYPE(
    ctypes.c_int32,
    ctypes.c_void_p,  # handle
    ctypes.c_int32,   # kind
    ctypes.c_void_p,  # tables (uint64[g, 4])
    ctypes.c_int32,   # g
    ctypes.c_void_p,  # target (uint64[4])
    ctypes.c_void_p,  # mask
    ctypes.c_void_p,  # inbits (int32[n_inbits])
    ctypes.c_int32,   # n_inbits
    ctypes.c_int64,   # arg0 (kind 2: overflow chunk start rank)
    ctypes.c_uint64,  # rng (engine-stream draw; reserved)
    ctypes.c_int32,   # slot (branch id; reserved)
    ctypes.c_void_p,  # resp (int32[12] out)
)


def _as_i32(ptr, n):
    return np.ctypeslib.as_array(
        ctypes.cast(ptr, ctypes.POINTER(ctypes.c_int32)), shape=(n,)
    )


def _as_u32(ptr, shape):
    return np.ctypeslib.as_array(
        ctypes.cast(ptr, ctypes.POINTER(ctypes.c_uint32)), shape=shape
    )


def make_eng_devcb(service):
    """Wraps a device-work service into the C callback ABI; returns
    ``(callback, pending)``.

    ``service(kind, tables, g, target, mask, inbits, arg0, rng, slot)``
    gets COPIES of the engine's live tables (uint32[g, 8]), target and
    mask, and returns None on a miss or the flat hit tuple written to
    resp[1:] ([fo, fi, a..e] for a 5-LUT, [fo, fm, fi, a..g] for a 7-LUT).
    An exception must not unwind across the C frame.  An ``Exception`` is a
    failed service: it is kept in ``pending["service_exc"]``, the callback
    reports failure, the engine bails, and :class:`LutEngineCaller` returns
    its ``BAILED`` result (the caller reruns the node on the Python engine,
    as the JAX package does).  A ``BaseException`` (KeyboardInterrupt,
    SystemExit) also makes the engine unwind, and is raised again once the
    engine call returns."""
    pending = {"exc": None, "service_exc": None}

    def cb(
        handle, kind, tables_p, g, target_p, mask_p, inbits_p, n_inbits,
        arg0, rng, slot, resp_p,
    ):
        try:
            tables = _as_u32(tables_p, (g, 8)).copy()
            target = _as_u32(target_p, (8,)).copy()
            mask = _as_u32(mask_p, (8,)).copy()
            inbits = (
                [int(x) for x in _as_i32(inbits_p, n_inbits)] if n_inbits else []
            )
            out = service(
                kind, tables, g, target, mask, inbits, int(arg0), int(rng),
                int(slot),
            )
            resp = _as_i32(resp_p, 12)
            if out is None:
                resp[0] = 0
            else:
                resp[0] = 1
                resp[1 : 1 + len(out)] = np.asarray(out, dtype=np.int64)
            return 0
        # torchlint: ignore[R5] not swallowed: the exception is handed to the engine's caller (pending['service_exc']), which re-raises it once the native engine has unwound; a C callback cannot raise
        except Exception as e:  # the engine bails; its caller reports it
            pending["service_exc"] = e
            _logger.debug(
                "device-work service failed inside the native LUT engine",
                exc_info=True,
            )
            return 1
        except BaseException as e:  # re-raised by the engine's caller
            pending["exc"] = e
            return 1

    return ENG_DEVCB(cb), pending


def _cpu_model() -> str:
    """The host CPU's model line: ``-march=native`` code built on one CPU
    may not run on another, so a copied build directory rebuilds."""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    return line.strip()
    except OSError:
        pass
    return platform.processor()


def _digest() -> str:
    h = hashlib.sha256()
    with open(SRC_PATH, "rb") as f:
        h.update(f.read())
    h.update(" ".join([_cxx()] + CXX_FLAGS).encode())
    h.update(platform.machine().encode())
    h.update(_cpu_model().encode())
    return h.hexdigest()[:16]


def _cxx() -> str:
    return os.environ.get("CXX", "g++")


def lib_path() -> str:
    return os.path.join(BUILD_DIR, LIB_NAME)


def build() -> str:
    """Compiles ``csrc/runtime.cpp`` (unless an up-to-date library exists)
    and returns the library path; raises NativeUnavailable with the
    compiler's output on failure.  Holds the build directory's lock
    (``_buildlock.build_lock``) throughout."""
    if not os.path.exists(SRC_PATH):
        raise NativeUnavailable(f"source not found: {SRC_PATH}")
    os.makedirs(BUILD_DIR, exist_ok=True)
    with build_lock(BUILD_DIR):
        return _build_locked()


def _build_locked() -> str:
    out = lib_path()
    stamp = out + ".digest"
    digest = _digest()
    if os.path.exists(out) and os.path.exists(stamp):
        with open(stamp) as f:
            if f.read().strip() == digest:
                return out
    tmp = tempfile.mkdtemp(prefix="build-", dir=BUILD_DIR)
    try:
        tmp_lib = os.path.join(tmp, LIB_NAME)
        try:
            proc = subprocess.run(
                [_cxx(), *CXX_FLAGS, "-o", tmp_lib, SRC_PATH],
                capture_output=True, text=True, timeout=300,
            )
        except (OSError, subprocess.TimeoutExpired) as e:
            raise NativeUnavailable(f"compiler launch failed: {e}") from e
        if proc.returncode != 0:
            raise NativeUnavailable(f"compile failed: {proc.stderr[-2000:]}")
        os.replace(tmp_lib, out)
        with open(os.path.join(tmp, "digest"), "w") as f:
            f.write(digest)
        os.replace(os.path.join(tmp, "digest"), stamp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    global compiles
    compiles += 1
    return out


_V = ctypes.c_void_p
_I32 = ctypes.c_int32
_I64 = ctypes.c_int64
_U64 = ctypes.c_uint64

#: (argtypes, restype) of the bound entry points.
_SIGNATURES = {
    "sbg_execute_circuit": ([_I32, _V, _V, _V, _V, _V, _V, _V], _I32),
    # tables, g, bucket, target, mask, pair_mt, not_mt, triple_mt, total3,
    # chunk3, seed, out
    "sbg_gate_step": ([_V, _I32, _I32, _V, _V, _V, _V, _V, _I64, _I32, _I32, _V],
                      None),
    # tables, g, bucket, target, mask, pair_mt, excl, n_excl, total3, chunk3,
    # has5, total5, chunk5, solve_rows, w_tab, m_tab, seed, out
    "sbg_lut_step": ([_V, _I32, _I32, _V, _V, _V, _V, _I32, _I64, _I32, _I32,
                      _I64, _I32, _I32, _V, _V, _I32, _V], None),
    # tables, g, target, mask, excl, n_excl, total7, chunk7, solve7, seed,
    # nfeas, ranks, req1, req0
    "sbg_lut7_stage_a": ([_V, _I32, _V, _V, _V, _I32, _I64, _I32, _I32, _I32,
                          _V, _V, _V, _V], _I64),
    # g, k, rank, count, out
    "sbg_combinations_from_rank": ([_I32, _I32, _U64, _I64, _V], _I64),
    # req1, req0, n, solve7, idx_tab, n_idx, seed, out
    "sbg_lut7_solve_small": ([_V, _V, _I32, _I32, _V, _I32, _I32, _V], None),
    # tables, g, num_inputs, max_gates, sat_metric, max_sat_metric, metric,
    # target, mask, pair_mt, pair_ops, not_mt, not_ops, triple_mt, tri_ops,
    # inbits, n_inbits, randomize, rng_seed, out_gid, added, stats
    "sbg_gate_engine": ([_V, _I32, _I32, _I32, _I64, _I64, _I32, _V, _V, _V, _V,
                         _V, _V, _V, _V, _V, _I32, _I32, _U64, _V, _V, _V], _I64),
    # tables, g, num_inputs, max_gates, sat_metric, max_sat_metric, metric,
    # target, mask, pair_mt, pair_ops, w_tab, m_tab, idx_tab, orders, wo_tab,
    # wm_tab, g_tab, n_sigma, inbits, n_inbits, randomize, rng_seed,
    # mux_threads, devcb, devcb_handle, out_gid, added, stats
    "sbg_lut_engine": ([_V, _I32, _I32, _I32, _I64, _I64, _I32, _V, _V, _V, _V,
                        _V, _V, _V, _V, _V, _V, _V, _I32, _V, _I32, _I32, _U64,
                        _I32, ENG_DEVCB, _V, _V, _V, _V], _I64),
}


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _build_error
    with _lock:
        if _lib is not None or _build_error is not None:
            return _lib
        try:
            handle = ctypes.CDLL(build())
        except (NativeUnavailable, OSError) as e:
            _build_error = str(e)
            return None
        for name, (argtypes, restype) in _SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = restype
        _lib = handle
        return _lib


def available() -> bool:
    """True when the library builds and loads (cached per process)."""
    return _load() is not None


def build_error() -> Optional[str]:
    """Why the library is unavailable, or None."""
    _load()
    return _build_error


def _require() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise NativeUnavailable(_build_error or "unknown load failure")
    return lib


def _buf(arr, dtype) -> np.ndarray:
    """Contiguous array of exactly ``dtype`` (no copy on the fast path)."""
    arr = np.asarray(arr)
    if arr.dtype != dtype or not arr.flags["C_CONTIGUOUS"]:
        arr = np.ascontiguousarray(arr, dtype=dtype)
    return arr


def _words(arr) -> np.ndarray:
    """256-bit truth-table operand: the uint32[..., 8] rows or their
    uint64[..., 4] view (the same bytes).  Never converts values: a dtype
    cast here would corrupt the tables silently."""
    arr = np.ascontiguousarray(arr)
    if arr.dtype != np.uint32 and arr.dtype != np.uint64:
        raise TypeError(f"table operand must be uint32/uint64, got {arr.dtype}")
    return arr


def tables32_to_64(tables32) -> np.ndarray:
    """uint32[..., 8] truth tables -> the uint64[..., 4] layout of the C
    ABI (little-endian word order)."""
    t = np.ascontiguousarray(tables32, dtype=np.uint32)
    assert t.shape[-1] == 8
    return t.astype("<u4", copy=False).view(np.uint64)


# -- wrappers -------------------------------------------------------------


def execute_circuit(types, in1, in2, in3, funcs, input_tables64) -> np.ndarray:
    """Evaluates every gate's 256-bit truth table; returns uint64[G, 4]."""
    lib = _require()
    g = len(types)
    ops = [_buf(a, np.int32) for a in (types, in1, in2, in3)]
    funcs = _buf(funcs, np.uint8)
    itab = _buf(input_tables64, np.uint64)
    out = np.empty((g, 4), dtype=np.uint64)
    rc = lib.sbg_execute_circuit(
        g, *(a.ctypes.data for a in ops), funcs.ctypes.data, itab.ctypes.data,
        out.ctypes.data,
    )
    if rc != 0:
        raise ValueError("malformed circuit program")
    return out


def _check_rows(tables, g, target, mask) -> None:
    """The raw-address ABI reads g rows of 32 bytes and one 32-byte table
    from target and mask: anything else would be read as garbage."""
    for a in (tables, target, mask):
        if not a.flags["C_CONTIGUOUS"] or a.dtype not in (np.uint32, np.uint64):
            raise TypeError("table operands must be C-contiguous uint32/uint64")
    if not (
        tables.shape[0] >= g and tables.shape[-1] * tables.itemsize == 32
        and target.nbytes == 32 and mask.nbytes == 32
    ):
        raise ValueError("table operands do not match the 32-byte-row ABI")


class GateStepCaller:
    """Per-context entry to ``sbg_gate_step``: holds the match tables and
    their addresses, so a node call passes only its own operands."""

    __slots__ = ("_fn", "_bufs", "pair_a", "not_a", "triple_a")

    def __init__(self, pair_table, not_table, triple_table):
        self._fn = _require().sbg_gate_step
        bufs = tuple(
            None if t is None else _buf(t, np.int16)
            for t in (pair_table, not_table, triple_table)
        )
        self._bufs = bufs  # keep alive
        self.pair_a, self.not_a, self.triple_a = (
            None if b is None else b.ctypes.data for b in bufs
        )

    def __call__(self, tables, g, bucket, target, mask, use_not, use_triple,
                 total3, chunk3, seed) -> np.ndarray:
        _check_rows(tables, g, target, mask)
        out = np.zeros(4, dtype=np.int32)
        self._fn(
            tables.ctypes.data, g, bucket, target.ctypes.data, mask.ctypes.data,
            self.pair_a, self.not_a if use_not else None,
            self.triple_a if use_triple else None, total3, chunk3, seed,
            out.ctypes.data,
        )
        return out


def gate_step(tables64, g, bucket, target64, mask64, pair_table, not_table,
              triple_table, total3, chunk3, seed) -> np.ndarray:
    """One gate-mode node head (steps 1-4) on the host: the int32[4]
    verdict of ``sweeps.gate_step_stream`` with the same selection.  None
    for ``not_table``/``triple_table`` disables that stage."""
    return GateStepCaller(pair_table, not_table, triple_table)(
        _words(tables64), g, bucket, _words(target64), _words(mask64),
        not_table is not None, triple_table is not None, total3, chunk3, seed,
    )


def lut_step(tables64, g, bucket, target64, mask64, pair_table, excl, total3,
             chunk3, has5, total5, chunk5, solve_rows, w_tab, m_tab,
             seed) -> np.ndarray:
    """One LUT-mode head (steps 1-3, 3-LUT, small-space 5-LUT) on the
    host: the int32[8] verdict of ``sweeps.lut_step_stream`` with the same
    selection.  ``excl`` lists the mux-used input bits (5-LUT only)."""
    lib = _require()
    tables64, target64, mask64 = _words(tables64), _words(target64), _words(mask64)
    _check_rows(tables64, g, target64, mask64)
    pair_table = _buf(pair_table, np.int16)
    excl = _buf(excl, np.int32)
    w_tab, m_tab = _buf(w_tab, np.uint32), _buf(m_tab, np.uint32)
    out = np.zeros(8, dtype=np.int32)
    lib.sbg_lut_step(
        tables64.ctypes.data, g, bucket, target64.ctypes.data, mask64.ctypes.data,
        pair_table.ctypes.data, excl.ctypes.data, excl.shape[0], total3, chunk3,
        1 if has5 else 0, total5, chunk5, solve_rows, w_tab.ctypes.data,
        m_tab.ctypes.data, seed, out.ctypes.data,
    )
    return out


def lut7_stage_a(tables64, g, target64, mask64, excl, total7, chunk7, solve7,
                 seed) -> Tuple[int, np.ndarray, np.ndarray, np.ndarray]:
    """Host 7-LUT stage A over C(g,7) ranks [0, chunk7) with the device
    stream's top-``solve7`` compaction order.  Returns (nfeas,
    ranks int32[take], req1 uint32[take, 4], req0)."""
    lib = _require()
    tables64, target64, mask64 = _words(tables64), _words(target64), _words(mask64)
    _check_rows(tables64, g, target64, mask64)
    excl = _buf(excl, np.int32)
    nfeas = np.zeros(1, dtype=np.int64)
    ranks = np.zeros(solve7, dtype=np.int32)
    req1 = np.zeros((solve7, 4), dtype=np.uint32)
    req0 = np.zeros((solve7, 4), dtype=np.uint32)
    take = lib.sbg_lut7_stage_a(
        tables64.ctypes.data, g, target64.ctypes.data, mask64.ctypes.data,
        excl.ctypes.data, excl.shape[0], total7, chunk7, solve7, seed,
        nfeas.ctypes.data, ranks.ctypes.data, req1.ctypes.data, req0.ctypes.data,
    )
    return int(nfeas[0]), ranks[:take], req1[:take], req0[:take]


def lut7_solve_small(req1, req0, solve7, idx_tab, seed) -> np.ndarray:
    """Host 7-LUT stage-B solve of at most 256 rows: int32[4] [found,
    best_t, sigma, fo*256+fm], the verdict of ``sweeps.lut7_solve`` on the
    same rows (``seed`` already xored as the solver takes it)."""
    lib = _require()
    req1, req0 = _buf(req1, np.uint32), _buf(req0, np.uint32)
    if req1.shape[0] > 256:
        raise ValueError(f"at most 256 rows, got {req1.shape[0]}")
    idx_tab = _buf(idx_tab, np.int32)
    out = np.zeros(4, dtype=np.int32)
    lib.sbg_lut7_solve_small(
        req1.ctypes.data, req0.ctypes.data, req1.shape[0], solve7,
        idx_tab.ctypes.data, idx_tab.shape[0], seed, out.ctypes.data,
    )
    return out


def combinations_from_rank(g: int, k: int, rank: int, count: int) -> np.ndarray:
    """Up to ``count`` consecutive lexicographic k-combinations of
    {0..g-1} from ``rank``, as int32[written, k]."""
    lib = _require()
    out = np.empty((count, k), dtype=np.int32)
    written = lib.sbg_combinations_from_rank(g, k, rank, count, out.ctypes.data)
    return out[:written]


def _ops_array(entries) -> np.ndarray:
    """Materialization rows of a match table's entries, int32[n, 8]:
    [num_inputs, fun1, fun2, not_a, not_b, not_c, not_out, perm], perm
    packing the operand order two bits per slot."""
    ops = np.zeros((max(len(entries), 1), 8), dtype=np.int32)
    for i, e in enumerate(entries):
        f = e.fun
        perm = 0
        for slot, p in enumerate(e.perm):
            perm |= (p & 3) << (2 * slot)
        ops[i] = (
            f.num_inputs, f.fun1, 0 if f.fun2 is None else f.fun2,
            int(f.not_a), int(f.not_b), int(f.not_c), int(f.not_out), perm,
        )
    return ops


def _engine_result(n, out_gid, added, stats):
    """(out_gid, added rows, stats) of an engine call; out_gid is NO_GATE
    (0xFFFF) when the search found nothing."""
    if n < 0:
        return 0xFFFF, added[:0], stats
    return int(out_gid[0]), added[: int(n)], stats


class GateEngineCaller:
    """Per-context entry to ``sbg_gate_engine``: the whole gate-mode
    ``create_circuit`` recursion in C++.  Only the adopted gate additions
    come back, for the caller's State to replay and re-verify."""

    __slots__ = ("_fn", "_bufs")

    def __init__(self, pair_table, pair_entries, not_table, not_entries,
                 triple_table, triple_entries):
        self._fn = _require().sbg_gate_engine
        self._bufs = (
            _buf(pair_table, np.int16), _ops_array(pair_entries),
            None if not_table is None else _buf(not_table, np.int16),
            _ops_array(not_entries),
            _buf(triple_table, np.int16), _ops_array(triple_entries),
        )

    def __call__(self, tables, g, num_inputs, max_gates, sat_metric,
                 max_sat_metric, metric, target, mask, inbits, randomize,
                 rng_seed, use_not):
        """Returns (out_gid, added int32[n, 5], stats int64[8])."""
        tables, target, mask = _words(tables), _words(target), _words(mask)
        _check_rows(tables, g, target, mask)
        pair_mt, pair_ops, not_mt, not_ops, tri_mt, tri_ops = self._bufs
        inb = np.asarray(list(inbits) or [0], dtype=np.int32)
        out_gid = np.full(1, 0xFFFF, dtype=np.int32)
        added = np.zeros((max_gates + 8, 5), dtype=np.int32)
        stats = np.zeros(8, dtype=np.int64)
        n = self._fn(
            tables.ctypes.data, g, num_inputs, max_gates, sat_metric,
            max_sat_metric, metric, target.ctypes.data, mask.ctypes.data,
            pair_mt.ctypes.data, pair_ops.ctypes.data,
            not_mt.ctypes.data if use_not and not_mt is not None else None,
            not_ops.ctypes.data, tri_mt.ctypes.data, tri_ops.ctypes.data,
            inb.ctypes.data, len(inbits), int(bool(randomize)),
            rng_seed & 0xFFFFFFFFFFFFFFFF, out_gid.ctypes.data,
            added.ctypes.data, stats.ctypes.data,
        )
        return _engine_result(n, out_gid, added, stats)


class LutEngineCaller:
    """Per-context entry to ``sbg_lut_engine``: the whole LUT-mode
    ``create_circuit`` recursion in C++.  Nodes that need device work
    (pivot-sized 5-LUT space, head-solver overflow, staged 7-LUT) go to
    the service of :func:`make_eng_devcb` and the recursion resumes in
    place.  When the service fails the engine bails: the call returns
    ``(BAILED, None, stats)`` and the failure is reported once on stderr
    (:func:`_note_service_failure`).  An interrupt raised in the service
    is raised here once the engine has unwound."""

    BAILED = -2

    __slots__ = ("_fn", "_bufs")

    def __init__(self, pair_table, pair_entries):
        from ..ops import sweeps

        self._fn = _require().sbg_lut_engine
        _, w_tab, m_tab = sweeps.lut5_split_tables()
        idx_tab, _ = sweeps.lut7_pair_tables()
        orders, wo_tab, wm_tab, g_tab = sweeps.lut7_split_tables()
        self._bufs = (
            _buf(pair_table, np.int16), _ops_array(pair_entries),
            _buf(w_tab, np.uint32), _buf(m_tab, np.uint32),
            _buf(idx_tab, np.int32), _buf(orders, np.int32),
            _buf(wo_tab, np.uint32), _buf(wm_tab, np.uint32),
            _buf(g_tab, np.uint32),
        )

    def __call__(self, tables, g, num_inputs, max_gates, sat_metric,
                 max_sat_metric, metric, target, mask, inbits, randomize,
                 rng_seed, devcb, mux_threads=1):
        """``devcb`` is a ``(callback, pending)`` pair from
        :func:`make_eng_devcb`, kept alive by the caller for the call.
        ``mux_threads > 1`` fans the outermost mux's branches out over C++
        threads (the service must then be thread-safe).
        Returns (out_gid, added int32[n, 5], stats int64[8])."""
        tables, target, mask = _words(tables), _words(target), _words(mask)
        _check_rows(tables, g, target, mask)
        cb, pending = devcb
        inb = np.asarray(list(inbits) or [0], dtype=np.int32)
        out_gid = np.full(1, 0xFFFF, dtype=np.int32)
        added = np.zeros((max_gates + 8, 5), dtype=np.int32)
        stats = np.zeros(8, dtype=np.int64)
        n = self._fn(
            tables.ctypes.data, g, num_inputs, max_gates, sat_metric,
            max_sat_metric, metric, target.ctypes.data, mask.ctypes.data,
            *(b.ctypes.data for b in self._bufs), self._bufs[4].shape[0],
            inb.ctypes.data, len(inbits), int(bool(randomize)),
            rng_seed & 0xFFFFFFFFFFFFFFFF, int(mux_threads), cb, None,
            out_gid.ctypes.data,
            added.ctypes.data, stats.ctypes.data,
        )
        exc, pending["exc"] = pending["exc"], None
        if exc is not None:
            raise exc
        sexc, pending["service_exc"] = pending["service_exc"], None
        if sexc is not None:
            _note_service_failure(sexc)
        if n == -2:
            return self.BAILED, None, stats
        return _engine_result(n, out_gid, added, stats)
