"""Builds and loads the hand-written CUDA kernels (``csrc/*.cu``).

Every source is compiled by ``nvcc`` for ``sm_90a`` into an object file —
one ``nvcc`` process per source, all started together — and the objects are
linked into one shared library with a plain C interface,
``build/torch_kernels/libsbgt_kernels.so`` under the checkout root, at first
use.  The library is loaded with ``ctypes``: every device pointer and the
CUDA stream travel as ``c_void_p``, and each entry point returns
``cudaGetLastError()`` so a refused launch raises here instead of failing
silently.

The build is keyed on a digest of the sources and their headers (a changed
``.cu`` or ``.cuh`` file rebuilds), runs under an exclusive file lock on the build directory (so
concurrent processes compile once), lands in a temporary name first and is
moved into place atomically, so no process loads a half-written library.
Nothing here runs at import time: the CPU test suite imports every module of
the package on a machine without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from typing import Optional

from ._buildlock import build_lock

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "torch_kernels")
LIB_NAME = "libsbgt_kernels.so"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

#: What the last build did: seconds, whether it compiled or reused a cached
#: library, and the compiler's resource report (``-Xptxas -v``).
build_info: dict = {}

#: Builds that compiled in this process (``utils.guards.recompile_guard``).
compiles = 0

_P = ctypes.c_void_p
_I = ctypes.c_int
#: C signatures of the entry points (all return cudaError_t as int).  ``ev0``
#: and ``ev1``: the launch's timing events, or None (csrc/launch_timing.cuh).
_SIGNATURES = {
    # tables, n_tables, combos, n, target, mask, req1, req0, stream, ev0, ev1
    "sbgt_lut5_filter": [_P, _I, _P, _I, _P, _P, _P, _P, _P, _P, _P],
    # tables, n_tables, combos, n, lanes, target, mask, req1, req0, stream,
    # ev0, ev1
    "sbgt_lut5_filter_lanes": [_P, _I, _P, _I, _I, _P, _P, _P, _P, _P, _P,
                               _P],
    # l1, l0, l_plane_stride, hcs, h_plane_stride, pmw, tl, th,
    # req1, req0, stream
    "sbgt_pivot_packed": [_P, _P, _I, _P, _I, _P, _I, _I, _P, _P, _P],
    # tables, l1, l0, l_plane_stride, hcs, h_plane_stride, lowvalid,
    # highvalid, descs, t0, n, t_end, tl, th, req1, req0, feas, counts,
    # stream, ev0, ev1
    "sbgt_pivot_window": [_P, _P, _P, _I, _P, _I, _P, _P, _P, _I, _I, _I,
                          _I, _I, _P, _P, _P, _P, _P, _P, _P],
    # tables, tab_lane, l1, l0, lstride, l_lane, hcs, hstride, h_lane,
    # lowvalid, highvalid, valid_lane, descs, desc_lane, t0, t_end, lanes,
    # n, tl, th, req1, req0, feas, counts, stream, ev0, ev1
    "sbgt_pivot_window_lanes": [_P, _I, _P, _P, _I, _I, _P, _I, _I, _P, _P,
                                _I, _P, _I, _P, _P, _I, _I, _I, _I, _P, _P,
                                _P, _P, _P, _P, _P],
    # lhs1, lhs0, rhsb, tl, th, req1, req0, stream
    "sbgt_pivot_pre": [_P, _P, _P, _I, _I, _P, _P, _P],
    # tables, l1, l0, hc, rows, lowvalid, highvalid, descs, t0, n, t_end,
    # tl, th, req1, req0, feas, counts, stream, ev0, ev1
    "sbgt_pivot_pre_window": [_P, _P, _P, _P, _I, _P, _P, _P, _I, _I, _I, _I,
                              _I, _P, _P, _P, _P, _P, _P, _P],
    # tables, n_gates, spectrum, out, stream, ev0, ev1
    "sbgt_walsh_scores": [_P, _I, _P, _P, _P, _P, _P],
    # prog, n_prog, n_in, out_slots, n_out, inputs, w, out, threads, smem,
    # stream, ev0, ev1
    "sbgt_circuit_eval": [_P, _I, _I, _P, _I, _P, _I, _P, _I, _I, _P, _P, _P],
    # kind, blocks, iters, sink, issued (host int64), stream
    # torchlint: ignore[R7] the tensor-core rate probe (csrc/tc_probe.cu): chip_smoke.py launches it to read the card's 1-bit and int8 rates (the measured peak of telemetry/attribution.py); no search path runs it
    "sbgt_tc_probe": [_I, _I, _I, _P, _P, _P],
}


def sources() -> list:
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def headers() -> list:
    return sorted(glob.glob(os.path.join(CSRC, "*.cuh")))


def _digest(srcs) -> str:
    h = hashlib.sha256()
    for path in srcs:
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(ARCH_FLAGS).encode())
    return h.hexdigest()[:16]


def nvcc_path() -> str:
    for cand in (
        os.environ.get("NVCC"),
        os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc")
        if os.environ.get("CUDA_HOME") else None,
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (set NVCC or CUDA_HOME): the CUDA kernels of "
        "sboxgates_tpu_torch are built from csrc/ at first use"
    )


def build(force: bool = False) -> str:
    """Compiles the kernels (unless an up-to-date library exists) and
    returns the library path.  Raises RuntimeError with the compiler's
    output when a source does not compile.  Holds an exclusive lock on the
    build directory (``_buildlock.build_lock``) from the digest check to
    the end, so concurrent processes compile once."""
    srcs = sources()
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    os.makedirs(BUILD_DIR, exist_ok=True)
    with build_lock(BUILD_DIR):
        return _build_locked(srcs, force)


def _build_locked(srcs, force: bool) -> str:
    lib_path = os.path.join(BUILD_DIR, LIB_NAME)
    stamp = os.path.join(BUILD_DIR, LIB_NAME + ".digest")
    digest = _digest(srcs + headers())
    t0 = time.perf_counter()
    if not force and os.path.exists(lib_path) and os.path.exists(stamp):
        with open(stamp) as f:
            if f.read().strip() == digest:
                build_info.update(seconds=0.0, compiled=False, ptxas="")
                return lib_path
    nvcc = nvcc_path()
    tmp = tempfile.mkdtemp(prefix="build-", dir=BUILD_DIR)
    try:
        procs = []
        for src in srcs:
            obj = os.path.join(tmp, os.path.basename(src) + ".o")
            cmd = [
                nvcc, *ARCH_FLAGS, "-std=c++17", "-O3", "-Xptxas", "-v",
                "-Xcompiler", "-fPIC", "-c", src, "-o", obj,
            ]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True,
            )))
        reports, errors = [], []
        for src, _, proc in procs:
            out, err = proc.communicate()
            reports.append(f"{os.path.basename(src)}:\n{out}{err}")
            if proc.returncode != 0:
                errors.append(f"{src}:\n{out}{err}")
        if errors:
            raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
        out_tmp = os.path.join(tmp, LIB_NAME)
        link = subprocess.run(
            [nvcc, *ARCH_FLAGS, "-shared", "-o", out_tmp,
             *[obj for _, obj, _ in procs]],
            capture_output=True, text=True,
        )
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
        os.replace(out_tmp, lib_path)
        with open(stamp + ".tmp", "w") as f:
            f.write(digest)
        os.replace(stamp + ".tmp", stamp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    global compiles
    compiles += 1
    build_info.update(
        seconds=time.perf_counter() - t0, compiled=True,
        ptxas="\n".join(reports),
    )
    return lib_path


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(build())
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = handle
        return _lib


def check(err: int, name: str) -> None:
    """Raises when a C entry point reported a CUDA error."""
    if err != 0:
        fn = lib().sbgt_error_string
        fn.restype = ctypes.c_char_p
        fn.argtypes = [ctypes.c_int]
        raise RuntimeError(f"{name}: CUDA error {err}: {fn(err).decode()}")


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream


def upload(values, dtype, device):
    """Host values (nested lists or a numpy array) as a ``dtype`` tensor on
    ``device``.  On the card the copy runs from pinned memory behind the
    stream's earlier work: a copy from pageable memory would wait for the
    stream, a host sync."""
    import torch

    t = torch.as_tensor(values, dtype=dtype)
    if torch.device(device).type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)
