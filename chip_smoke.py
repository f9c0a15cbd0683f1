#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (sboxgates_tpu_torch) on one GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``.  It needs one
CUDA card, ``nvcc`` and the repository; without a card (or run from a
directory that holds nothing else of the repository) it exits non-zero and
prints no result.  Phases, each of which raises on failure:

1. build — compiles every kernel under sboxgates_tpu_torch/csrc with nvcc
   (one process per source, in parallel) and, at the same time, the native
   host runtime (csrc/runtime.cpp, with the host's C++ compiler) into
   build/torch_native/, and prints the build seconds; fails if either does
   not build or load;
2. parity — each kernel against its plain PyTorch version on the card, on
   seeded inputs at the shapes the search gives it: the 5-LUT filter (K3)
   at N = 2^17 candidates over 64- and 512-row tables, with a full mask,
   the 6-input mask of DES S1 and random mask words, the single-tile pivot
   kernels (K1 packed, K2 int8 lanes) at (tl, th) = (256, 512) and
   (512, 512) on real pair-cell operands of a G = 200 state, the window
   kernels the pivot sweep runs (K1 on words, K2 on int8 lanes, on the
   tensor cores) on windows of 1 and 64 tiles and on one crossing the end
   of the descriptors, at 256 x 512 on phase 4a's G = 99 state and
   planted target and at 512 x 512 on the G = 200 state, with
   torch._int_mm on one tile's K2 operands timed beside K2 as a yardstick,
   the Walsh-score kernel (K5) at B = 64, 512 and 2^20 gates against a
   target's spectrum, a random int32 spectrum and an extreme one, and the
   circuit kernel (K4) on every examples/*.xml and on a G = 200, 8-output
   state of NOT, 2-input and LUT gates, at W = 2 words and W = 2^22 + 13
   (a ragged edge).  Requires 0 differing words and times each version
   (CUDA events), K4 at W = 2^22 and K5 also at the large B;
3. main path — ``python -m sboxgates_tpu_torch -l -o 0 --seed 1
   sboxes/des_s1.txt`` in process on the device route (``SBG_DISABLE_NATIVE``
   set, as for every run of phases 3, 4a and 5: their golden files are the
   JAX CLI's with its native runtime off): every output gate is checked against the
   S-box, and the XML bytes against the file the JAX package wrote for the
   same command (tests/data/torch_golden/des_s1_l_o0_seed1.xml); after
   phase 6, a torch.profiler window around a second run of the same
   command (3b): the device's busy share, the host's synchronising CUDA
   calls and the top eight device operations;
4. pivot sweep at the flagship's size — 8-input states from
   sboxes/rijndael.txt grown with seeded random gates to G = 99 (the
   deepest AES branch of examples/AES_RUN.md) and G = 200:
   a. the CLI resumes (``-g``) from the saved G = 99 state against an
      S-box whose output bit 0 is a planted 5-LUT, which the pivot sweep
      finds, once with each pivot window kernel: ``--pivot-backend packed``
      (K1, the default) and ``--pivot-backend pre`` (K2).  The output gate
      is checked, and the XML bytes against the file the JAX package wrote
      for the same command
      (tests/data/torch_golden/rijndael_planted_l_o0_seed1_g99.xml);
   b. the full 5-LUT space against a random target on the packed (K1)
      backend at G = 99 and G = 200: candidates/s, windows, tiles swept
      and tiles solved printed, then the sweep alone again under
      torch.profiler for its busy share (device time over that run's
      wall), and the sweep alone on the pre (K2) backend, its
      candidates/s beside the packed one's;
   c. a torch.profiler window over 400 tiles of the G = 200 sweep: the
      device's busy share of the profiled wall, device operations per tile
      and its time by kernel;
5. spectral candidate order — the CLI runs of SPECTRAL_RUNS with
   ``--candidate-order spectral``: DES S1 (no stream reordered), a G = 22
   resume against a planted 7-LUT (K5 scores the 7-LUT stage A's rank
   chunks) and the G = 99 resume (K5 tiers the pivot tiles); the ``-v -v``
   stats must show ordered dispatches where SPECTRAL_RUNS says so, and the
   XML bytes must be the JAX CLI's;
6. codegen — ``eval_sbox`` on the card (K4) for every examples/*.xml and
   every state file the CLI runs wrote, against the S-box bits, then the
   CLI's ``-c`` and ``-d`` on a LUT and a gate circuit against the JAX
   CLI's text (tests/data/torch_golden/*.cu, *.c, *.dot);
7. gate mode and the native route (files under
   tests/data/torch_golden/gate/, each the JAX CLI's for the same command
   and route):
   a. ``-o 0 --seed 1 sboxes/des_s1.txt`` on the device route: wall, nodes,
      gate_step dispatches, then the first 300 nodes of a second run under
      the profiler (device operations and host syncs per node, busy share);
   b. the same command on the native route (the default): wall, engine
      nodes, and a profiled second run that must launch no CUDA kernel;
   c. ``-l -o 0 --seed 1 sboxes/des_s1.txt`` on the default route, its wall
      beside phase 3's;
   d. phase 4a's G = 99 resume without ``-v`` on the default route: the LUT
      engine's one device-work request runs K1's 8 windows over 191 tiles;
   e. one gate_step on the device and on the host at G = 64, 200 and 500;
8. resilience (every file and journal the JAX CLI's under the same faults,
   tests/data/torch_golden/journal/<case>/):
   a. ``SBG_DISABLE_NATIVE=1 -l -o 0 -i 2 --seed 1 sboxes/des_s1.txt`` in a
      fresh process with ``SBG_FAULTS=ckpt.write:crash@2`` exits 17 in its
      second checkpoint write, and ``--resume-run`` in another finishes
      it (K3 launches);
   b. 7d's G = 99 resume with ``--dispatch-timeout 2`` and
      ``dispatch.sweep:hang@1``: one breach, one retry, 7d's K1 windows and
      file;
   c. the same with ``hang@1+``: three breaches, the circuit breaker
      tripped, no K1 window, the host chunk stream on K3;
   d. the same resume with ``native.devcb:raise@1``: one stderr line, the
      node rerun on the Python engine with K1 windows on the card.
   Each case prints its wall, K1 and K3 launches and its breach, retry and
   trip counters on one line;
9. the journal's cost on the default route: 7c's and 7d's commands five
   more times each, every run's wall beside its time in the journal's
   writes, in the device probe and in the telemetry (every CLI run's line
   prints the three);
10. telemetry (``--trace --status-port 0 --metrics-interval 0.05``):
   a. the G = 99 resume on the default route (7d's command) and on the
      device route (4a's, packed): the goldens, ``trace.json`` whose
      dispatch spans are as many as metrics.json's ``device_dispatches``,
      K1's 8 launch times (``dispatch_latency_s[pivot_window/...]``, CUDA
      events) with every K1 attribution row at most 105% of its bound, the
      wall beside phase 9's median of 7d, and the host syncs
      (``set_sync_debug_mode("warn")``) equal to those of the same run
      without telemetry;
   b. DES S1 ``-l`` on the device route: K3's 132 launch times and its
      attribution row at N = 2^17;
   c. the flight dumps of phase 8's runs: 8a's crash dumps before exit 17,
      8c leaves a ``deadline_exhausted`` and a ``circuit_breaker`` dump,
      each with its heartbeat incident line;
11. the job axis (JOB_RUNS, goldens of tests/torch_job_goldens.py), and
   11e: the lane forms against their plain versions (run after phase 2);
12. chained rounds, the serve and the result store (ROUND_RUNS, goldens of
   tests/torch_round_goldens.py):
   a. one round-driver window of the planted chain, its host syncs
      (``utils.guards.sync_guard``) and K3 launches per round, against its
      CPU run; DES S1 as one chain (``-l --chain-rounds 8 --serial-mux``)
      at N = 8 and N = 1 on both routes, its round-driver windows, host
      rounds and K3 launches;
   b. the DES-8 one-output serve and a chained serve of eight planted
      boxes on the device route, each merged and with
      ``--serve-no-merge`` (the same files), jobs/s and K3's lane-form
      launches (merged only);
   c. a serve that fills a ``--result-store`` and the same serve again:
      no kernel launch and no device dispatch, 8 store hits, the lookup
      latency;
   d. the chained serve (default route) in a fresh process, SIGTERM after
      its first job, and the same command again: the uninterrupted
      serve's files (a job finished before the signal runs again and its
      journal gains a second ``run_done``, as in the JAX package).
   ``--rounds`` runs the build and phase 12 alone, with the DES-8 serve on
   the device route too;
13. the HTTP admission front door (``serve_net/``; request sequences and
   goldens of tests/torch_net_goldens.py, written by the JAX package):
   a. the eight planted chains posted over loopback HTTP to an in-process
      ``AdmissionServer`` on the device route, all admitted before the
      orchestrator starts (one merged wave of 8 lanes, K3's lane form),
      long-polled to their ends: every response and file the golden's
      (``net_chain8_dev``); 200 repeat POSTs of the finished queries (200
      each, with circuits, no device dispatch, no kernel launch); the
      admissions per second and ``net_admit_s`` of the eight fresh POSTs
      (median, max) and of the repeats (median, p99); to a second server
      whose orchestrator never starts, one request each for 401, 403, 411,
      413, 400 and 429 (rate, quota) and 200 fresh admissions (the eight
      chains under new Idempotency-Keys: admit record, S-box file and
      queue, no search; median and p99), none reaching the device;
   b. ``-o 0 --serve --serve-lanes 8 --serve-port 0 --serve-token-file T``
      (the CLI in a fresh process, default route): DES S1-S8 posted and
      long-polled, SIGTERM; the golden ``net_des8_o0``, nothing pending;
      the same command again replays nothing;
   c. the same command under ``SBG_FAULTS=net.admit_journal:crash@2``
      exits 17 with one job admitted and not queued; the command again
      replays it to the uninterrupted run's files.
   ``--net`` runs the build and phase 13 alone;
14. several shards and processes on the one card (goldens of
   tests/torch_mesh_goldens.py, written by the JAX package at the same
   device count):
   a. ``SBG_LOCAL_SHARDS=2 ... --mesh``: the G = 99 resume on the device
      route with each backend and DES S1 ``-l -o 0 --seed 1``; K1's (K2's)
      windows counted by shard, both shards launching;
   b. the G = 99 resume on two processes of the card (``--coordinator
      127.0.0.1:P --num-processes 2 --process-id i``, gloo: they share the
      card): rank 0 writes the JAX CLI's 2 x 1 files, both ranks return
      the same state, each rank's shard launches its windows;
   c. ``--permute-sweep --shard-sweep`` on two ranks with rank 1 killed
      at its third round, then ``--resume-run``: the uninterrupted run's
      files; the replicated abort (``dispatch.sweep@rank:1`` hanging every
      window, tests/torch_mesh_worker.py): the JAX workers' lines;
   d. ``--fleet --fleet-candidates 2`` on two shards;
   e. the whole G = 200 pivot space against a random target through the
      sharded stream on 1 x 1, 1 x 2 and (two gloo ranks) 2 x 1 shards:
      candidates/s, windows and all-reduces per window;
   f. ``--fleet`` on four job shards of the card (``SBG_LOCAL_SHARDS=4``,
      device route): the DES-8 fleet and the G = 99 resume's 8 restarts
      (``fleet_des8_d4_dev``, ``fleet_g99_i8_d4_dev``), each lane-form
      launch split by job shard: the JAX CLI's files at 4 devices, and
      K3's lane form (DES-8) and K1's (G = 99) launched by every job
      shard, every launch of it in the run a job shard's
      (``ops/sweeps.py: JOB_SHARD_LAUNCHES``);
   h. the same fleets on 4 job shards x 2 candidate shards of the card
      (``SBG_LOCAL_SHARDS=8 --fleet-candidates 2``; ``fleet_des8_c2_d8_dev``,
      ``fleet_g99_i8_c2_d8_dev``), each job shard's lane-form launches cut
      along the candidates into one launch per candidate shard: the JAX
      CLI's files at 8 devices, the lane form launched by every one of
      the 8 (job shard, candidate shard) pairs, every launch of it in the
      run a candidate shard's (``ops/sweeps.py:
      CANDIDATE_SHARD_LAUNCHES``, by local shard j * 2 + c).
   ``--mesh`` runs the build and phase 14 a-e alone, ``--fleet-shards``
   the build, 14f, 14h and then 14g: 14f's fleets on one shard, on four
   job shards and on 4 x 2 shards of the card, in turns (one, 4 x 1,
   4 x 2, 4 x 2, 4 x 1, one).
15. ``--cards`` only, run by hand on a host of several cards (the
   default run needs one card and leaves it out): 15a the G = 99 resume
   on one process over the n cards, a shard per card; 15b the same on n
   processes of one card each, whose collectives run on NCCL, both
   against the JAX CLI's n-device goldens (four cards: ``g99_d4_dev`` and
   ``g99_p4x1_dev`` of tests/torch_mesh_goldens.py, which only this phase
   reads); 15c the G = 200 space on 1 x 1, 1 x n and n x 1; 15d 14f's two
   fleets with one job shard per card against the JAX CLI's n-device
   goldens, and 15e the same fleets on n/2 job shards x 2 candidate
   shards, one shard per card (``fleet_des8_c2_d4_dev``,
   ``fleet_g99_i8_c2_d4_dev`` on four cards), beside the same command on
   the first card alone, in turns (one card, 15d, 15e, 15e, 15d, one
   card): walls and lane-form launches by card.
   ``--fleet-cards`` runs the build and 15d and 15e alone.

Phase 7a and phase 12, host-bound and the two longest, each run in a child
process of their own (``chip_smoke.py --phase-7a`` and ``--phase-12``,
which load the kernels the parent built), started after phase 7e and
joined after 14h: they share the card and the host's cores with phases
8-14h, and their walls and those phases' are taken so.  A child's log is
printed where it is joined; its paths are counted as every other's.

Every CLI run's output directory must hold the JAX CLI's names for the same
command and nothing else: its XML files, the journal
(``search.journal.jsonl`` and ``.json``, byte for byte the goldens under
tests/data/torch_golden/journal/, written by
tests/torch_journal_goldens.py), the telemetry of an explicit
``--output-dir`` (``telemetry.jsonl``, ``metrics.json``), and the trace and
the flight dumps where the run makes them.

The CLI runs (phases 3, 4a, 5, 7a-7d, 8b-8d, 10a, 10b, 11, 12, 14a,
14d, 14f, 14h), phase 6 and 13a's serve are the main path.  Every launch
count is set to 0 right before each of them and read right after it; each
kernel must have launched on its own path (K3 on DES S1, K1's window
kernel and K2's on the G = 99 resume with their backend, K5 on the
spectral G = 99 resume, K4 on codegen, K1's window kernel through the
engine's service in 7d), none of K1-K5 in gate mode, K5 never on a lexicographic path
nor on DES S1 spectral, the single-tile K1 and K2 on no path, and K1–K3
(launches and tiles) as often on the lexicographic paths as LEX_LAUNCHES
records; in phase 8, K1 on 8b and 8d, K3 on 8a and 8c and no K1 on 8c.
Phases 4b and 4c call the
sweep directly and report their launches in their own lines only.  The last
lines are one ``{"kernels": [...]}`` JSON line, the card's ``nvidia-smi``
name and power limit, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import glob
import io
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(ROOT, "tests", "data", "torch_golden")
EXAMPLES = sorted(glob.glob(os.path.join(ROOT, "examples", "*.xml")))

# K1-K3 launches of the lexicographic CLI runs, each counted from 0.  The
# G = 99 resume consumes 114 pivot tiles (its hit is in tile 113): K1
# (packed) or K2 (pre) sweeps them in the windows of
# sweeps._pivot_stream, 1, 2, 4, ..., 64 tiles, one window ahead of
# the host: 8 launches over tiles [0, 191), the hit's window [63, 127) and
# the one launched behind it, [127, 191), swept past the hit and dropped.
# Both backends count the same 5-LUT candidates, those of tiles [0, 114).
LEX_LAUNCHES = {
    "des_s1": {"lut5_filter": 132, "pivot_window": 0, "pivot_pre": 0},
    "g99_packed": {"lut5_filter": 0, "pivot_window": 8, "pivot_window_tiles": 191,
                   "pivot_pre": 0},
    "g99_pre": {"lut5_filter": 0, "pivot_window": 0, "pivot_pre": 8,
                "pivot_pre_tiles": 191},
}
G99_TILES = 114
G99_CANDIDATES = 2061108


def attribution():
    """The port's attribution module: the kernels' analytic costs
    (``window_cost``, ``filter_cost``, ``walsh_cost``, ``circuit_cost``)
    and ``bound`` against the H100 SXM data-sheet peaks (``PEAKS``)."""
    from sboxgates_tpu_torch.telemetry import attribution as attr

    return attr


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Milliseconds per call of ``fn``: CUDA events around ``reps``
    back-to-back calls, after a warm-up, over the count."""
    import torch

    for _ in range(warmup):
        fn()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def _device_us(evt) -> float:
    for attr in ("device_time_total", "cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def profiled(fn, warm_up):
    """(key_averages, wall microseconds, result) of one call of ``fn``
    under torch.profiler, wall on the host's clock up to a device sync.
    ``warm_up`` runs first, in the profiler's warm-up step: a trace that
    starts with the measured work loses its first device operations (on
    the H100, the first 5-7 windows of a pivot sweep, and in one run 14 of
    a G = 99 sweep's 23 windows despite the warm-up).  The measured work
    also starts and ends ``margin`` seconds inside the active step, off the
    wall: device operations whose timestamps fall just outside the step's
    span on the host's clock are not in its trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    margin = 0.05
    got = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                 on_trace_ready=lambda p: got.append(p.key_averages())) as prof:
        warm_up()
        torch.cuda.synchronize()
        prof.step()
        time.sleep(margin)
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
        time.sleep(margin)
        prof.step()
    return got[0], wall_us, out


def kernel_device_ms(fn, kernel: str, reps: int = 20):
    """Device milliseconds per launch of the kernel whose name contains
    ``kernel``, from a torch.profiler trace of ``reps`` calls of ``fn``;
    None when the trace holds no device time for it."""
    events, _, _ = profiled(lambda: [fn() for _ in range(reps)], fn)
    total, count = 0.0, 0
    for evt in events:
        if kernel in evt.key:
            total += _device_us(evt)
            count += evt.count
    return total / count / 1e3 if count and total > 0 else None


def compare(name, got, want, quiet: bool = False) -> dict:
    """Word-for-word comparison of kernel and plain outputs."""
    mism, err = 0, 0
    for g, w in zip(got, want):
        diff = g.long() - w.long()
        mism += int((diff != 0).sum())
        err = max(err, int(diff.abs().max()) if diff.numel() else 0)
    if not quiet or mism:
        log(f"  {name}: {mism} differing words, max |diff| {err}")
    if mism:
        raise AssertionError(f"{name}: kernel disagrees with its plain version")
    return {"mismatches": mism, "max_abs_err": err}


def random_state(g: int, seed: int):
    """8-input state from sboxes/rijndael.txt's inputs grown to ``g`` gates
    with seeded random 2-input gates."""
    import numpy as np

    from sboxgates_tpu_torch.core import boolfunc as bf
    from sboxgates_tpu_torch.graph.state import GATES, State

    rng = np.random.default_rng(seed)
    st = State.init_inputs(8)
    funs = (bf.AND, bf.OR, bf.XOR, bf.A_AND_NOT_B)
    while st.num_gates < g:
        a, b = rng.choice(st.num_gates, size=2, replace=False)
        st.add_gate(funs[int(rng.integers(len(funs)))], int(a), int(b), GATES)
    return st


def mixed_state(g: int = 200, seed: int = 5):
    """8-input state grown to ``g`` gates with seeded NOT gates, 2-input
    gates of every function and 3-LUTs; its last 8 gates are the outputs."""
    import numpy as np

    from sboxgates_tpu_torch.core import boolfunc as bf
    from sboxgates_tpu_torch.graph.state import GATES, NO_GATE, State

    rng = np.random.default_rng(seed)
    st = State.init_inputs(8)
    while st.num_gates < g:
        a, b, c = (int(x) for x in rng.choice(st.num_gates, size=3, replace=False))
        kind = int(rng.integers(3))
        if kind == 0:
            st.add_gate(bf.NOT, a, NO_GATE, GATES)
        elif kind == 1:
            st.add_gate(int(rng.integers(16)), a, b, GATES)
        else:
            st.add_lut(int(rng.integers(256)), a, b, c)
    st.outputs = list(range(g - 8, g))
    return st


def phase_build() -> float:
    """The CUDA kernels (nvcc) and, at the same time on another thread, the
    native host runtime (csrc/runtime.cpp, the host's C++ compiler); fails
    if either does not build or load."""
    import threading

    from sboxgates_tpu_torch import _kernels, native

    host = {}

    def build_native():
        t = time.perf_counter()
        try:
            shutil.rmtree(native.BUILD_DIR, ignore_errors=True)
            host["ok"] = native.available()
        finally:
            host["seconds"] = time.perf_counter() - t

    th = threading.Thread(target=build_native)
    th.start()
    try:
        _kernels.build(force=True)
    finally:
        th.join()
    if not host.get("ok"):
        raise AssertionError(f"native host runtime: {native.build_error()}")
    info = dict(_kernels.build_info)
    _kernels.lib()
    log(f"phase 1 build: {info['seconds']:.2f} s "
        f"({len(_kernels.sources())} sources, sm_90a); native host runtime "
        f"{host['seconds']:.2f} s ({native.lib_path()})")
    for line in info.get("ptxas", "").splitlines():
        if "registers" in line or "spill" in line:
            log("  ptxas: " + line.strip())
    return info["seconds"]


def phase_parity(dev) -> dict:
    import numpy as np
    import torch

    from sboxgates_tpu_torch.core import ttable as tt
    from sboxgates_tpu_torch.ops import lut5_filter, pivot_tile, sweeps
    from sboxgates_tpu_torch.search.lut import PivotOperands

    rng = np.random.default_rng(2024)
    words = lambda a: sweeps.as_words(a, dev)  # noqa: E731
    out = {}

    # K3: the 5-LUT filter at the stream chunk, over both table buckets,
    # with a full mask, the partial mask of a 6-input S-box (upper words 0:
    # need1 = need0 = 0 there) and random mask words.
    n = 1 << 17
    k3 = {"mismatches": 0, "max_abs_err": 0}
    masks = {
        "full": np.full(8, 0xFFFFFFFF, np.uint64),
        "6-input": tt.mask_table(6),
        "random": rng.integers(0, 2**32, size=8, dtype=np.uint64),
    }
    for b, mname in ((64, "full"), (512, "full"), (64, "6-input"), (512, "random")):
        tables = words(rng.integers(0, 2**32, size=(b, 8), dtype=np.uint64))
        combos = torch.from_numpy(
            np.sort(rng.integers(0, b, size=(n, 5)), axis=1).astype(np.int32)
        ).to(dev)
        target = words(rng.integers(0, 2**32, size=8, dtype=np.uint64))
        mask = words(masks[mname])
        got = lut5_filter.lut5_filter_cells(tables, combos, target, mask)
        want = lut5_filter.lut5_filter_cells_plain(tables, combos, target, mask)
        r = compare(f"K3 lut5_filter_cells B={b} N={n} {mname} mask", got, want)
        k3["mismatches"] += r["mismatches"]
        k3["max_abs_err"] = max(k3["max_abs_err"], r["max_abs_err"])
        if (b, mname) == (64, "full"):
            run = lambda: lut5_filter.lut5_filter_cells(tables, combos, target, mask)  # noqa: E731
            k3.update(
                ms=time_ms(run, 30),
                device_ms=kernel_device_ms(run, "lut5_filter_kernel"),
                plain_ms=time_ms(
                    lambda: lut5_filter.lut5_filter_cells_plain(tables, combos, target, mask), 5
                ),
                shape=f"N={n} B={b}",
                **attribution().filter_cost(n, b),
            )
    out["lut5_filter"] = k3

    # K1/K2 single tiles (on no search path): real pair-cell operands of a
    # G = 200 state, one mid-space tile per production shape.
    st = random_state(200, 7)
    target = rng.integers(0, 2**32, size=8, dtype=np.uint64).astype(np.uint32)
    mask = np.full(8, 0xFFFFFFFF, np.uint32)
    tables = words(np.pad(st.live_tables(), ((0, 512 - 200), (0, 0))))
    for tl, th in ((256, 512), (512, 512)):
        ops_ = PivotOperands(200, tl, th, [], tables, target, mask, dev)
        d = ops_.descs[len(ops_.descs) // 2]
        m, lo0, hi0 = int(d[0]), int(d[1]), int(d[3])
        l1 = ops_.lc1[:, lo0 : lo0 + tl]
        l0 = ops_.lc0[:, lo0 : lo0 + tl]
        hcs = ops_.hc[:, hi0 : hi0 + th]
        pm = tables[m]
        pmw = torch.stack([~pm, pm])
        pmb = pivot_tile.expand_lanes(pm)
        pmsel = torch.stack([1 - pmb, pmb])
        lhs1 = (pivot_tile.expand_lanes(l1)[None] * pmsel[:, None, None, :]).contiguous()
        lhs0 = (pivot_tile.expand_lanes(l0)[None] * pmsel[:, None, None, :]).contiguous()
        rhsb = pivot_tile.expand_lanes(hcs).contiguous()
        runs = {
            "tile": (lambda: pivot_tile.pivot_constraints(l1, l0, hcs, pmw),
                     lambda: pivot_tile.pivot_constraints_plain(l1, l0, hcs, pmw),
                     "K1 pivot_constraints", "pivot_packed_kernel"),
            "pre_tile": (lambda: pivot_tile.pivot_constraints_pre(lhs1, lhs0, rhsb),
                         lambda: pivot_tile.pivot_constraints_pre_plain(lhs1, lhs0, rhsb),
                         "K2 pivot_constraints_pre", "pivot_pre_kernel"),
        }
        got = {}
        for key, (kern, plain, label, kname) in runs.items():
            got[key] = kern()
            compare(f"{label} {tl}x{th}", got[key], plain())
            if (tl, th) == (512, 512):
                ms = time_ms(kern, 50)
                dms = kernel_device_ms(kern, kname)
                log(f"  {label} (single tile, on no search path) {tl}x{th}: "
                    f"{ms:.4f} ms per call (device {dms})")
        compare(f"K1 vs K2 {tl}x{th}", got["tile"], got["pre_tile"])
    out["pivot_window"] = parity_window(dev, tables, target, mask, "packed")
    out["pivot_pre"] = parity_window(dev, tables, target, mask, "pre")
    out["walsh_score"] = parity_walsh(dev, rng)
    out["circuit_eval"] = parity_circuit(dev)
    for name, r in out.items():
        dms = r["device_ms"]
        log(f"  {name}: {r['ms']:.4f} ms per wrapper call (kernel on the device "
            f"{'not in the trace' if dms is None else f'{dms:.4f} ms'}), "
            f"plain {r['plain_ms']:.3f} ms at {r['shape']}")
    return out


WINDOWS = {
    # backend: (window kernel, its plain version, label, kernel name)
    "packed": ("pivot_window", "pivot_window_plain", "K1 pivot_window",
               "pivot_window_kernel"),
    "pre": ("pivot_pre_window", "pivot_pre_window_plain", "K2 pivot_pre_window",
            "pivot_pre_kernel"),
}


def parity_window(dev, tables, target, mask, backend) -> dict:
    """The window kernel of ``backend`` (K1 or K2 as the pivot sweep runs
    them) against its plain version at both of the sweep's tile shapes:
    256 x 512 on the G = 99 state and planted target of phase 4a (the shape
    of the g99 resumes and of phase 4b's G = 99 sweep; windows from tile
    100, which hold tile 113's feasible candidate) and 512 x 512 on the
    G = 200 state of the single-tile parity (``tables``, ``target``,
    ``mask``; windows from its middle tile).  At each: one tile, a full
    window of 64 tiles and a window crossing the end of the descriptors
    (its last 54 tiles past t_end); timed per launch at 64 tiles (the
    sweep's full window) and 1 (its first window).  The row is the 64-tile
    window at 512 x 512; for K2, ``gemm_only_ms`` times torch._int_mm on
    one tile's operands beside it."""
    import numpy as np
    import torch

    from sboxgates_tpu_torch.core import ttable as tt
    from sboxgates_tpu_torch.ops import pivot_tile, sweeps
    from sboxgates_tpu_torch.search.lut import PivotOperands

    kname, pname, label, kernel = WINDOWS[backend]
    kern, plain = getattr(pivot_tile, kname), getattr(pivot_tile, pname)
    st99 = random_state(99, 11)
    states = {
        (256, 512): (99, sweeps.as_words(
            np.pad(st99.live_tables(), ((0, 512 - 99), (0, 0))), dev),
            tt.target_table(planted_sbox(st99), 0), tt.mask_table(8), 100),
        (512, 512): (200, tables, target, mask, None),
    }
    r = {"mismatches": 0, "max_abs_err": 0}
    timed = {}
    for (tl, th), (g, tabs, tgt, msk, t_first) in states.items():
        ops = PivotOperands(g, tl, th, [], tabs, tgt, msk, dev, backend=backend)
        descs = torch.from_numpy(ops.descs).to(dev)
        t_real = ops.t_real
        mid = t_real // 2 if t_first is None else t_first
        args = (*ops.stream_args()[:6], descs)
        feasible = 0
        for t0, n in ((mid, 1), (mid, 64), (t_real - 10, 64)):
            got = kern(*args, t0, n, t_real, tl, th)
            want = plain(*args, t0, n, t_real, tl, th)
            c = compare(f"{label} G={g} {tl}x{th} tiles [{t0}, {t0 + n}) "
                        f"of {t_real} ({int(want[3].sum())} feasible)", got, want)
            feasible += int(want[3].sum())
            r["mismatches"] += c["mismatches"]
            r["max_abs_err"] = max(r["max_abs_err"], c["max_abs_err"])
        if t_first is not None and not feasible:
            raise AssertionError(f"{label} G={g}: the compared windows "
                                 "hold no feasible candidate")
        for n in (64, 1):
            run = lambda n=n: kern(*args, mid, n, t_real, tl, th)  # noqa: E731
            t = dict(
                ms=time_ms(run, 20 if n > 1 else 50),
                device_ms=kernel_device_ms(run, kernel),
                plain_ms=time_ms(lambda n=n: plain(*args, mid, n, t_real, tl, th),
                                 1, warmup=1),
                shape=f"{n} tiles of {tl}x{th} (G={g})", tiles=n,
                **attribution().window_cost(n, tl, th, backend),
            )
            timed[(tl, th, n)] = t
            dms = t["device_ms"]
            b_ms, b_by, b_form = bound(t)
            log(f"  {label} G={g}, {n} tiles of {tl}x{th}: {t['ms']:.4f} ms "
                f"per launch, {t['ms'] / n:.5f} ms per tile (device "
                f"{'not in the trace' if dms is None else f'{dms / n:.5f} ms'} per "
                f"tile), bound {b_ms / n:.5f} ms per tile by {b_by} ({b_form})")
        if backend == "pre" and (tl, th) == (512, 512):
            r["gemm_only_ms"] = gemm_only_ms(ops, int(ops.descs[mid][0]),
                                             int(ops.descs[mid][1]),
                                             int(ops.descs[mid][3]), tl, th)
    r.update(timed.pop((512, 512, 64)))
    r["also"] = [timed[(512, 512, 1)], timed[(256, 512, 64)], timed[(256, 512, 1)]]
    return r


def gemm_only_ms(ops, m: int, lo0: int, hi0: int, tl: int, th: int):
    """The yardstick beside K2: torch._int_mm on one tile's operands
    concatenated into one product, A int8 [2 req x 2 s x 4 j x tl, 256] (the
    polarity folded in) and H int8 [256, 4 th]: the count matrix only,
    int32 [16 tl, 4 th] written out, no > 0 and no packing.  The port never
    calls it.  Milliseconds per call (CUDA events)."""
    import torch

    from sboxgates_tpu_torch.ops import pivot_tile

    l1, l0, hc = ops.lanes
    pmb = pivot_tile.expand_lanes(ops.tables[m])
    pmsel = torch.stack([1 - pmb, pmb])[:, None, None, :]
    a = torch.stack([l1[None, :, lo0 : lo0 + tl] * pmsel,
                     l0[None, :, lo0 : lo0 + tl] * pmsel]).reshape(-1, 256).contiguous()
    h = hc[:, hi0 : hi0 + th].reshape(4 * th, 256).contiguous().t()
    ms = time_ms(lambda: torch._int_mm(a, h), 20)
    log(f"  gemm_only (torch._int_mm, [{a.shape[0]}, 256] x [256, {h.shape[1]}], "
        f"{4 * a.shape[0] * h.shape[1] / 2**20:.0f} MB of int32 counts): "
        f"{ms:.4f} ms per tile")
    return ms


def parity_walsh(dev, rng) -> dict:
    """K5 against its plain version at the search's table buckets and a
    large B = 2^20, on three spectra: a target's, a random int32 one and an
    extreme one (every entry +-(2^31 - 1)), which exercise the wrapping
    sums and the floor division of negative sums; timed at B = 512 (the
    path's shape), B = 64 and, labelled as such, B = 2^20 where the bound
    means something."""
    import numpy as np
    import torch

    from sboxgates_tpu_torch.ops import spectral, sweeps

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    words = lambda a: sweeps.as_words(a, dev)  # noqa: E731
    r = {"mismatches": 0, "max_abs_err": 0}
    timed = {}
    for b in (64, 512, 1 << 20):
        tables = words(rng.integers(0, 2**32, size=(b, 8), dtype=np.uint64))
        specs = {
            "target": spectral.target_spectrum(
                words(rng.integers(0, 2**32, size=8, dtype=np.uint64)),
                words(rng.integers(0, 2**32, size=8, dtype=np.uint64)),
            ),
            "random": torch.from_numpy(
                rng.integers(-2**31, 2**31, size=256).astype("int32")).to(dev),
            "extreme": torch.from_numpy(
                (rng.choice([-1, 1], size=256) * (2**31 - 1)).astype("int32")).to(dev),
        }
        for sname, spec in specs.items():
            got = spectral.gate_scores_kernel(tables, spec)
            want = spectral.gate_scores_plain(tables, spec)
            c = compare(f"K5 walsh_score B={b} {sname} spectrum", [got], [want])
            r["mismatches"] += c["mismatches"]
            r["max_abs_err"] = max(r["max_abs_err"], c["max_abs_err"])
        spec = specs["target"]
        run = lambda: spectral.gate_scores_kernel(tables, spec)  # noqa: E731
        timed[b] = dict(
            ms=time_ms(run, 50),
            device_ms=kernel_device_ms(run, "walsh_score_kernel"),
            plain_ms=time_ms(lambda: spectral.gate_scores_plain(tables, spec), 5),
            shape=f"B={b}" + (" (large B, off the path)" if b > 512 else ""),
            **attribution().walsh_cost(b, sms),
        )
    r.update(timed[512])
    r["also"] = [timed[64], timed[1 << 20]]
    return r


def circuit_cost(st, w: int) -> dict:
    """K4's bytes and operations (``attribution.circuit_cost``) over ``w``
    words of the circuit ``st``: its inputs, its outputs and the
    instructions of its lowered program."""
    from sboxgates_tpu_torch.codegen import cuda_kernel, output_bits

    prog, _, _ = cuda_kernel.pack_program(st)
    return attribution().circuit_cost(st.num_inputs, len(output_bits(st)),
                                      len(prog), w)


def parity_circuit(dev) -> dict:
    """K4 against its plain version on every examples/*.xml and on a
    G = 200, 8-output mixed state, at W = 2 (all 2^6 inputs of a 6-input
    S-box) and W = 2^22 + 13; timed at W = 2^22 on
    examples/des_s1_bit0_lut_best.xml and on the mixed state."""
    import torch

    from sboxgates_tpu_torch.codegen import compile_circuit, compile_cuda, cuda_kernel
    from sboxgates_tpu_torch.graph.xmlio import load_state

    gen = torch.Generator(device=dev)
    gen.manual_seed(4)
    circuits = [(os.path.basename(p), load_state(p)) for p in EXAMPLES]
    circuits.append(("mixed G=200", mixed_state()))
    r = {"mismatches": 0, "max_abs_err": 0}
    for name, st in circuits:
        fn, plain = compile_cuda(st, dev), compile_circuit(st)
        for w in (2, (1 << 22) + 13):
            x = torch.randint(-2**31, 2**31, (st.num_inputs, w), dtype=torch.int32,
                              device=dev, generator=gen)
            c = compare(f"K4 circuit_eval {name} W={w}", [fn(x)], [plain(x)],
                        quiet=True)
            r["mismatches"] += c["mismatches"]
            r["max_abs_err"] = max(r["max_abs_err"], c["max_abs_err"])
    log(f"  K4 circuit_eval: {len(circuits)} circuits x 2 widths, "
        f"{r['mismatches']} differing words")
    timed = {}
    for name, st in (("des_s1_bit0_lut_best", load_state(os.path.join(
            ROOT, "examples", "des_s1_bit0_lut_best.xml"))), ("mixed G=200", circuits[-1][1])):
        w = 1 << 22
        x = torch.randint(-2**31, 2**31, (st.num_inputs, w), dtype=torch.int32,
                          device=dev, generator=gen)
        fn, plain = compile_cuda(st, dev), compile_circuit(st)
        prog, _, n_slots = cuda_kernel.pack_program(st)
        threads, smem = cuda_kernel.block_shape(len(prog), n_slots)
        log(f"  K4 {name}: {st.num_gates - st.num_inputs} gates, {len(prog)} "
            f"instructions over {n_slots} slots, {threads} threads x 4 words "
            f"per block, {smem} B of shared memory")
        timed[name] = dict(
            ms=time_ms(lambda: fn(x), 30),
            device_ms=kernel_device_ms(lambda: fn(x), "circuit_eval_kernel"),
            plain_ms=time_ms(lambda: plain(x), 3),
            shape=f"{name} ({st.num_gates} gates) W=2^22",
            **circuit_cost(st, w),
        )
    r.update(timed["des_s1_bit0_lut_best"])
    r["also"] = [timed["mixed G=200"]]
    return r


@contextlib.contextmanager
def native_route(on: bool):
    """The port's CLI reads ``SBG_DISABLE_NATIVE`` on every call: unset, every
    node runs on the native host runtime (the default route); set, every
    node runs on the device sweeps (the route of the native-off golden
    files)."""
    old = os.environ.pop("SBG_DISABLE_NATIVE", None)
    if not on:
        os.environ["SBG_DISABLE_NATIVE"] = "1"
    try:
        yield
    finally:
        os.environ.pop("SBG_DISABLE_NATIVE", None)
        if old is not None:
            os.environ["SBG_DISABLE_NATIVE"] = old


class NodeLimit(Exception):
    """Ends a profiled run after its first nodes (``counting_calls``)."""


@contextlib.contextmanager
def counting_calls(cls, method: str, limit=None):
    """Counts the calls of ``cls.method`` (and records the instances of
    ``cls`` created) while the block runs: yields a dict with ``calls`` and
    ``instances``.  With ``limit``, the call after the first ``limit``
    raises NodeLimit."""
    seen = {"calls": 0, "instances": []}
    real, real_init = getattr(cls, method), cls.__init__

    def wrapped(self, *a, **kw):
        if limit is not None and seen["calls"] >= limit:
            raise NodeLimit
        seen["calls"] += 1
        return real(self, *a, **kw)

    def init(self, *a, **kw):
        real_init(self, *a, **kw)
        seen["instances"].append(self)

    setattr(cls, method, wrapped)
    cls.__init__ = init
    try:
        yield seen
    finally:
        setattr(cls, method, real)
        cls.__init__ = real_init


@contextlib.contextmanager
def timing_calls(groups):
    """Wall seconds spent in the functions of each group while the block
    runs: ``groups`` maps a name to ``(owner, attribute)`` pairs; yields a
    dict of name -> ``[seconds, calls]``.  Only a group's outermost calls
    count (a timed function called by another of its group counts once)."""
    spent = {g: [0.0, 0] for g in groups}
    depth = {g: 0 for g in groups}
    saved = []

    def timed(group, real):
        def wrapper(*a, **kw):
            depth[group] += 1
            t0 = time.perf_counter()
            try:
                return real(*a, **kw)
            finally:
                depth[group] -= 1
                if depth[group] == 0:
                    spent[group][0] += time.perf_counter() - t0
                    spent[group][1] += 1
        return wrapper

    for group, targets in groups.items():
        for owner, attr in targets:
            real = getattr(owner, attr)
            saved.append((owner, attr, real))
            setattr(owner, attr, timed(group, real))
    try:
        yield spent
    finally:
        for owner, attr, real in reversed(saved):
            setattr(owner, attr, real)


JOURNAL_FILES = ("search.journal.jsonl", "search.journal.json")
JOURNAL_GOLDEN = os.path.join(GOLDEN, "journal")


def _journal_timed():
    """The journal's writes, timed in every CLI run: its appends (each
    record's fsync and every snapshot) and its atomic rewrites (the
    truncate at start, the tail rewrite at resume)."""
    from sboxgates_tpu_torch.resilience import journal

    return {"journal": [(journal.SearchJournal, "append"),
                        (journal, "durable_write_text")]}


def _telemetry_timed():
    """The telemetry's work on the CLI's own thread, timed in every CLI run:
    the heartbeat's truncation, start line and stop (final line,
    metrics.json), the /status endpoint's start and shutdown, and the trace
    export."""
    from sboxgates_tpu_torch.telemetry import heartbeat, status, trace

    return {"telemetry": [(heartbeat.Heartbeat, "__init__"),
                          (heartbeat.Heartbeat, "start"),
                          (heartbeat.Heartbeat, "stop"),
                          (status.StatusServer, "__init__"),
                          (status.StatusServer, "shutdown"),
                          (trace.Tracer, "export")]}


# What an explicit --output-dir holds beside the XML files and the journal,
# as in the JAX CLI: the heartbeat and the end-of-run snapshot.
TELEMETRY_FILES = ("metrics.json", "telemetry.jsonl")


def flight_reasons(d: str) -> list:
    """The reasons of the flight-recorder dumps in ``d``, in dump order."""
    names = sorted((n for n in os.listdir(d) if n.startswith("flight-")),
                   key=lambda n: int(n.rsplit("-", 1)[1].split(".")[0]))
    out = []
    for n in names:
        with open(os.path.join(d, n), encoding="utf-8") as f:
            out.append(json.load(f)["reason"])
    return out


def heartbeat_kinds(d: str) -> list:
    with open(os.path.join(d, "telemetry.jsonl"), encoding="utf-8") as f:
        return [json.loads(line)["kind"] for line in f if line.strip()]
# The golden journals name their inputs by absolute path, the checkout's
# root written as this mark (tests/torch_journal_goldens.py).
ROOT_MARK = "@ROOT@"


def check_run_dir(label: str, d: str, journal: str, xml_goldens=None,
                  extra=()) -> list:
    """The files of a CLI run's output directory: its XML files, its
    journal, the telemetry files and the names in ``extra`` (the trace, the
    flight dumps), the JAX CLI's names for the same command, and nothing
    else.  The journal must be the JAX CLI's for the same command, byte for
    byte (GOLDEN/journal/<journal>/, the mark replaced by this checkout's
    root), and so must every XML file when ``xml_goldens`` (a directory) is
    given.  Returns the XML paths."""
    names = sorted(os.listdir(d))
    xmls = [n for n in names if n.endswith(".xml")]
    want_rest = sorted(JOURNAL_FILES + TELEMETRY_FILES + tuple(extra))
    if sorted(set(names) - set(xmls)) != want_rest:
        raise AssertionError(f"{label}: {d} holds {names}: expected the XML "
                             f"files and {want_rest}")
    want = {}
    for n in JOURNAL_FILES:
        with open(os.path.join(JOURNAL_GOLDEN, journal, n), encoding="utf-8") as f:
            want[n] = f.read().replace(ROOT_MARK, ROOT).encode("utf-8")
    if xml_goldens is not None:
        gx = sorted(n for n in os.listdir(xml_goldens) if n.endswith(".xml"))
        if gx != xmls:
            raise AssertionError(f"{label}: wrote {xmls}, the JAX CLI {gx}")
        for n in gx:
            with open(os.path.join(xml_goldens, n), "rb") as f:
                want[n] = f.read()
    for n, data in want.items():
        with open(os.path.join(d, n), "rb") as f:
            if f.read() != data:
                raise AssertionError(f"{label}: {n} differs from the JAX CLI's")
    return [os.path.join(d, n) for n in xmls]


def run_cli(dev, label: str, argv, box: str, golden: str, outdir: str,
            native: bool = False, verbose: bool = True, journal: str = None,
            extra=(), faults_spec: str = None, extra_names=()):
    """``python -m sboxgates_tpu_torch <argv> [-v -v] <extra> --output-dir
    <dir>`` in process, on ``dev``, on the native route or
    (``native=False``) the device route, with the fault sites of
    ``faults_spec`` (``SBG_FAULTS`` grammar) armed: one state file; every
    output gate in it is checked against the S-box ``box``, its bytes
    against ``golden`` (the file the JAX CLI writes for the same command,
    route and faults), and the directory by :func:`check_run_dir` against
    the journal golden ``journal`` (default: the label's last word), the
    directory also holding ``extra_names``.  Returns the state file's path,
    the run's counters (its search context's stats, the ``-v -v`` line's)
    with ``gate_step`` calls added, the run's standard error as ``stderr``
    and the seconds in the journal's writes, the device probe and the
    telemetry's work, and its wall seconds."""
    from sboxgates_tpu_torch import cli
    from sboxgates_tpu_torch.core import ttable as tt
    from sboxgates_tpu_torch.graph.xmlio import load_state
    from sboxgates_tpu_torch.search.context import SearchContext
    from sboxgates_tpu_torch.utils.sbox import load_sbox

    d = os.path.join(outdir, label.split()[-1])
    os.makedirs(d)
    buf, err = io.StringIO(), io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(err), \
            native_route(native), armed(faults_spec), \
            counting_calls(SearchContext, "gate_step") as seen, \
            timing_calls(_journal_timed() | _telemetry_timed()
                         | {"probe": [(cli, "_probe_device")]}) as spent:
        rc = cli.main([*argv, *(["-v", "-v"] if verbose else []), *extra,
                       "--device", dev.type, "--output-dir", d, box])
    wall = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"{label} exited {rc}: {err.getvalue()[-2000:]}")
    stats = {k: int(v) for k, v in seen["instances"][-1].stats.items()}
    stats["gate_step_calls"] = seen["calls"]
    stats["stderr"] = err.getvalue()
    stats["journal_s"], stats["journal_writes"] = spent["journal"]
    stats["probe_s"] = spent["probe"][0]
    stats["telemetry_s"] = spent["telemetry"][0]
    names = [os.path.basename(p) for p in
             check_run_dir(label, d, journal or label.split()[-1],
                           extra=extra_names)]
    if len(names) != 1:
        raise AssertionError(f"{label}: expected one state file, found {names}")
    path = os.path.join(d, names[0])
    st = load_state(path)
    sbox, n_in = load_sbox(box)
    for bit, gid in enumerate(st.outputs):
        if gid != 0xFFFF and not bool(tt.eq_mask(
                st.table(gid), tt.target_table(sbox, bit), tt.mask_table(n_in))):
            raise AssertionError(f"{label}: output {bit} gate {gid} misses the S-box")
    with open(path, "rb") as f, open(golden, "rb") as g:
        same = f.read() == g.read()
    log(f"{label}: {names[0]} in {wall:.2f} s "
        f"({'native' if native else 'device'} route), "
        f"{st.num_gates - st.num_inputs} gates, outputs verified, XML "
        f"{'byte-identical to' if same else 'DIFFERS from'} the golden file, "
        "journal byte-identical to the JAX CLI's; "
        f"{1e3 * stats['journal_s']:.3f} ms in {stats['journal_writes']} journal "
        f"writes, {1e3 * stats['probe_s']:.3f} ms in the device probe, "
        f"{1e3 * stats['telemetry_s']:.3f} ms in the telemetry")
    if not same:
        raise AssertionError(f"{label}: XML differs from {golden}")
    return path, stats, wall


@contextlib.contextmanager
def armed(spec):
    """The fault sites of ``spec`` (``SBG_FAULTS`` grammar) armed while the
    block runs, every site disarmed (and its hits reset) after it."""
    from sboxgates_tpu_torch.resilience import faults

    faults.disarm()
    for site, s in faults.parse_spec(spec or "").items():
        faults.arm(site, s.action, f"{s.first}{'' if s.once else '+'}")
    try:
        yield
    finally:
        faults.disarm()


# Phases 3-10 pin the serial mux: they hold the single-lane kernels' launch
# counts and the engine service's path, which the concurrent mux (the card's
# default, phase 11) changes.  Their journals are the JAX CLI's with the same
# flag.
SERIAL_MUX = ["--serial-mux"]
DES_ARGV = ["-l", "-o", "0", "--seed", "1", *SERIAL_MUX]
DES_BOX = os.path.join(ROOT, "sboxes", "des_s1.txt")
G99_ARGV = ["-l", "-o", "0", "--seed", "1", *SERIAL_MUX, "-g",
            os.path.join(GOLDEN, "rijndael_g99_state.xml")]
G99_BOX = os.path.join(GOLDEN, "rijndael_planted_bit0.txt")
# A G = 22 state (planted7_state) resumed against an S-box whose output bit
# 0 is a planted 7-LUT of its gates (planted7_sbox): the head misses, and
# the 7-LUT stage A sweeps C(22,7) = 170544 ranks in 6 stream chunks.
G22_ARGV = ["-l", "-o", "0", "--seed", "1", *SERIAL_MUX, "-g",
            os.path.join(GOLDEN, "rijndael_g22_state.xml")]
G22_BOX = os.path.join(GOLDEN, "rijndael_planted7_bit0.txt")
VV = ["-v", "-v"]
CRASH_ARGV = ["-l", "-o", "0", "-i", "2", "--seed", "1", *SERIAL_MUX]
CRASH_SPEC = "ckpt.write:crash@2"
HANG_TIMEOUT = ["--dispatch-timeout", "2"]


def phase_main_path(dev, outdir: str):
    """``-l -o 0 --seed 1 sboxes/des_s1.txt``: the golden file
    tests/data/torch_golden/des_s1_l_o0_seed1.xml."""
    return run_cli(dev, "phase 3 main path des_s1", DES_ARGV, DES_BOX,
                   os.path.join(GOLDEN, "des_s1_l_o0_seed1.xml"), outdir)


def planted_sbox(st, gates=(90, 91, 92, 93, 94)):
    """sboxes/rijndael.txt with output bit 0 replaced by the planted 5-LUT
    0xB4(0x2D(a, b, c), d, e) over the gates ``gates`` of ``st``."""
    import numpy as np

    from sboxgates_tpu_torch.core import ttable as tt
    from sboxgates_tpu_torch.utils.sbox import load_sbox

    a, b, c, d, e = gates
    outer = tt.eval_lut(0x2D, st.table(a), st.table(b), st.table(c))
    target = tt.eval_lut(0xB4, outer, st.table(d), st.table(e))
    sbox, _ = load_sbox(os.path.join(ROOT, "sboxes", "rijndael.txt"))
    return (sbox & 0xFE) | tt.to_bits(target).astype(np.uint8)


def planted7_state(g: int = 22):
    """8-input state grown to ``g`` gates with seeded AND/OR/XOR/A_AND_NOT_B
    gates (the construction of the JAX package's tests/planted.py
    build_planted_lut7)."""
    import numpy as np

    from sboxgates_tpu_torch.core import boolfunc as bf
    from sboxgates_tpu_torch.graph.state import GATES, State

    rng = np.random.default_rng(3)
    st = State.init_inputs(8)
    funs = [bf.AND, bf.OR, bf.XOR, bf.A_AND_NOT_B]
    while st.num_gates < g:
        a, b = rng.choice(st.num_gates, size=2, replace=False)
        st.add_gate(funs[rng.integers(len(funs))], int(a), int(b), GATES)
    return st


def planted7_sbox(st):
    """sboxes/rijndael.txt with output bit 0 replaced by the planted 7-LUT
    0xCA(0x96(g9, g12, g17), 0xE8(g10, g15, g21), g19) of ``st``."""
    import numpy as np

    from sboxgates_tpu_torch.core import ttable as tt
    from sboxgates_tpu_torch.utils.sbox import load_sbox

    outer = tt.eval_lut(0x96, st.table(9), st.table(12), st.table(17))
    middle = tt.eval_lut(0xE8, st.table(10), st.table(15), st.table(21))
    target = tt.eval_lut(0xCA, outer, middle, st.table(19))
    sbox, _ = load_sbox(os.path.join(ROOT, "sboxes", "rijndael.txt"))
    return (sbox & 0xFE) | tt.to_bits(target).astype(np.uint8)


def phase_resume_pivot(dev, backend: str, outdir: str):
    """``-l -o 0 --seed 1 --pivot-backend <backend> -g <state> <sbox>``: the
    CLI resumes from a saved G = 99 state (random_state(99, 11)) against an
    S-box whose output bit 0 is a planted 5-LUT of its gates
    (planted_sbox).  The node head finds no gate or 3-LUT, and the pivot
    sweep finds a 5-LUT.  The XML must be the file the JAX CLI writes for
    the same command with its native runtime off, whichever tile kernel
    ran."""
    return run_cli(
        dev, f"phase 4a resume G=99 g99_{backend}",
        G99_ARGV + ["--pivot-backend", backend], G99_BOX,
        os.path.join(GOLDEN, "rijndael_planted_l_o0_seed1_g99.xml"), outdir,
        journal="g99",
    )


def phase_spectral(dev, name: str, outdir: str):
    """A CLI run with ``--candidate-order spectral`` (phase 5): the XML is
    the JAX CLI's for the same command, and the score tiers reordered at
    least one stream (``order_tier_dispatches`` > 0) where SPECTRAL_RUNS
    says they must, none where it says they cannot."""
    argv, box, golden, ordered = SPECTRAL_RUNS[name]
    path, stats, wall = run_cli(dev, f"phase 5 spectral {name}", argv, box, golden,
                                outdir)
    log(f"  {name} stats: order_tier_dispatches="
        f"{stats.get('order_tier_dispatches', 0)} order_first_hit_tier="
        f"{stats.get('order_first_hit_tier', 0)} lut5_candidates="
        f"{stats.get('lut5_candidates', 0)} lut7_candidates="
        f"{stats.get('lut7_candidates', 0)}")
    if (stats.get("order_tier_dispatches", 0) > 0) != ordered:
        raise AssertionError(f"{name}: ordered dispatches "
                             f"{stats.get('order_tier_dispatches', 0)}, expected "
                             f"{'some' if ordered else 'none'}")
    return path, stats, wall


def phase_codegen(dev, written) -> None:
    """Phase 6: ``eval_sbox`` on the card (K4) for every examples/*.xml and
    every state file of ``written`` [(path, sbox path)], against the S-box
    bits of the outputs each circuit has; then ``-c`` and ``-d`` on a LUT
    and a gate circuit against the JAX CLI's text."""
    import numpy as np

    from sboxgates_tpu_torch import cli
    from sboxgates_tpu_torch.codegen import eval_sbox
    from sboxgates_tpu_torch.graph.xmlio import load_state
    from sboxgates_tpu_torch.utils.sbox import load_sbox

    def sbox_of(path):
        box = "_".join(os.path.basename(path).split("_")[:2])
        return os.path.join(ROOT, "sboxes", box + ".txt")

    circuits = [(p, sbox_of(p)) for p in EXAMPLES] + list(written)
    for path, box in circuits:
        st = load_state(path)
        sbox, n = load_sbox(box)
        bits = sum(1 << b for b in range(8) if st.outputs[b] != 0xFFFF)
        got = eval_sbox(st, dev)
        if not np.array_equal(got & bits, sbox[: 1 << n] & bits):
            raise AssertionError(f"eval_sbox on the card: {path} misses {box}")
    log(f"phase 6 codegen: eval_sbox on the card reproduced the S-box bits of "
        f"{len(circuits)} circuits ({len(written)} written by the CLI runs)")
    for flag, name, golden in (
        ("-c", "des_s1_bit0_lut_best", "des_s1_bit0_lut_best.cu"),
        ("-d", "des_s1_bit0_lut_best", "des_s1_bit0_lut_best.dot"),
        ("-c", "des_s1_bit0_17gates", "des_s1_bit0_17gates.c"),
        ("-d", "des_s1_bit0_17gates", "des_s1_bit0_17gates.dot"),
    ):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main([flag, os.path.join(ROOT, "examples", name + ".xml")])
        with open(os.path.join(GOLDEN, golden)) as f:
            same = rc == 0 and buf.getvalue() == f.read()
        log(f"  {flag} {name}: {'identical to' if same else 'DIFFERS from'} {golden}")
        if not same:
            raise AssertionError(f"{flag} {name} differs from the JAX CLI's text")


def phase_pivot(dev) -> dict:
    import numpy as np
    import torch

    from sboxgates_tpu_torch.core import ttable as tt
    from sboxgates_tpu_torch.ops import pivot_tile, sweeps
    from sboxgates_tpu_torch.search import Options, SearchContext
    from sboxgates_tpu_torch.search.lut import (
        PivotOperands,
        _lut5_search_pivot,
        pivot_tile_shape,
    )

    rates = {}
    mask = tt.mask_table(8)
    for g in (99, 200):
        st = random_state(g, 11)
        rng = np.random.default_rng(g)
        target = rng.integers(0, 2**32, size=8, dtype=np.uint64).astype(np.uint32)
        ctx = SearchContext(Options(seed=1, lut_graph=True, device=dev.type))
        tiles = sweeps.pivot_tile_descs(g, *pivot_tile_shape(g), []).shape[0]
        zero_pivot_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = _lut5_search_pivot(ctx, st, target, mask, [])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        windows = pivot_tile.launches["packed"]
        swept = pivot_tile.tiles["packed"]
        solved = pivot_tile.tiles["solved"]
        cand = ctx.stats["lut5_candidates"]
        if res is not None:
            raise AssertionError(f"G={g}: a random target decomposed")
        if cand != math.comb(g, 5):
            raise AssertionError(f"G={g}: swept {cand} of C({g},5) candidates")
        if swept < tiles:
            raise AssertionError(f"G={g}: K1 swept {swept} of {tiles} tiles")
        # The sweep alone: the same stream over operands built beforehand
        # (the node's wall above includes building them).
        tl, th = pivot_tile_shape(g)
        ops = PivotOperands(g, tl, th, [], ctx.device_tables(st), target, mask, dev)
        jw, jm = ctx.lut5_tabs()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        v = sweeps.lut5_pivot_stream(*ops.stream_args(), 0, ops.t_real, jw, jm, 1,
                                     tl=tl, th=th)
        torch.cuda.synchronize()
        sweep = time.perf_counter() - t1
        if int(v[0]) != 0 or int(v[8]) != tiles:
            raise AssertionError(f"G={g}: the sweep alone returned {v.tolist()}")
        # Its busy share from one run: the same sweep again under the
        # profiler, its device time in that trace over that run's wall.
        def sweep_to(t_end):
            return sweeps.lut5_pivot_stream(*ops.stream_args(), 0, t_end, jw, jm, 1,
                                            tl=tl, th=th)

        events, prof_us, _ = profiled(lambda: counted(sweep_to, ops.t_real),
                                      lambda: sweep_to(min(200, ops.t_real)))
        busy_us, _ = device_summary(
            events, f"phase 4b profile G={g}, the whole sweep alone", prof_us, top=3)
        traced_windows(events)
        # The same sweep alone on the pre backend (K2 windows over the lanes
        # expanded once), after a warm-up over the first 200 tiles.
        pre = PivotOperands(g, tl, th, [], ctx.device_tables(st), target, mask, dev,
                            backend="pre")
        sweeps.lut5_pivot_stream(*pre.stream_args(), 0, min(200, pre.t_real), jw, jm,
                                 1, tl=tl, th=th, backend="pre")
        zero_pivot_counts()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        v = sweeps.lut5_pivot_stream(*pre.stream_args(), 0, pre.t_real, jw, jm, 1,
                                     tl=tl, th=th, backend="pre")
        torch.cuda.synchronize()
        sweep_pre = time.perf_counter() - t2
        if int(v[0]) != 0 or int(v[8]) != tiles or pivot_tile.tiles["pre"] < tiles:
            raise AssertionError(f"G={g}: the pre sweep returned {v.tolist()} over "
                                 f"{pivot_tile.tiles['pre']} tiles")
        log(f"phase 4b pivot sweep G={g} alone, pre (K2): {cand} candidates in "
            f"{sweep_pre:.4f} s = {cand / sweep_pre:.4e} cand/s, "
            f"{sweep_pre / tiles * 1e3:.5f} ms per tile, "
            f"{pivot_tile.launches['pre']} windows; packed alone "
            f"{cand / sweep:.4e} cand/s")
        rates[g] = {"candidates": cand, "seconds": wall, "cand_per_s": cand / wall,
                    "sweep_seconds": sweep, "sweep_cand_per_s": cand / sweep,
                    "sweep_busy": busy_us / prof_us,
                    "sweep_pre_seconds": sweep_pre,
                    "sweep_pre_cand_per_s": cand / sweep_pre,
                    "tiles": tiles, "windows": windows, "tiles_swept": swept,
                    "tiles_solved": solved}
        log(f"phase 4b pivot sweep G={g} (packed): {cand} candidates in "
            f"{wall:.3f} s = {cand / wall:.4e} cand/s, no hit (as expected); "
            f"{tiles} tiles in {windows} windows ({swept} tiles swept, "
            f"{swept - tiles} of them overflow re-drives), {solved} tiles solved "
            f"({100 * solved / tiles:.2f}%), {wall / tiles * 1e3:.5f} ms per tile, "
            f"{wall / windows * 1e3:.4f} ms per window; the sweep alone "
            f"{sweep:.4f} s = {cand / sweep:.4e} cand/s, "
            f"{sweep / tiles * 1e3:.5f} ms per tile")
    return rates


def phase_profile_sweep(dev, tiles: int = 400) -> None:
    """torch.profiler window over ``tiles`` tiles of phase 4b's
    G = 200 sweep: the device's busy share of the profiled run's wall,
    device operations per tile and the device time by kernel."""
    import numpy as np

    from sboxgates_tpu_torch.ops import pivot_tile, sweeps
    from sboxgates_tpu_torch.search import Options, SearchContext
    from sboxgates_tpu_torch.search.lut import PivotOperands, pivot_tile_shape

    g = 200
    st = random_state(g, 11)
    target = np.random.default_rng(g).integers(
        0, 2**32, size=8, dtype=np.uint64).astype(np.uint32)
    mask = np.full(8, 0xFFFFFFFF, np.uint32)
    ctx = SearchContext(Options(seed=1, lut_graph=True, device=dev.type))
    tl, th = pivot_tile_shape(g)
    ops = PivotOperands(g, tl, th, [], ctx.device_tables(st), target, mask, dev)
    jw, jm = ctx.lut5_tabs()

    def window(t0, t1):
        return sweeps.lut5_pivot_stream(
            *ops.stream_args(), t0, t1, jw, jm, 12345, tl=tl, th=th)

    # The warm-up sweeps up to a full window, so the window buffers come
    # from the caching allocator as they do from the second pivot node of a
    # search.
    window(0, 200)
    events, wall_us, v = profiled(lambda: counted(window, 200, 200 + tiles),
                                  lambda: window(0, 200))
    if int(v[0]) != 0:
        raise AssertionError("profiled window found a hit on a random target")
    busy, nops = device_summary(events, f"phase 4c profile G={g}, {tiles} tiles",
                                wall_us)
    traced_windows(events)
    log(f"  {pivot_tile.launches['packed']} windows, {pivot_tile.tiles['packed']} "
        f"tiles swept, {pivot_tile.tiles['solved']} solved; "
        f"{nops / tiles:.3f} device operations per tile, "
        f"{wall_us / 1e3 / tiles:.5f} ms of profiled wall per tile")


def zero_pivot_counts() -> None:
    from sboxgates_tpu_torch.ops import pivot_tile

    pivot_tile.launches.update(packed=0, pre=0, tile=0, pre_tile=0, lanes=0)
    pivot_tile.tiles.update(packed=0, pre=0, lanes=0, solved=0)
    pivot_tile.shard_launches.clear()


def counted(fn, *args):
    """``fn(*args)`` with the pivot launch and tile counts set to 0 just
    before it."""
    zero_pivot_counts()
    return fn(*args)


def traced_windows(events) -> None:
    """Raises unless the trace holds one window kernel per window launched
    since the counts were last set to 0: a busy share from a trace that
    lost device operations would read low."""
    from sboxgates_tpu_torch.ops import pivot_tile

    windows = pivot_tile.launches["packed"]
    got = sum(e.count for e in events if "pivot_window_kernel" in e.key
              and _device_us(e) > 0)
    log(f"  the trace holds {got} window kernels of {windows} windows run")
    if got != windows:
        raise AssertionError(f"the trace holds {got} window kernels, not {windows}")


def device_summary(events, label: str, wall_us: float, top: int = 8):
    """Logs a profiler window's device busy share and its ``top`` device
    operations by time; returns (busy microseconds, device operations).
    The profiler's step span (``ProfilerStep#``) is on the device's
    timeline too, but it is the measured step itself, not an operation."""
    from torch.autograd import DeviceType

    rows = sorted(
        ((e.key, _device_us(e), e.count) for e in events
         if e.device_type == DeviceType.CUDA and _device_us(e) > 0
         and not e.key.startswith("ProfilerStep")),
        key=lambda r: -r[1],
    )
    busy = sum(r[1] for r in rows)
    nops = sum(r[2] for r in rows)
    log(f"{label}: wall {wall_us / 1e3:.2f} ms, device busy {busy / 1e3:.2f} ms "
        f"({100 * busy / wall_us:.1f}%), {nops} device operations")
    for key, us, count in rows[:top]:
        log(f"  {us / 1e3:9.3f} ms {count:6d}x  {key[:90]}")
    return busy, nops


def profile_cli(dev, outdir: str, label: str, argv, box: str, native: bool,
                max_nodes=None):
    """torch.profiler window around one CLI run (not a counted path), or
    around its first ``max_nodes`` gate-mode node heads: the device's busy
    share, the host's synchronising CUDA calls (counted as the warnings of
    ``torch.cuda.set_sync_debug_mode("warn")``) and the top eight device
    operations.  Returns (busy us, device operations, device operations
    that are kernels, syncs, wall us, node heads run)."""
    import warnings

    import torch

    from sboxgates_tpu_torch import cli
    from sboxgates_tpu_torch.search.context import SearchContext

    d = os.path.join(outdir, label.split()[-1] + "_profile")
    os.makedirs(d)
    seen = {}

    def run():
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with contextlib.redirect_stdout(io.StringIO()), native_route(native), \
                    counting_calls(SearchContext, "gate_step", max_nodes) as calls:
                seen.update(calls=calls)
                try:
                    return cli.main([*argv, "--device", dev.type, "--output-dir", d,
                                     box])
                except NodeLimit:
                    return 0
        finally:
            torch.cuda.set_sync_debug_mode(0)

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        events, wall_us, rc = profiled(
            run, lambda: torch.ones(1 << 20, device=dev).cumsum(0))
    if rc != 0:
        raise AssertionError(f"profiled {label} run exited {rc}")
    syncs = sum(1 for w in caught if "synchroniz" in str(w.message))
    busy, nops = device_summary(events, label, wall_us)
    kernels = device_kernels(events)
    log(f"  {syncs} synchronising CUDA calls on the host, "
        f"{wall_us / 1e3 / max(syncs, 1):.4f} ms of wall per sync; "
        f"{kernels} of the device operations are kernels")
    return busy, nops, kernels, syncs, wall_us, seen["calls"]["calls"]


def device_kernels(events) -> int:
    """Kernels in a profiler window: device operations other than copies,
    fills and the profiler's step span."""
    from torch.autograd import DeviceType

    return sum(
        e.count for e in events
        if e.device_type == DeviceType.CUDA and _device_us(e) > 0
        and not e.key.startswith(("ProfilerStep", "Memcpy", "Memset"))
    )


def phase_profile_des(dev, outdir: str) -> None:
    """Phase 3b: a profiled second DES S1 run of phase 3's command on the
    device route."""
    profile_cli(dev, outdir, "phase 3b profile des_s1", DES_ARGV, DES_BOX,
                native=False)


GATE_GOLDEN = os.path.join(GOLDEN, "gate")
GATE_ARGV = ["-o", "0", "--seed", "1", *SERIAL_MUX]
PROFILED_NODES = 300


def phase_gate_device(dev, outdir: str):
    """Phase 7a: gate mode on the device route, ``SBG_DISABLE_NATIVE=1
    -o 0 --seed 1 sboxes/des_s1.txt``: the JAX CLI's native-off file;
    wall, nodes and gate_step dispatches, then a profiled second run
    (device operations, host syncs per node, busy share)."""
    path, stats, wall = run_cli(
        dev, "phase 7a gate mode device route gate_off", GATE_ARGV, DES_BOX,
        os.path.join(GATE_GOLDEN, "des_off", "1-021-0197-0-7d4eef05.xml"),
        outdir, native=False)
    nodes = stats.get("python_nodes", 0)
    if stats["gate_step_calls"] != nodes or nodes == 0:
        raise AssertionError(f"7a: {stats['gate_step_calls']} gate_step calls over "
                             f"{nodes} nodes")
    log(f"  7a: wall {wall:.3f} s, {nodes} nodes, {stats['gate_step_calls']} "
        f"gate_step dispatches, {wall / nodes * 1e3:.3f} ms per node; "
        f"pair_candidates={stats.get('pair_candidates', 0)} "
        f"triple_candidates={stats.get('triple_candidates', 0)}")
    # The whole second run holds millions of device operations, more than a
    # trace can take in the time limit: the profile covers its first
    # PROFILED_NODES node heads.
    busy, nops, kernels, syncs, wall_us, heads = profile_cli(
        dev, outdir, "phase 7a profile gate_off", GATE_ARGV, DES_BOX, native=False,
        max_nodes=PROFILED_NODES)
    log(f"  7a profile over the first {heads} nodes of a second run: {nops} device "
        f"operations ({nops / heads:.1f} per node), {syncs / heads:.2f} host syncs "
        f"per node, {wall_us / 1e3 / heads:.3f} ms of profiled wall per node, busy "
        f"{100 * busy / wall_us:.1f}% of {wall_us / 1e6:.3f} s")
    return path, stats, wall


def phase_gate_native(dev, outdir: str):
    """Phase 7b: the same command on the native route (the default): the
    JAX CLI's default file; wall and engine nodes, then a profiled second
    run that must launch no CUDA kernel."""
    path, stats, wall = run_cli(
        dev, "phase 7b gate mode native route gate_native", GATE_ARGV, DES_BOX,
        os.path.join(GATE_GOLDEN, "des_native", "1-020-0185-0-8a96f192.xml"),
        outdir, native=True)
    if stats.get("python_nodes", 0) or not stats.get("engine_nodes", 0):
        raise AssertionError(f"7b: not run by the native engine: {stats}")
    log(f"  7b: wall {wall:.3f} s, {stats['engine_nodes']} engine nodes")
    kernels = profile_cli(
        dev, outdir, "phase 7b profile gate_native", GATE_ARGV, DES_BOX,
        native=True)[2]
    if kernels:
        raise AssertionError(f"7b: the native route launched {kernels} kernels")
    return path, stats, wall


def phase_lut_native(dev, outdir: str, device_wall: float):
    """Phase 7c: ``-l -o 0 --seed 1 sboxes/des_s1.txt`` on the default
    route: the JAX CLI's default file, its wall beside phase 3's (the
    device route's)."""
    path, stats, wall = run_cli(
        dev, "phase 7c LUT mode default route des_l_native", DES_ARGV, DES_BOX,
        os.path.join(GATE_GOLDEN, "des_l_native", "1-011-0000-0-fa23f056.xml"),
        outdir, native=True, verbose=False)
    log(f"  7c: wall {wall:.3f} s on the native route against {device_wall:.3f} s "
        f"on the device route (phase 3); engine nodes "
        f"{stats.get('engine_nodes', 0)}, engine device-work requests "
        f"{stats.get('engine_devcalls', 0)}")
    return path, stats, wall


def phase_engine_service(dev, outdir: str):
    """Phase 7d: the G = 99 resume of phase 4a without ``-v`` on the default
    route: the LUT engine hands the pivot-sized node to the device service
    once (K1's windows), and the file is the golden one."""
    path, stats, wall = run_cli(
        dev, "phase 7d engine continuation g99_native", G99_ARGV, G99_BOX,
        os.path.join(GOLDEN, "rijndael_planted_l_o0_seed1_g99.xml"), outdir,
        native=True, verbose=False)
    if stats.get("engine_devcalls") != 1 or stats.get("python_nodes", 0):
        raise AssertionError(f"7d: expected one engine device-work request: {stats}")
    if stats.get("lut5_candidates") != G99_CANDIDATES:
        raise AssertionError(f"7d: {stats.get('lut5_candidates')} 5-LUT candidates")
    log(f"  7d: wall {wall:.3f} s, engine_devcalls 1, {G99_CANDIDATES} candidates")
    return path, stats, wall


JOURNAL_COST_RUNS = 5


def phase_journal_cost(dev, outdir: str) -> dict:
    """Phase 9: what the journal costs on the default route.  7c's and 7d's
    commands JOURNAL_COST_RUNS more times each (every file and journal
    checked as there): each run's wall, its time in the journal's writes
    and in the device probe, and their medians."""
    cases = (
        ("des_l_native", DES_ARGV, DES_BOX,
         os.path.join(GATE_GOLDEN, "des_l_native", "1-011-0000-0-fa23f056.xml")),
        ("g99_native", G99_ARGV, G99_BOX,
         os.path.join(GOLDEN, "rijndael_planted_l_o0_seed1_g99.xml")),
    )
    out = {}
    for name, argv, box, golden in cases:
        rows = []
        for r in range(JOURNAL_COST_RUNS):
            _, st, wall = run_cli(
                dev, f"phase 9 journal cost {name}_{r}", argv, box, golden,
                outdir, native=True, verbose=False, journal=name)
            rows.append((wall, st["journal_s"], st["probe_s"],
                         st["journal_writes"], st["telemetry_s"]))
        wall, jour, probe, writes, tele = (statistics.median(c) for c in zip(*rows))
        out[name] = {"walls": [r[0] for r in rows], "wall": wall,
                     "journal_s": jour, "probe_s": probe, "telemetry_s": tele}
        log(f"  9 {name}: walls {[round(r[0], 4) for r in rows]} s; median "
            f"wall {wall:.4f} s, journal {1e3 * jour:.3f} ms in {writes:g} "
            f"writes, device probe {1e3 * probe:.3f} ms, telemetry (heartbeat "
            f"and metrics.json) {1e3 * tele:.3f} ms, wall less the three "
            f"{wall - jour - probe - tele:.4f} s")
    return out


TRACE_FLAGS = ["--trace", "--status-port", "0", "--metrics-interval", "0.05"]
# Phase 10's traced CLI runs: name -> (argv, S-box, golden, journal golden,
# native route, -v -v, the kernel whose launch times it checks, its launches
# (LEX_LAUNCHES), the bucket of its attribution row to print).
TRACED_RUNS = {
    "g99_native": (G99_ARGV, G99_BOX,
                   os.path.join(GOLDEN, "rijndael_planted_l_o0_seed1_g99.xml"),
                   "g99_native", True, False, "pivot_window", 8, None),
    "g99_packed": (G99_ARGV, G99_BOX,
                   os.path.join(GOLDEN, "rijndael_planted_l_o0_seed1_g99.xml"),
                   "g99", False, True, "pivot_window", 8, None),
    "des_s1": (DES_ARGV, DES_BOX, os.path.join(GOLDEN, "des_s1_l_o0_seed1.xml"),
               "des_s1", False, True, "lut5_filter", 132, "131072x64"),
}


@contextlib.contextmanager
def untimed_launches():
    """The kernel launch timing off: ``attribution.recording`` binds no
    timer (the baseline of the sync count, a run without telemetry)."""
    attr = attribution()
    real = attr.recording

    @contextlib.contextmanager
    def unbound(timer, gate=None):
        with real(None, gate) as launched:
            yield launched

    attr.recording = unbound
    try:
        yield
    finally:
        attr.recording = real


def count_syncs(dev, outdir: str, name: str, traced: bool) -> int:
    """Host syncs of one run of TRACED_RUNS[name] (``sync_guard`` in count
    mode: ``torch.cuda.set_sync_debug_mode("warn")``'s warnings): with
    every telemetry feature on, or with none (no flag, no explicit
    --output-dir, so no heartbeat, and the launch timing off); the files
    go to a directory of their own."""
    from sboxgates_tpu_torch import cli
    from sboxgates_tpu_torch.utils.guards import sync_guard

    argv, box, _, _, native, verbose, _, _, _ = TRACED_RUNS[name]
    d = tempfile.mkdtemp(prefix=f"syncs-{name}-", dir=outdir)
    flags = TRACE_FLAGS + ["--output-dir", d] if traced else []
    cwd = os.getcwd()
    os.chdir(d)  # the run without --output-dir writes into the cwd
    try:
        with contextlib.ExitStack() as stack:
            stack.enter_context(contextlib.redirect_stdout(io.StringIO()))
            stack.enter_context(native_route(native))
            if not traced:
                stack.enter_context(untimed_launches())
            rep = stack.enter_context(sync_guard(action="count", device=dev))
            rc = cli.main([*argv, *(VV if verbose else []), "--device", dev.type,
                           *flags, box])
    finally:
        os.chdir(cwd)
    if rc != 0:
        raise AssertionError(f"10 sync count {name}: exit {rc}")
    return rep


def phase_traced(dev, outdir: str, name: str, ref_wall=None) -> dict:
    """Phase 10a/10b: TRACED_RUNS[name] with ``--trace --status-port 0
    --metrics-interval 0.05``: the XML and the journal the goldens, the
    directory the JAX CLI's names plus trace.json; the trace's dispatch
    spans as many as metrics.json's device_dispatches; the kernel's launch
    times (``dispatch_latency_s[<kernel>/...]``) as many as its launches,
    each attribution row of it at most 105% of its bound (a time below the
    bound is a timing fault).  Prints the wall beside ``ref_wall``."""
    argv, box, golden, journal, native, verbose, kernel, launches, row_bucket = \
        TRACED_RUNS[name]
    path, stats, wall = run_cli(
        dev, f"phase 10 traced {name}", argv, box, golden, outdir, native=native,
        verbose=verbose, journal=journal, extra=TRACE_FLAGS,
        extra_names=("trace.json",))
    d = os.path.dirname(path)
    with open(os.path.join(d, "metrics.json"), encoding="utf-8") as f:
        metrics = json.load(f)
    with open(os.path.join(d, "trace.json"), encoding="utf-8") as f:
        events = json.load(f)["traceEvents"]
    spans = sum(1 for e in events
                if e.get("cat") == "dispatch" and e["name"].startswith("dispatch["))
    dispatches = metrics["counters"]["device_dispatches"]
    kinds = heartbeat_kinds(d)
    if spans != dispatches or not dispatches or kinds[0] != "start" or \
            kinds[-1] != "final":
        raise AssertionError(f"10 {name}: {spans} dispatch spans, "
                             f"device_dispatches {dispatches}, heartbeat {kinds}")
    prefix = f"dispatch_latency_s[{kernel}/"
    timed = sum(h["count"] for k, h in metrics["histograms"].items()
                if k.startswith(prefix))
    rows = [r for r in metrics["attribution"]["rows"] if r["kernel"] == kernel]
    worst = max(r.get("roofline_utilization", 0.0) for r in rows) if rows else None
    if timed != launches or metrics["attribution"]["backend"] != "gpu" or \
            worst is None or worst > 1.05:
        raise AssertionError(f"10 {name}: {timed} launch times of {kernel} "
                             f"(expected {launches}), rows {rows}")
    log(f"phase 10 traced {name}: wall {wall:.4f} s"
        + (f" (phase 9's median of the same command without the flags "
           f"{ref_wall:.4f} s)" if ref_wall is not None else "")
        + f", of it {1e3 * stats['telemetry_s']:.3f} ms in the telemetry; "
        f"{spans} dispatch spans = device_dispatches, {timed} {kernel} launch "
        f"times")
    for r in rows:
        mean = r.get("mean_dispatch_latency_s")
        log(f"  attribution {kernel}/{r['bucket']}: {r['dispatches']} launches, "
            f"{'-' if mean is None else f'{1e3 * mean:.5f}'} ms per launch "
            f"(CUDA events around the launch in its entry point: the kernel "
            f"plus the stream's start-up), bound {1e3 * r['bound_s']:.5f} ms by "
            f"{r['bound_by']} ({r['bound_formulation']}), the bound is "
            f"{100 * r.get('roofline_utilization', 0):.1f}% of that time, "
            f"{r.get('roofline', '-')}")
    row = next((r for r in rows if r["bucket"] == row_bucket), None)
    return {"wall": wall, "telemetry_s": stats["telemetry_s"], "spans": spans,
            "launch_times": timed, "rows": rows, "row": row}


def phase_traced_syncs(dev, outdir: str, name: str) -> dict:
    """Phase 10a's sync check: the host syncs of TRACED_RUNS[name] with
    every telemetry feature on equal those without telemetry."""
    reps = {t: count_syncs(dev, outdir, name, t) for t in (False, True)}
    syncs = {t: r.syncs for t, r in reps.items()}
    log(f"phase 10 syncs {name}: {syncs[True]} host syncs with the telemetry, "
        f"{syncs[False]} without")
    if syncs[True] != syncs[False]:
        for t, r in reps.items():
            log(f"  syncs {'with' if t else 'without'} the telemetry: {r.events}")
        raise AssertionError(f"10 {name}: the telemetry changed the host syncs")
    return syncs


def rand_gate_state(rng, num_inputs: int, extra: int):
    """A random gate state (the construction of tests/test_native.py): AND,
    OR and XOR gates and, one time in four, a NOT."""
    from sboxgates_tpu_torch.core import boolfunc as bf
    from sboxgates_tpu_torch.graph.state import GATES, State

    st = State.init_inputs(num_inputs)
    while st.num_gates < num_inputs + extra:
        a, b = rng.choice(st.num_gates, size=2, replace=False)
        if rng.integers(0, 4) == 0:
            st.add_not_gate(int(a), GATES)
        else:
            st.add_gate(int(rng.choice([bf.AND, bf.OR, bf.XOR])), int(a), int(b),
                        GATES)
    return st


def phase_gate_placement(dev, gs=(64, 200, 500)) -> dict:
    """Phase 7e: gate_step on the device and on the host at G = 64, 200 and
    500 (8-input random gate states, a random target: a miss, so the
    triple stream covers C(G, 3)); the same step verdict on both.  Each
    route takes one warm-up step at each G, then the median of 5.  Figures
    only: the placement sends every node to the host on the native route,
    and results do not depend on the route."""
    import numpy as np
    import torch

    from sboxgates_tpu_torch.core import ttable as tt
    from sboxgates_tpu_torch.search import Options, SearchContext

    rng = np.random.default_rng(230)
    mask = tt.mask_table(8)
    out = {}

    def median_ms(ctx, st, target):
        ctx.gate_step(st, target, mask)  # warm-up
        times = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            v = ctx.gate_step(st, target, mask)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return sorted(times)[2], v

    for g in gs:
        st = rand_gate_state(rng, 8, g - 8)
        target = rng.integers(0, 2**32, size=8, dtype=np.uint64).astype(np.uint32)
        dctx = SearchContext(Options(seed=1, device=dev.type, native=False))
        hctx = SearchContext(Options(seed=1, device=dev.type, native=True))
        dev_ms, vd = median_ms(dctx, st, target)
        host_ms, vh = median_ms(hctx, st, target)
        if vd[0] != vh[0]:
            raise AssertionError(f"7e G={g}: device step {vd} != host step {vh}")
        out[g] = {"device_ms": dev_ms, "host_ms": host_ms, "step": int(vd[0])}
        log(f"phase 7e gate_step G={g} (step {vd[0]}, C(G,3) = {math.comb(g, 3)} "
            f"triples): device {dev_ms:.3f} ms, host {host_ms:.3f} ms (each the "
            f"median of 5 after a warm-up), device/host {dev_ms / host_ms:.1f}x")
    return out


# Runs the port's CLI in a fresh process on argv[2] (JSON) from the
# checkout argv[1], then prints its K1/K3 launches and the counters of its
# search context (a crashed run prints nothing).
_CLI_PROCESS = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
from sboxgates_tpu_torch import cli
from sboxgates_tpu_torch.ops import lut5_filter, pivot_tile
from sboxgates_tpu_torch.search.context import SearchContext
made, init = [], SearchContext.__init__
def record(self, *a, **k):
    init(self, *a, **k)
    made.append(self)
SearchContext.__init__ = record
rc = cli.main(json.loads(sys.argv[2]))
print(json.dumps({"rc": rc, "lut5_filter": lut5_filter.launches,
                  "pivot_window": pivot_tile.launches["packed"],
                  "stats": {k: int(v) for k, v in made[-1].stats.items()}}))
sys.exit(rc)
"""


def cli_process(argv, env: dict, label: str):
    """The port's CLI in a fresh process (``_CLI_PROCESS``): (exit code,
    its launch counts and counters or None, wall seconds, output)."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-c", _CLI_PROCESS, ROOT, json.dumps(argv)],
        env=env, capture_output=True, text=True, timeout=600, cwd=ROOT,
    )
    wall = time.perf_counter() - t0
    lines = proc.stdout.strip().splitlines()
    out = None
    if lines and lines[-1].startswith("{"):
        out = json.loads(lines[-1])
    log(f"  {label}: exit {proc.returncode} in {wall:.2f} s")
    return proc.returncode, out, wall, proc.stdout + proc.stderr


def phase_crash_resume(dev, outdir: str) -> dict:
    """Phase 8a: a real crash on the card.  ``SBG_DISABLE_NATIVE=1 -l -o 0
    -i 2 --seed 1 sboxes/des_s1.txt`` in a fresh process with
    ``SBG_FAULTS=ckpt.write:crash@2`` must die with exit code 17 in the
    second iteration's checkpoint write; ``--resume-run`` in another
    process finishes it (K3 on the device route), and the directory must
    then hold the files the JAX CLI wrote for the same crash and resume:
    both XML files and the journal."""
    d = os.path.join(outdir, "crash_resume")
    env = dict(os.environ, SBG_DISABLE_NATIVE="1", SBG_FAULTS=CRASH_SPEC)
    rc, _, wall_crash, text = cli_process(
        [*CRASH_ARGV, "--device", dev.type, "--output-dir", d, DES_BOX], env,
        "phase 8a crash run")
    if rc != 17:
        raise AssertionError(f"8a: the crash run exited {rc}, not 17: {text[-2000:]}")
    left = sorted(os.listdir(d))
    if not any(n.startswith(".sbg-tmp-") for n in left):
        raise AssertionError(f"8a: the crash left no torn temp file: {left}")
    # Phase 10c: the crash dumped the flight recorder before its exit, and
    # the dump's incident hook wrote the heartbeat's last line.
    crash_dumps, crash_kinds = flight_reasons(d), heartbeat_kinds(d)
    if crash_dumps != ["injected_crash"] or crash_kinds[-1] != "incident:injected_crash":
        raise AssertionError(f"10c: the crash left dumps {crash_dumps} and "
                             f"heartbeat lines {crash_kinds}")
    log(f"phase 10c crash (8a): exit 17 after a flight dump {crash_dumps} "
        f"and the heartbeat line {crash_kinds[-1]!r}")
    env.pop("SBG_FAULTS")
    rc, out, wall, text = cli_process(
        ["--resume-run", d, "--device", dev.type], env, "phase 8a resume run")
    if rc != 0 or out is None:
        raise AssertionError(f"8a: the resume exited {rc}: {text[-2000:]}")
    check_run_dir("phase 8a crash_resume", d, "crash_resume",
                  xml_goldens=os.path.join(JOURNAL_GOLDEN, "crash_resume"),
                  extra=("flight-rank00-1.json",))
    st = out["stats"]
    if out["lut5_filter"] <= 0:
        raise AssertionError(f"8a: the resumed iteration launched no K3: {out}")
    log(f"phase 8a crash_resume: crash run {wall_crash:.3f} s (exit 17, left "
        f"{left}), resume {wall:.3f} s: K1 windows {out['pivot_window']}, K3 "
        f"launches {out['lut5_filter']}, deadline_breaches "
        f"{st.get('deadline_breaches', 0)}, dispatch_retries "
        f"{st.get('dispatch_retries', 0)}, circuit_breaker_trips "
        f"{st.get('circuit_breaker_trips', 0)}; both XML files and the journal "
        "byte-identical to the JAX CLI's")
    return {"lut5_filter": out["lut5_filter"], "pivot_window": out["pivot_window"],
            "wall": wall, "wall_crash": wall_crash}


# Phase 8b-8d: the G = 99 resume of 7d on the default route under a fault:
# (journal golden, XML golden, extra argv, SBG_FAULTS, the reasons of the
# flight-recorder dumps it leaves, in order).
G99_FAULTED = {
    "g99_hang1": ("g99_native",
                  os.path.join(GOLDEN, "rijndael_planted_l_o0_seed1_g99.xml"),
                  HANG_TIMEOUT, "dispatch.sweep:hang@1", []),
    "g99_hang_all": ("g99_hang_all", None, HANG_TIMEOUT, "dispatch.sweep:hang@1+",
                     ["deadline_exhausted", "circuit_breaker"]),
    "g99_devcb": ("g99_devcb", None, [], "native.devcb:raise@1", []),
}


def phase_g99_faulted(dev, outdir: str, name: str):
    """Phases 8b-8d: 7d's G = 99 resume on the default route with the
    faults of G99_FAULTED[name]; the file and the journal must be the JAX
    CLI's under the same spec, and the run must leave the flight dumps the
    entry names (phase 10c for 8c: the breaker's and the retry
    exhaustion's).  Returns run_cli's triple."""
    journal, golden, extra, spec, dumps = G99_FAULTED[name]
    if golden is None:
        d = os.path.join(JOURNAL_GOLDEN, journal)
        golden = os.path.join(d, [n for n in os.listdir(d) if n.endswith(".xml")][0])
    out = run_cli(dev, f"phase 8 {spec} {name}", G99_ARGV, G99_BOX, golden, outdir,
                  native=True, verbose=False, journal=journal, extra=extra,
                  faults_spec=spec,
                  extra_names=[f"flight-rank00-{i + 1}.json" for i in range(len(dumps))])
    d = os.path.dirname(out[0])
    got, kinds = flight_reasons(d), heartbeat_kinds(d)
    incidents = [k for k in kinds if k.startswith("incident:")]
    if got != dumps or incidents != [f"incident:{r}" for r in dumps] or \
            kinds[-1] != "final":
        raise AssertionError(f"{name}: flight dumps {got} and heartbeat lines "
                             f"{kinds}, expected the dumps {dumps}")
    if dumps:
        log(f"phase 10c {name}: flight dumps {got}, heartbeat incident lines "
            f"{incidents}, then the final line")
    return out


def fault_line(label: str, wall: float, counts: dict, stats: dict) -> None:
    log(f"{label}: wall {wall:.3f} s, K1 windows {counts['pivot_window']}, K3 "
        f"launches {counts['lut5_filter']}, deadline_breaches "
        f"{stats.get('deadline_breaches', 0)}, dispatch_retries "
        f"{stats.get('dispatch_retries', 0)}, circuit_breaker_trips "
        f"{stats.get('circuit_breaker_trips', 0)}, python_nodes "
        f"{stats.get('python_nodes', 0)}, engine_devcalls "
        f"{stats.get('engine_devcalls', 0)}")


# -------------------------------------------------------------------------
# Phase 11: the job axis
# -------------------------------------------------------------------------


def job_cases():
    """tests/torch_cli_helpers.py: the job-axis CLI cases and their JAX CLI
    goldens (tests/data/torch_golden/jobs/<case>/)."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import torch_cli_helpers

    return torch_cli_helpers


def lane_counts() -> dict:
    """The lane forms' launch counts (K3's, K1's and K1's tiles)."""
    from sboxgates_tpu_torch.ops import lut5_filter, pivot_tile

    return {"lut5_filter_lanes": lut5_filter.lane_launches,
            "pivot_window_lanes": pivot_tile.launches["lanes"],
            "pivot_window_lanes_tiles": pivot_tile.tiles["lanes"]}


def run_case(dev, label: str, case: str, outdir: str):
    """One job-axis CLI case in process on ``dev`` (``python -m
    sboxgates_tpu_torch <argv> --device cuda --output-dir <dir>`` with the
    case's environment): every file of the run directory held against the
    JAX CLI's for the same command, byte for byte (the XML in the per-box
    and pXX/ directories, the run and per-box journals), every output gate
    checked against its S-box.  Returns (wall seconds, metrics.json
    counters)."""
    from sboxgates_tpu_torch import cli

    h = job_cases()
    argv, env = h.golden_case(case)
    d = os.path.join(outdir, case)
    buf, err = io.StringIO(), io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(err), \
            h.environ(env):
        rc = cli.main([*argv, "--device", dev.type, "--output-dir", d])
    wall = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"{label} exited {rc}: {err.getvalue()[-2000:]}")
    h.compare_run(case, d)
    xmls = verify_outputs(d, argv)
    with open(os.path.join(d, "metrics.json"), encoding="utf-8") as f:
        counters = json.load(f)["counters"]
    log(f"{label}: {xmls} state files in {wall:.3f} s, every file "
        "byte-identical to the JAX CLI's, outputs verified; "
        f"device_dispatches {counters.get('device_dispatches', 0)}, "
        f"fleet_rounds {counters.get('fleet_rounds', 0)}, fleet_dispatches "
        f"{counters.get('fleet_dispatches', 0)}, fleet_lanes "
        f"{counters.get('fleet_lanes', 0)}, fleet_submits "
        f"{counters.get('fleet_submits', 0)}")
    return wall, counters


def verify_outputs(d: str, argv) -> int:
    """Every output gate of every state file under ``d`` against its S-box
    (the box of its subdirectory, the permutation for pXX/, else the
    run's).  Returns the number of state files."""
    from sboxgates_tpu_torch.core import ttable as tt
    from sboxgates_tpu_torch.graph.xmlio import load_state
    from sboxgates_tpu_torch.utils.sbox import load_sbox, permuted_box

    boxes = [a for a in argv if a.endswith(".txt")]
    n = 0
    for base, _, files in os.walk(d):
        sub = os.path.relpath(base, d)
        for f in files:
            if not f.endswith(".xml"):
                continue
            if sub == ".":
                sbox, n_in = load_sbox(boxes[-1])
            elif sub.startswith("p") and len(boxes) == 1:
                sbox, n_in = load_sbox(boxes[0])
                sbox = permuted_box(sbox, n_in, int(sub[1:], 16))
            else:
                sbox, n_in = load_sbox(next(b for b in boxes if os.path.basename(
                    b) == sub + ".txt"))
            st = load_state(os.path.join(base, f))
            for bit, gid in enumerate(st.outputs):
                if gid != 0xFFFF and not bool(tt.eq_mask(
                        st.table(gid), tt.target_table(sbox, bit),
                        tt.mask_table(n_in))):
                    raise AssertionError(f"{base}/{f}: output {bit} misses")
            n += 1
    return n


def lane_pivot_operands(dev, i: int):
    """PivotOperands of lane ``i`` of 11e's K1 check: G = 99 - i % 3 gates
    of ``random_state(g, 11 + i)`` (lane 0 is phase 4a's state), the
    planted 5-LUT over gates 90-94 as the target, every fourth lane with
    one excluded pivot gate."""
    import numpy as np

    from sboxgates_tpu_torch.core import ttable as tt
    from sboxgates_tpu_torch.ops import sweeps
    from sboxgates_tpu_torch.search.lut import PivotOperands

    g = 99 - i % 3
    st = random_state(g, 11 + i)
    tabs = sweeps.as_words(np.pad(st.live_tables(), ((0, 512 - g), (0, 0))), dev)
    excl = [2 + i % 7] if i % 4 == 3 else []
    return PivotOperands(g, 256, 512, excl, tabs,
                         tt.target_table(planted_sbox(st), 0), tt.mask_table(8), dev)


def planted_hits(dev, pivots) -> list:
    """The planted hit's tile of each lane's pivot sweep (single-lane
    sweeps on the card, seed 5 + lane)."""
    from sboxgates_tpu_torch.ops import sweeps

    _, w_tab, m_tab = sweeps.lut5_split_tables()
    jw, jm = sweeps.as_words(w_tab, dev), sweeps.as_words(m_tab, dev)
    return [int(sweeps.lut5_pivot_stream(
        *o.stream_args(), 0, o.t_real, jw, jm, 5 + i, tl=256, th=512)[8]) - 1
        for i, o in enumerate(pivots)]


def round_syncs(dev, pivots, hits) -> dict:
    """Host syncs of one lockstep round on the card, counted by
    ``utils.guards.sync_guard`` (CUDA's sync debug mode), for 1 lane and
    for 8: a 5-LUT stream of one chunk per lane (K3 and the solve of every
    lane; DES-bucket tables, G = 14-21, chunk 2^15), and a pivot stream of
    one window per lane at that lane's planted hit tile (K1 and one solve
    round).  The pivot window's counts are read behind an event, which the
    debug mode does not count."""
    import math

    import numpy as np
    import torch

    from sboxgates_tpu_torch.ops import sweeps
    from sboxgates_tpu_torch.utils.guards import sync_guard

    rng = np.random.default_rng(89)
    _, w_tab, m_tab = sweeps.lut5_split_tables()
    jw, jm = sweeps.as_words(w_tab, dev), sweeps.as_words(m_tab, dev)
    binom = sweeps.binom_device(dev)
    rows5 = []
    for i in range(8):
        g = 14 + i
        tabs = rng.integers(0, 2**32, size=(64, 8), dtype=np.uint64).astype(np.uint32)
        rows5.append((sweeps.as_words(tabs, dev), binom, g,
                      sweeps.as_words(tabs[0] ^ tabs[g - 1], dev),
                      sweeps.as_words(np.full(8, 0xFFFFFFFF, np.uint32), dev),
                      torch.full((8,), -1, dtype=torch.int32, device=dev), 0,
                      math.comb(g, 5), jw, jm, 3 + i))
    rowsp = [(*o.stream_args(), hit, hit + 1, jw, jm, 5 + i)
             for i, (o, hit) in enumerate(zip(pivots, hits))]
    out = {}
    for name, fn, rows in (
            ("lut5_stream", lambda r: sweeps.lut5_stream_lanes(r, chunk=1 << 15),
             rows5),
            ("lut5_pivot_stream", lambda r: sweeps.lut5_pivot_stream_lanes(
                r, tl=256, th=512), rowsp)):
        for lanes in (1, 8):
            fn(rows[:lanes])                       # warm: allocations, pinned
            with sync_guard(action="count", device=dev) as rep:
                fn(rows[:lanes])
            out[(name, lanes)] = rep.syncs
            log(f"  11e one merged round of {name}, {lanes} lane(s): "
                f"{rep.syncs} host sync(s) {rep.events}")
    if out[("lut5_stream", 1)] != 1 or out[("lut5_stream", 8)] != 1 or \
            out[("lut5_pivot_stream", 8)] != out[("lut5_pivot_stream", 1)]:
        raise AssertionError(f"11e: one merged round synced {out}")
    return out


def parity_lanes(dev) -> dict:
    """11e: K3's and K1's lane forms against their plain versions on the
    card, word for word, at 8 and 64 lanes, and per launch (CUDA events;
    device ms from torch.profiler) beside the same lanes as single-lane
    launches.  K3: N = 2^17 5-tuples per lane over 64-row tables (the
    stream chunk at the DES buckets), every lane its own tables, target and
    mask.  K1: 256 x 512 tiles of G = 97-99 planted states, lane 0 phase
    4a's, every lane its own state, target, exclusion and so pair cells,
    validity and descriptors (:func:`lane_pivot_operands`), at its own
    window (8 lanes x 8 tiles, 64 lanes x 1 tile), ragged: lanes cut by
    their t_end, done lanes (t0 = t_end) and two lanes at their planted
    hit's tile.  The bound counts the tiles
    the lanes sweep.  Then the host syncs of one merged round
    (:func:`round_syncs`)."""
    import numpy as np
    import torch

    from sboxgates_tpu_torch.core import ttable as tt
    from sboxgates_tpu_torch.ops import lut5_filter, pivot_tile, sweeps
    from sboxgates_tpu_torch.search.lut import PivotOperands

    rng = np.random.default_rng(88)
    out = {}
    attr = attribution()
    n, b = 1 << 17, 64
    for lanes in (8, 64):
        w = lambda shape: torch.from_numpy(  # noqa: E731
            rng.integers(0, 2**32, size=shape, dtype=np.uint64)
            .astype(np.uint32).view(np.int32)).to(dev)
        tables, target, mask = w((lanes, b, 8)), w((lanes, 8)), w((lanes, 8))
        mask[::3] = sweeps.as_words(tt.mask_table(6), dev)
        combos = torch.from_numpy(np.sort(
            rng.integers(0, b, size=(lanes, n, 5)), axis=2).astype(np.int32)).to(dev)
        args = (tables, combos, target, mask)
        r = compare(f"K3 lane form {lanes} lanes x N={n} B={b}",
                    lut5_filter.lut5_filter_cells_lanes(*args),
                    lut5_filter.lut5_filter_cells_lanes_plain(*args))
        run = lambda a=args: lut5_filter.lut5_filter_cells_lanes(*a)  # noqa: E731
        single = lambda a=args, k=lanes: [  # noqa: E731
            lut5_filter.lut5_filter_cells(*(x[i] for x in a)) for i in range(k)]
        r.update(
            ms=time_ms(run, 20),
            device_ms=kernel_device_ms(run, "lut5_filter_lanes_kernel", reps=10),
            single_ms=time_ms(single, 5),
            plain_ms=time_ms(lambda a=args: lut5_filter.lut5_filter_cells_lanes_plain(*a),
                             1, warmup=1),
            shape=f"{lanes} lanes x N={n} B={b}", lanes=lanes,
            **attr.lanes_cost(attr.filter_cost(n, b), lanes),
        )
        out[("lut5_filter_lanes", lanes)] = r

    tl, th = 256, 512
    planted = [lane_pivot_operands(dev, i) for i in range(64)]
    hits = planted_hits(dev, planted[:8])
    for lanes, width in ((8, 8), (64, 1)):
        ops = planted[:lanes]
        real = [o.t_real for o in ops]
        descs = torch.zeros((lanes, max(real), 5), dtype=torch.int32)
        for i, o in enumerate(ops):
            descs[i, : real[i]] = torch.from_numpy(o.descs)
        pad = lambda j, o=ops: sweeps._pad_rows(  # noqa: E731
            [x.stream_args()[j] for x in o], 1 if j < 4 else 0)
        args = (pad(0), pad(1), pad(2), pad(3), pad(4), pad(5), descs.to(dev))
        t0 = [(100 + 3 * i) % real[i] for i in range(lanes)]
        t_end = list(real)
        for i in range(0, lanes, 4):
            t_end[i] = min(real[i], t0[i] + max(1, width // 2))   # cut
        for i in range(1, lanes, 5):
            t0[i] = t_end[i]                                      # done
        for i in (2, 6):
            t0[i] = hits[i]                                       # a hit
        got = pivot_tile.pivot_window_lanes(*args, t0, width, t_end, tl, th)
        want = pivot_tile.pivot_window_lanes_plain(*args, t0, width, t_end, tl, th)
        r = compare(f"K1 lane form {lanes} lanes x {width} tiles of {tl}x{th} "
                    f"({int(want[3].sum())} feasible)", got, want)
        active = sum(max(0, min(width, e - s)) for s, e in zip(t0, t_end))
        run = lambda a=args, t0=t0, te=t_end, w_=width: pivot_tile.pivot_window_lanes(  # noqa: E731
            *a, t0, w_, te, tl, th)
        single = lambda a=args, k=lanes, w_=width, t0=t0, te=t_end: [  # noqa: E731
            pivot_tile.pivot_window(*(x[i] for x in a), t0[i], w_, te[i], tl, th)
            for i in range(k) if t0[i] < te[i]]
        r.update(
            ms=time_ms(run, 10),
            device_ms=kernel_device_ms(run, "pivot_window_lanes_kernel", reps=5),
            single_ms=time_ms(single, 3),
            plain_ms=time_ms(lambda a=args, t0=t0, te=t_end, w_=width:
                             pivot_tile.pivot_window_lanes_plain(
                                 *a, t0, w_, te, tl, th), 1, warmup=0),
            shape=f"{lanes} lanes x {width} tiles of {tl}x{th} (G=97-99, every "
                  f"lane its own state and target), {active} tiles swept",
            lanes=lanes, tiles=active,
            **attr.window_lanes_cost(active, lanes * width, tl, th),
        )
        out[("pivot_window_lanes", lanes)] = r
    for (name, lanes), r in out.items():
        b_ms, b_by, b_form = bound(r)
        dms = r["device_ms"]
        log(f"  11e {name} {r['shape']}: {r['ms']:.4f} ms per launch (device "
            f"{'not in the trace' if dms is None else f'{dms:.4f} ms'}), the "
            f"same lanes as single-lane launches {r['single_ms']:.4f} ms, plain "
            f"{r['plain_ms']:.3f} ms, bound {b_ms:.5f} ms by {b_by} ({b_form})")
    out["syncs"] = round_syncs(dev, planted[:8], hits)
    return out


#: Phase 11's CLI runs: (label, case of tests/torch_cli_helpers.py).
JOB_RUNS = (
    ("11a fleet", "fleet_des8_dev_lut_o0"),
    ("11a serial-jobs", "serial_des8_dev_lut_o0"),
    ("11b fleet default route", "fleet_des8_lut_o0"),
    ("11b batched default route", "mb_des8_lut_o0"),
    ("11c fleet permute sweep", "fleet_ps_des_s1_dev"),
    ("11d fleet G=99 restarts", "fleet_g99_i8_dev"),
    ("11f engine mux threads", "emt4_g99_mux"),
    ("11f concurrent mux", "mux_des_s1_dev"),
    ("11f serial mux", "serial_mux_des_s1_dev"),
    ("11f concurrent mux G=99 device route", "mux_g99_dev"),
    ("11f concurrent mux G=99 default route", "mux_g99_native"),
)


def phase_jobs(dev, on_path) -> dict:
    """Phase 11's CLI runs, each a counted path (launch counts zeroed just
    before it and read just after); returns {case: (counts, wall,
    counters)}."""
    outdir = tempfile.mkdtemp(prefix="chip_smoke-")
    out = {}
    try:
        for label, case in JOB_RUNS:
            box = {}
            counts = on_path(case, lambda lb=label, c=case: box.update(
                r=run_case(dev, f"phase {lb} {c}", c, outdir)))
            out[case] = (counts, *box["r"])
    finally:
        shutil.rmtree(outdir, ignore_errors=True)
    fleet, serial = out["fleet_des8_dev_lut_o0"], out["serial_des8_dev_lut_o0"]
    log(f"  11a: fleet {fleet[1]:.3f} s, {fleet[2].get('fleet_rounds')} merged "
        f"rounds for {fleet[2].get('fleet_submits')} submits, "
        f"{fleet[0]['lut5_filter_lanes']} K3 lane launches and "
        f"{fleet[0]['lut5_filter']} single-lane, "
        f"{fleet[2].get('device_dispatches')} device_dispatches; serial jobs "
        f"{serial[1]:.3f} s, {serial[0]['lut5_filter_lanes']} K3 lane launches "
        f"(the concurrent mux's merged heads) and {serial[0]['lut5_filter']} "
        f"single-lane, {serial[2].get('device_dispatches')} device_dispatches "
        "(a mux rendezvous group is not counted, as in the JAX package)")
    for case in ("fleet_des8_dev_lut_o0", "fleet_ps_des_s1_dev"):
        if out[case][0]["lut5_filter_lanes"] <= 0:
            raise AssertionError(f"{case}: K3's lane form never launched")
    if out["fleet_g99_i8_dev"][0]["pivot_window_lanes"] <= 0:
        raise AssertionError("fleet_g99_i8_dev: K1's lane form never launched")
    return out


# -------------------------------------------------------------------------
# Phase 12: chained rounds, the serve and the result store
# -------------------------------------------------------------------------


def round_goldens():
    """tests/torch_round_goldens.py: the chain and serve CLI cases and their
    JAX CLI goldens (tests/data/torch_golden/rounds|serve/<case>/)."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import torch_round_goldens

    return torch_round_goldens


@contextlib.contextmanager
def in_dir(d: str):
    prev = os.getcwd()
    os.makedirs(d, exist_ok=True)
    os.chdir(d)
    try:
        yield
    finally:
        os.chdir(prev)


def run_round_case(dev, label: str, case: str, outdir: str, extra=(),
                   n1=False, steps=None, tag=None):
    """The commands of one case of tests/torch_round_goldens.py in process
    on ``dev``, from their own directory (relative ``--output-dir D`` and
    ``--result-store S``), the last command's directory (and the store)
    held against the JAX CLI's files; ``extra`` is added to the last
    command.  ``n1`` runs a chain case at ``--chain-rounds 1`` against its
    N = 8 golden (:func:`_n1_golden`).  ``steps`` runs only those commands
    (in the directory ``tag`` names, shared by the steps of one case); the
    golden is checked after the last.  Returns (wall seconds of the last
    command run, its metrics.json, the seconds in round-driver windows and
    in host rounds)."""
    from sboxgates_tpu_torch import cli

    g = round_goldens()
    h = job_cases()
    _, cmds, store = g.CASES[case]
    tag = tag or label.replace(" ", "_").replace("=", "")
    cwd = os.path.join(outdir, tag)
    golden = g.golden_dir(case)
    if n1:
        argv, env, _ = cmds[0]
        i = argv.index("--chain-rounds")
        cmds = [(argv[: i + 1] + ["1"] + argv[i + 2:], env, None)]
        edited = os.path.join(outdir, tag + "_golden")
        for base, _, files in os.walk(golden):
            for f in files:
                src = os.path.join(base, f)
                dst = os.path.join(edited, os.path.relpath(src, golden))
                os.makedirs(os.path.dirname(dst), exist_ok=True)
                with open(src, "rb") as fi, open(dst, "wb") as fo:
                    fo.write(_n1_golden(f, fi.read()))
        golden = edited
    from sboxgates_tpu_torch.ops import sweeps
    from sboxgates_tpu_torch.search import rounds

    groups = {"windows": [(sweeps, "round_driver_lanes")],
              "host_rounds": [(rounds._ChainLane, "host_round")]}
    steps = range(len(cmds)) if steps is None else steps
    with in_dir(cwd):
        for i in steps:
            argv, env, _ = cmds[i]
            last = i == len(cmds) - 1
            d = "D" if last else f"D{i}"
            buf, err = io.StringIO(), io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf), \
                    contextlib.redirect_stderr(err), h.environ(env), \
                    timing_calls(groups) as spent:
                rc = cli.main([*argv, *(extra if last else ()), "--device",
                               dev.type, "--output-dir", d])
            wall = time.perf_counter() - t0
            if rc != 0:
                raise AssertionError(f"{label} exited {rc}: "
                                     f"{err.getvalue()[-2000:]}")
        if not last:
            log(f"{label}: {wall:.3f} s")
            return wall, None, spent
        g.compare_dir(golden, "D", "S" if store else None)
        if "--serve" in argv:
            xmls = sum(verify_outputs(os.path.join("D", j), [b])
                       for j, b in serve_jobs(argv))
        else:
            xmls = verify_outputs("D", argv)
        with open(os.path.join("D", "metrics.json"), encoding="utf-8") as f:
            snap = json.load(f)
    counters = snap["counters"]
    log(f"{label}: {xmls} state files in {wall:.3f} s, every file "
        "byte-identical to the JAX CLI's, outputs verified; device_dispatches "
        f"{counters.get('device_dispatches', 0)}, round_driver_rounds "
        f"{counters.get('round_driver_rounds', 0)}, round_driver_fallbacks "
        f"{counters.get('round_driver_fallbacks', 0)}, fleet_dispatches "
        f"{counters.get('fleet_dispatches', 0)}, serve_merged_dispatches "
        f"{counters.get('serve_merged_dispatches', 0)}, store_hits "
        f"{counters.get('store_hits', 0)}; {spent['windows'][1]} round-driver "
        f"windows {spent['windows'][0]:.3f} s, {spent['host_rounds'][1]} host "
        f"rounds {spent['host_rounds'][0]:.3f} s (summed over the serve's "
        "lanes)")
    return wall, snap, spent


def serve_jobs(argv):
    """(job directory, S-box) of each job of a serve command, the CLI's
    job ids."""
    boxes = [a for a in argv if a.endswith(".txt")]
    return [(f"job{i:02d}-{os.path.splitext(os.path.basename(b))[0]}", b)
            for i, b in enumerate(boxes)]


def chain_window_syncs(dev) -> dict:
    """12a: one round-driver window on the card, the planted chain's first
    8 rounds from the bare inputs (rounds 0-4 finish on the device, round 5
    freezes): its host syncs counted by ``utils.guards.sync_guard`` (CUDA's
    sync debug mode) and its K3 launches, per round and per window."""
    import numpy as np
    import torch

    from sboxgates_tpu_torch.core import ttable as tt
    from sboxgates_tpu_torch.graph.state import State
    from sboxgates_tpu_torch.ops import lut5_filter, sweeps
    from sboxgates_tpu_torch.search import context as C
    from sboxgates_tpu_torch.utils.guards import sync_guard
    from sboxgates_tpu_torch.utils.sbox import load_sbox

    g = round_goldens()
    sbox, n_in = load_sbox(g.planted_path())
    st = State.init_inputs(n_in)
    rb = 8
    pad = np.zeros((64, 8), np.uint32)
    pad[: st.num_gates] = st.live_tables()
    targets = np.stack([tt.target_table(sbox, b) for b in range(8)])
    masks = np.stack([tt.mask_table(n_in)] * 8)
    seeds = np.arange(1, 9, dtype=np.int32) * 7919
    dcs = np.arange(8, dtype=np.int32) * 37
    splits, w_tab, m_tab = sweeps.lut5_split_tables()
    w = lambda a: sweeps.as_words(a, dev)  # noqa: E731
    args = (w(pad), sweeps.binom_device(dev), st.num_gates, w(targets),
            w(masks), torch.full((8,), -1, dtype=torch.int32, device=dev),
            seeds, dcs, rb, C.PIVOT_MIN_TOTAL, splits, w(w_tab), w(m_tab))
    statics = dict(chunk3=C.STREAM_CHUNK[3], chunk5=C.STREAM_CHUNK[5],
                   has5=True, max_rounds=rb, solve_rows=C.LUT5_HEAD_SOLVE_ROWS)
    want = sweeps.round_driver(*(a.cpu() if hasattr(a, "cpu") else a
                                 for a in args), **statics)
    sweeps.round_driver(*args, **statics)              # warm: allocations
    lut5_filter.launches = 0
    with sync_guard(action="count", device=dev) as rep:
        hits = sweeps.round_driver(*args, **statics)
    k3 = lut5_filter.launches
    if not np.array_equal(hits, want):
        raise AssertionError(f"12a: the round driver on the card differs from "
                             f"its CPU run:\n{hits}\n{want}")
    done = int(hits[rb, 0])
    run = done + (1 if done < rb else 0)
    out = {"rounds_done": done, "rounds_run": run, "syncs": rep.syncs,
           "syncs_per_round": rep.syncs / run, "k3": k3,
           "kinds": [int(k) for k in hits[:run, 0]]}
    log(f"  12a one round-driver window of {rb} rounds on the planted chain: "
        f"{done} rounds done on the card (kinds {out['kinds']}), "
        f"{rep.syncs} host syncs = {out['syncs_per_round']:.2f} per round run "
        f"(the JAX driver: 1 per window), {k3} K3 launches in the window; "
        "equal to its CPU run")
    return out


def _n1_golden(rel: str, data: bytes) -> bytes:
    """The N = 8 golden as the N = 1 run's: only the journal's recorded
    chain_rounds differs (the JAX package's window-split invariance, held
    against its N = 1 and N = 4 goldens in tests/test_torch_rounds.py)."""
    if "journal" in rel:
        return data.replace(b'"chain_rounds": 8', b'"chain_rounds": 1')
    return data


#: Phase 12's CLI runs: (label, case, extra argv of its last command,
#: whether it runs at N = 1 against the case's N = 8 golden, the commands
#: it runs (None: all), whether only ``--rounds`` runs it).  The DES-8
#: serve on the device route (K3's lane form under merged waves; 72 s
#: merged and 146 s not on the card) is the ``--rounds`` mode's only.
ROUND_RUNS = (
    ("12a DES S1 chain N=8", "des_s1_n8", (), False, None, False),
    ("12a DES S1 chain N=1", "des_s1_n8", (), True, None, False),
    ("12a DES S1 chain N=8 device route", "des_s1_n8_dev", (), False, None,
     False),
    ("12a DES S1 chain N=1 device route", "des_s1_n8_dev", (), True, None,
     False),
    ("12b DES-8 serve merged", "serve_des8_o0", (), False, None, False),
    ("12b DES-8 serve no-merge", "serve_des8_o0", ("--serve-no-merge",),
     False, None, False),
    ("12b chained serve merged", "serve_chain8_dev", (), False, None, False),
    ("12b chained serve no-merge", "serve_chain8_dev", ("--serve-no-merge",),
     False, None, False),
    ("12b DES-8 serve merged device route", "serve_des8_o0_dev", (), False,
     None, True),
    ("12b DES-8 serve no-merge device route", "serve_des8_o0_dev",
     ("--serve-no-merge",), False, None, True),
    ("12c result-store fill", "serve_chain8_store", (), False, [0], False),
    ("12c result-store re-serve", "serve_chain8_store", (), False, [1], False),
)


def phase_rounds(dev, on_path, extended=False) -> dict:
    """Phase 12: the chained rounds (12a: DES S1 as one chain of N = 8 and
    N = 1 on both routes, one window's host syncs), the serve (12b: DES-8
    and a chained serve, each merged and with --serve-no-merge), the result
    store (12c: a re-serve answered from the store with no kernel launch)
    and a SIGTERM drain (12d), each CLI run a counted path held against the
    JAX CLI's files.  ``extended`` adds the runs only ``--rounds`` makes."""
    out = {"window": chain_window_syncs(dev)}
    outdir = tempfile.mkdtemp(prefix="chip_smoke-")
    try:
        for label, case, extra, n1, steps, ext in ROUND_RUNS:
            if ext and not extended:
                continue
            box = {}
            tag = case if steps is not None else None
            counts = on_path(label, lambda lb=label, c=case, e=extra, n=n1,
                             st=steps, t=tag: box.update(
                                 r=run_round_case(dev, lb, c, outdir, e, n, st,
                                                  t)))
            out[label] = (counts, *box["r"])
        out["12d"] = phase_serve_drain(dev, outdir)
    finally:
        shutil.rmtree(outdir, ignore_errors=True)
    kernel_counts = ("lut5_filter", "lut5_filter_lanes", "pivot_window",
                     "pivot_window_lanes", "pivot_pre", "walsh_score",
                     "circuit_eval")
    for label, val in out.items():
        if not label.startswith("12") or label == "12d" or val[2] is None:
            continue
        counts, wall, snap, spent = val
        c = snap["counters"]
        if label.startswith("12c"):
            if any(counts[k] for k in kernel_counts) or \
                    c.get("device_dispatches", 0) or c.get("store_hits") != 8:
                raise AssertionError(f"12c: the re-serve launched {counts}, "
                                     f"{c.get('device_dispatches')} dispatches, "
                                     f"{c.get('store_hits')} store hits")
            q = snap["histograms"]["store_get_s"]
            log(f"  12c: 8 store hits, no kernel launch, no device dispatch; "
                f"lookup latency {1e3 * q['total'] / q['count']:.3f} ms mean "
                f"(max {1e3 * q['max']:.3f} ms) over {q['count']} lookups, the "
                f"whole re-serve {wall:.3f} s")
        elif label.startswith("12b"):
            log(f"  {label}: {8 / wall:.3f} jobs/s, K3 lane-form launches "
                f"{counts['lut5_filter_lanes']}, single-lane "
                f"{counts['lut5_filter']}, merged dispatches "
                f"{c.get('serve_merged_dispatches', 0)}")
        else:
            hist = snap["histograms"].get("rounds_per_dispatch", {})
            log(f"  {label}: {hist.get('count', 0)} round_driver windows, "
                f"{c.get('round_driver_rounds', 0)} rounds on the card, "
                f"{c.get('round_driver_fallbacks', 0)} host rounds, K3 "
                f"launches {counts['lut5_filter']}")
    for kind in ("chained serve", "DES-8 serve"):
        for suffix in ("", " device route"):
            m = out.get(f"12b {kind} merged{suffix}")
            u = out.get(f"12b {kind} no-merge{suffix}")
            if m is None:
                continue
            if u[0]["lut5_filter_lanes"] or (
                    kind == "chained serve" or suffix) and (
                    m[0]["lut5_filter_lanes"] <= 0
                    or m[2]["counters"].get("serve_merged_dispatches", 0) <= 0):
                raise AssertionError(f"12b {kind}{suffix}: K3's lane form and "
                                     "merged dispatches must run in the merged "
                                     "serve only")
    return out


def phase_serve_drain(dev, outdir: str) -> dict:
    """12d: the chained serve (default route) in a fresh process, SIGTERM
    once its first job is done; the same command again finishes every job,
    and the directory then holds the JAX CLI's files of the uninterrupted
    serve."""
    import signal as _signal

    g = round_goldens()
    argv, env, _ = g.CASES["serve_chain8"][1][0]
    cwd = os.path.join(outdir, "12d")
    os.makedirs(cwd)
    full = [*argv, "--device", dev.type, "--output-dir", os.path.join(cwd, "D")]
    penv = dict(os.environ, PYTHONUNBUFFERED="1")
    penv.pop("SBG_DISABLE_NATIVE", None)
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-c", _CLI_PROCESS, ROOT, json.dumps(full)],
        env=penv, cwd=cwd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True,
    )
    done_before = 0
    try:
        for line in proc.stdout:
            if line.startswith("serve: job") and " done " in line:
                done_before += 1
                proc.send_signal(_signal.SIGTERM)
                break
        proc.stdout.read()
        rc = proc.wait(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
    first = time.perf_counter() - t0
    if rc != -_signal.SIGTERM:
        raise AssertionError(f"12d: the serve exited {rc}, not by SIGTERM")
    finished = sum(
        1 for j, _ in serve_jobs(argv)
        if os.path.exists(os.path.join(cwd, "D", j, "search.journal.json"))
        and '"run_done"' in open(os.path.join(cwd, "D", j,
                                              "search.journal.json")).read())
    drained = [j for j, _ in serve_jobs(argv)
               if os.path.isdir(os.path.join(cwd, "D", j))
               and any(f.startswith("flight-")
                       for f in os.listdir(os.path.join(cwd, "D", j)))]
    rc2, _, second, _ = cli_process(full, penv, "12d the same serve again")
    if rc2 != 0:
        raise AssertionError(f"12d: the re-run exited {rc2}")
    # The jobs the first run finished run again in the second, as in the
    # JAX package: their journals gain a second run_done record.
    want = g.files_of(g.golden_dir("serve_chain8"))
    got = g.files_of(os.path.join(cwd, "D"))
    if sorted(got) != sorted(want):
        raise AssertionError(f"12d: files {sorted(got)} != {sorted(want)}")
    again = 0
    for rel in want:
        if got[rel] == want[rel]:
            continue
        if rel.endswith(".jsonl"):
            w, gg = ([json.loads(x) for x in b.splitlines()]
                     for b in (want[rel], got[rel]))
        elif rel.endswith(".json"):
            w, gg = (json.loads(b)["records"] for b in (want[rel], got[rel]))
        else:
            raise AssertionError(f"12d: {rel} differs from the JAX CLI's")
        if gg[: len(w)] != w or [r["type"] for r in gg[len(w):]] != ["run_done"]:
            raise AssertionError(f"12d: {rel} differs from the JAX CLI's")
        again += rel.endswith(".jsonl")
    log(f"  12d: SIGTERM after {done_before} job(s) done ({first:.2f} s), "
        f"{finished} of 8 jobs finished then, {len(drained)} drained with a "
        f"flight dump; the re-run ({second:.2f} s) finished the rest: every "
        f"XML file the JAX CLI's uninterrupted serve's, every journal too but "
        f"the {again} finished jobs' second run_done record")
    if again > finished or finished >= 8:
        raise AssertionError(f"12d: {finished} jobs finished before the "
                             f"SIGTERM, {again} journals ran again")
    return {"first_s": first, "second_s": second, "finished": finished,
            "drained": len(drained)}


# -------------------------------------------------------------------------
# Phase 13: the HTTP admission front door
# -------------------------------------------------------------------------


def net_goldens():
    """tests/torch_net_goldens.py: the front door's request sequences and
    their JAX package goldens (tests/data/torch_golden/net/<case>/)."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import torch_net_goldens

    return torch_net_goldens


def kernel_totals() -> tuple:
    """Every kernel's launch count as it stands (no reset)."""
    from sboxgates_tpu_torch.codegen import cuda_kernel
    from sboxgates_tpu_torch.ops import lut5_filter, pivot_tile, spectral

    return (lut5_filter.launches, lut5_filter.lane_launches,
            sorted(pivot_tile.launches.items()), spectral.launches,
            cuda_kernel.launches)


def p50_p99(xs) -> tuple:
    xs = sorted(xs)
    return statistics.median(xs), xs[max(0, math.ceil(0.99 * len(xs)) - 1)]


def admit_samples(ctx) -> list:
    """The ``net_admit_s`` values ``ctx``'s registry observes from now on,
    in order (the registry keeps only the histogram)."""
    samples = []
    observe = ctx.stats.observe

    def record(name, value):
        if name == "net_admit_s":
            samples.append(value)
        observe(name, value)

    ctx.stats.observe = record
    return samples


def net_serve(dev, root: str) -> dict:
    """13a: net_chain8_dev's requests through the port's AdmissionServer
    in process on ``dev`` (the device route, the eight planted chains
    admitted before the orchestrator starts: one merged wave), every
    response and file held against the JAX package's golden.  Returns the
    stack, still serving, and the fresh admissions' numbers."""
    g = net_goldens()
    ctx, orch, srv = g.make_stack("torch", "net_chain8_dev", root,
                                  device=dev.type)
    samples = admit_samples(ctx)
    srv.start()
    times = []
    out, ids = g.drive(srv.port, g.CASES["net_chain8_dev"]["steps"], orch,
                       times=times)
    left = g.settle("torch", root)
    if left:
        raise AssertionError(f"13a: jobs {left} pending after the serve")
    g.compare_net("net_chain8_dev", root, out)
    start = next(t0 for kind, t0, _ in times if kind == "start")
    polls = [t1 for kind, _, t1 in times if kind == "poll"]
    fresh = [t1 - t0 for _, t0, t1 in times[:8]]
    return {"stack": (ctx, orch, srv), "samples": samples, "ids": ids,
            "fresh_admit_s": samples[:8], "fresh_wall_s": sum(fresh),
            "serve_s": max(polls) - start,
            "dispatches": int(ctx.stats.get("device_dispatches", 0))}


def net_repeats(r: dict, n: int = 200) -> dict:
    """13a: ``n`` repeat POSTs of the finished queries: each 200 with its
    circuit, no device dispatch and no kernel launch."""
    g = net_goldens()
    ctx, orch, srv = r["stack"]
    hits0 = int(ctx.stats.get("net_repeat_hits", 0))
    kern0 = kernel_totals()
    before = len(r["samples"])
    t0 = time.perf_counter()
    for i in range(n):
        box = ("file", g.PLANTED8[i % 8])
        s, d = g.request(srv.port, "POST", "/v1/jobs",
                         {"sbox": g.sbox_text(box)}, token=g.TOKENS["acme"])
        if s != 200 or d.get("state") != "done" or not d.get("circuits") \
                or d["job_id"] != r["ids"][i % 8]:
            raise AssertionError(f"13a repeat {i}: {s} {d}")
    wall = time.perf_counter() - t0
    hits = int(ctx.stats.get("net_repeat_hits", 0)) - hits0
    if hits != n or kernel_totals() != kern0 or \
            int(ctx.stats.get("device_dispatches", 0)) != r["dispatches"]:
        raise AssertionError(f"13a: {n} repeats gave {hits} repeat hits, "
                             f"kernels {kernel_totals()} (were {kern0}), "
                             f"{ctx.stats.get('device_dispatches')} dispatches")
    return {"wall_s": wall, "admit_s": r["samples"][before:]}


#: The unstarted server's tenants: the rejection checks' and one whose
#: quota and rate hold 200 queued jobs.
IDLE_TENANTS = {"bulk": {"token": "tok-bulk", "max_jobs": 256,
                         "rate_per_s": 1e4, "burst": 400}}


def net_idle_server(dev, root: str, n: int = 200) -> dict:
    """13a: an admission server on ``dev`` whose orchestrator never
    starts.  One request each for 401, 403, 411, 413, 400 (bad JSON) and
    429 (rate and quota): each its status, code and counter.  Then ``n``
    fresh admissions, the eight planted chains under new Idempotency-Keys
    (each a new job: quota, admit record, S-box file, queue), 202 each.
    Neither a device dispatch nor a kernel launch."""
    g = net_goldens()
    ctx, orch, srv = g.build_stack("torch", root, {"lut_graph": True,
                                                   "seed": 1},
                                   "dev", 2, dev.type,
                                   g.REJECT_TENANTS | IDLE_TENANTS)
    srv.start()
    toy = " ".join("%02x" % v for v in g.toy_values(0))
    kern0 = kernel_totals()
    post = lambda body, token, idem=None: g.request(  # noqa: E731
        srv.port, "POST", "/v1/jobs", body, token=token, idem=idem)
    cases = (
        ("401", lambda: post({"sbox": toy}, "wrong"), "net_rejected_auth"),
        ("403", lambda: post({"sbox": toy}, "tok-off"), "net_rejected_auth"),
        ("411", lambda: g.raw_request(srv.port, (
            "POST /v1/jobs HTTP/1.1\r\nHost: t\r\nAuthorization: Bearer "
            "tok-acme\r\n\r\n").encode()), None),
        ("413", lambda: post("x" * (65 * 1024), "tok-acme"), "net_oversize"),
        ("400", lambda: post("{not json", "tok-acme"), None),
        ("429 rate", lambda: (post({"sbox": "x"}, "tok-slow"),
                              post({"sbox": "x"}, "tok-slow"))[1],
         "net_rejected_rate"),
        ("429 quota", lambda: (post({"sbox": toy, "output": 0}, "tok-one"),
                               post({"sbox": toy, "output": 1}, "tok-one"))[1],
         "net_rejected_quota"),
    )
    got = {}
    try:
        for name, send, counter in cases:
            n0 = int(ctx.stats.get(counter, 0)) if counter else 0
            s, d = send()
            if s != int(name[:3]) or d["error"]["status"] != s or (
                    counter and int(ctx.stats.get(counter, 0)) != n0 + 1):
                raise AssertionError(f"13a rejection {name}: {s} {d}")
            got[name] = d["error"]["code"]
        samples = admit_samples(ctx)
        admitted0 = int(ctx.stats.get("net_jobs_admitted", 0))
        texts = [g.sbox_text(("file", p)) for p in g.PLANTED8]
        t0 = time.perf_counter()
        for i in range(n):
            s, d = post({"sbox": texts[i % 8]}, "tok-bulk", f"fresh-{i}")
            if s != 202 or d.get("state") != "queued":
                raise AssertionError(f"13a fresh admission {i}: {s} {d}")
        wall = time.perf_counter() - t0
    finally:
        srv.close()
        orch.stop()
    admitted = int(ctx.stats.get("net_jobs_admitted", 0)) - admitted0
    if admitted != n or len(samples) != n or orch.active_jobs("bulk") != n:
        raise AssertionError(f"13a: {admitted} of {n} fresh admissions, "
                             f"{orch.active_jobs('bulk')} queued")
    if kernel_totals() != kern0 or ctx.stats.get("device_dispatches", 0) or \
            ctx.stats.get("circuit_breaker_trips", 0):
        raise AssertionError("13a: a rejection or an admission reached "
                             "the device")
    return {"rejected": got, "fresh_admit_s": samples, "fresh_wall_s": wall}


def net_cli(outdir: str) -> dict:
    """13b and 13c: net_des8_o0's command through the port's CLI in fresh
    processes on the card (the default route), SIGTERM ending each; 13b
    and 13c run side by side (their own directories and ports)."""
    import signal as _signal
    from concurrent.futures import ThreadPoolExecutor

    g = net_goldens()
    cmd = [sys.executable, "-m", "sboxgates_tpu_torch"]
    env = g.cli_env()

    def run_13b() -> dict:
        cwd = os.path.join(outdir, "13b")
        os.makedirs(cwd)
        t0 = time.perf_counter()
        rc, resp, ids, text = g.run_cli("torch", cmd, "net_des8_o0", cwd, env)
        first = time.perf_counter() - t0
        if rc != -_signal.SIGTERM:
            raise AssertionError(f"13b: the CLI exited {rc}:\n{text[-3000:]}")
        d = os.path.join(cwd, "D")
        g.compare_net("net_des8_o0", d, resp)
        if g.pending("torch", d):
            raise AssertionError(f"13b: {g.pending('torch', d)} pending")
        t0 = time.perf_counter()
        rc, (s, doc), text = g.rerun_replays_nothing("torch", cmd, cwd, env,
                                                     ids[0])
        again = time.perf_counter() - t0
        if rc != -_signal.SIGTERM or s != 404 or "serve-net: replayed" in text:
            raise AssertionError(f"13b: the same command again: {rc} {s} "
                                 f"{doc}\n{text[-3000:]}")
        g.compare_net("net_des8_o0", d, only=set(ids))
        return {"13b_s": first, "13b_again_s": again}

    def run_13c() -> dict:
        cwd = os.path.join(outdir, "13c")
        os.makedirs(cwd)
        t0 = time.perf_counter()
        rc1, left, rc2, text = g.crash_and_replay("torch", cmd, cwd, env)
        wall = time.perf_counter() - t0
        d = os.path.join(cwd, "D")
        if rc1 != 17 or len(left) != 1 or rc2 != -_signal.SIGTERM or \
                "serve-net: replayed 1 admitted job(s)" not in text or \
                g.pending("torch", d):
            raise AssertionError(f"13c: exits {rc1}, {rc2}, pending {left} "
                                 f"then {g.pending('torch', d)}:\n"
                                 f"{text[-3000:]}")
        g.compare_net("net_des8_o0", d, only=set(left))
        return {"13c_s": wall}

    with ThreadPoolExecutor(2) as pool:
        b, c = pool.submit(run_13b), pool.submit(run_13c)
        return b.result() | c.result()


def phase_net(dev, on_path) -> dict:
    """Phase 13: the HTTP admission front door (13a in process on the
    device route, 13b and 13c the CLI in fresh processes)."""
    t_phase = time.perf_counter()
    outdir = tempfile.mkdtemp(prefix="chip_smoke-")
    box = {}
    try:
        counts = on_path("net_chain8_dev", lambda: box.update(
            r=net_serve(dev, os.path.join(outdir, "13a"))))
        r = box["r"]
        try:
            rep = net_repeats(r)
        finally:
            ctx, orch, srv = r["stack"]
            srv.close()
            orch.run_until_idle(timeout_s=60)
            orch.stop()
        idle = net_idle_server(dev, os.path.join(outdir, "13a-idle"))
        cli = net_cli(outdir)
    finally:
        shutil.rmtree(outdir, ignore_errors=True)
    if counts["lut5_filter_lanes"] < 1:
        raise AssertionError(f"13a: K3's lane form never launched: {counts}")
    fm, fx = statistics.median(r["fresh_admit_s"]), max(r["fresh_admit_s"])
    rm, rp = p50_p99(rep["admit_s"])
    im, ip = p50_p99(idle["fresh_admit_s"])
    n_idle = len(idle["fresh_admit_s"])
    log(f"  13a net_chain8_dev over HTTP (device route, 8 lanes, one merged "
        f"wave): every response and file the JAX package's; serve "
        f"{r['serve_s']:.3f} s ({8 / r['serve_s']:.3f} jobs/s), K3 lane-form "
        f"launches {counts['lut5_filter_lanes']}, single-lane "
        f"{counts['lut5_filter']}, device_dispatches {r['dispatches']}")
    log(f"  13a the 8 fresh admissions: {8 / r['fresh_wall_s']:.1f} "
        f"admissions/s (client round trips), net_admit_s median "
        f"{1e3 * fm:.3f} ms, max {1e3 * fx:.3f} ms")
    log(f"  13a 200 repeat POSTs: {200 / rep['wall_s']:.1f} admissions/s, "
        f"net_admit_s median {1e3 * rm:.3f} ms, p99 {1e3 * rp:.3f} ms; 200 "
        "repeat hits, no device dispatch, no kernel launch")
    log(f"  13a rejections: {idle['rejected']}; {n_idle} fresh admissions "
        f"to the unstarted orchestrator: "
        f"{n_idle / idle['fresh_wall_s']:.1f} admissions/s, net_admit_s "
        f"median {1e3 * im:.3f} ms, p99 {1e3 * ip:.3f} ms; no device "
        "dispatch, no kernel launch")
    log(f"  13b the CLI (default route): {cli['13b_s']:.2f} s, the JAX "
        f"package's files; the same command again {cli['13b_again_s']:.2f} s, "
        f"nothing replayed; 13c crash and replay {cli['13c_s']:.2f} s")
    wall = time.perf_counter() - t_phase
    log(f"phase 13: {wall:.1f} s ({gpu_line()})")
    return {"counts": counts, "serve_s": r["serve_s"],
            "fresh_admit_ms": (1e3 * fm, 1e3 * fx),
            "idle_admit_ms": (1e3 * im, 1e3 * ip),
            "repeat_admit_ms": (1e3 * rm, 1e3 * rp),
            "repeat_per_s": 200 / rep["wall_s"], "wall_s": wall, **cli}


def phase_paths(dev) -> dict:
    """``--paths``: the single-lane device-route paths, timed, for a
    comparison of two trees in one call (this script run from each tree's
    root in turn): phase 3's DES S1 search (checked against its golden
    file), phase 4b's pivot node and sweeps alone at G = 99 and 200, and
    phase 7e's gate step at G = 64 and 200."""
    outdir = tempfile.mkdtemp(prefix="chip_smoke-")
    try:
        _, _, des_s = phase_main_path(dev, outdir)
    finally:
        shutil.rmtree(outdir, ignore_errors=True)
    pivot = {g: {k: r[k] for k in ("seconds", "sweep_seconds", "sweep_pre_seconds")}
             for g, r in phase_pivot(dev).items()}
    gate = {g: r["device_ms"] for g, r in phase_gate_placement(dev, (64, 200)).items()}
    return {"des_s1_s": des_s, "pivot": pivot, "gate_step_ms": gate}


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "unknown"


# Phase 5's CLI runs: (argv, S-box, golden file of the JAX CLI, whether a
# stream must be reordered).  DES S1 at seed 1 never reaches an ordered
# stream (its nodes stay below G = 19, where the 7-LUT stage A first spans
# two chunks, and below G = 50, where the pivot sweep starts), so it must
# write the lexicographic run's file; the planted G = 22 resume is the
# smallest configuration found that reorders a stream (the 7-LUT stage A),
# and the G = 99 resume reorders the pivot tiles.
SPECTRAL = ["--candidate-order", "spectral"]
SPECTRAL_RUNS = {
    "des_s1_spectral": (DES_ARGV + SPECTRAL, DES_BOX,
                        os.path.join(GOLDEN, "des_s1_l_o0_seed1.xml"), False),
    "g22_spectral": (G22_ARGV + SPECTRAL, G22_BOX,
                     os.path.join(GOLDEN, "rijndael_planted7_l_o0_seed1_g22_spectral.xml"),
                     True),
    "g99_spectral": (G99_ARGV + SPECTRAL, G99_BOX,
                     os.path.join(GOLDEN, "rijndael_planted_l_o0_seed1_g99_spectral.xml"),
                     True),
}

# The CLI runs whose files the JAX CLI wrote for the same command, route
# and faults: journal golden -> (the JAX CLI's argv, native route,
# SBG_FAULTS, whether the run crashes and is resumed).  Each phase passes
# its run_cli the argv before the S-box, ``-v -v`` where its entry has it,
# and ``--device``/``--pivot-backend``, which the journal does not record.
# tests/torch_journal_goldens.py writes GOLDEN/journal/<name>/ from this
# table (the phase 8 entries' XML files too).
JOURNAL_RUNS = {
    "des_s1": (DES_ARGV + VV + [DES_BOX], False, None, False),
    "g99": (G99_ARGV + VV + [G99_BOX], False, None, False),
    "des_s1_spectral": (DES_ARGV + SPECTRAL + VV + [DES_BOX], False, None, False),
    "g22_spectral": (G22_ARGV + SPECTRAL + VV + [G22_BOX], False, None, False),
    "g99_spectral": (G99_ARGV + SPECTRAL + VV + [G99_BOX], False, None, False),
    "gate_off": (GATE_ARGV + VV + [DES_BOX], False, None, False),
    "gate_native": (GATE_ARGV + VV + [DES_BOX], True, None, False),
    "des_l_native": (DES_ARGV + [DES_BOX], True, None, False),
    "g99_native": (G99_ARGV + [G99_BOX], True, None, False),
    "crash_resume": (CRASH_ARGV + [DES_BOX], False, CRASH_SPEC, True),
    "g99_hang_all": (G99_ARGV + HANG_TIMEOUT + [G99_BOX], True,
                     "dispatch.sweep:hang@1+", False),
    "g99_devcb": (G99_ARGV + [G99_BOX], True, "native.devcb:raise@1", False),
}

# Each kernel: (route, source, TPU kernel replaced, home path).
# -------------------------------------------------------------------------
# Phase 14: several shards and processes on the one card
# -------------------------------------------------------------------------


def mesh_goldens():
    """tests/torch_mesh_goldens.py: the mesh and multi-process cases and
    their JAX goldens."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import torch_mesh_goldens

    return torch_mesh_goldens


def run_mesh_case(dev, label: str, case: str, outdir: str, extra=()):
    """A CLI case of one process on ``SBG_LOCAL_SHARDS`` shards of the card
    (the JAX CLI's device count): the JAX CLI's files, byte for byte.
    Returns (wall, K1 window launches by shard)."""
    from sboxgates_tpu_torch import cli
    from sboxgates_tpu_torch.ops import pivot_tile

    mg, h = mesh_goldens(), job_cases()
    argv, env, devices, procs = mg.CLI_CASES[case]
    d = os.path.join(outdir, label)
    t0 = time.perf_counter()
    with h.environ(dict(env, SBG_LOCAL_SHARDS=str(devices))):
        rc = cli.main([*argv, *extra, "--device", dev.type, "--output-dir", d])
    wall = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"{label}: rc {rc}")
    mg.compare_files(case, d)
    shards = dict(sorted(pivot_tile.shard_launches.items()))
    log(f"  {label}: {case} {' '.join(extra)} in {wall:.3f} s, the JAX CLI's "
        f"files at {devices} devices; K1 window launches by shard {shards}")
    return wall, shards


# One rank of a CLI run in a fresh process: argv[1] the checkout, argv[2]
# the argv (JSON); prints the states its search returned and its K1
# launches by shard.
_RANK_PROCESS = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
from sboxgates_tpu_torch import cli, search
from sboxgates_tpu_torch.graph.xmlio import state_filename
from sboxgates_tpu_torch.ops import pivot_tile
real = search.generate_graph_one_output
got = []
def returned(*a, **k):
    out = real(*a, **k)
    got.extend(state_filename(s) for s in out)
    return out
search.generate_graph_one_output = returned
rc = cli.main(json.loads(sys.argv[2]))
print("RANKRESULT " + json.dumps({"rc": rc, "states": got,
      "shards": pivot_tile.shard_launches,
      "windows": pivot_tile.launches["packed"]}), flush=True)
sys.exit(rc)
"""

#: Per-call limit of phase 14's rank processes.
RANK_TIMEOUT_S = 240


def rank_processes(cmds, envs):
    """Starts the ranks, waits, kills and reaps what is left; returns (return
    codes, stdouts, stderrs)."""
    procs = [subprocess.Popen(c, env=e, cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for c, e in zip(cmds, envs)]
    outs, errs = [], []
    try:
        for p in procs:
            try:
                o, e = p.communicate(timeout=RANK_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                p.kill()
                o, e = p.communicate()
            outs.append(o)
            errs.append(e)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return [p.returncode for p in procs], outs, errs


def cli_ranks(dev, argv, outdir, env, rank_env=None, ranks: int = 2):
    """The port's CLI on ``ranks`` processes of ``dev``; ``rank_env`` adds
    variables by rank (a card of its own: ``CUDA_VISIBLE_DEVICES``)."""
    mg = mesh_goldens()
    port = mg.free_port()
    cmds = [[sys.executable, "-c", _RANK_PROCESS, ROOT, json.dumps(
        [*argv, "--device", dev.type, "--output-dir", outdir, "--coordinator",
         f"127.0.0.1:{port}", "--num-processes", str(ranks), "--process-id",
         str(i)])] for i in range(ranks)]
    base = {k: v for k, v in os.environ.items() if not k.startswith("SBG_")}
    envs = [dict(base, **env, **((rank_env or {}).get(i, {})))
            for i in range(ranks)]
    return rank_processes(cmds, envs)


def rank_result(out: str) -> dict:
    lines = [ln for ln in out.splitlines() if ln.startswith("RANKRESULT ")]
    return json.loads(lines[-1][len("RANKRESULT "):]) if lines else {}


def phase_mesh_rates(dev) -> dict:
    """14e: the whole G = 200 pivot space against a random target through
    the sharded stream on 1 x 1, 1 x 2 and (two processes over gloo) 2 x 1
    shards of the card: candidates/s, windows and all-reduces."""
    out = {}
    for shards in (1, 2):
        out[f"1x{shards}"] = _mesh_rate_local(dev, shards)
    out["2x1"] = mesh_rate_ranks(2)
    return out


def mesh_rate_ranks(ranks: int, own_card: bool = False) -> dict:
    """:func:`_mesh_rate` on ``ranks`` processes of one shard each (each on
    a card of its own with ``own_card``, else all on the first): rank 0's
    figures, every rank's rows checked equal."""
    mg = mesh_goldens()
    port = mg.free_port()
    cmds = [[sys.executable, "-c", _MESH_RATE, ROOT, str(port), str(i),
             str(ranks)] for i in range(ranks)]
    base = {k: v for k, v in os.environ.items() if not k.startswith("SBG_")}
    envs = [dict(base, **({"CUDA_VISIBLE_DEVICES": str(i)} if own_card else {}))
            for i in range(ranks)]
    rcs, outs, errs = rank_processes(cmds, envs)
    if any(rcs):
        raise AssertionError(f"rates on {ranks} ranks: rcs {rcs}: {errs}")
    got = [json.loads(o.strip().splitlines()[-1]) for o in outs]
    if any(g["rows"] != got[0]["rows"] for g in got):
        raise AssertionError(f"rates on {ranks} ranks: the verdict rows differ")
    backends = sorted({ln.split("collectives on ")[1].split(":")[0]
                       for e in errs for ln in e.splitlines()
                       if "collectives on" in ln})
    return got[0] | {"backends": backends,
                     "rank_shard_launches": [g["shard_launches"] for g in got]}


def _mesh_rate(dev) -> dict:
    """The sharded pivot stream over the whole G = 200 space on this
    process's mesh (a warm-up over 200 tiles first)."""
    import numpy as np
    import torch

    from sboxgates_tpu_torch.core import ttable as tt
    from sboxgates_tpu_torch.ops import pivot_tile
    from sboxgates_tpu_torch.parallel import MeshPlan, make_mesh
    from sboxgates_tpu_torch.parallel import mesh as pmesh
    from sboxgates_tpu_torch.search import Options, SearchContext
    from sboxgates_tpu_torch.search.lut import PivotOperands, pivot_tile_shape

    g = 200
    st = random_state(g, 11)
    target = np.random.default_rng(g).integers(
        0, 2**32, size=8, dtype=np.uint64).astype(np.uint32)
    mask = tt.mask_table(8)
    plan = MeshPlan(make_mesh(device="cuda"))
    ctx = SearchContext(Options(seed=1, lut_graph=True, device="cuda"),
                        mesh_plan=plan)
    tl, th = pivot_tile_shape(g)
    ops = PivotOperands(g, tl, th, [], ctx.device_tables(st), target, mask,
                        ctx.device)
    jw, jm = ctx.lut5_tabs()
    n = plan.n_candidate_shards
    pmesh.sharded_pivot_stream(plan, *ops.stream_args(), 0,
                               min(200, ops.t_real), jw, jm, 1, tl=tl, th=th)
    zero_pivot_counts()
    pmesh.COLLECTIVES.update(windows=0, window_reduces=0, gathers=0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rows = pmesh.sharded_pivot_stream(plan, *ops.stream_args(), 0, ops.t_real,
                                      jw, jm, 1, tl=tl, th=th)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    cand = math.comb(g, 5)
    if (rows[:, 0] != 0).any() or int(rows[0, 9]) < ops.t_real:
        raise AssertionError(f"G={g}: the sharded sweep returned {rows.tolist()}")
    return {"shards": n, "seconds": wall, "cand_per_s": cand / wall,
            "windows": pmesh.COLLECTIVES["windows"],
            "window_reduces": pmesh.COLLECTIVES["window_reduces"],
            "gathers": pmesh.COLLECTIVES["gathers"],
            "tiles": ops.t_real,
            "shard_launches": dict(sorted(pivot_tile.shard_launches.items())),
            "rows": rows.tolist()}


# One rank of a rates topology of one shard per process: argv[1] the
# checkout, argv[2] the coordinator's port, argv[3] the rank, argv[4] the
# ranks; prints _mesh_rate's JSON last.
_MESH_RATE = r"""
import json, os, sys
sys.path.insert(0, sys.argv[1])
os.environ["SBG_LOCAL_SHARDS"] = "1"
import torch
import chip_smoke
from sboxgates_tpu_torch.parallel import distributed as dist
dist.initialize("127.0.0.1:" + sys.argv[2], int(sys.argv[4]), int(sys.argv[3]),
                device="cuda")
r = chip_smoke._mesh_rate(torch.device("cuda", 0))
dist.barrier("rate-done")
dist.shutdown()
print(json.dumps(r), flush=True)
"""


def phase_cards(dev) -> dict:
    """Phase 15 (``--cards``, every card of one host, at least two): 15a the
    G = 99 resume (device route) on one process over the n cards, a shard
    per card; 15b the same on n processes of one card each, whose
    collectives run on NCCL; both the JAX CLI's files at n devices.  15c
    the whole G = 200 pivot space on 1 x 1, 1 x n and n x 1 (NCCL)."""
    import torch

    n = torch.cuda.device_count()
    mg = mesh_goldens()
    case, pcase = f"g99_d{n}_dev", f"g99_p{n}x1_dev"
    if n < 2 or case not in mg.CLI_CASES:
        raise AssertionError(f"--cards: no golden for {n} cards")
    t_phase = time.perf_counter()
    cards = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip().splitlines()
    log(f"phase 15: {n} cards: {cards}")
    res: dict = {}
    outdir = tempfile.mkdtemp(prefix="chip_smoke-")
    try:
        zero_pivot_counts()
        wall, shards = run_mesh_case(dev, "15a", case, outdir)
        if sorted(shards) != list(range(n)) or min(shards.values()) < 1:
            raise AssertionError(f"15a: K1 windows by shard {shards}")
        res["15a"] = {"wall": wall, "shards": shards}
        argv, env, _, _ = mg.CLI_CASES[pcase]
        d = os.path.join(outdir, "15b")
        t0 = time.perf_counter()
        rcs, outs, errs = cli_ranks(
            dev, argv, d, env, ranks=n,
            rank_env={i: {"CUDA_VISIBLE_DEVICES": str(i)} for i in range(n)})
        wall = time.perf_counter() - t0
        if any(rcs):
            raise AssertionError(f"15b: rcs {rcs}: {errs}")
        mg.compare_files(pcase, d)
        ranks = [rank_result(o) for o in outs]
        lines = [ln for e in errs for ln in e.splitlines()
                 if "collectives on" in ln]
        if any(r["states"] != ranks[0]["states"] for r in ranks) or \
                len(lines) != n or not all("on nccl" in ln for ln in lines):
            raise AssertionError(f"15b: {ranks} {lines}")
        res["15b"] = {"wall": wall, "shards": [r["shards"] for r in ranks]}
        log(f"  15b {n} ranks, one card each: {wall:.3f} s, every rank "
            f"{ranks[0]['states']}, the JAX CLI's {n} x 1 files; K1 windows "
            f"by rank {res['15b']['shards']}; {lines[0]}")
    finally:
        shutil.rmtree(outdir, ignore_errors=True)
    rates = {"1x1": _mesh_rate_local(dev, 1), f"1x{n}": _mesh_rate_local(dev, n),
             f"{n}x1": mesh_rate_ranks(n, own_card=True)}
    one = rates["1x1"]["cand_per_s"]
    for topo, r in rates.items():
        log(f"  15c G=200 sharded sweep {topo}: {r['cand_per_s']:.6e} cand/s "
            f"({r['cand_per_s'] / one:.3f}x 1x1), {r['seconds']:.5f} s, "
            f"{r['windows']} windows, {r['window_reduces']} all-reduces, "
            f"{r['gathers']} row gathers, backends {r.get('backends', '-')}, "
            f"K1 by shard {r.get('rank_shard_launches', r['shard_launches'])}")
    res["rates"] = rates
    log(f"phase 15 cards: {time.perf_counter() - t_phase:.1f} s")
    return res


def _mesh_rate_local(dev, shards: int) -> dict:
    os.environ["SBG_LOCAL_SHARDS"] = str(shards)
    try:
        return _mesh_rate(dev)
    finally:
        os.environ.pop("SBG_LOCAL_SHARDS", None)


def phase_mesh(dev, on_path) -> dict:
    """Phase 14: several shards and processes on the one card.  14a the CLI
    on two shards of the card (the G = 99 resume on both backends and DES
    S1, device route), 14b two processes on the card over gloo (the G = 99
    resume), 14c the job-sharded sweep killed and resumed and the
    replicated abort (exhaust) on two ranks, 14d the fleet on 2 shards
    split (1, 2), 14e the sharded sweep's rates."""
    mg = mesh_goldens()
    t_phase = time.perf_counter()
    res: dict = {"paths": {}, "shards": {}}
    outdir = tempfile.mkdtemp(prefix="chip_smoke-")
    try:
        for label, case, extra in (
            ("14a_g99_packed", "g99_d2_dev", ("--pivot-backend", "packed")),
            ("14a_g99_pre", "g99_d2_dev", ("--pivot-backend", "pre")),
            ("14a_des_s1", "des_s1_d2_dev", ()),
            ("14d_fleet", "fleet_c2_d2_dev", ()),
        ):
            box = {}
            res["paths"][label] = on_path(label, lambda c=case, lb=label, x=extra:
                                          box.update(r=run_mesh_case(
                                              dev, lb, c, outdir, x)))
            res["shards"][label] = box["r"][1]
        for label, kern in (("14a_g99_packed", "pivot_window"),
                            ("14a_g99_pre", "pivot_pre")):
            sh = res["shards"][label]
            if sorted(sh) != [0, 1] or min(sh.values()) < 1 or \
                    sum(sh.values()) != res["paths"][label][kern]:
                raise AssertionError(f"{label}: {kern} launches by shard {sh}, "
                                     f"{res['paths'][label][kern]} in all")
        # 14b: two ranks on the card.
        argv, env, _, _ = mg.CLI_CASES["g99_p2x1_dev"]
        d = os.path.join(outdir, "14b")
        t0 = time.perf_counter()
        rcs, outs, errs = cli_ranks(dev, argv, d, env)
        wall = time.perf_counter() - t0
        if any(rcs):
            raise AssertionError(f"14b: rcs {rcs}: {errs}")
        mg.compare_files("g99_p2x1_dev", d)
        ranks = [rank_result(o) for o in outs]
        if ranks[0]["states"] != ranks[1]["states"] or not ranks[0]["states"]:
            raise AssertionError(f"14b: the ranks' results differ: {ranks}")
        for i, r in enumerate(ranks):
            if list(r["shards"]) != [str(i)] or r["shards"][str(i)] < 1:
                raise AssertionError(f"14b rank {i}: K1 by shard {r['shards']}")
        res["shards"]["14b"] = {k: v for r in ranks for k, v in r["shards"].items()}
        backend_lines = [ln for e in errs for ln in e.splitlines()
                         if "collectives on" in ln]
        log(f"  14b two ranks on the card: {wall:.3f} s, both ranks "
            f"{ranks[0]['states']}, the JAX CLI's 2 x 1 files; K1 windows by "
            f"shard {res['shards']['14b']}; {backend_lines}")
        # 14c: the killed job-sharded sweep and the replicated abort.
        argv, env, _, _ = mg.CLI_CASES["shard_sweep_p2"]
        d = os.path.join(outdir, "14c")
        t0 = time.perf_counter()
        rcs, _, errs = cli_ranks(dev, argv, d, env,
                                 rank_env={1: {"SBG_FAULTS": "search.round:crash@3"}})
        if rcs[1] != 17:
            raise AssertionError(f"14c: rank 1 exited {rcs[1]}, not 17: {errs}")
        rcs, outs, errs = cli_ranks(dev, ["--resume-run", d], d, {})
        if any(rcs):
            raise AssertionError(f"14c resume: rcs {rcs}: {errs}")
        mg.compare_files("shard_sweep_p2", d, xml_only=True)
        kill_wall = time.perf_counter() - t0
        port = mg.free_port()
        worker = os.path.join(ROOT, "tests", "torch_mesh_worker.py")
        base = {k: v for k, v in os.environ.items() if not k.startswith("SBG_")}
        t0 = time.perf_counter()
        rcs, outs, errs = rank_processes(
            [[sys.executable, worker, "degrade", str(i), str(port), "1", "2",
              "exhaust", dev.type] for i in range(2)], [base, base])
        abort_wall = time.perf_counter() - t0
        lines = [mg.result_lines(o, "degrade") for o in outs]
        if any(rcs) or lines != mg.golden_lines("abort_2x1_exhaust"):
            raise AssertionError(f"14c abort: rcs {rcs}, lines {lines}: {errs}")
        log(f"  14c job-sharded sweep killed (rank 1, exit 17) and resumed on "
            f"the card to the uninterrupted run's files: {kill_wall:.3f} s; "
            f"replicated abort (exhaust) on two ranks of the card: the JAX "
            f"workers' lines {lines[0]}, {abort_wall:.3f} s")
        res["rates"] = phase_mesh_rates(dev)
    finally:
        shutil.rmtree(outdir, ignore_errors=True)
    one = res["rates"]["1x1"]["cand_per_s"]
    for topo, r in res["rates"].items():
        per_window = (r["window_reduces"] / r["windows"]) if r["windows"] else 0
        log(f"  14e G=200 sharded sweep {topo}: {r['cand_per_s']:.6e} cand/s "
            f"({r['cand_per_s'] / one:.3f}x 1x1), {r['seconds']:.5f} s, "
            f"{r['windows']} windows, {r['window_reduces']} all-reduces "
            f"({per_window:.3f} per window), {r['gathers']} row gathers, "
            f"K1 by shard {r['shard_launches']}")
    log(f"phase 14 mesh: {time.perf_counter() - t_phase:.1f} s")
    return res


# The fleets of four job shards (14f: four shards of the one card; 15d: one
# per card) and of two candidate shards per job shard (14h: 4 x 2 on eight
# shards of the one card; 15e: 2 x 2 on four cards): (name, the JAX CLI's
# golden at n devices, the one-device golden of the same command, the lane
# form every shard must launch, the JAX CLI's golden at n devices with
# --fleet-candidates 2).
FLEET_SHARD_RUNS = (
    ("des8", "fleet_des8_d{n}_dev", "fleet_des8_dev_lut_o0",
     "lut5_filter_lanes", "fleet_des8_c2_d{n}_dev"),
    ("g99", "fleet_g99_i8_d{n}_dev", "fleet_g99_i8_dev", "pivot_window_lanes",
     "fleet_g99_i8_c2_d{n}_dev"),
)


def run_fleet_shards(dev, label: str, case: str, shards: int, outdir: str):
    """One fleet CLI case in process on ``shards`` local shards
    (``SBG_LOCAL_SHARDS``) of the device route: the run directory byte for
    byte the JAX CLI's (``case`` a golden of tests/torch_mesh_goldens.py,
    or of tests/torch_cli_helpers.py at one shard), every output gate
    checked against its S-box.  Returns (wall, lane-form launches by
    kernel and job shard, lane-form launches of the run, lane-form
    launches by kernel and local shard j * C + c of the (job shard,
    candidate shard) that made them)."""
    from sboxgates_tpu_torch import cli
    from sboxgates_tpu_torch.ops import sweeps as tsweeps

    mg, h = mesh_goldens(), job_cases()
    if case in mg.CLI_CASES:
        argv, env = mg.CLI_CASES[case][:2]
    else:
        argv, env = h.golden_case(case)
    d = os.path.join(outdir, label)
    tsweeps.JOB_SHARD_LAUNCHES.clear()
    tsweeps.CANDIDATE_SHARD_LAUNCHES.clear()
    before = lane_counts()
    buf, err = io.StringIO(), io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(err), \
            h.environ(dict(env, SBG_LOCAL_SHARDS=str(shards))):
        rc = cli.main([*argv, "--device", dev.type, "--output-dir", d])
    wall = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"{label} exited {rc}: {err.getvalue()[-2000:]}")
    if case in mg.CLI_CASES:
        mg.compare_files(case, d)
    else:
        h.compare_run(case, d)
    verify_outputs(d, argv)
    lanes = {k: v - before[k] for k, v in lane_counts().items()}

    def by_kernel(counts):
        return {k: dict(sorted(v.items())) for k, v in sorted(counts.items())}

    return (wall, by_kernel(tsweeps.JOB_SHARD_LAUNCHES), lanes,
            by_kernel(tsweeps.CANDIDATE_SHARD_LAUNCHES))


def check_job_shards(label: str, kernel: str, n: int, launches: dict,
                     lanes: dict) -> dict:
    """Every one of the ``n`` shards (job shards, or local shards of a
    candidate split) launched ``kernel`` (a lane form), and every launch
    of it in the run was one of theirs."""
    by = launches.get(kernel, {})
    if sorted(by) != list(range(n)) or min(by.values()) < 1 or \
            sum(by.values()) != lanes[kernel]:
        raise AssertionError(f"{label}: {kernel} launches by shard {by}, "
                             f"{lanes[kernel]} in the run")
    return by


def phase_fleet_shards(dev, on_path, phase: str = "14f",
                       candidates: int = 1) -> dict:
    """Phase 14f: the fleets of FLEET_SHARD_RUNS on four job shards of the
    card (``SBG_LOCAL_SHARDS=4``, device route), each a counted path: the
    JAX CLI's files at 4 devices, and every job shard launching its lane
    form (K3's on DES-8, K1's on the G = 99 restarts).  Phase 14h
    (``candidates`` 2): the same fleets on 4 job shards x 2 candidate
    shards (``SBG_LOCAL_SHARDS=8 --fleet-candidates 2``): the JAX CLI's
    files at 8 devices, and every one of the 8 (job shard, candidate
    shard) pairs launching the lane form, every launch of it a candidate
    shard's."""
    shards = 4 * candidates
    t_phase = time.perf_counter()
    res: dict = {"paths": {}, "job_shards": {}, "candidate_shards": {}}
    outdir = tempfile.mkdtemp(prefix="chip_smoke-")
    try:
        for name, case, _, kernel, ccase in FLEET_SHARD_RUNS:
            label = f"{phase}_{name}"
            case = (case if candidates == 1 else ccase).format(n=shards)
            box = {}
            res["paths"][label] = on_path(label, lambda lb=label, c=case:
                                          box.update(r=run_fleet_shards(
                                              dev, lb, c, shards, outdir)))
            wall, launches, lanes, local = box["r"]
            by = check_job_shards(label, kernel, 4, launches, lanes)
            res["job_shards"][label] = {kernel: by}
            split = ""
            if candidates > 1:
                by_local = check_job_shards(label, kernel, shards, local, lanes)
                res["candidate_shards"][label] = {kernel: by_local}
                split = (f", by (job shard j, candidate shard c) as local "
                         f"shard j * {candidates} + c {by_local}")
            log(f"  {label}: {case} on 4 job shards x {candidates} candidate "
                f"shard(s) of the card in {wall:.3f} s, the JAX CLI's files "
                f"at {shards} devices, outputs verified; {kernel} by job "
                f"shard {by}{split} ({lanes[kernel]} in the run); all "
                f"lane-form launches by job shard {launches}")
    finally:
        shutil.rmtree(outdir, ignore_errors=True)
    log(f"phase {phase} fleet shards: {time.perf_counter() - t_phase:.1f} s")
    return res


def phase_fleet_turns(dev, phases, shards: int, cand_shards: int) -> dict:
    """The fleets of FLEET_SHARD_RUNS on ``shards`` job shards (the JAX
    CLI's files at that many devices, every job shard launching the lane
    form), on ``cand_shards`` local shards split as ``cand_shards / 2``
    job shards x 2 candidate shards (``--fleet-candidates 2``: the JAX
    CLI's files at that many devices, every local shard launching the lane
    form, every launch of it a candidate shard's) and the same command on
    one shard of the first card (the one-device golden), in turns: one,
    jobs, candidates, candidates, jobs, one.  ``phases`` names the job and
    the candidate runs: 14g (``--fleet-shards``) puts four job shards and
    4 x 2 shards on the one card; on n cards (``--cards``,
    ``--fleet-cards``) 15d gives each card one job shard and 15e one shard
    of n/2 x 2."""
    mg = mesh_goldens()
    t_phase = time.perf_counter()
    res: dict = {}
    outdir = tempfile.mkdtemp(prefix="chip_smoke-")
    modes = ((1, "one"), (shards, "jobs"), (cand_shards, "cands"),
             (cand_shards, "cands"), (shards, "jobs"), (1, "one"))
    phase = {"one": phases[0], "jobs": phases[0], "cands": phases[1]}
    title = "/".join(dict.fromkeys(phases))
    try:
        for name, case, one, kernel, ccase in FLEET_SHARD_RUNS:
            cases = {"one": one, "jobs": case.format(n=shards),
                     "cands": ccase.format(n=cand_shards)}
            for mode in ("jobs", "cands"):
                if shards < 2 or cases[mode] not in mg.CLI_CASES:
                    raise AssertionError(f"{phase[mode]}: no golden "
                                         f"{cases[mode]}")
            runs: dict = {m: [] for m in cases}
            for n, mode in modes:
                label = f"{phase[mode]}_{name}_{mode}_{len(runs[mode])}"
                wall, launches, lanes, local = run_fleet_shards(
                    dev, label, cases[mode], n, outdir)
                by = {}
                if mode == "jobs":
                    by = check_job_shards(label, kernel, n, launches, lanes)
                elif mode == "cands":
                    by = check_job_shards(label, kernel, n, local, lanes)
                runs[mode].append({"wall": wall, "by_shard": by,
                                   kernel: lanes[kernel]})
                log(f"  {label}: {wall:.3f} s on {n} local shard(s), the JAX "
                    f"CLI's files ({cases[mode]}); {kernel} {lanes[kernel]}, "
                    f"by {'local shard' if mode == 'cands' else 'job shard'} "
                    f"{by}")
            res[name] = runs
            log(f"  {title} {name}: " + ", ".join(
                f"{m} {[round(r['wall'], 3) for r in rs]} s"
                for m, rs in runs.items()))
    finally:
        shutil.rmtree(outdir, ignore_errors=True)
    log(f"phase {title} fleet turns: {time.perf_counter() - t_phase:.1f} s")
    return res


KERNELS = {
    "lut5_filter": ("cuda", "sboxgates_tpu_torch/csrc/lut5_filter.cu",
                    "sboxgates_tpu/ops/pallas_filter.py:58", "des_s1"),
    "pivot_window": ("cuda", "sboxgates_tpu_torch/csrc/pivot_tile.cu",
                     "sboxgates_tpu/ops/pallas_pivot.py:133", "g99_packed"),
    "pivot_pre": ("cuda", "sboxgates_tpu_torch/csrc/pivot_pre.cu",
                  "sboxgates_tpu/ops/pallas_pivot.py:218", "g99_pre"),
    "walsh_score": ("cuda", "sboxgates_tpu_torch/csrc/walsh_score.cu",
                    "sboxgates_tpu/ops/spectral.py:119", "g99_spectral"),
    "circuit_eval": ("cuda", "sboxgates_tpu_torch/csrc/circuit_eval.cu",
                     "sboxgates_tpu/codegen/pallas_kernel.py:26", "codegen"),
}


# The lane forms (phase 11): (route, source, TPU kernel replaced, home path).
LANE_KERNELS = {
    "lut5_filter_lanes": ("cuda", "sboxgates_tpu_torch/csrc/lut5_filter.cu",
                          "sboxgates_tpu/ops/pallas_filter.py:58",
                          "fleet_des8_dev_lut_o0"),
    "pivot_window_lanes": ("cuda", "sboxgates_tpu_torch/csrc/pivot_tile.cu",
                           "sboxgates_tpu/ops/pallas_pivot.py:133",
                           "fleet_g99_i8_dev"),
}


def bound(r: dict):
    """(bound_ms, bound_by, formulation) of a timed shape on the H100:
    ``attribution.bound``."""
    return attribution().bound(r)


def on_path(name, drive) -> dict:
    """Launch counts of one main-path run: 0 right before, read right
    after."""
    from sboxgates_tpu_torch.codegen import cuda_kernel
    from sboxgates_tpu_torch.ops import lut5_filter, pivot_tile, spectral

    lut5_filter.launches = 0
    lut5_filter.lane_launches = 0
    zero_pivot_counts()
    spectral.launches = 0
    cuda_kernel.launches = 0
    drive()
    counts = lane_counts() | {
        "lut5_filter": lut5_filter.launches,
        "pivot_window": pivot_tile.launches["packed"],
        "pivot_window_tiles": pivot_tile.tiles["packed"],
        "pivot_pre": pivot_tile.launches["pre"],
        "pivot_pre_tiles": pivot_tile.tiles["pre"],
        "pivot_tiles_solved": pivot_tile.tiles["solved"],
        "pivot_tile": pivot_tile.launches["tile"],
        "pivot_pre_tile": pivot_tile.launches["pre_tile"],
        "walsh_score": spectral.launches,
        "circuit_eval": cuda_kernel.launches,
    }
    log(f"  launches on path {name}: {counts}")
    return counts


# Phase 7a and phase 12, host-bound and the script's two longest (260 s
# and 240 s on an H100 host), each run in a child process of its own
# beside phases 8-14h (started after phase 7e, so that no phase that
# times the device shares it before then).  A child prints its log and,
# as its last line, the counts of its paths; it builds nothing.
CHILD_PHASES = ("--phase-7a", "--phase-12")
CHILD_TIMEOUT_S = 900


def child_paths(dev, flag: str) -> dict:
    """The counted paths of one child phase (``CHILD_PHASES``)."""
    if flag == "--phase-7a":
        outdir = tempfile.mkdtemp(prefix="chip_smoke-")
        try:
            return {"gate_off": on_path("gate_off",
                                        lambda: phase_gate_device(dev, outdir))}
        finally:
            shutil.rmtree(outdir, ignore_errors=True)
    rounds = phase_rounds(dev, on_path)
    return {label: val[0] for label, val in rounds.items()
            if label.startswith("12") and label != "12d" and val[2] is not None}


def start_child(flag: str):
    """(process, its stdout file, start time) of ``chip_smoke.py <flag>``."""
    out = tempfile.TemporaryFile(mode="w+")
    proc = subprocess.Popen([sys.executable, os.path.join(ROOT, "chip_smoke.py"),
                             flag], stdout=out, cwd=ROOT)
    return proc, out, time.perf_counter()


def join_child(flag: str, child, t0: float) -> dict:
    """Waits for a child phase, prints its log and returns its paths'
    counts; raises when it failed."""
    proc, out, started = child
    rc = proc.wait(timeout=max(1.0, CHILD_TIMEOUT_S - (time.perf_counter() - started)))
    joined = time.perf_counter()
    out.seek(0)
    lines = out.read().splitlines()
    log(f"child {flag}: exit {rc}, started {started - t0:.1f} s into the run, "
        f"joined {joined - t0:.1f} s into it; its log:")
    for line in lines[:-1]:
        log(line)
    if rc != 0 or not lines:
        raise AssertionError(f"child {flag} exited {rc}")
    return json.loads(lines[-1])


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; nothing run",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from sboxgates_tpu_torch.codegen import cuda_kernel
    from sboxgates_tpu_torch.ops import lut5_filter, pivot_tile, spectral

    dev = torch.device("cuda", 0)
    flag = next((a for a in sys.argv[1:] if a in CHILD_PHASES), None)
    if flag is not None:
        # A child phase: the kernels and the native runtime are the ones
        # the parent built (loaded from build/, not rebuilt).
        from sboxgates_tpu_torch import _kernels, native

        _kernels.lib()
        if not native.available():
            raise AssertionError(f"native host runtime: {native.build_error()}")
        print(json.dumps(child_paths(dev, flag)), flush=True)
        return 0
    t0 = time.perf_counter()
    log(f"device: {torch.cuda.get_device_name(0)}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    phase_build()
    if "--paths" in sys.argv[1:]:
        # The single-lane paths' times only (phase_paths), no result line.
        print(gpu_line(), flush=True)
        print(json.dumps(phase_paths(dev)), flush=True)
        return 0
    if "--cards" in sys.argv[1:]:
        # Phase 15 alone, on every card of the host (four cards); no
        # result line.
        n = torch.cuda.device_count()
        print(gpu_line(), flush=True)
        phase_cards(dev)
        phase_fleet_turns(dev, ("15d", "15e"), n, n)
        return 0
    if "--fleet-cards" in sys.argv[1:]:
        # Phases 15d and 15e alone, on every card of the host; no result
        # line.
        n = torch.cuda.device_count()
        print(gpu_line(), flush=True)
        phase_fleet_turns(dev, ("15d", "15e"), n, n)
        return 0
    if any(a in sys.argv[1:] for a in ("--rounds", "--net", "--mesh",
                                        "--fleet-shards")):
        # Phase 12 (or, with --net, phase 13; with --mesh, phase 14 a-e;
        # with --fleet-shards, 14f, 14h and 14g) alone, its runs counted as
        # in a whole run; no result line.
        from sboxgates_tpu_torch.ops import lut5_filter as _l5

        def counted_path(name, drive) -> dict:
            _l5.launches = 0
            _l5.lane_launches = 0
            zero_pivot_counts()
            spectral.launches = 0
            cuda_kernel.launches = 0
            drive()
            return lane_counts() | {"lut5_filter": _l5.launches,
                                    "pivot_window": pivot_tile.launches["packed"],
                                    "pivot_pre": pivot_tile.launches["pre"],
                                    "walsh_score": spectral.launches,
                                    "circuit_eval": cuda_kernel.launches}

        print(gpu_line(), flush=True)
        if "--net" in sys.argv[1:]:
            phase_net(dev, counted_path)
        elif "--mesh" in sys.argv[1:]:
            phase_mesh(dev, counted_path)
        elif "--fleet-shards" in sys.argv[1:]:
            phase_fleet_shards(dev, counted_path)
            phase_fleet_shards(dev, counted_path, "14h", 2)
            phase_fleet_turns(dev, ("14g", "14g"), 4, 8)
        else:
            phase_rounds(dev, counted_path, extended=True)
        return 0
    log("phase 2 parity")
    par = phase_parity(dev)
    # Phase 11e, the lane forms against their plain versions, beside the
    # single-lane kernels' parity (and in the same profiler state).
    log("phase 11e lane-form parity")
    lanes_par = parity_lanes(dev)
    if "--quick" in sys.argv[1:]:
        # Build and parity only: a first check of new kernels, no result
        # line.
        return 0

    outdir = tempfile.mkdtemp(prefix="chip_smoke-")
    try:
        written, stats, walls = [], {}, {}

        def cli_path(name, drive, box):
            path, stats[name], walls[name] = drive()
            written.append((path, box))

        paths = {
            "des_s1": on_path("des_s1", lambda: cli_path(
                "des_s1", lambda: phase_main_path(dev, outdir), DES_BOX)),
            "g99_packed": on_path("g99_packed", lambda: cli_path(
                "g99_packed", lambda: phase_resume_pivot(dev, "packed", outdir),
                G99_BOX)),
            "g99_pre": on_path("g99_pre", lambda: cli_path(
                "g99_pre", lambda: phase_resume_pivot(dev, "pre", outdir), G99_BOX)),
        }
        for name, (_, box, _, _) in SPECTRAL_RUNS.items():
            paths[name] = on_path(name, lambda n=name, b=box: cli_path(
                n, lambda: phase_spectral(dev, n, outdir), b))
        paths["codegen"] = on_path("codegen", lambda: phase_codegen(dev, written))
        phase_profile_des(dev, outdir)
    finally:
        shutil.rmtree(outdir, ignore_errors=True)
    for name, (_, _, _, home) in KERNELS.items():
        if paths[home][name] <= 0:
            raise AssertionError(f"{name} never launched on path {home}")
    if paths["g99_packed"]["pivot_pre"] or paths["g99_pre"]["pivot_window"]:
        raise AssertionError("--pivot-backend did not pick the tile kernel")
    for path in ("g99_packed", "g99_pre"):
        if stats[path].get("lut5_candidates") != G99_CANDIDATES:
            raise AssertionError(
                f"{path} counted {stats[path].get('lut5_candidates')} 5-LUT "
                f"candidates, not the {G99_CANDIDATES} of tiles [0, {G99_TILES})")
        log(f"  {path}: {G99_CANDIDATES} candidates over {G99_TILES} tiles, "
            f"{paths[path]['pivot_tiles_solved']} of them solved")
    if paths["des_s1_spectral"]["walsh_score"] or not paths["g22_spectral"]["walsh_score"]:
        raise AssertionError("walsh_score launched off an ordered stream, or not on one")
    for path, want in LEX_LAUNCHES.items():
        got = {k: paths[path][k] for k in want}
        if got != want or paths[path]["walsh_score"]:
            raise AssertionError(
                f"lexicographic path {path} launched {paths[path]}, expected "
                f"{want} and no walsh_score")
    rates = phase_pivot(dev)
    phase_profile_sweep(dev)

    # Phase 7: gate mode on both routes and the default (native) route of
    # LUT mode, each a counted path (7a in a child, CHILD_PHASES); then the
    # gate-step placement figures.
    outdir = tempfile.mkdtemp(prefix="chip_smoke-")
    try:
        paths["gate_native"] = on_path(
            "gate_native", lambda: phase_gate_native(dev, outdir))
        paths["des_l_native"] = on_path(
            "des_l_native", lambda: phase_lut_native(dev, outdir, walls["des_s1"]))
        paths["g99_native"] = on_path(
            "g99_native", lambda: phase_engine_service(dev, outdir))
    finally:
        shutil.rmtree(outdir, ignore_errors=True)
    want = {"pivot_window": 8, "pivot_window_tiles": 191, "pivot_pre": 0,
            "walsh_score": 0, "lut5_filter": 0}
    got = {k: paths["g99_native"][k] for k in want}
    if got != want:
        raise AssertionError(f"7d launched {got}, expected {want} (K1 through the "
                             "engine's device-work service)")
    if paths["des_l_native"]["walsh_score"] or paths["des_l_native"]["pivot_window"]:
        raise AssertionError(f"7c launched {paths['des_l_native']}")
    log(f"  7c: K3 launched {paths['des_l_native']['lut5_filter']} times on the "
        f"native route (phase 3, device route: {paths['des_s1']['lut5_filter']})")
    placement = phase_gate_placement(dev)
    children = {}
    try:
        for flag in CHILD_PHASES:
            children[flag] = start_child(flag)
        res = after_gate_phases(dev, paths, par)
        for flag, child in children.items():
            paths.update(join_child(flag, child, t0))
    finally:
        for proc, out, _ in children.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            out.close()
    for path in ("gate_off", "gate_native"):
        if any(v for k, v in paths[path].items()):
            raise AssertionError(f"gate mode launched a kernel of K1-K5: {paths[path]}")
    if any(c["pivot_tile"] or c["pivot_pre_tile"] for c in paths.values()):
        raise AssertionError("a search path launched a single-tile K1 or K2")
    report(dev, paths, par, lanes_par, rates, placement, **res)
    return 0


def after_gate_phases(dev, paths: dict, par: dict) -> dict:
    """Phases 8-11, 13, 14, 14f and 14h of the default run, each CLI run a
    counted path added to ``paths``; returns what the report reads."""
    # Phase 8: resilience, each case a counted path.
    outdir = tempfile.mkdtemp(prefix="chip_smoke-")
    try:
        crash = phase_crash_resume(dev, outdir)
        paths["crash_resume"] = {k: 0 for k in paths["g99_native"]} | {
            k: crash[k] for k in ("lut5_filter", "pivot_window")}
        faulted = {}
        for name in G99_FAULTED:
            paths[name] = on_path(name, lambda n=name: faulted.update(
                {n: phase_g99_faulted(dev, outdir, n)}))
    finally:
        shutil.rmtree(outdir, ignore_errors=True)
    for name, (_, st, wall) in faulted.items():
        fault_line(f"phase 8 {name}", wall, paths[name], st)
    b, c, dd = (faulted[n][1] for n in G99_FAULTED)
    if (b.get("deadline_breaches"), b.get("dispatch_retries"),
            b.get("circuit_breaker_trips", 0)) != (1, 1, 0) or \
            paths["g99_hang1"]["pivot_window"] != paths["g99_native"]["pivot_window"]:
        raise AssertionError(f"8b: expected 1 breach, 1 retry, no trip and 7d's K1 "
                             f"windows: {paths['g99_hang1']} {b}")
    if (c.get("deadline_breaches"), c.get("dispatch_retries"),
            c.get("circuit_breaker_trips")) != (3, 2, 1) or \
            paths["g99_hang_all"]["pivot_window"] or \
            paths["g99_hang_all"]["lut5_filter"] <= 0:
        raise AssertionError(f"8c: expected 3 breaches, 1 trip, no K1 window and "
                             f"K3 launches: {paths['g99_hang_all']} {c}")
    service_lines = [ln for ln in dd["stderr"].splitlines()
                     if "device-work service failed inside the native engine" in ln]
    if len(service_lines) != 1 or not dd.get("python_nodes") or \
            paths["g99_devcb"]["pivot_window"] <= 0 or dd.get("deadline_breaches"):
        raise AssertionError(f"8d: expected one stderr line and the node on the "
                             f"Python engine with K1 windows: {paths['g99_devcb']} "
                             f"{dd}")
    log(f"  8d stderr: {service_lines[0]}")

    outdir = tempfile.mkdtemp(prefix="chip_smoke-")
    try:
        cost = phase_journal_cost(dev, outdir)
        # Phase 10: the telemetry on the G = 99 resume (both routes) and on
        # DES S1 (device route), each a counted path.
        traced = {}
        for name in TRACED_RUNS:
            ref = cost.get(name, {}).get("wall")
            paths[f"traced_{name}"] = on_path(f"traced_{name}", lambda n=name, r=ref:
                                              traced.update({n: phase_traced(dev, outdir, n, r)}))
            if name.startswith("g99"):
                traced[name]["syncs"] = phase_traced_syncs(dev, outdir, name)
    finally:
        shutil.rmtree(outdir, ignore_errors=True)
    k3 = traced["des_s1"]["row"]
    log(f"phase 10b K3 attribution row (DES S1, N = 2^17 x 64 rows): "
        f"{k3['dispatches']} launches, "
        f"{1e3 * k3['mean_dispatch_latency_s']:.5f} ms per launch by CUDA events "
        f"around the launch in its entry point against a bound of {1e3 * k3['bound_s']:.5f} ms "
        f"(phase 2's profiler: {par['lut5_filter']['device_ms']} device ms)")
    for name in TRACED_RUNS:
        kernel, launches = TRACED_RUNS[name][6:8]
        if paths[f"traced_{name}"][kernel] != launches:
            raise AssertionError(f"10 {name}: {paths[f'traced_{name}'][kernel]} "
                                 f"{kernel} launches, expected {launches}")

    # Phase 11: the job axis, the CLI runs of JOB_RUNS, each a counted path
    # (11e ran after phase 2).
    jobs = phase_jobs(dev, on_path)
    for case, (counts, _, _) in jobs.items():
        paths[case] = counts
    # Phase 12 (chained rounds, the serve and the result store) runs in a
    # child (CHILD_PHASES).
    # Phase 13: the HTTP admission front door.
    paths["net_chain8_dev"] = phase_net(dev, on_path)["counts"]
    # Phase 14: several shards and processes on the card.
    mesh = phase_mesh(dev, on_path)
    paths.update(mesh["paths"])
    # Phase 14f: the fleets of four job shards on the card.
    fleet_shards = phase_fleet_shards(dev, on_path)
    paths.update(fleet_shards["paths"])
    # Phase 14h: the same fleets on 4 job shards x 2 candidate shards.
    fleet_cands = phase_fleet_shards(dev, on_path, "14h", 2)
    paths.update(fleet_cands["paths"])
    return {"mesh": mesh, "fleet_shards": fleet_shards,
            "fleet_candidates": fleet_cands}


def report(dev, paths, par, lanes_par, rates, placement, mesh, fleet_shards,
           fleet_candidates):
    """The kernels' JSON line, the card's line and the result line."""
    import torch

    for name in LANE_KERNELS:
        par[name] = dict(lanes_par[(name, 8)])
        par[name]["also"] = [lanes_par[(name, 64)]]

    kernels = []
    for name, (route, source, replaces, home) in (KERNELS | LANE_KERNELS).items():
        r = par[name]
        bound_ms, bound_by, bound_form = bound(r)
        also = []
        for extra in r.get("also", []):
            b_ms, b_by, b_form = bound(extra)
            also.append({k: extra[k] for k in ("shape", "ms", "device_ms", "plain_ms")
                         if k in extra}
                        | ({"single_ms": extra["single_ms"]} if "single_ms" in extra
                           else {})
                        | {"bound_ms": b_ms, "bound_by": b_by,
                           "bound_formulation": b_form})
            log(f"  {name} at {extra['shape']}: {extra['ms']:.4f} ms per call "
                f"(device {extra['device_ms']}), plain {extra['plain_ms']:.3f} ms, "
                f"bound {b_ms:.5f} ms by {b_by} ({b_form})")
        per_tile = {}
        if "tiles" in r:
            per_tile = {"tiles": paths[home][f"{name}_tiles"],
                     "tiles_by_path": {p: c[f"{name}_tiles"] for p, c in paths.items()},
                     "tiles_per_launch": r["tiles"],
                     "ms_per_tile": r["ms"] / r["tiles"],
                     "device_ms_per_tile": None if r["device_ms"] is None
                     else r["device_ms"] / r["tiles"],
                     "bound_ms_per_tile": bound_ms / r["tiles"]}
        if name in ("pivot_window", "pivot_pre"):
            # Phase 14: the window launches of each mesh shard, by path
            # (14b's two ranks in their own processes, 14e's rates).
            per_tile["shard_launches_by_path"] = {
                p: sh for p, sh in mesh["shards"].items()
                if (name == "pivot_pre") == p.endswith("_pre")}
            if name == "pivot_window":
                per_tile["mesh_rates"] = {
                    t: {k: r[k] for k in ("shards", "cand_per_s", "windows",
                                          "window_reduces", "shard_launches")}
                    for t, r in mesh["rates"].items()}
        kernels.append(per_tile | {
            "name": name, "route": route, "source": source,
            "replaces": replaces, "launches": paths[home][name],
            "path": home,
            "launches_by_path": {p: c[name] for p, c in paths.items()},
            "max_abs_err": r["max_abs_err"], "mismatches": r["mismatches"],
            "ms": r["ms"], "device_ms": r["device_ms"], "plain_ms": r["plain_ms"],
            "bound_ms": bound_ms, "bound_by": bound_by,
            "bound_formulation": bound_form,
            "library_ms": None, "shape": r["shape"], "also": also,
        } | ({"gemm_only_ms": r["gemm_only_ms"]} if "gemm_only_ms" in r else {})
          | ({"single_lane_ms": r["single_ms"]} if "single_ms" in r else {})
          | ({"job_shard_launches_by_path": {
              p: by[name] for f in (fleet_shards, fleet_candidates)
              for p, by in f["job_shards"].items() if name in by},
              "candidate_shard_launches_by_path": {
              p: by[name] for p, by in
              fleet_candidates["candidate_shards"].items() if name in by}}
             if name in LANE_KERNELS else {}))
    for g, r in rates.items():
        log(f"pivot G={g}: {r['cand_per_s']:.6e} cand/s (node), "
            f"{r['sweep_cand_per_s']:.6e} cand/s (sweep alone), "
            f"{r['sweep_pre_cand_per_s']:.6e} cand/s (sweep alone, pre), "
            f"{100 * r['sweep_busy']:.1f}% busy (the sweep alone, profiled), "
            f"{r['windows']} windows, {r['tiles_solved']} of {r['tiles']} tiles solved")
    for g, r in placement.items():
        log(f"gate_step G={g}: device {r['device_ms']:.3f} ms, host "
            f"{r['host_ms']:.3f} ms")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(gpu_line(), flush=True)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)


if __name__ == "__main__":
    sys.exit(main())
