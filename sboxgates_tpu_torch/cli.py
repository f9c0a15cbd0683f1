"""Command-line interface of the PyTorch/CUDA port.

Flag-for-flag with the JAX package's CLI (and the reference,
sboxgates.c:43-73, 895-986) for what the port covers: gate-mode searches
(AND/OR/XOR gates and their NOT-augmented and 3-input forms) and, with
``-l``, LUT-mode searches, for all outputs or one (``-o``), with ``-i -p -a
-n -s -v -g``, ``--seed`` and ``--output-dir``; the same validation failures
print the same one-line messages.  Searches write
``O-GGG-MMMM-N-FFFFFFFF.xml`` state files, byte for byte the files the JAX
package writes for the same command and seed.

Placement follows the JAX package: every search node runs on the native
host runtime (``csrc/runtime.cpp``, built at first use into
``build/torch_native/``), the whole recursion in its native engine, and the
LUT engine sends the nodes that need device work (the pivot 5-LUT sweep,
head-solver overflows, the staged 7-LUT) to the device.  With
``SBG_DISABLE_NATIVE`` set (read on every call) every node runs on the
device instead, as in the JAX package with the same variable: the two
routes write different files for a randomized search, each the JAX CLI's.

``--device`` picks where the device sweeps run: ``cuda`` (the default)
launches the hand-written kernels and fails when no card is usable; ``cpu``
must be asked for.  ``--pivot-backend`` picks the pivot 5-LUT tile kernel,
the counterpart of the JAX package's ``SBG_PIVOT_BACKEND``: ``packed`` (the
default) runs it on packed cell words on the integer pipe, ``pre`` on int8
lanes expanded once per node, on the tensor cores; both sweep windows of
tiles and give the same files.  ``--candidate-order spectral`` sweeps the
candidate chunks and pivot tiles in Walsh-score tiers best-first (the
Walsh-score kernel K5 on the card).  ``-c``/``-d`` convert a saved state to
C/CUDA source or Graphviz DOT, the JAX package's text.

Every search keeps the JAX CLI's crash-safe journal in its output directory
(``search.journal.jsonl`` and ``search.journal.json``, the same bytes for
the same command): ``--resume-run DIR`` continues a killed run, the port's
or the JAX CLI's, to the files the uninterrupted run writes.
``--dispatch-timeout`` arms the hung-sweep deadline (retries, then the host
chunk stream), and ``SBG_FAULTS`` the fault sites
(``resilience/faults.py``).

Several shards and processes, as in the JAX CLI: ``--mesh`` shards the
candidate sweeps over every visible card (``SBG_LOCAL_SHARDS=N`` sets the
local shard count, N shards taking the devices in turn: ``parallel/``),
``--coordinator HOST:PORT --num-processes N --process-id I`` (or the JAX
package's ``JAX_COORDINATOR_ADDRESS``, ``JAX_NUM_PROCESSES`` and
``JAX_PROCESS_ID``) joins N processes into one ``torch.distributed``
group whose mesh spans every rank's shards (rank 0 writes the files), and
``--shard-sweep`` gives each process its slice of a several-box or
permutation sweep instead (journals under ``shard-NN/``);
``--fleet-candidates C`` (and ``--fleet`` on several local shards) builds
the JAX package's (jobs, candidates) fleet mesh of n/C job shards: the
jobs buckets are padded to multiples of the job shards, so the seed draws
are the JAX CLI's, and each job shard's lanes of every K1 and K3
lane-form launch are split over its C devices, each taking a contiguous
piece of the candidates (the rest of each round runs on the first card).

The job axis, as in the JAX CLI: several S-box files or ``--permute-sweep``
run a sweep of jobs (``search/multibox.py``; states in per-box or ``pXX/``
subdirectories), ``--batch-iterations`` runs the ``-i`` restarts as one
batch, and ``--fleet`` runs the jobs as fleet waves whose sweeps merge
into the kernels' lane forms; ``--serial-mux`` turns off the concurrent
mux that a card runs by default (``Options.parallel_mux``).
``--chain-rounds N`` solves the missing outputs of a LUT search as one
greedy chain of rounds, up to N per device call (``search/rounds.py``).

Serving, as in the JAX CLI: ``--serve`` runs each input file as one job
of the fault-tolerant queue of ``search/serve.py`` (``--serve-lanes``,
``--serve-retries``, ``--serve-timeout``, ``--serve-no-merge``; per-job
files under ``DIR/<job-id>/``), ``--serve-port`` with
``--serve-token-file`` opens the authenticated HTTP admission front door
of ``serve_net/`` (``POST /v1/jobs``, ``GET /v1/jobs/<id>?wait=N``; the
run then lasts until ``SIGTERM``), and ``--result-store DIR`` (or
``SBG_RESULT_STORE``) publishes finished circuits to the content-addressed
store of ``store/``, which serve admission consults first.

Telemetry, as in the JAX CLI: with an explicit ``--output-dir`` (or
``--resume-run``) a run also writes the heartbeat ``telemetry.jsonl``
(``--metrics-interval``) and an atomic ``metrics.json`` at exit, and an
incident (deadline exhaustion, breaker trip, injected crash, ``SIGTERM``,
fatal exception) leaves a flight-recorder dump there; ``--trace [FILE]``
exports a Perfetto trace, ``--status-port`` serves ``/status``.  None of it
changes a result.
"""

from __future__ import annotations

import argparse
import os
import signal
import sys
import threading
from typing import List, Optional

from .core import boolfunc as bf
from .graph.state import GATES, SAT, State
from .graph.xmlio import StateLoadError, load_state
from .resilience.deadline import DispatchTimeout, run_with_deadline
from .utils.sbox import SboxError, load_sbox, num_outputs


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="sboxgates",
        description=(
            "Generates graphs of Boolean gates or 3-bit LUTs that realize a "
            "target S-box. PyTorch/CUDA port of sboxgates_tpu."
        ),
    )
    p.add_argument("input", nargs="*", help="S-box table file")
    p.add_argument("-a", "--available-gates", type=int, default=None, metavar="NUM",
                   help="bitfield of available 2-input gate types (default AND+OR+XOR = 194)")
    p.add_argument("-c", "--convert-c", action="store_true",
                   help="convert an XML state file to C/CUDA source")
    p.add_argument("-d", "--convert-dot", action="store_true",
                   help="convert an XML state file to Graphviz DOT")
    p.add_argument("-g", "--graph", metavar="FILE", default=None,
                   help="resume from a saved XML state")
    p.add_argument("-i", "--iterations", type=int, default=1, metavar="NUM",
                   help="number of search iterations (default 1)")
    p.add_argument("-l", "--lut", action="store_true",
                   help="generate LUT graphs (3-input LUTs)")
    p.add_argument("-n", "--append-not", action="store_true",
                   help="append NOT gates to available gate outputs/inputs")
    p.add_argument("-o", "--single-output", type=int, default=-1, metavar="NUM",
                   help="generate only output bit NUM (0-7)")
    p.add_argument("-p", "--permute", type=int, default=0, metavar="NUM",
                   help="XOR the S-box input with NUM before searching")
    p.add_argument("-s", "--sat-metric", action="store_true",
                   help="optimize for SAT/CNF metric instead of gate count")
    p.add_argument("-v", "--verbose", action="count", default=0,
                   help="increase verbosity (repeatable)")
    p.add_argument("--seed", type=int, default=None,
                   help="PRNG seed for reproducible randomized search")
    p.add_argument("--batch-iterations", action="store_true",
                   help="run the -i restarts as one concurrent batch "
                        "(independent restarts whose sweeps merge into "
                        "lane-batched launches) instead of a serial loop")
    p.add_argument("--permute-sweep", action="store_true",
                   help="search every input permutation (all 2^n -p values) "
                        "as one sweep of jobs; states land in pXX/ "
                        "subdirectories of --output-dir")
    p.add_argument("--serial-jobs", action="store_true",
                   help="run multi-S-box / permute-sweep jobs serially "
                        "instead of as a rendezvous batch")
    p.add_argument("--fleet", action="store_true",
                   help="fleet-batched execution: all jobs (multi-S-box "
                        "sweeps, --permute-sweep, -i restarts) run "
                        "concurrently and their same-kind sweeps, node heads "
                        "and streams alike, merge into ONE launch of the "
                        "kernels' lane forms per round")
    p.add_argument("--mesh", action="store_true",
                   help="shard candidate sweeps over all visible devices "
                        "(SBG_LOCAL_SHARDS=N: N local shards instead)")
    p.add_argument("--fleet-candidates", type=int, default=1, metavar="C",
                   help="the JAX CLI's (jobs, candidates) fleet split of "
                        "the local shards (n/C, C): the jobs buckets are "
                        "padded to multiples of the n/C job shards, so the "
                        "seed draws match the JAX CLI's, and each job "
                        "shard's lane-form launches are split over its C "
                        "devices, a contiguous piece of the candidates on "
                        "each (default 1; must divide the local shard "
                        "count)")
    p.add_argument("--fleet-max-wave", type=int, default=256, metavar="N",
                   help="jobs per fleet wave (resident-thread cap, "
                        "default 256).  The wave is the unit per-job "
                        "seeds are drawn in, so this shapes the "
                        "deterministic draw stream and is journaled for "
                        "--resume-run")
    p.add_argument("--shard-sweep", action="store_true",
                   help="several processes: partition the multi-box / "
                        "permute sweep across processes (each searches "
                        "its own slice on its local shards) instead of "
                        "running every search across the whole group; "
                        "with --fleet, each process runs its slice as a "
                        "local fleet")
    p.add_argument("--serial-mux", action="store_true",
                   help="disable concurrent exploration of mux select bits "
                        "(on by default on a card, off on the CPU; one "
                        "sweep in flight at a time)")
    p.add_argument("--serve", action="store_true",
                   help="multi-tenant serve mode: each input S-box file "
                        "becomes one job in a fault-tolerant queue over one "
                        "shared context (search/serve.py): lane admission, "
                        "priority preemption by journal snapshot and "
                        "requeue (bit-exact resume), per-job retry, timeout "
                        "and backoff with quarantine for poison jobs, and a "
                        "graceful SIGTERM drain; requires an explicit "
                        "--output-dir (per-job journals and files live "
                        "under DIR/<job-id>/)")
    p.add_argument("--serve-lanes", type=int, default=4, metavar="N",
                   help="concurrent serve job lanes (default 4)")
    p.add_argument("--serve-retries", type=int, default=2, metavar="N",
                   help="failed attempts a serve job may retry (with "
                        "exponential backoff) before it is quarantined "
                        "(default 2)")
    p.add_argument("--serve-timeout", type=float, default=None, metavar="S",
                   help="per-attempt wall budget of one serve job in "
                        "seconds (default: unbounded); a breach is raised "
                        "at the job's next journal boundary and consumes "
                        "one retry")
    p.add_argument("--serve-port", type=int, default=None, metavar="PORT",
                   help="serve mode only: open the network admission "
                        "service on http://127.0.0.1:PORT (0 binds an "
                        "ephemeral port) — an authenticated, quota-"
                        "enforced HTTP front door (serve_net/): POST "
                        "/v1/jobs submits a query idempotently (repeat "
                        "of a stored query answers 200 with the circuit "
                        "and zero device dispatches; an in-flight "
                        "duplicate joins the existing search), GET "
                        "/v1/jobs/<id>?wait=N long-polls progress, and "
                        "every accepted job is fsync'd to an admission "
                        "journal BEFORE its 202 so a crash loses "
                        "nothing (restart replays it); requires "
                        "--serve-token-file")
    p.add_argument("--serve-token-file", default=None, metavar="FILE",
                   help="per-tenant bearer-token file for --serve-port "
                        "(JSON: {\"version\": 1, \"tenants\": {name: "
                        "{\"token\": ..., \"max_jobs\": N, "
                        "\"rate_per_s\": R, \"burst\": B}}}); loaded "
                        "FAIL-CLOSED — a missing, corrupt, or world-"
                        "writable file refuses to serve rather than "
                        "admit openly")
    p.add_argument("--serve-no-merge", action="store_true",
                   help="disable merged serve waves: same-bucket jobs "
                        "admitted together then dispatch their sweeps "
                        "independently instead of as one lane-form call "
                        "per round (SBG_SERVE_NO_MERGE=1 is the "
                        "environment's form; the same files either way)")
    p.add_argument("--chain-rounds", type=int, default=0, metavar="N",
                   help="greedy chained-outputs driver (LUT mode, "
                        "--iterations 1): solve the missing outputs as one "
                        "chain of rounds, up to N rounds per device call "
                        "(search/rounds.py; 0 = off, the default beam "
                        "search).  A round the round driver cannot finish falls "
                        "back to the full recursive search; the same "
                        "circuit for every N > 0")
    p.add_argument("--output-dir", default=None, metavar="DIR",
                   help="directory for saved XML states (default: cwd)")
    p.add_argument("--result-store", default=None, metavar="DIR",
                   help="content-addressed result store (default: "
                        "SBG_RESULT_STORE; an empty string disables): "
                        "finished circuits (and interrupted searches' "
                        "frontiers) are published to DIR keyed on the "
                        "canonical form of (target, mask, metric) under "
                        "input permutation and negation and output "
                        "complement, and serve admission answers a repeat "
                        "query from DIR with no device work (the stored "
                        "circuit re-verified over all 2^8 inputs first); "
                        "an unwritable DIR degrades to read-only lookups")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where the sweeps run (default cuda; cpu runs the "
                        "kernels' plain PyTorch versions)")
    p.add_argument("--pivot-backend", choices=("packed", "pre"), default="packed",
                   help="pivot 5-LUT tile kernel: packed cell words (default) "
                        "or int8 lanes expanded before the launch; same results")
    p.add_argument("--candidate-order", default="lex", metavar="ORDER",
                   help="sweep-stream candidate order: 'lex' (default) "
                        "streams rank chunks lexicographically; "
                        "'spectral' scores the gate tables against the "
                        "masked target on device (Walsh correlation, "
                        "ops/spectral.py) and sweeps the score tiers "
                        "best-first.  Ordering only — run-to-exhaustion "
                        "visits the identical hit set either way, and "
                        "the order is a deterministic function of the "
                        "search state (no RNG, no wall clock), so "
                        "resume stays bit-identical")
    p.add_argument("--pipeline-depth", type=int, default=2, metavar="N",
                   help="chunks the host chunk stream makes ahead and filter "
                        "launches it keeps in flight (default 2; 1 = serial; "
                        "results are bit-identical either way)")
    p.add_argument("--compile-cache", default=None, metavar="DIR",
                   help="accepted for the JAX CLI's command lines: its "
                        "persistent XLA compile cache has nothing to cache "
                        "here (the CUDA kernels are built once, at first "
                        "use); no effect")
    p.add_argument("--no-warmup", action="store_true",
                   help="accepted for the JAX CLI's command lines: there "
                        "is no background kernel warmer here; no effect")
    p.add_argument("--resume-run", metavar="DIR", default=None,
                   help="resume a killed search from DIR's journal (written "
                        "by a run with --output-dir DIR, of this CLI or the "
                        "JAX package's); the search configuration comes from "
                        "the journal and the final files are the "
                        "uninterrupted run's")
    p.add_argument("--dispatch-timeout", type=float, default=None, metavar="S",
                   help="hung-dispatch deadline of the device sweeps in "
                        "seconds (default: SBG_DISPATCH_TIMEOUT_S or off); a "
                        "breach retries with backoff, then the search "
                        "degrades to the host chunk stream for the rest of "
                        "the run")
    p.add_argument("--trace", nargs="?", const="", default=None,
                   metavar="FILE",
                   help="record structured spans (every dispatch, "
                        "deadline window, journal write) and export a "
                        "Chrome/Perfetto trace.json at exit (to FILE, "
                        "default trace.json in --output-dir); purely "
                        "observational — results are bit-identical with "
                        "or without it")
    p.add_argument("--status-port", type=int, default=None, metavar="PORT",
                   help="serve a read-only live-introspection endpoint "
                        "on http://127.0.0.1:PORT/status — a JSON "
                        "snapshot of counters, histogram quantiles, "
                        "search-space coverage with derived ETA, "
                        "breaker state, and the per-kernel roofline "
                        "attribution table; 0 binds an ephemeral port "
                        "(reported in the heartbeat start line's "
                        "config).  Observation-only: results are "
                        "bit-identical with or without it")
    p.add_argument("--coordinator", metavar="HOST:PORT", default=None,
                   help="several processes: rank 0's address for the "
                        "torch.distributed group (tcp:// init; or set "
                        "JAX_COORDINATOR_ADDRESS); implies --mesh")
    p.add_argument("--num-processes", type=int, default=None, metavar="N",
                   help="several processes: total number of processes")
    p.add_argument("--process-id", type=int, default=None, metavar="I",
                   help="several processes: this process's rank (0-based)")
    p.add_argument("--metrics-interval", type=float, default=60.0,
                   metavar="S",
                   help="telemetry heartbeat period in seconds (default "
                        "60): with an explicit --output-dir, a "
                        "background thread appends one fsync'd counter "
                        "line per period to telemetry.jsonl and an "
                        "atomic metrics.json snapshot is written at "
                        "exit; 0 disables the periodic line (the final "
                        "snapshot is still written)")
    return p


#: The journal's recorded configuration, the JAX CLI's keys
#: (sboxgates_tpu/cli.py): one list drives the record and the restore.
JOURNAL_CONFIG_KEYS = (
    "permute",
    "iterations",
    "single_output",
    "available_gates",
    "seed",
    "sat_metric",
    "lut",
    "append_not",
    "batch_iterations",
    "permute_sweep",
    "serial_jobs",
    "serial_mux",
    "mesh",
    "fleet",
    "fleet_candidates",
    "fleet_max_wave",
    "shard_sweep",
    "pipeline_depth",
    "serve",
    "serve_lanes",
    "serve_retries",
    "serve_timeout",
    "chain_rounds",
    "candidate_order",
    "result_store",
    "serve_port",
    "serve_token_file",
)

#: Keys a journal of an earlier build of the same version may lack, with
#: the value every such build ran with (the JAX CLI's table).
JOURNAL_KEY_DEFAULTS = {
    "fleet_candidates": 1,
    "fleet_max_wave": 256,
    "serve": False,
    "serve_lanes": 4,
    "serve_retries": 2,
    "serve_timeout": None,
    "chain_rounds": 0,
    "candidate_order": "lex",
    "result_store": None,
    "serve_port": None,
    "serve_token_file": None,
}


def _err(msg: str) -> int:
    print(msg, file=sys.stderr)
    return 1


def _resume_config(args) -> Optional[int]:
    """Restores the journaled configuration of ``--resume-run`` into
    ``args`` (before validation, as the JAX CLI does); returns an exit
    code when the run must stop, else None with ``args.journal`` set."""
    from .resilience.journal import JOURNAL_VERSION, JournalError, SearchJournal

    # The journaled configuration decides whether this is a sharded
    # resume; an explicit --shard-sweep only cross-checks it.
    shard_requested = args.shard_sweep
    try:
        journal = SearchJournal.resume(args.resume_run)
    except JournalError as e:
        return _err(f"Error: {e}")
    ver = journal.records[0].get("version")
    if ver != JOURNAL_VERSION:
        return _err(
            f"Error: journal in {args.resume_run} has version {ver}, "
            f"this build reads version {JOURNAL_VERSION}; re-run the "
            "search instead of resuming."
        )
    cfg = journal.config
    args.output_dir = args.resume_run
    try:
        args.input = list(cfg["input"])
        args.graph = cfg["graph"]
        for key in JOURNAL_CONFIG_KEYS:
            if key not in cfg and key in JOURNAL_KEY_DEFAULTS:
                setattr(args, key, JOURNAL_KEY_DEFAULTS[key])
                continue
            setattr(args, key, cfg[key])
    except KeyError as e:
        return _err(
            f"Error: journal in {args.resume_run} lacks the recorded "
            f"setting {e}; it was written by an incompatible build — "
            "re-run the search instead of resuming."
        )
    if shard_requested and not args.shard_sweep:
        return _err(
            f"Error: journal in {args.resume_run} records a "
            "non-sharded run, but --shard-sweep was given; resume "
            "without it (the journaled configuration decides the "
            "execution mode)."
        )
    if args.serve:
        # The run being resumed was a serve run: its resume is per job.
        return _err(
            f"Error: journal in {args.resume_run} records a "
            "serve-mode run; re-run --serve with the same inputs "
            "and --output-dir instead of --resume-run (each job "
            "resumes bit-identically from its per-job journal)."
        )
    if journal.complete:
        print(f"Run in {args.resume_run} is already complete; nothing to resume.")
        return 0
    args.journal = journal
    return None


def _check_serve_port(args) -> Optional[int]:
    """The JAX CLI's checks of ``--serve-port``, in its order and with its
    one-line messages: serve mode, the port's range, a token file that
    loads fail-closed (before anything heavy is imported), and a port that
    binds now (0 always binds).  Returns an exit code, or None."""
    if not args.serve:
        return _err(
            "--serve-port requires --serve (and an explicit "
            "--output-dir): the admission service fronts the serve "
            "orchestrator."
        )
    if not (0 <= args.serve_port <= 65535):
        return _err(f"Bad serve port value: {args.serve_port}")
    if args.serve_token_file is None:
        return _err(
            "--serve-port requires --serve-token-file: network "
            "admission is authenticated-only (never open)."
        )
    from .serve_net import TokenFileError, TokenStore, check_file

    problem = check_file(args.serve_token_file)
    if problem is not None:
        return _err(problem)
    try:
        TokenStore.load(args.serve_token_file)
    except TokenFileError as e:
        return _err(str(e))
    import socket

    probe = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    try:
        probe.bind(("127.0.0.1", args.serve_port))
    except OSError as e:
        return _err(
            f"serve port {args.serve_port} unavailable: {e.strerror or e}"
        )
    finally:
        probe.close()
    return None


def _probe_device(name: str) -> Optional[str]:
    """The card's first touch under ``SBG_DEVICE_PROBE_TIMEOUT_S`` (default
    60 s, 0 = no deadline): returns a one-line error, or None."""
    import torch

    from .search.context import resolve_device

    def touch():
        # A context and a round trip to the card, and no kernel: a run on
        # the native route launches none.
        dev = resolve_device(name)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    probe_s = float(os.environ.get("SBG_DEVICE_PROBE_TIMEOUT_S", "60"))
    try:
        run_with_deadline(touch, probe_s, "device probe")
    except DispatchTimeout:
        return (
            f"Error: the {name} device did not answer within {probe_s:.0f}s; "
            "pass --device cpu to run on the host, or set "
            "SBG_DEVICE_PROBE_TIMEOUT_S to adjust or disable the probe."
        )
    except (RuntimeError, ValueError) as e:
        return f"Error: {(str(e).splitlines() or ['unknown error'])[0]}"
    return None


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    # Telemetry files (heartbeat, metrics.json, flight dumps) live with the
    # journal in an explicit --output-dir (--resume-run implies one); the
    # cwd default must not sprout them wherever the tool runs.
    outdir_explicit = args.output_dir is not None or args.resume_run is not None
    # The result store: SBG_RESULT_STORE applies only when the flag is
    # absent (an explicit empty string disables it); a resume restores the
    # journaled value instead.
    if args.result_store is None and args.resume_run is None:
        args.result_store = os.environ.get("SBG_RESULT_STORE") or None
    elif args.result_store == "":
        args.result_store = None
    args.journal = None
    if args.resume_run is not None:
        if args.serve:
            return _err(
                "Error: --serve cannot be combined with --resume-run; a "
                "killed serve run resumes by re-running --serve with "
                "the same inputs and --output-dir (each job continues "
                "from its per-job journal)."
            )
        rc = _resume_config(args)
        if rc is not None:
            return rc

    # Validation mirroring parse_opt (sboxgates.c:895-986), in the JAX
    # package's order and with its messages.
    if args.available_gates is not None and not (
        0 < args.available_gates <= 65535
    ):
        return _err(f"Bad available gates value: {args.available_gates}")
    if args.iterations < 1:
        return _err(f"Bad iterations value: {args.iterations}")
    if args.single_output != -1 and not (0 <= args.single_output <= 7):
        return _err(f"Bad output value: {args.single_output}")
    if not (0 <= args.permute <= 255):
        return _err(f"Bad permutation value: {args.permute}")
    if args.pipeline_depth < 1:
        return _err(f"Bad pipeline depth value: {args.pipeline_depth}")
    if args.convert_c and args.convert_dot:
        return _err("Cannot combine c and d options.")
    if args.lut and args.sat_metric:
        return _err("SAT metric can not be combined with LUT graph generation.")
    if not args.input:
        return _err("Input file name argument missing.")
    multibox = len(args.input) > 1
    if multibox and (args.convert_c or args.convert_dot):
        return _err("Cannot convert more than one file.")
    if multibox and args.graph is not None:
        return _err("Cannot combine -g with multiple S-box files.")
    if args.permute_sweep and (multibox or args.graph is not None):
        return _err("--permute-sweep takes a single S-box file and no -g.")
    if args.permute_sweep and args.permute:
        return _err("--permute-sweep replaces -p; do not combine them.")
    if args.shard_sweep and not (multibox or args.permute_sweep):
        return _err(
            "--shard-sweep requires a sweep to shard: multiple S-box "
            "files or --permute-sweep."
        )
    if args.fleet and args.serial_jobs:
        return _err(
            "--fleet and --serial-jobs are incompatible: the fleet's "
            "whole point is merging the jobs' dispatches."
        )
    if args.result_store is not None and (
        args.convert_c or args.convert_dot
    ):
        return _err(
            "--result-store has no effect on -c/-d conversion; drop it."
        )
    if args.result_store is not None and args.serve and (
        args.output_dir is None
    ):
        return _err(
            "--result-store on a serve run requires an explicit "
            "--output-dir: store hits land as per-job artifacts under "
            "DIR/<job-id>/."
        )
    if args.serve:
        # The orchestrator owns scheduling and the execution shape.
        for flag, name in (
            (args.convert_c, "-c"),
            (args.convert_dot, "-d"),
            (args.graph is not None, "-g"),
            (args.permute_sweep, "--permute-sweep"),
            (args.shard_sweep, "--shard-sweep"),
            (args.mesh, "--mesh"),
            (args.fleet, "--fleet"),
            (args.batch_iterations, "--batch-iterations"),
            (args.serial_jobs, "--serial-jobs"),
        ):
            if flag:
                return _err(
                    f"--serve cannot be combined with {name}; the serve "
                    "orchestrator owns job scheduling over the shared "
                    "warm context."
                )
        if args.output_dir is None:
            return _err(
                "--serve requires an explicit --output-dir: per-job "
                "journals, checkpoints, and telemetry artifacts live "
                "under DIR/<job-id>/."
            )
        if args.serve_lanes < 1:
            return _err(f"Bad serve lanes value: {args.serve_lanes}")
        if args.serve_retries < 0:
            return _err(f"Bad serve retries value: {args.serve_retries}")
        if args.serve_timeout is not None and args.serve_timeout <= 0:
            return _err(f"Bad serve timeout value: {args.serve_timeout}")
    if args.serve_no_merge and not args.serve:
        return _err("--serve-no-merge requires --serve.")
    if args.serve_port is not None:
        rc = _check_serve_port(args)
        if rc is not None:
            return rc
    elif args.serve_token_file is not None:
        return _err("--serve-token-file requires --serve-port.")
    if args.chain_rounds < 0:
        return _err(f"Bad chain rounds value: {args.chain_rounds}")
    if args.chain_rounds > 0:
        # The chained driver replaces the beam search: never silently
        # ignored by a mode it does not drive.
        if not args.lut:
            return _err(
                "--chain-rounds requires -l/--lut: the round kernel "
                "appends LUT gates."
            )
        if args.iterations != 1:
            return _err(
                "--chain-rounds requires --iterations 1: the chain is "
                "one greedy pass, not a restarted beam."
            )
        if args.single_output != -1:
            return _err(
                "--chain-rounds drives the all-outputs graph search; "
                "it cannot be combined with -o."
            )
    if args.candidate_order not in ("lex", "spectral"):
        return _err(f"Bad candidate order value: {args.candidate_order}")
    if args.fleet_candidates < 1:
        return _err(
            f"Bad fleet candidates value: {args.fleet_candidates}"
        )
    if args.fleet_max_wave < 1:
        return _err(f"Bad fleet max wave value: {args.fleet_max_wave}")
    if args.metrics_interval < 0:
        return _err(f"Bad metrics interval value: {args.metrics_interval}")
    if args.status_port is not None and not (0 <= args.status_port <= 65535):
        return _err(f"Bad status port value: {args.status_port}")

    # Conversion mode: deserialize -> emit, no search (sboxgates.c:1097-1114).
    if args.convert_c or args.convert_dot:
        from .codegen import c_function_text, digraph_text

        try:
            st = load_state(args.input[0])
        except (OSError, StateLoadError) as e:
            return _err(f"Error when reading state file {args.input[0]}: {e}")
        if args.convert_c:
            try:
                sys.stdout.write(c_function_text(st))
            except ValueError as e:
                return _err(f"Error: {e}")
        else:
            sys.stdout.write(digraph_text(st))
        return 0

    # The JAX package's switch of the native runtime: SBG_DISABLE_NATIVE
    # sends every node to the device.  SBG_ENGINE_MUX_THREADS is read by the
    # context (SearchContext.engine_mux_threads).
    native = not os.environ.get("SBG_DISABLE_NATIVE")
    if args.output_dir is None:
        args.output_dir = "."
    # Telemetry (heartbeat, metrics.json, flight dumps) is per rank: captured
    # before the non-primary ranks drop their output directory.
    tele_root = args.output_dir if outdir_explicit else None

    multiprocess = (
        args.coordinator is not None
        or args.num_processes is not None
        or "JAX_COORDINATOR_ADDRESS" in os.environ
    )
    if args.serve and multiprocess:
        return _err(
            "--serve is a single-process orchestrator over the local "
            "warm device pool; drop the multi-host flags (shard tenants "
            "across serve processes instead)."
        )
    log = print
    if args.fleet and args.mesh:
        return _err(
            "--fleet builds its own (jobs, candidates) mesh over the "
            "local devices; drop --mesh (use --fleet-candidates to "
            "shard candidates inside the fleet lanes)."
        )
    if args.fleet and multiprocess and not args.shard_sweep:
        return _err(
            "--fleet is process-local; a multi-host fleet needs "
            "--shard-sweep, which composes one local fleet per process "
            "over its slice of the sweep."
        )
    fleet_sharded = args.fleet and args.shard_sweep
    from .parallel import distributed as dist

    if multiprocess:
        # The group first (the card is probed after it); the mesh then
        # spans every rank's shards (the reference's MPI_Init and worker
        # topology, sboxgates.c:1045-1057).
        try:
            dist.initialize(args.coordinator, args.num_processes,
                            args.process_id, device=args.device)
        except (ValueError, RuntimeError) as e:
            return _err(f"Error: {(str(e).splitlines() or ['unknown'])[0]}")
        # A fleet-sharded run keeps mesh=False: each process owns a
        # local fleet, not a candidate mesh.
        if not fleet_sharded:
            args.mesh = True
        args.seed = dist.shared_seed(args.seed)
        if args.shard_sweep:
            # Job sharding: every rank owns its slice's side effects; its
            # lines carry its rank (the reference's per-rank find lines).
            _rank = dist.rank()
            log = lambda s: print(f"[{_rank:4d}] {s}")  # noqa: E731
        elif not dist.is_primary():
            # Side effects belong to rank 0 (the reference's rank-0-gated
            # printing and save_state).
            args.output_dir = None
            log = lambda s: None  # noqa: E731
    try:
        return _search(args, native, multiprocess, log, tele_root)
    finally:
        if multiprocess:
            # Rank 0 hosts the group's store: it leaves last.
            try:
                dist.barrier("exit", timeout_s=EXIT_BARRIER_S)
            except TimeoutError:
                pass
            dist.shutdown()


#: How long rank 0 waits at exit for the other ranks (a rank that died
#: never comes).
EXIT_BARRIER_S = 10.0


def _search(args, native: bool, multiprocess: bool, log, tele_root) -> int:
    """The search of :func:`main` once the flags are checked and the
    process group (if any) joined."""
    from .parallel import distributed as dist

    try:
        sbox, num_inputs = load_sbox(args.input[0], args.permute)
    except OSError:
        return _err("Error when opening target S-box file.")
    except SboxError as e:
        return _err(str(e))

    from .search import (
        Options,
        SearchContext,
        generate_graph,
        generate_graph_one_output,
        make_targets,
    )

    targets = make_targets(sbox)
    n_out = num_outputs(sbox, num_inputs)
    if args.single_output >= n_out:
        return _err(
            f"Error: Can't generate output bit {args.single_output}. "
            f"Target S-box only has {n_out} outputs."
        )
    problem = _probe_device(args.device)
    if problem is not None:
        return _err(problem)

    # Device plans build (and validate) before the journal: a refused
    # configuration must not leave a journal of a run that never started.
    mesh_plan = fleet_plan = None
    try:
        from .parallel import mesh as _mesh

        if args.fleet:
            local = _mesh.local_devices(args.device)
            if len(local) > 1 or args.fleet_candidates > 1:
                fleet_plan = _mesh.FleetPlan(_mesh.make_fleet_mesh(
                    local, candidates=args.fleet_candidates))
        elif args.shard_sweep or args.mesh:
            # A job-sharded sweep runs each slice on its local shards; a
            # plain --mesh spans every rank's.
            mesh_plan = _mesh.MeshPlan(_mesh.make_mesh(
                _mesh.local_devices(args.device) if args.shard_sweep
                else None, device=args.device))
    except (ValueError, RuntimeError) as e:
        return _err(f"Error: {e}")

    journaling = args.output_dir is not None
    if args.seed is None:
        # Materialized so the journal can reproduce the run.
        args.seed = int.from_bytes(os.urandom(4), "little")

    opt = Options(
        iterations=args.iterations,
        permute=args.permute,
        metric=SAT if args.sat_metric else GATES,
        lut_graph=args.lut,
        try_nots=args.append_not,
        avail_gates_bitfield=(
            args.available_gates
            if args.available_gates is not None
            else bf.DEFAULT_AVAILABLE
        ),
        # torchlint: ignore[R7] progress display only; never shapes the draw stream
        verbosity=args.verbose,
        seed=args.seed,
        # torchlint: ignore[R7] the device picks where the sweeps run; like the JAX CLI's platform it is not journaled (the journal stays byte-identical to the JAX CLI's), so --resume-run takes --device again
        device=args.device,
        # torchlint: ignore[R7] K1 (packed) and K2 (pre) return the same verdict on every tile, so the backend never shapes the draw stream; not journaled, like --device
        pivot_backend=args.pivot_backend,
        candidate_order=args.candidate_order,
        native=native,
        pipeline_depth=args.pipeline_depth,
        # torchlint: ignore[R7] deadline/degradation timing; results bit-identical with or without
        dispatch_timeout_s=args.dispatch_timeout,
        # torchlint: ignore[R7] telemetry is observation-only (zero-sync counter-asserted)
        trace=args.trace is not None,
        # torchlint: ignore[R7] live-introspection endpoint; observation-only, never shapes the draw stream
        status_port=args.status_port,
        batch_restarts=args.batch_iterations,
        parallel_mux=False if args.serial_mux else None,
        fleet=args.fleet,
        fleet_max_wave=args.fleet_max_wave,
        chain_rounds=args.chain_rounds,
        result_store=args.result_store,
    )

    # The journal's recorded configuration (the JAX CLI's), also the
    # multi-process start-up digest and the heartbeat start line's config.
    run_config = {key: getattr(args, key) for key in JOURNAL_CONFIG_KEYS}
    run_config["input"] = [os.path.abspath(p) for p in args.input]
    run_config["graph"] = (
        os.path.abspath(args.graph) if args.graph is not None else None
    )
    rc = _open_journals(args, run_config, journaling, multiprocess)
    if rc is not None:
        return rc
    journal = args.journal
    if multiprocess:
        # Every rank runs the same journaled configuration (inputs
        # included), or the first collective would diverge silently.
        import hashlib
        import json as _json

        digest = hashlib.sha256(
            _json.dumps(run_config, sort_keys=True, default=str).encode()
        ).hexdigest()
        try:
            dist.run_config_check(digest)
        except RuntimeError as e:
            return _err(f"Error: {e}")
    try:
        ctx = SearchContext(opt, mesh_plan=mesh_plan, fleet_plan=fleet_plan)
    except (RuntimeError, ValueError) as e:
        return _err(f"Error: {e}")
    if ctx.result_store is not None:
        note = " (read-only)" if ctx.result_store.readonly else ""
        log(f"Result store: {args.result_store}{note}")

    rank = dist.rank() if multiprocess else 0
    tele_dir = tele_root
    if tele_root is not None and multiprocess and (args.shard_sweep or rank):
        from .resilience.journal import shard_dir

        tele_dir = shard_dir(tele_root, rank)
    tele = _Telemetry(ctx, args, run_config, tele_dir, rank=rank,
                      multiprocess=multiprocess, log=log)
    try:
        if args.graph is None:
            st = State.init_inputs(num_inputs)
        else:
            try:
                st = load_state(args.graph)
            except (OSError, StateLoadError) as e:
                return _err(f"Error when reading state file {args.graph}: {e}")
        sweep = len(args.input) > 1 or args.permute_sweep
        if args.graph is not None:
            log(f"Loaded {args.graph}.")

        if args.verbose >= 1:
            # The reference's listing, trailing spaces included
            # (sboxgates.c:1080-1094).
            log("Available gates: NOT " + "".join(
                bf.GATE_NAMES[f.fun] + " " for f in ctx.avail_gates))
            log("Generated gates: " + "".join(
                bf.GATE_NAMES[f.fun] + " " for f in ctx.avail_not))
            log("Generated 3-input gates: " + "".join(
                "%02x " % f.fun for f in ctx.avail_3))
        if args.serve:
            return _run_serve(ctx, args, journal, tele)
        if sweep:
            return _run_sweep(ctx, args, sbox, num_inputs, journal, tele, log)

        if args.single_output != -1:
            generate_graph_one_output(
                ctx, st, targets, args.single_output, save_dir=args.output_dir,
                log=log, journal=journal,
            )
        else:
            generate_graph(ctx, st, targets, save_dir=args.output_dir,
                           log=log, journal=journal)
        return _finish(ctx, args, tele, log)
    except BaseException as e:
        if not isinstance(e, SystemExit):
            # Dump before the teardown: the heartbeat's incident hook is
            # still registered, so the dump also writes an incident line.
            from .telemetry import flight as _flight

            _flight.flight_dump(
                "fatal_exception", registry=ctx.stats,
                extra={"error": repr(e)},
            )
        raise
    finally:
        tele.teardown()


def _open_journals(args, run_config, journaling: bool,
                   multiprocess: bool) -> Optional[int]:
    """Sets ``args.journal``: the run journal (rank 0 writes it; a rank
    without an output directory keeps a resumed journal read-only, so it
    restores the primary's beam and PRNG position without writing), and
    for a job-sharded sweep this rank's own journal under ``shard-NN/``
    (checkpoint names relative to the run's directory).  Returns an exit
    code when the run must stop."""
    from .parallel import distributed as dist
    from .resilience.journal import JournalError, SearchJournal, shard_dir

    resume = args.resume_run is not None
    journal = args.journal
    journal_config = None
    if journaling:
        journal_config = dict(run_config)
        if args.shard_sweep:
            journal_config["shard_processes"] = (
                dist.world_size() if multiprocess else 1)
    if journaling and not resume:
        # The run journal is rank 0's (config-only for a job-sharded
        # sweep: each rank's progress goes to its shard journal).
        if not multiprocess or dist.is_primary():
            journal = SearchJournal.start(args.output_dir,
                                          config=journal_config)
    elif journal is not None and not journaling:
        journal.readonly = True
    elif not journaling:
        journal = None
    if journaling and args.shard_sweep:
        r = dist.rank() if multiprocess else 0
        nproc = dist.world_size() if multiprocess else 1
        if resume:
            rec = (journal.config if journal is not None else {}).get(
                "shard_processes")
            if rec != nproc:
                return _err(
                    f"Error: journal in {args.resume_run} records a "
                    f"{rec}-process --shard-sweep run; resume with "
                    f"the same process count (this run has {nproc})."
                )
        scfg = dict(journal_config, shard_index=r)
        sdir = shard_dir(args.output_dir, r)
        if resume:
            try:
                journal = SearchJournal.resume(sdir, ckpt_root=args.output_dir)
            except JournalError:
                # This rank died before its shard journal existed: its
                # slice reruns from the start, deterministically.
                journal = SearchJournal.start(sdir, config=scfg,
                                              ckpt_root=args.output_dir)
        else:
            journal = SearchJournal.start(sdir, config=scfg,
                                          ckpt_root=args.output_dir)
    args.journal = journal
    return None


def _finish(ctx, args, tele, log=print) -> int:
    tele.teardown()
    if args.verbose >= 2:
        log("")
        log("stats: " + " ".join(
            f"{k}={v}" for k, v in sorted(ctx.stats.items())
        ))
        # The JAX CLI's per-phase report.
        log("")
        log(ctx.prof.report(ctx.stats))
    return 0


def _run_serve(ctx, args, journal, tele) -> int:
    """``--serve``: every input file is one job of the queue of
    :mod:`.search.serve` (per-job journals and files under
    ``DIR/<job-id>/``); the run journal records the configuration and the
    final counts.  SIGTERM drains the queue before the run's own dump.

    With ``--serve-port`` the HTTP admission front door of
    :mod:`.serve_net` fronts the queue: the admission journal replays the
    jobs a previous boot admitted but did not finish before the listener
    opens, and the run lasts until SIGTERM, which closes the listener
    before it drains the queue."""
    from .resilience.deadline import DeadlineConfig
    from .search.serve import ServeJob, ServeOrchestrator

    orch = ServeOrchestrator(
        ctx, args.output_dir, lanes=args.serve_lanes,
        deadline=DeadlineConfig(
            budget_s=args.serve_timeout or 0.0, retries=args.serve_retries,
        ),
        merge=False if args.serve_no_merge else None,
    )
    tele.add_provider("serve", orch.status_view)
    net_server = None
    if args.serve_port is not None:
        from .serve_net import TokenStore
        from .serve_net.server import AdmissionServer

        net_server = AdmissionServer(
            orch, TokenStore.load(args.serve_token_file), ctx.stats,
            args.output_dir, port=args.serve_port, log=print,
        )
        replayed = net_server.replay()
        if replayed:
            print(f"serve-net: replayed {len(replayed)} admitted job(s) "
                  "from the admission journal")
        # SIGTERM closes the front door first, then drains the queue.
        tele.drain_hooks.append(net_server.close)
    tele.drain_hooks.append(lambda: orch.drain(timeout_s=10.0))
    for i, path in enumerate(args.input):
        stem = os.path.splitext(os.path.basename(path))[0]
        orch.submit(ServeJob(
            job_id=f"job{i:02d}-{stem}", sbox_path=path,
            output=args.single_output, permute=args.permute,
        ))
    orch.start()
    if net_server is not None:
        net_server.start()
        print("serve-net: admission endpoint on "
              f"http://127.0.0.1:{net_server.port}/v1/jobs", flush=True)
        # Admission arrives over HTTP, so idle is not done: only a drain
        # (SIGTERM) ends the run.
        view = orch.run_until_drained()
        net_server.close()
    else:
        view = orch.run_until_idle()
    orch.stop()
    counts = view["counts"]
    print("serve: " + "  ".join(
        f"{k}={counts.get(k, 0)}" for k in ("done", "quarantined", "preempted")
    ))
    if journal is not None and journal.writable:
        journal.append("run_done", beam=[], serve=counts)
    return _finish(ctx, args, tele)


def _run_sweep(ctx, args, sbox, num_inputs, journal, tele, log=print) -> int:
    """Several S-box files or ``--permute-sweep``: the sweep of jobs of
    :mod:`.search.multibox` (serial with ``--serial-jobs`` or a mesh, a
    fleet with ``--fleet``, else the drivers' default), states in per-box
    (``pXX/``) subdirectories of the output directory.  With
    ``--shard-sweep`` this process searches its slice only."""
    from .search.multibox import (
        load_box_jobs,
        permute_sweep_jobs,
        process_slice,
        search_boxes_all_outputs,
        search_boxes_one_output,
    )

    try:
        if len(args.input) > 1:
            boxes = load_box_jobs(args.input, args.permute)
        else:
            boxes = permute_sweep_jobs(sbox, num_inputs)
    except OSError:
        return _err("Error when opening target S-box file.")
    except SboxError as e:
        return _err(str(e))
    if args.shard_sweep:
        try:
            boxes = process_slice(boxes)
        except ValueError as e:
            return _err(f"Error: {e}")
    batched = (
        "fleet" if args.fleet
        else False if (args.serial_jobs or args.mesh) else None
    )
    try:
        if args.single_output != -1:
            search_boxes_one_output(
                ctx, boxes, args.single_output, save_dir=args.output_dir,
                log=log, batched=batched, journal=journal,
            )
        else:
            search_boxes_all_outputs(
                ctx, boxes, save_dir=args.output_dir, log=log,
                batched=batched, journal=journal,
            )
    except ValueError as e:
        return _err(f"Error: {e}")
    return _finish(ctx, args, tele, log)


class _Telemetry:
    """One run's telemetry, as the JAX CLI wires it: the ``/status``
    endpoint (``--status-port``, started first so its bound port rides the
    heartbeat's start line), the flight recorder and the heartbeat in
    ``tele_dir`` (an explicit ``--output-dir``; resume-aware), the
    ``SIGTERM`` dump, and :meth:`teardown`, which runs once on every exit
    path."""

    #: Bounded grace of the SIGTERM dump's worker (a managed host's
    #: SIGTERM-to-SIGKILL window is typically 15-30 s).
    SIGNAL_DUMP_JOIN_S = 15.0

    def __init__(self, ctx, args, run_config: dict, tele_dir: Optional[str],
                 rank: int = 0, multiprocess: bool = False, log=print):
        from .telemetry import flight as _flight
        from .telemetry.heartbeat import Heartbeat
        from .telemetry.status import StatusServer

        self.ctx = ctx
        self.args = args
        self.tele_dir = tele_dir
        self.rank = rank
        self.multiprocess = multiprocess
        self.log = log
        self._done = False
        #: Run on SIGTERM before the run's own dump (the serve drain).
        self.drain_hooks: List = []
        self.status_server = None
        if ctx.opt.status_port is not None:
            self.status_server = StatusServer(
                ctx.stats, port=ctx.opt.status_port,
                extra={"engine": ctx.status_state},
                gates_fn=lambda: ctx.last_dispatch_gates,
            ).start()
            log("Status endpoint on "
                f"http://127.0.0.1:{self.status_server.port}/status")
        self.heartbeat = None
        if tele_dir is not None:
            _flight.configure(tele_dir, rank=rank)
            hb_config = run_config
            if self.status_server is not None:
                # A copy: the journal's config never records the port.
                hb_config = dict(run_config, status_port=self.status_server.port)
            self.heartbeat = Heartbeat(
                ctx.stats, tele_dir, interval_s=args.metrics_interval, rank=rank,
                resume=args.resume_run is not None, run_config=hb_config,
            ).start()
        # Preemption delivers SIGTERM before the kill: the dump and the
        # whole teardown run on a worker thread with a bounded join (the
        # handler interrupts the main thread, which may hold a telemetry
        # lock), then the signal is raised again with its default action,
        # so the exit status still says SIGTERM.  SIGINT keeps Python's
        # KeyboardInterrupt, which reaches the fatal-exception dump.
        self._prev_handlers = {}
        if threading.current_thread() is threading.main_thread():
            try:
                self._prev_handlers[signal.SIGTERM] = signal.signal(
                    signal.SIGTERM, self._on_signal
                )
            except (ValueError, OSError):
                pass

    def _on_signal(self, signum, frame) -> None:
        from .telemetry import flight as _flight

        name = signal.Signals(signum).name

        def work() -> None:
            for hook in list(self.drain_hooks):
                try:
                    hook()
                except Exception as e:
                    import logging

                    logging.getLogger(__name__).warning(
                        "signal drain hook failed: %r", e
                    )
            path = _flight.flight_dump(
                f"signal:{name}", registry=self.ctx.stats,
                extra={"signal": name},
            )
            if path is not None:
                self.ctx.stats.inc("flight_dumps")
            self.teardown()

        t = threading.Thread(target=work, name="sbg-signal-dump", daemon=True)
        t.start()
        t.join(self.SIGNAL_DUMP_JOIN_S)
        signal.signal(signum, signal.SIG_DFL)
        os.kill(os.getpid(), signum)

    def add_provider(self, name: str, provider) -> None:
        """One extra section of every ``/status`` snapshot and heartbeat
        line (the serve queue view)."""
        if self.status_server is not None:
            self.status_server.add_provider(name, provider)
        if self.heartbeat is not None:
            self.heartbeat.add_provider(name, provider)

    def teardown(self) -> None:
        """Restores the signal handler, stops ``/status``, reads the launch
        times never synced, writes the heartbeat's final line and
        ``metrics.json``, exports the trace, and clears the process-global
        tracer and flight recorder for a later run in this process.
        Runs once (a flag, not a lock: the SIGTERM worker may run it while
        the interrupted main thread is inside it)."""
        if self._done:
            return
        self._done = True
        from .telemetry import flight as _flight
        from .telemetry import trace as _trace

        for sig, prev in self._prev_handlers.items():
            try:
                signal.signal(sig, prev)
            except (ValueError, OSError):
                pass
        if self.status_server is not None:
            self.status_server.shutdown()
        self.ctx.close_telemetry()
        if self.ctx.result_store is not None:
            # Every queued publish lands before the run ends.
            self.ctx.result_store.close()
        if self.heartbeat is not None:
            self.heartbeat.stop()
        if self.args.trace is not None:
            out = self.args.trace
            if out and self.multiprocess:
                # One FILE for every rank: each writes its own.
                stem, ext = os.path.splitext(out)
                out = f"{stem}-rank{self.rank:02d}{ext or '.json'}"
            out = out or os.path.join(
                self.tele_dir if self.tele_dir is not None else ".", "trace.json"
            )
            self.log(f"Trace written to {_trace.tracer().export(out)}.")
            _trace.tracer().enabled = False
            _trace.tracer().reset()
        _flight.configure(None)
        _flight.flight_recorder().reset()


if __name__ == "__main__":
    sys.exit(main())
