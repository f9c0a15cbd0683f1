"""torchlint configuration: the ``[tool.torchlint]`` table of ``torchlint.toml``.

One source of truth for the CLI and the tier-1 gate test: both load the
table from the nearest ``torchlint.toml`` at or above the start directory
(read with :mod:`tomllib`).  The file holds one table, ``[tool.torchlint]``,
with the keys of the JAX package's ``[tool.jaxlint]``; the names in it are
the port's own.
"""

from __future__ import annotations

import fnmatch
import os
import tomllib
from dataclasses import dataclass, field
from typing import List, Optional

#: Per-file rules.
FILE_RULES = ("R1", "R2", "R3", "R4", "R5", "R6")
#: Cross-module rules (whole-program pass only).  R7/R8/R9 are the
#: contract-verification passes: registry drift, bucket discipline,
#: lock ordering.  R10/R11/R12 are the protocol/determinism/durability
#: shadows: replicated-protocol divergence, determinism taint, and
#: durable-write discipline.  R13/R14/R15 are the network-tier
#: trust-boundary shadows: untrusted-input taint, admission-order
#: dominance, and resource lifecycle.
CROSS_RULES = (
    "R1x", "R2x", "R4x", "R7", "R8", "R9",
    "R10", "R11", "R12", "R13", "R14", "R15",
)
ALL_RULES = FILE_RULES + CROSS_RULES

#: Defaults mirror the committed torchlint.toml so API callers that never
#: read it (unit tests on fixture snippets) see the same rules.
DEFAULT_HOT_MODULES = (
    "sboxgates_tpu_torch/ops/*",
    "sboxgates_tpu_torch/search/lut.py",
    "sboxgates_tpu_torch/parallel/mesh.py",
)

#: Modules whose functions dispatch registered kernels: R7's
#: registry-bypass check and R8's bucket-discipline pass apply here.
DEFAULT_DISPATCH_MODULES = (
    "sboxgates_tpu_torch/search/*",
    "sboxgates_tpu_torch/ops/*",
)

#: Modules holding the kernel wrappers: the only dispatch-module sites
#: that may reach a CUDA entry point of ``_kernels`` (R7).
DEFAULT_KERNEL_WRAPPERS = ("sboxgates_tpu_torch/ops/*",)

#: Names whose presence in (or derivation into) a shape expression marks
#: it bucket-disciplined (R8).  Any name containing "bucket" counts too.
DEFAULT_BUCKET_SOURCES = (
    "bucket_size",
    "PIVOT_G_BUCKETS",
    "FLEET_BUCKETS",
    "STACKED_BUCKETS",
    "FLEET_LADDER",
    "ROUND_BUCKETS",
)

#: Call names that block on a device resolve or a cross-rank agreement
#: (R9: a lock held across one deadlocks against the abandonment path).
DEFAULT_BLOCKING_CALLS = (
    "guarded_dispatch",
    "dispatch_with_retry",
    "replicated_dispatch_with_retry",
    "breach_verdict",
    "host_sync_deadline",
)

#: Call names whose RESULT differs per process (R10): a branch testing
#: one of these — or a local derived from one — is rank-gated control
#: flow.  Names that agree on every rank (``world_size``) are NOT rank
#: sources: branching on them is replicated, not divergent.
DEFAULT_RANK_SOURCES = (
    "rank",
    "process_rank",
    "is_primary",
)

#: Agreement / collective entry points (R10): every process must reach
#: these in lockstep, so a call path gated on one side of a rank branch
#: hangs or splits the group.  The ``torch.distributed`` collectives are
#: included — a rank-gated collective is the launch-count bug class
#: directly — and so are the control store's waits (a dotted entry
#: matches like ``deterministic_sinks``).
DEFAULT_AGREEMENT_SITES = (
    "breach_verdict",
    "journal_seq_check",
    "run_config_check",
    "_kv_exchange",
    "_agree",
    "shared_seed",
    "all_agree",
    "renew",
    "replicated_dispatch_with_retry",
    "all_reduce_min",
    "all_reduce_max",
    "all_gather_array",
    "all_reduce",
    "all_gather",
    "broadcast",
    "barrier",
    "store.wait",
)

#: Bit-identity sinks (R11): calls whose inputs must be reproducible
#: byte-for-byte across runs and processes.  A dotted entry like
#: "journal.append" matches attribute chains ending in ``append`` whose
#: receiver mentions ``journal``; a bare entry matches the call tail.
DEFAULT_DETERMINISTIC_SINKS = (
    "journal.append",
    "durable_write_text",
    "with_digest",
    "canonicalize",
    "exact_key",
    "exact_multi_key",
    "default_rng",
    "SeedSequence",
    "manual_seed",
)

#: Persistence modules (R12): every truncating write / os.replace here
#: must route through the shared durable helper or carry a reason.
DEFAULT_DURABLE_MODULES = (
    "sboxgates_tpu_torch/resilience/*",
    "sboxgates_tpu_torch/store/*",
    "sboxgates_tpu_torch/telemetry/*",
    "sboxgates_tpu_torch/serve_net/*",
)

#: Functions exempt from R12 — the durable helper itself (its fdopen +
#: os.replace ARE the tmp+fsync+atomic-replace discipline).
DEFAULT_DURABLE_HELPERS = ("durable_write_text",)

#: Modules that parse network requests (R13 sources seed here; R14
#: dominance applies to these functions' bodies).
DEFAULT_HANDLER_MODULES = ("sboxgates_tpu_torch/serve_net/*",)

#: Calls whose RESULT is request-derived (R13 sources).  Dotted entries
#: match like deterministic_sinks: "headers.get" matches
#: ``h.headers.get(...)``; a bare entry matches the call tail.
DEFAULT_UNTRUSTED_SOURCES = (
    "headers.get",
    "rfile.read",
    "urlsplit",
    "parse_qs",
    "recv",
)

#: Calls whose RESULT is trusted even when their inputs are tainted
#: (R13): schema validators, int/range coercion, canonical-key and
#: digest derivation, and the token-file-backed authenticator.
DEFAULT_SANITIZERS = (
    "int",
    "float",
    "len",
    "parse_sbox",
    "authenticate",
    "canonicalize",
    "exact_key",
    "exact_multi_key",
    "blake2b",
    "sha256",
    "hexdigest",
)

#: Sensitive sinks (R13): filesystem path construction, journal/store
#: record fields, the fault-scope tenant tag, and process spawns.
#: Dotted entries match like deterministic_sinks.
DEFAULT_TRUST_SINKS = (
    "path.join",
    "open",
    "journal.admit",
    "journal.append",
    "set_tenant",
    "subprocess.run",
    "subprocess.Popen",
    "subprocess.call",
    "os.system",
    "os.remove",
    "os.rename",
)

#: Authentication / rate-limit call sites (R14): every effectful call
#: in a handler body must be dominated by one.
DEFAULT_AUTH_SITES = ("authenticate", "allow")

#: Quota check sites (R14): fresh-admission effects must also be
#: dominated by one of these.
DEFAULT_QUOTA_SITES = ("active_jobs",)

#: Fsync'd admission-journal appends (R14): every 202-class response
#: write must be dominated by one.
DEFAULT_JOURNAL_SITES = ("journal.admit", "journal.append")

#: Effectful calls in handler bodies (R14): orchestrator enqueue/join
#: and durable admission records.
DEFAULT_EFFECT_SITES = ("orch.submit", "orch.join", "journal.admit")

#: Response-writing helpers (R14): a call with a constant 201/202
#: status argument is an admission acknowledgement.
DEFAULT_RESPONSE_SITES = ("_send_json", "send_response")

#: Resource constructors (R15): sockets, listeners, threads, temp
#: files.  A project class whose base's name tail matches one of these
#: counts too (``class Server(ThreadingHTTPServer)``).
DEFAULT_RESOURCE_CTORS = (
    "socket.socket",
    "create_connection",
    "ThreadingHTTPServer",
    "HTTPServer",
    "TCPServer",
    "Thread",
    "Timer",
    "mkstemp",
    "NamedTemporaryFile",
    "TemporaryFile",
)

#: Teardown registries (R15): handing a resource (or a closure over
#: one) to these counts as a release on all paths.
DEFAULT_TEARDOWN_REGISTRIES = (
    "drain_hooks",
    "_teardown",
    "atexit.register",
)


@dataclass
class TorchlintConfig:
    """Resolved analyzer configuration.

    ``hot_modules``: glob patterns (posix, relative to the project root)
    naming the modules where R2/R2x (host-device sync inside a loop)
    apply.  ``rules``: enabled rule IDs (per-file R1–R5 and cross-module
    R1x/R2x/R4x).  ``exclude``: glob patterns skipped when scanning
    directories.  ``paths``: default scan roots when the CLI is invoked
    without positional paths.  ``whole_program``: run the cross-module
    pass (call graph + R1x/R2x/R4x) by default.  ``thread_roots`` /
    ``jit_roots``: per-rule root extras for the call graph — function
    names ("Class.meth", "fn", or "pkg.mod:Class.meth") treated as
    thread entries (R4x) / compile boundaries beyond the auto-detected
    ``threading.Thread(target=...)`` and ``torch.compile``/``torch.jit``
    sites.  ``kernel_wrappers``: the modules that may reach a CUDA entry
    point of ``_kernels`` (R7).
    """

    hot_modules: List[str] = field(default_factory=lambda: list(DEFAULT_HOT_MODULES))
    rules: List[str] = field(default_factory=lambda: list(ALL_RULES))
    exclude: List[str] = field(default_factory=list)
    paths: List[str] = field(default_factory=lambda: ["sboxgates_tpu_torch"])
    root: str = "."
    whole_program: bool = False
    thread_roots: List[str] = field(default_factory=list)
    jit_roots: List[str] = field(default_factory=list)
    dispatch_modules: List[str] = field(
        default_factory=lambda: list(DEFAULT_DISPATCH_MODULES)
    )
    kernel_wrappers: List[str] = field(
        default_factory=lambda: list(DEFAULT_KERNEL_WRAPPERS)
    )
    bucket_sources: List[str] = field(
        default_factory=lambda: list(DEFAULT_BUCKET_SOURCES)
    )
    blocking_calls: List[str] = field(
        default_factory=lambda: list(DEFAULT_BLOCKING_CALLS)
    )
    rank_sources: List[str] = field(
        default_factory=lambda: list(DEFAULT_RANK_SOURCES)
    )
    agreement_sites: List[str] = field(
        default_factory=lambda: list(DEFAULT_AGREEMENT_SITES)
    )
    deterministic_sinks: List[str] = field(
        default_factory=lambda: list(DEFAULT_DETERMINISTIC_SINKS)
    )
    durable_modules: List[str] = field(
        default_factory=lambda: list(DEFAULT_DURABLE_MODULES)
    )
    durable_helpers: List[str] = field(
        default_factory=lambda: list(DEFAULT_DURABLE_HELPERS)
    )
    #: "site: reason" strings waiving chaos coverage for declared fault
    #: sites that cannot be exercised by an armed test.
    chaos_waivers: List[str] = field(default_factory=list)
    #: globs (relative to the root) of the test files whose arm() calls
    #: and SBG_FAULTS specs count as chaos coverage
    test_globs: List[str] = field(default_factory=lambda: ["tests/*"])
    handler_modules: List[str] = field(
        default_factory=lambda: list(DEFAULT_HANDLER_MODULES)
    )
    untrusted_sources: List[str] = field(
        default_factory=lambda: list(DEFAULT_UNTRUSTED_SOURCES)
    )
    sanitizers: List[str] = field(
        default_factory=lambda: list(DEFAULT_SANITIZERS)
    )
    trust_sinks: List[str] = field(
        default_factory=lambda: list(DEFAULT_TRUST_SINKS)
    )
    auth_sites: List[str] = field(
        default_factory=lambda: list(DEFAULT_AUTH_SITES)
    )
    quota_sites: List[str] = field(
        default_factory=lambda: list(DEFAULT_QUOTA_SITES)
    )
    journal_sites: List[str] = field(
        default_factory=lambda: list(DEFAULT_JOURNAL_SITES)
    )
    effect_sites: List[str] = field(
        default_factory=lambda: list(DEFAULT_EFFECT_SITES)
    )
    response_sites: List[str] = field(
        default_factory=lambda: list(DEFAULT_RESPONSE_SITES)
    )
    resource_ctors: List[str] = field(
        default_factory=lambda: list(DEFAULT_RESOURCE_CTORS)
    )
    teardown_registries: List[str] = field(
        default_factory=lambda: list(DEFAULT_TEARDOWN_REGISTRIES)
    )

    def is_hot(self, relpath: str) -> bool:
        rp = relpath.replace(os.sep, "/")
        return any(fnmatch.fnmatch(rp, pat) for pat in self.hot_modules)

    def is_dispatch(self, relpath: str) -> bool:
        rp = relpath.replace(os.sep, "/")
        return any(fnmatch.fnmatch(rp, pat) for pat in self.dispatch_modules)

    def is_kernel_wrapper(self, relpath: str) -> bool:
        rp = relpath.replace(os.sep, "/")
        return any(fnmatch.fnmatch(rp, pat) for pat in self.kernel_wrappers)

    def is_excluded(self, relpath: str) -> bool:
        rp = relpath.replace(os.sep, "/")
        return any(fnmatch.fnmatch(rp, pat) for pat in self.exclude)

    def is_durable(self, relpath: str) -> bool:
        rp = relpath.replace(os.sep, "/")
        return any(fnmatch.fnmatch(rp, pat) for pat in self.durable_modules)

    def is_handler(self, relpath: str) -> bool:
        rp = relpath.replace(os.sep, "/")
        return any(fnmatch.fnmatch(rp, pat) for pat in self.handler_modules)


#: The configuration file's name and its table.
CONFIG_FILE = "torchlint.toml"
TABLE = "tool.torchlint"


def find_config(start: str) -> Optional[str]:
    """Nearest torchlint.toml at or above ``start``."""
    d = os.path.abspath(start)
    if os.path.isfile(d):
        d = os.path.dirname(d)
    while True:
        cand = os.path.join(d, CONFIG_FILE)
        if os.path.isfile(cand):
            return cand
        parent = os.path.dirname(d)
        if parent == d:
            return None
        d = parent


def load_config(start: str = ".") -> TorchlintConfig:
    """Config from the nearest torchlint.toml's ``[tool.torchlint]`` table
    (defaults when absent).  ``root`` is the directory holding the file,
    so module globs resolve against the project root no matter where the
    CLI is invoked from."""
    cfg = TorchlintConfig()
    path = find_config(start)
    if path is None:
        cfg.root = os.path.abspath(start)
        return cfg
    cfg.root = os.path.dirname(path)
    with open(path, "rb") as f:
        table = tomllib.load(f)
    for part in TABLE.split("."):
        table = table.get(part, {})
    for key in (
        "hot_modules", "rules", "exclude", "paths",
        "thread_roots", "jit_roots",
        "dispatch_modules", "kernel_wrappers", "bucket_sources",
        "blocking_calls",
        "rank_sources", "agreement_sites", "deterministic_sinks",
        "durable_modules", "durable_helpers", "chaos_waivers", "test_globs",
        "handler_modules", "untrusted_sources", "sanitizers",
        "trust_sinks", "auth_sites", "quota_sites", "journal_sites",
        "effect_sites", "response_sites", "resource_ctors",
        "teardown_registries",
    ):
        val = table.get(key)
        if isinstance(val, list) and all(isinstance(x, str) for x in val):
            setattr(cfg, key, list(val))
    if isinstance(table.get("whole_program"), bool):
        cfg.whole_program = table["whole_program"]
    bad = [r for r in cfg.rules if r not in ALL_RULES]
    if bad:
        raise ValueError(
            f"[tool.torchlint] unknown rule ids {bad}; known: {list(ALL_RULES)}"
        )
    return cfg
