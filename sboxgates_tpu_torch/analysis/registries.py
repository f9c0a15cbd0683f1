"""R7 — registry-drift analysis (whole-program contract verification).

The port runs on implicit cross-layer contracts anchored in declared
registries:

* ``_SIGNATURES`` (``_kernels.py``) — the C entry points of the
  hand-written CUDA kernels.  Only the kernel wrappers under ``ops/``
  (``[tool.torchlint] kernel_wrappers``) may launch one: a search-layer
  site that reaches an entry directly skips the wrapper's CPU fallback,
  its launch count and its timing events, so the card's launch checks
  silently stop covering that path;
* ``KERNELS`` / ``FLEET_SHARED`` (search/warmup.py) — the sweep registry
  the dispatchers and the rendezvous merge through;
* ``METRICS`` (telemetry/metrics.py) — every counter/histogram name must
  be declared and typed, or the registry-parity guarantees fork;
* ``KNOWN_SITES`` (resilience/faults.py) — every ``fault_point`` site
  must be documented, or ``SBG_FAULTS`` specs silently arm nothing;
* ``JOURNAL_CONFIG_KEYS`` / ``JOURNAL_KEY_DEFAULTS`` (cli.py) — every
  draw-stream-shaping Options field must be journaled, or a
  ``--resume-run`` replays a different stream;
* ``[tool.torchlint] thread_roots`` — every ``threading.Thread`` entry
  must be pinned, or the R4x/R9 concurrency gates lapse when a spawn
  site is refactored.

The runtime parity tests check these per-test and only on exercised
paths; this pass proves them on ALL paths at lint time, in both
directions: a use site that bypasses/escapes its registry is a finding,
and a declared entry with no reachable use site is a finding too (dead
declarations let registries accrete as code is refactored away).

Registries are extracted structurally by their declared NAME wherever
they live, so fixture packs can declare miniature registries of their
own.  Everything iterates sorted; output is deterministic.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from .callgraph import (
    ProjectGraph,
    iter_body_nodes as _body_nodes,
    spec_matches_function,
    strip_locals,
)
from .config import TorchlintConfig
from .rules import _is_stats_base, dotted

RawFinding = Tuple[str, int, int, str]  # (rule, line, col, message)

#: Facade methods whose first argument names a metric.
_METRIC_METHODS = frozenset({"inc", "observe", "put", "ensure"})
#: Free-function increment helpers: ``bump(stats, name)`` and the
#: deadline module's ``_bump`` wrapper — the metric name is argument 1.
_BUMP_NAMES = frozenset({"bump", "_bump"})


@dataclass
class Declared:
    """One extracted registry: entry -> (declaring relpath, line)."""

    entries: Dict[str, Tuple[str, int]] = field(default_factory=dict)
    module: Optional[str] = None  # declaring relpath; None = not found

    def add(self, name: str, path: str, line: int) -> None:
        self.entries.setdefault(name, (path, line))


@dataclass
class Registries:
    """Every declared registry plus the use-site inventories the drift
    checks compare against."""

    kernels: Declared = field(default_factory=Declared)
    #: C entry points of the CUDA kernels (``_SIGNATURES`` keys)
    cuda_entries: Declared = field(default_factory=Declared)
    fleet_shared: Declared = field(default_factory=Declared)
    metrics: Declared = field(default_factory=Declared)
    fault_sites: Declared = field(default_factory=Declared)
    journal_keys: Declared = field(default_factory=Declared)
    journal_defaults: Declared = field(default_factory=Declared)
    #: argparse destinations declared in the journal-keys module
    argparse_dests: Set[str] = field(default_factory=set)
    #: (module name, class name) owning a private MetricsRegistry
    #: (``declared=None``) — their ``self.stats`` names are off-schema
    private_stats_classes: Set[Tuple[str, str]] = field(default_factory=set)
    #: string constant (and f-string prefix base) -> (relpath, line)
    #: sites using it
    str_uses: Dict[str, Set[Tuple[str, int]]] = field(default_factory=dict)
    #: attribute name -> (relpath, line) sites reading it
    attr_uses: Dict[str, Set[Tuple[str, int]]] = field(default_factory=dict)


# --------------------------------------------------------------------------
# extraction


def _const_str_elements(node: ast.AST) -> List[Tuple[str, int]]:
    if isinstance(node, (ast.Tuple, ast.List, ast.Set)):
        return [
            (el.value, el.lineno)
            for el in node.elts
            if isinstance(el, ast.Constant) and isinstance(el.value, str)
        ]
    return []


def _const_dict_keys(node: ast.AST) -> List[Tuple[str, int]]:
    if isinstance(node, ast.Dict):
        return [
            (k.value, k.lineno)
            for k in node.keys
            if isinstance(k, ast.Constant) and isinstance(k.value, str)
        ]
    return []


def _kerneldef_names(node: ast.AST) -> List[Tuple[str, int]]:
    """``KernelDef("name", ...)`` first-argument strings anywhere under
    the KERNELS assignment value (the registry is a dict comprehension
    over a tuple of KernelDefs)."""
    out: List[Tuple[str, int]] = []
    for n in ast.walk(node):
        if (
            isinstance(n, ast.Call)
            and (dotted(n.func) or "").rsplit(".", 1)[-1] == "KernelDef"
            and n.args
            and isinstance(n.args[0], ast.Constant)
            and isinstance(n.args[0].value, str)
        ):
            out.append((n.args[0].value, n.args[0].lineno))
    return out


def _argparse_dests(tree: ast.Module) -> Set[str]:
    """Destinations of every ``add_argument`` call in the module: the
    explicit ``dest=``, the first long option, a bare positional name,
    or the short option letter."""
    dests: Set[str] = set()
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        if not (
            isinstance(node.func, ast.Attribute)
            and node.func.attr == "add_argument"
        ):
            continue
        options = [
            a.value
            for a in node.args
            if isinstance(a, ast.Constant) and isinstance(a.value, str)
        ]
        explicit = None
        for kw in node.keywords:
            if kw.arg == "dest" and isinstance(kw.value, ast.Constant):
                explicit = kw.value.value
        if explicit:
            dests.add(explicit)
            continue
        longs = [o for o in options if o.startswith("--")]
        bare = [o for o in options if not o.startswith("-")]
        shorts = [o for o in options if o.startswith("-") and o not in longs]
        if longs:
            dests.add(longs[0].lstrip("-").replace("-", "_"))
        elif bare:
            dests.add(bare[0])
        elif shorts:
            dests.add(shorts[0].lstrip("-"))
    return dests


def _private_stats_classes(mname: str, tree: ast.Module,
                           out: Set[Tuple[str, str]]) -> None:
    """Classes assigning ``self.stats = MetricsRegistry(..., declared=None)``
    anywhere in a method: their counters are a private schema by design."""
    for cls in ast.walk(tree):
        if not isinstance(cls, ast.ClassDef):
            continue
        for node in ast.walk(cls):
            if not isinstance(node, ast.Assign):
                continue
            if not (
                isinstance(node.value, ast.Call)
                and (dotted(node.value.func) or "").rsplit(".", 1)[-1]
                == "MetricsRegistry"
            ):
                continue
            declared_none = any(
                kw.arg == "declared"
                and isinstance(kw.value, ast.Constant)
                and kw.value.value is None
                for kw in node.value.keywords
            )
            if not declared_none:
                continue
            for t in node.targets:
                if (
                    isinstance(t, ast.Attribute)
                    and t.attr == "stats"
                    and isinstance(t.value, ast.Name)
                    and t.value.id == "self"
                ):
                    out.add((mname, cls.name))


def _collect_str_uses(relpath: str, tree: ast.Module,
                      uses: Dict[str, Set[Tuple[str, int]]],
                      attrs: Dict[str, Set[Tuple[str, int]]]) -> None:
    for node in ast.walk(tree):
        if isinstance(node, ast.Attribute):
            attrs.setdefault(node.attr, set()).add((relpath, node.lineno))
        elif isinstance(node, ast.Constant) and isinstance(node.value, str):
            uses.setdefault(node.value, set()).add((relpath, node.lineno))
            if "[" in node.value:
                uses.setdefault(
                    node.value.split("[", 1)[0], set()
                ).add((relpath, node.lineno))
        elif isinstance(node, ast.JoinedStr) and node.values:
            first = node.values[0]
            if isinstance(first, ast.Constant) and isinstance(
                first.value, str
            ):
                uses.setdefault(
                    first.value.split("[", 1)[0], set()
                ).add((relpath, node.lineno))


def extract_registries(graph: ProjectGraph) -> Registries:
    reg = Registries()
    slots = {
        "KERNELS": reg.kernels,
        "_SIGNATURES": reg.cuda_entries,
        "FLEET_SHARED": reg.fleet_shared,
        "METRICS": reg.metrics,
        "KNOWN_SITES": reg.fault_sites,
        "JOURNAL_CONFIG_KEYS": reg.journal_keys,
        "JOURNAL_KEY_DEFAULTS": reg.journal_defaults,
    }
    for mname in sorted(graph.modules):
        mi = graph.modules[mname]
        _collect_str_uses(mi.path, mi.tree, reg.str_uses, reg.attr_uses)
        _private_stats_classes(mname, mi.tree, reg.private_stats_classes)
        for node in mi.tree.body:
            if not isinstance(node, (ast.Assign, ast.AnnAssign)):
                continue
            targets = (
                node.targets if isinstance(node, ast.Assign)
                else [node.target]
            )
            value = node.value
            if value is None:
                continue
            for t in targets:
                if not isinstance(t, ast.Name) or t.id not in slots:
                    continue
                decl = slots[t.id]
                if decl.module is not None:  # first declaration wins
                    continue
                if t.id == "KERNELS":
                    found = _kerneldef_names(value) or _const_dict_keys(value)
                else:
                    found = (
                        _const_dict_keys(value)
                        or _const_str_elements(value)
                    )
                if not found:
                    continue
                decl.module = mi.path
                for name, line in found:
                    decl.add(name, mi.path, line)
        if reg.journal_keys.module == mi.path:
            reg.argparse_dests = _argparse_dests(mi.tree)
    return reg


# --------------------------------------------------------------------------
# use-site scans


def _metric_literal(expr: ast.AST) -> Optional[str]:
    """The statically-known base metric name of a name expression:
    ``"warm_hits"`` -> warm_hits, ``f"device_wait_s[{p}]"`` ->
    device_wait_s; None when the base itself is dynamic."""
    if isinstance(expr, ast.Constant) and isinstance(expr.value, str):
        return expr.value.split("[", 1)[0]
    if isinstance(expr, ast.JoinedStr) and expr.values:
        first = expr.values[0]
        if isinstance(first, ast.Constant) and isinstance(first.value, str):
            if "[" in first.value:
                return first.value.split("[", 1)[0]
    return None


def _receiver_mentions_global(expr: ast.AST) -> bool:
    name = dotted(expr)
    return name is not None and "GLOBAL" in name.split(".")


def _telemetry_exempt(relpath: str) -> bool:
    return "telemetry" in relpath.replace("\\", "/").split("/")


class _R7Scan:
    """One pass over every function body, collecting the use-site
    findings (kernel entries reached outside their wrappers, undeclared
    metric/fault names, journal-key escapes)."""

    def __init__(self, graph: ProjectGraph, reg: Registries,
                 config: TorchlintConfig) -> None:
        self.g = graph
        self.reg = reg
        self.config = config
        self.out: Dict[str, List[RawFinding]] = {}

    def _flag(self, path: str, line: int, col: int, msg: str) -> None:
        self.out.setdefault(path, []).append(("R7", line, col, msg))

    def run(self) -> Dict[str, List[RawFinding]]:
        for fkey in sorted(self.g.functions):
            fi = self.g.functions[fkey]
            check_entry = (
                self.reg.cuda_entries.module is not None
                and self.config.is_dispatch(fi.path)
                and not self.config.is_kernel_wrapper(fi.path)
                and fi.path != self.reg.cuda_entries.module
            )
            check_journal = (
                self.reg.journal_keys.module is not None
                and fi.path == self.reg.journal_keys.module
            )
            for node in _body_nodes(fi.node):
                if (
                    check_entry
                    and isinstance(node, ast.Attribute)
                    and node.attr in self.reg.cuda_entries.entries
                ):
                    self._flag(
                        fi.path, node.lineno, node.col_offset,
                        f"CUDA entry '{node.attr}' "
                        f"({self.reg.cuda_entries.module}) reached at a "
                        "dispatch site outside its kernel wrapper: call "
                        "the ops/ wrapper, so the CPU fallback, the launch "
                        "count and the timing events hold on this path "
                        "too",
                    )
                if not isinstance(node, ast.Call):
                    continue
                self._check_metric(fi, node)
                self._check_fault(fi, node)
                if check_journal:
                    self._check_journal(fi, node)
        return self.out

    # -- metrics ----------------------------------------------------------

    def _check_metric(self, fi, call: ast.Call) -> None:
        if self.reg.metrics.module is None or _telemetry_exempt(fi.path):
            return
        name_expr: Optional[ast.AST] = None
        f = call.func
        if isinstance(f, ast.Attribute) and f.attr in _METRIC_METHODS:
            recv = f.value
            if not _is_stats_base(recv):
                return
            if _receiver_mentions_global(recv):
                return  # GLOBAL is a declared=None registry by design
            if (
                isinstance(recv, ast.Attribute)
                and isinstance(recv.value, ast.Name)
                and recv.value.id == "self"
                and (fi.module, fi.cls) in self.reg.private_stats_classes
            ):
                return  # the class's own private (declared=None) schema
            if call.args:
                name_expr = call.args[0]
        elif (dotted(f) or "").rsplit(".", 1)[-1] in _BUMP_NAMES:
            if len(call.args) >= 2:
                name_expr = call.args[1]
        if name_expr is None:
            return
        lit = _metric_literal(name_expr)
        if lit is None or lit in self.reg.metrics.entries:
            return
        self._flag(
            fi.path, name_expr.lineno, name_expr.col_offset,
            f"metric '{lit}' is not declared in METRICS "
            f"({self.reg.metrics.module}) — every counter/histogram "
            "must be declared and typed, or the schema silently forks "
            "(declare it, or route a private tally through a "
            "declared=None registry)",
        )

    # -- fault sites ------------------------------------------------------

    def _check_fault(self, fi, call: ast.Call) -> None:
        if self.reg.fault_sites.module is None:
            return
        if (dotted(call.func) or "").rsplit(".", 1)[-1] != "fault_point":
            return
        if not call.args:
            return
        a0 = call.args[0]
        if not (isinstance(a0, ast.Constant) and isinstance(a0.value, str)):
            return
        if a0.value in self.reg.fault_sites.entries:
            return
        self._flag(
            fi.path, call.lineno, call.col_offset,
            f"fault site '{a0.value}' is not declared in KNOWN_SITES "
            f"({self.reg.fault_sites.module}) — undocumented sites make "
            "SBG_FAULTS specs unguessable; add it to the declared set",
        )

    # -- journal keys -----------------------------------------------------

    def _check_journal(self, fi, call: ast.Call) -> None:
        if (dotted(call.func) or "").rsplit(".", 1)[-1] != "Options":
            return
        exprs = list(call.args) + [kw.value for kw in call.keywords]
        for expr in exprs:
            for n in ast.walk(expr):
                if (
                    isinstance(n, ast.Attribute)
                    and isinstance(n.value, ast.Name)
                    and n.value.id == "args"
                    and n.attr not in self.reg.journal_keys.entries
                ):
                    self._flag(
                        fi.path, n.lineno, n.col_offset,
                        f"Options field built from args.{n.attr} is "
                        "consumed by the journaled driver but "
                        f"'{n.attr}' is not in JOURNAL_CONFIG_KEYS — a "
                        "--resume-run would silently drop it; add the "
                        "key, or acknowledge with ignore[R7] if it "
                        "cannot shape the deterministic draw stream",
                    )


# --------------------------------------------------------------------------
# declaration-side checks (dead entries, drift between registries, pins)


def _dead_declarations(reg: Registries) -> Dict[str, List[RawFinding]]:
    out: Dict[str, List[RawFinding]] = {}

    def flag(path: str, line: int, msg: str) -> None:
        out.setdefault(path, []).append(("R7", line, 0, msg))

    def dead_scan(decl: Declared, what: str, hint: str,
                  attrs: bool = False) -> None:
        if decl.module is None:
            return
        for name in sorted(decl.entries):
            path, line = decl.entries[name]
            # Only the declaration site itself is excluded — a use
            # elsewhere in the declaring module still counts.
            used_in = reg.str_uses.get(name, set()) - {(path, line)}
            if attrs:
                used_in |= reg.attr_uses.get(name, set())
            if not used_in:
                flag(
                    path, line,
                    f"{what} '{name}' has no reachable use site outside "
                    f"its declaration — dead declaration; {hint}",
                )

    dead_scan(
        reg.kernels, "kernel registry entry",
        "shrink the registry (or wire the kernel into a dispatcher)",
    )
    dead_scan(
        reg.cuda_entries, "CUDA entry point",
        "remove it from _SIGNATURES (no wrapper launches it)",
        attrs=True,
    )
    dead_scan(
        reg.metrics, "declared metric",
        "remove the declaration (nothing increments or observes it)",
    )
    dead_scan(
        reg.fault_sites, "declared fault site",
        "remove it from KNOWN_SITES (no fault_point names it)",
    )

    # FLEET_SHARED must stay a subset of the kernel registry.
    if (
        reg.fleet_shared.module is not None
        and reg.kernels.module is not None
    ):
        for name in sorted(reg.fleet_shared.entries):
            if name not in reg.kernels.entries:
                path, line = reg.fleet_shared.entries[name]
                flag(
                    path, line,
                    f"FLEET_SHARED declares shared operand axes for "
                    f"'{name}', which is not in the kernel registry — "
                    "the fleet warm specs enumerated from it would "
                    "build a kernel that cannot dispatch",
                )

    # Journal keys must be recordable (argparse destinations), and the
    # late-added defaults must name journaled keys.
    if reg.journal_keys.module is not None and reg.argparse_dests:
        for name in sorted(reg.journal_keys.entries):
            if name not in reg.argparse_dests:
                path, line = reg.journal_keys.entries[name]
                flag(
                    path, line,
                    f"JOURNAL_CONFIG_KEYS entry '{name}' matches no "
                    "argparse destination — recording "
                    "getattr(args, ...) would raise at run start; "
                    "remove or fix the key",
                )
    if reg.journal_defaults.module is not None:
        for name in sorted(reg.journal_defaults.entries):
            if (
                reg.journal_keys.module is not None
                and name not in reg.journal_keys.entries
            ):
                path, line = reg.journal_defaults.entries[name]
                flag(
                    path, line,
                    f"JOURNAL_KEY_DEFAULTS entry '{name}' is not in "
                    "JOURNAL_CONFIG_KEYS — the default would never be "
                    "applied on resume",
                )
    return out


#: Synthetic path for findings about the config itself (dead thread-root
#: pins live in torchlint.toml, which is not a scanned python file).
CONFIG_PATH = "torchlint.toml"


def _thread_pins(graph: ProjectGraph,
                 config: TorchlintConfig) -> Dict[str, List[RawFinding]]:
    out: Dict[str, List[RawFinding]] = {}
    specs = list(config.thread_roots)
    for tc in sorted(
        graph.thread_creations, key=lambda t: (t.path, t.line, t.col)
    ):
        if not tc.targets:
            out.setdefault(tc.path, []).append(
                (
                    "R7", tc.line, tc.col,
                    f"cannot statically resolve Thread target "
                    f"'{tc.raw}' — pin the entry function in "
                    "[tool.torchlint] thread_roots so the R4x/R9 "
                    "concurrency gates cover it",
                )
            )
            continue
        pinned = any(
            spec_matches_function(spec, t)
            for spec in specs
            for t in tc.targets
        )
        if not pinned:
            qual = strip_locals(tc.targets[0].split(":", 1)[1])
            out.setdefault(tc.path, []).append(
                (
                    "R7", tc.line, tc.col,
                    f"thread entry '{qual}' is not pinned in "
                    "[tool.torchlint] thread_roots — auto-detection "
                    "covers it today, but an unpinned root silently "
                    "drops out of the R4x/R9 gates when this spawn "
                    "site is refactored; pin it",
                )
            )
    # Stale pins: a spec naming no function is a refactored-away root.
    for spec in sorted(set(specs)):
        if not any(
            spec_matches_function(spec, key) for key in graph.functions
        ):
            out.setdefault(CONFIG_PATH, []).append(
                (
                    "R7", 1, 0,
                    f"[tool.torchlint] thread_roots spec '{spec}' matches "
                    "no function in the scanned tree — stale pin; fix "
                    "the spec or remove it",
                )
            )
    return out


# --------------------------------------------------------------------------
# driver


def run_r7(
    graph: ProjectGraph,
    config: TorchlintConfig,
    registries: Optional[Registries] = None,
) -> Dict[str, List[RawFinding]]:
    """The full registry-drift pass: use-site escapes, dead
    declarations, and thread-root pinning.  Findings for
    :data:`CONFIG_PATH` describe the torchlint.toml config itself."""
    reg = registries if registries is not None else extract_registries(graph)
    out = _R7Scan(graph, reg, config).run()
    for src in (_dead_declarations(reg), _thread_pins(graph, config)):
        for path, items in src.items():
            out.setdefault(path, []).extend(items)
    return out
