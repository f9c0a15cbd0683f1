"""R13: untrusted-input taint (whole-program pass).

The network front door takes attacker-controlled bytes —
headers, body fields, query params, path segments — and the admission
pipeline turns them into filesystem paths, journal record fields, the
fault-scope tenant tag, and orchestrator state.  The runtime tests
pin a handful of those flows; this pass pins ALL of them: every value
produced by an ``untrusted_sources`` call in a ``handler_modules``
function is tainted, taint propagates through the assignment fixpoint,
through function returns, and through call arguments into callee
parameters, and a finding fires where a still-tainted expression
reaches a ``trust_sinks`` call — unless the value passed through a
declared ``sanitizers`` call (schema validators, int/range coercion,
canonical-key/digest derivation) on the way.

Sinks fire in ANY module: the taint originates at the network
boundary, but the dangerous join/open/record-write often lives in a
helper two modules away — that is exactly the flow an intraprocedural
linter cannot see.

Acknowledged sources follow the R2x/R11 on-source marker contract: a
valid ``# torchlint: ignore[R13] reason`` on the source line kills the
taint for every consumer, and the source is re-emitted as a suppressed
"acknowledged" finding so the baseline documents the inventory and the
marker is never judged stale.  A marker on the SINK line suppresses
that one finding only (plain inline-suppression semantics).
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from .callgraph import ProjectGraph, bind_call_args, iter_body_nodes
from .config import TorchlintConfig
from .rules import dotted

RawFinding = Tuple[str, int, int, str]


def site_name(node: ast.Call, entries: List[str]) -> Optional[str]:
    """The matching config entry if this call names a declared site.
    A dotted entry ("journal.admit") requires the call tail to match
    its last component and the preceding component to appear in the
    receiver chain (``self.journal.admit`` matches); a bare entry
    matches the call-name tail.  Shared by R13/R14 (same semantics as
    R11's deterministic_sinks matcher)."""
    name = dotted(node.func)
    if name is None:
        return None
    parts = name.split(".")
    tail = parts[-1]
    for entry in entries:
        if "." in entry:
            ehead, _, etail = entry.rpartition(".")
            if tail == etail and ehead in parts[:-1]:
                return entry
        elif tail == entry:
            return entry
    return None


class _FuncTrust:
    """Per-function R13 state, built once; taint is recomputed cheaply
    on each interprocedural fixpoint round."""

    def __init__(self, graph: ProjectGraph, fkey: str,
                 config: TorchlintConfig,
                 acknowledged: Set[Tuple[str, int]]) -> None:
        fi = graph.functions[fkey]
        self.fi = fi
        self.graph = graph
        self.config = config
        self.calls = graph.call_index(fkey)
        self.in_handler = config.is_handler(fi.path)
        self.assigns: List[Tuple[Set[str], ast.AST]] = []
        self.call_nodes: List[ast.Call] = []
        self.returns: List[ast.AST] = []
        for node in iter_body_nodes(fi.node):
            if isinstance(node, ast.Call):
                self.call_nodes.append(node)
            elif isinstance(node, ast.Assign):
                names: Set[str] = set()
                for t in node.targets:
                    for n in ast.walk(t):
                        if isinstance(n, ast.Name):
                            names.add(n.id)
                if names:
                    self.assigns.append((names, node.value))
            elif isinstance(node, ast.AnnAssign) and node.value is not None:
                if isinstance(node.target, ast.Name):
                    self.assigns.append(({node.target.id}, node.value))
            elif isinstance(node, ast.NamedExpr):
                if isinstance(node.target, ast.Name):
                    self.assigns.append(({node.target.id}, node.value))
            elif isinstance(node, ast.Return) and node.value is not None:
                self.returns.append(node.value)
        #: id(call node) -> source description (acknowledged excluded;
        #: sources only seed in handler modules).
        self.sources: Dict[int, str] = {}
        #: every source site, acknowledged or not: (line, col, desc)
        self.all_sites: List[Tuple[int, int, str]] = []
        if self.in_handler:
            for node in self.call_nodes:
                entry = site_name(node, config.untrusted_sources)
                if entry is None:
                    continue
                desc = f"request input {entry}"
                self.all_sites.append(
                    (node.lineno, node.col_offset, desc)
                )
                if (fi.path, node.lineno) not in acknowledged:
                    self.sources[id(node)] = desc
        #: every resolved callee key — the round loop skips functions
        #: whose callees are all untainted and that have no sources or
        #: injected parameter taint (they cannot produce anything).
        self.callee_set: Set[str] = set()
        for keys in self.calls.values():
            self.callee_set.update(keys)
        #: parameter name -> witness, injected by the caller-side
        #: argument propagation between fixpoint rounds.
        self.param_taint: Dict[str, str] = {}
        self.tainted: Dict[str, str] = {}
        self.tainted_return: Optional[str] = None

    def _expr_taint(self, expr: ast.AST,
                    tainted_fns: Dict[str, str]) -> Optional[str]:
        """Witness description if this expression mentions an untrusted
        source, a tainted local/param, or a call into a tainted-return
        function — WITHOUT descending into sanitizer calls (their
        result is trusted by declaration) and WITHOUT propagating taint
        out of lookup-key positions: ``jobs[tainted]`` and
        ``jobs.get(tainted)`` read a record TRUSTED code stored — the
        attacker chooses which record, not its contents (which-record
        authorization is R14's domain, not taint's)."""
        stack: List[ast.AST] = [expr]
        while stack:
            node = stack.pop()
            if isinstance(
                node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)
            ):
                continue
            if isinstance(node, ast.Call):
                desc = self.sources.get(id(node))
                if desc is not None:
                    return desc
                if site_name(node, self.config.sanitizers) is not None:
                    continue  # trusted by declaration: skip the subtree
                callees = self.calls.get(
                    (node.lineno, node.col_offset), ()
                )
                if callees:
                    # Resolved project call: its return taint is the
                    # callee's computed summary (param taint flows in
                    # via arg_taints, out via tainted_fns) — do NOT
                    # also apply the lexical mentions-a-tainted-arg
                    # rule, which would re-taint values the callee
                    # provably sanitized (e.g. _parse_job(body)).
                    for callee in callees:
                        w = tainted_fns.get(callee)
                        if w is not None:
                            return w
                    stack.append(node.func)  # tainted receiver counts
                    continue
                if (
                    isinstance(node.func, ast.Attribute)
                    and node.func.attr in ("get", "pop")
                ):
                    stack.append(node.func)  # receiver taints; key not
                    continue
            elif isinstance(node, ast.Subscript):
                stack.append(node.value)  # container taints; slice not
                continue
            elif isinstance(node, ast.Name):
                w = self.tainted.get(node.id)
                if w is not None:
                    return w
            stack.extend(ast.iter_child_nodes(node))
        return None

    def recompute(self, tainted_fns: Dict[str, str]) -> bool:
        """Refresh local taint + the tainted-return flag; True if the
        return status changed (drives the global fixpoint)."""
        self.tainted = dict(self.param_taint)
        changed = True
        while changed:
            changed = False
            for names, value in self.assigns:
                if names <= set(self.tainted):
                    continue
                w = self._expr_taint(value, tainted_fns)
                if w is not None:
                    for n in names:
                        self.tainted.setdefault(n, w)
                    changed = True
        ret: Optional[str] = None
        for value in self.returns:
            ret = self._expr_taint(value, tainted_fns)
            if ret is not None:
                break
        flipped = (ret is None) != (self.tainted_return is None)
        self.tainted_return = ret
        return flipped

    def arg_taints(self, tainted_fns: Dict[str, str]
                   ) -> List[Tuple[str, str, str]]:
        """(callee key, param name, witness) for every tainted argument
        handed to a project function — the caller side of the
        interprocedural parameter-taint propagation."""
        out: List[Tuple[str, str, str]] = []
        for node in self.call_nodes:
            callees = self.calls.get((node.lineno, node.col_offset))
            if not callees:
                continue
            if site_name(node, self.config.sanitizers) is not None:
                continue
            for callee in callees:
                fi = self.graph.functions.get(callee)
                if fi is None:
                    continue
                for pname, arg in bind_call_args(fi, node):
                    w = self._expr_taint(arg, tainted_fns)
                    if w is not None:
                        out.append((callee, pname, w))
        return out

    def sink_findings(self, tainted_fns: Dict[str, str]
                      ) -> List[RawFinding]:
        out: List[RawFinding] = []
        for node in self.call_nodes:
            sink = site_name(node, self.config.trust_sinks)
            if sink is None:
                continue
            args = list(node.args) + [kw.value for kw in node.keywords]
            for arg in args:
                w = self._expr_taint(arg, tainted_fns)
                if w is not None:
                    out.append(
                        (
                            "R13",
                            node.lineno,
                            node.col_offset,
                            f"request-derived value ({w}) reaches "
                            f"sensitive sink {sink} without a declared "
                            "sanitizer — canonicalize/validate it "
                            "(int/range coercion, schema validator, "
                            "digest-derived id) or acknowledge the "
                            "SOURCE with ignore[R13] and a reason",
                        )
                    )
                    break
        return out


def untrusted_sites(graph: ProjectGraph, config: TorchlintConfig
                    ) -> Dict[Tuple[str, int], Tuple[int, str]]:
    """(path, line) -> (col, desc) for every untrusted-source site in
    the project, acknowledged or not — project.py uses this to emit the
    suppressed "acknowledged source" inventory entries (R2x contract)."""
    sites: Dict[Tuple[str, int], Tuple[int, str]] = {}
    for fkey in sorted(graph.functions):
        if not config.is_handler(graph.functions[fkey].path):
            continue  # sources only seed in handler modules
        scan = _FuncTrust(graph, fkey, config, acknowledged=set())
        for line, col, desc in scan.all_sites:
            key = (scan.fi.path, line)
            if key not in sites or (col, desc) < sites[key]:
                sites[key] = (col, desc)
    return sites


def run_r13(graph: ProjectGraph, config: TorchlintConfig,
            acknowledged: Set[Tuple[str, int]]
            ) -> Dict[str, List[RawFinding]]:
    """R13 findings per project-relative path.

    ``acknowledged``: (path, line) pairs carrying a valid R13 marker —
    those sources taint nobody."""
    scans: Dict[str, _FuncTrust] = {
        fkey: _FuncTrust(graph, fkey, config, acknowledged)
        for fkey in sorted(graph.functions)
    }
    #: function key -> witness for tainted-return functions
    tainted_fns: Dict[str, str] = {}

    def _inert(scan: _FuncTrust) -> bool:
        """No way for this function to hold or emit taint right now."""
        return (
            not scan.sources
            and not scan.param_taint
            and not scan.tainted
            and scan.tainted_return is None
            and not (scan.callee_set & tainted_fns.keys())
        )

    for _ in range(12):  # bounded interprocedural fixpoint
        changed = False
        for fkey in sorted(scans):
            scan = scans[fkey]
            if _inert(scan):
                continue
            if scan.recompute(tainted_fns):
                changed = True
            if scan.tainted_return is not None:
                if tainted_fns.get(fkey) != scan.tainted_return:
                    tainted_fns[fkey] = scan.tainted_return
                    changed = True
            elif fkey in tainted_fns:
                del tainted_fns[fkey]
                changed = True
        # caller -> callee parameter taint (monotone: params only gain)
        for fkey in sorted(scans):
            scan = scans[fkey]
            if _inert(scan):
                continue
            for callee, pname, w in scan.arg_taints(tainted_fns):
                dest = scans.get(callee)
                if dest is not None and pname not in dest.param_taint:
                    dest.param_taint[pname] = w
                    changed = True
        if not changed:
            break

    out: Dict[str, List[RawFinding]] = {}
    for fkey in sorted(scans):
        scan = scans[fkey]
        if _inert(scan):
            continue
        found = scan.sink_findings(tainted_fns)
        if found:
            out.setdefault(scan.fi.path, []).extend(found)
    return out
