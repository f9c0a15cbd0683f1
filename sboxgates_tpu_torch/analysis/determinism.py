"""R11: determinism taint (whole-program pass).

Bit-identical resume and cross-process content-addressed
store keys both reduce to one invariant: every byte that lands
in the journal, a checkpoint, a canonical key, or a PRNG seed must be a
pure function of the run inputs.  A wall-clock read, an unseeded RNG,
``os.urandom``, a uuid, an unsorted directory scan, iteration over a
``set``, or ``id()`` anywhere upstream of those sinks silently breaks
the contract — the chaos matrices only catch it when a kill lands on
the exact divergent byte.

This pass reuses the R2x shape: nondeterministic *sources* seed a
per-function assignment-taint fixpoint (the R8 derivation machinery)
plus an interprocedural "returns a nondeterministic value" fixpoint
over the call graph; findings fire where a tainted expression is passed
to a *bit-identity sink* (``[tool.torchlint] deterministic_sinks``).

Acknowledged sources follow the R2x on-source marker contract: a valid
``# torchlint: ignore[R11] reason`` on the source line kills the taint
for every caller, and the source is re-emitted as a suppressed
"acknowledged" finding so the baseline documents the inventory and the
marker is never judged stale.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from .callgraph import ProjectGraph, iter_body_nodes
from .config import TorchlintConfig
from .rules import dotted

RawFinding = Tuple[str, int, int, str]

_TIME_CALLS = frozenset(
    {
        "time.time",
        "time.time_ns",
        "time.monotonic",
        "time.monotonic_ns",
        "time.perf_counter",
        "time.perf_counter_ns",
        "datetime.now",
        "datetime.datetime.now",
        "datetime.utcnow",
        "datetime.datetime.utcnow",
    }
)

#: RNG constructors that are deterministic WITH an explicit seed arg and
#: nondeterministic without one.
_SEEDABLE_CTORS = frozenset({"default_rng", "SeedSequence", "Random"})

_DIR_SCAN_TAILS = frozenset(
    {"listdir", "scandir", "glob", "iglob", "iterdir"}
)

_UUID_TAILS = frozenset({"uuid1", "uuid3", "uuid4", "uuid5"})


def _tail(name: Optional[str]) -> Optional[str]:
    return name.rsplit(".", 1)[-1] if name else None


def _is_set_expr(node: ast.AST) -> bool:
    if isinstance(node, (ast.Set, ast.SetComp)):
        return True
    return (
        isinstance(node, ast.Call) and dotted(node.func) == "set"
    )


def _classify_source(node: ast.Call,
                     sorted_wrapped: Set[int]) -> Optional[str]:
    """Human description if this call is a nondeterminism source."""
    name = dotted(node.func)
    if name is None:
        return None
    parts = name.split(".")
    tail = parts[-1]
    if name in _TIME_CALLS:
        return f"wall clock {name}()"
    if name == "os.urandom":
        return "os.urandom entropy"
    if name == "id":
        return "id() (address-dependent)"
    if parts[0] == "uuid" or tail in _UUID_TAILS:
        return f"uuid {name}()"
    if tail in _SEEDABLE_CTORS:
        if not node.args and not node.keywords:
            return f"unseeded {tail}()"
        return None
    if "random" in parts[:-1] or parts[0] == "random" and len(parts) > 1:
        return f"unseeded RNG {name}()"
    if parts[0] == "secrets":
        return f"secrets {name}()"
    if tail in _DIR_SCAN_TAILS:
        if id(node) not in sorted_wrapped:
            return f"unsorted directory scan {tail}()"
        return None
    if tail in ("list", "tuple") and node.args:
        if _is_set_expr(node.args[0]):
            return f"{tail}() over an unordered set"
    return None


def _sink_name(node: ast.Call, sinks: List[str]) -> Optional[str]:
    """The matching ``deterministic_sinks`` entry, if this call is a
    sink.  A dotted entry ("journal.append") requires the call tail to
    match its last component and the preceding component to appear in
    the receiver chain (``self.journal.append`` matches); a bare entry
    matches the call-name tail."""
    name = dotted(node.func)
    if name is None:
        return None
    parts = name.split(".")
    tail = parts[-1]
    for entry in sinks:
        if "." in entry:
            ehead, _, etail = entry.rpartition(".")
            if tail == etail and ehead in parts[:-1]:
                return entry
        elif tail == entry:
            return entry
    return None


class _FuncDet:
    """Per-function R11 state, built once; taint is recomputed cheaply
    on each interprocedural fixpoint round."""

    def __init__(self, graph: ProjectGraph, fkey: str,
                 config: TorchlintConfig,
                 acknowledged: Set[Tuple[str, int]]) -> None:
        fi = graph.functions[fkey]
        self.fi = fi
        self.calls = graph.call_index(fkey)
        self.assigns: List[Tuple[Set[str], ast.AST]] = []
        self.call_nodes: List[ast.Call] = []
        self.returns: List[ast.AST] = []
        self.set_loops: List[ast.For] = []
        sorted_wrapped: Set[int] = set()
        for node in iter_body_nodes(fi.node):
            if isinstance(node, ast.Call):
                self.call_nodes.append(node)
                if dotted(node.func) == "sorted":
                    for arg in node.args:
                        sorted_wrapped.add(id(arg))
            elif isinstance(node, ast.Assign):
                names = {
                    t.id for t in node.targets if isinstance(t, ast.Name)
                }
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
            elif isinstance(node, ast.For):
                if _is_set_expr(node.iter):
                    self.set_loops.append(node)
        #: id(call node) -> source description (acknowledged excluded)
        self.sources: Dict[int, str] = {}
        #: every source site, acknowledged or not: (line, col, desc)
        self.all_sites: List[Tuple[int, int, str]] = []
        for node in self.call_nodes:
            desc = _classify_source(node, sorted_wrapped)
            if desc is None:
                continue
            self.all_sites.append(
                (node.lineno, node.col_offset, desc)
            )
            if (fi.path, node.lineno) not in acknowledged:
                self.sources[id(node)] = desc
        self.tainted: Dict[str, str] = {}
        self.nondet_return: Optional[str] = None

    def _expr_taint(self, expr: ast.AST,
                    nondet_fns: Dict[str, str]) -> Optional[str]:
        """Witness description if this expression mentions a nondet
        source, a tainted local, or a call into a nondet function."""
        for node in ast.walk(expr):
            if isinstance(node, ast.Call):
                desc = self.sources.get(id(node))
                if desc is not None:
                    return desc
                for callee in self.calls.get(
                    (node.lineno, node.col_offset), ()
                ):
                    w = nondet_fns.get(callee)
                    if w is not None:
                        return w
            elif isinstance(node, ast.Name):
                w = self.tainted.get(node.id)
                if w is not None:
                    return w
        return None

    def recompute(self, nondet_fns: Dict[str, str]) -> bool:
        """Refresh local taint + the nondet-return flag; True if the
        nondet-return status changed (drives the global fixpoint)."""
        self.tainted = {}
        for loop in self.set_loops:
            for t in ast.walk(loop.target):
                if isinstance(t, ast.Name):
                    self.tainted[t.id] = "iteration over an unordered set"
        changed = True
        while changed:
            changed = False
            for names, value in self.assigns:
                if names <= set(self.tainted):
                    continue
                w = self._expr_taint(value, nondet_fns)
                if w is not None:
                    for n in names:
                        self.tainted.setdefault(n, w)
                    changed = True
        ret: Optional[str] = None
        for value in self.returns:
            ret = self._expr_taint(value, nondet_fns)
            if ret is not None:
                break
        flipped = (ret is None) != (self.nondet_return is None)
        self.nondet_return = ret
        return flipped

    def sink_findings(self, config: TorchlintConfig,
                      nondet_fns: Dict[str, str]) -> List[RawFinding]:
        out: List[RawFinding] = []
        for node in self.call_nodes:
            sink = _sink_name(node, config.deterministic_sinks)
            if sink is None:
                continue
            args = list(node.args) + [kw.value for kw in node.keywords]
            for arg in args:
                w = self._expr_taint(arg, nondet_fns)
                if w is not None:
                    out.append(
                        (
                            "R11",
                            node.lineno,
                            node.col_offset,
                            f"nondeterministic value ({w}) flows into "
                            f"bit-identity sink {sink} — breaks "
                            "bit-identical resume / cross-process key "
                            "agreement; make the input deterministic or "
                            "acknowledge the SOURCE with ignore[R11] "
                            "and a reason",
                        )
                    )
                    break
        return out


def nondet_sites(graph: ProjectGraph, config: TorchlintConfig
                 ) -> Dict[Tuple[str, int], Tuple[int, str]]:
    """(path, line) -> (col, desc) for every nondeterminism source in
    the project, acknowledged or not — project.py uses this to emit the
    suppressed "acknowledged source" inventory entries (R2x contract)."""
    sites: Dict[Tuple[str, int], Tuple[int, str]] = {}
    for fkey in sorted(graph.functions):
        det = _FuncDet(graph, fkey, config, acknowledged=set())
        for line, col, desc in det.all_sites:
            key = (det.fi.path, line)
            if key not in sites or (col, desc) < sites[key]:
                sites[key] = (col, desc)
    return sites


def run_r11(graph: ProjectGraph, config: TorchlintConfig,
            acknowledged: Set[Tuple[str, int]]
            ) -> Dict[str, List[RawFinding]]:
    """R11 findings per project-relative path.

    ``acknowledged``: (path, line) pairs carrying a valid R11 marker —
    those sources taint nobody."""
    scans: Dict[str, _FuncDet] = {
        fkey: _FuncDet(graph, fkey, config, acknowledged)
        for fkey in sorted(graph.functions)
    }
    #: function key -> witness description for nondet-returning functions
    nondet_fns: Dict[str, str] = {}
    for _ in range(12):  # bounded interprocedural fixpoint
        changed = False
        for fkey in sorted(scans):
            det = scans[fkey]
            if det.recompute(nondet_fns):
                changed = True
            if det.nondet_return is not None:
                if nondet_fns.get(fkey) != det.nondet_return:
                    nondet_fns[fkey] = det.nondet_return
                    changed = True
            elif fkey in nondet_fns:
                del nondet_fns[fkey]
                changed = True
        if not changed:
            break

    out: Dict[str, List[RawFinding]] = {}
    for fkey in sorted(scans):
        det = scans[fkey]
        found = det.sink_findings(config, nondet_fns)
        if found:
            out.setdefault(det.fi.path, []).extend(found)
    return out
