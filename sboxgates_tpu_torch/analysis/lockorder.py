"""R9 — lock-acquisition-order and held-across-dispatch analysis.

Eight kinds of background threads (prefetcher, warmer, heartbeat,
deadline workers, abort watchers, mux/restart/fleet workers) share
locks with no ordering discipline beyond convention.  This pass builds
a **lock-acquisition-order graph** over the whole program: an edge
``A -> B`` means some path acquires ``B`` while holding ``A`` — either
lexically (``with A: ... with B:``) or through the call graph (a
function called under ``A`` transitively acquires ``B``).  Two
findings come out of it:

* **order cycles** — ``A -> B`` on one path and ``B -> A`` on another
  is the classic two-thread deadlock; the finding carries the witness
  cycle with each hop's acquisition site;
* **lock held across a blocking dispatch** — a ``with <lock>:`` body
  that reaches a ``guarded_dispatch``/``dispatch_with_retry``/verdict
  resolve (``[tool.torchlint] blocking_calls``) blocks the lock for the
  whole deadline window, and the abandonment/degradation path that
  must then run CANNOT need that lock; holding one across the resolve
  deadlocks exactly when the resilience machinery is the thing trying
  to save the run.

Lock identities: module-level locks are ``module.name``; instance
locks are class-qualified (``module:Class.attr``) when acquired via
``self``, and attr-qualified (``*.attr``) otherwise.  Locks passed as
parameters have unknowable identity and stay out of the order graph
(they still suppress R4x).  Everything iterates sorted, so the graph
JSON and the findings are deterministic.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass
from typing import Dict, List, Optional, Set, Tuple

from .callgraph import ProjectGraph, FunctionInfo
from .config import TorchlintConfig
from .rules import dotted

RawFinding = Tuple[str, int, int, str]


@dataclass(frozen=True)
class OrderEdge:
    """``to`` acquired (or transitively acquirable) while ``frm`` held."""

    frm: str
    to: str
    path: str
    line: int
    col: int
    note: str  # "with" | "call <callee qualname>"


class LockOrderResult:
    def __init__(self) -> None:
        self.edges: List[OrderEdge] = []
        self.acquires: Dict[str, Set[str]] = {}  # fn key -> direct locks
        self.trans_acquires: Dict[str, Set[str]] = {}
        self.blocking_funcs: Set[str] = set()
        self.cycles: List[List[str]] = []
        self.findings: Dict[str, List[RawFinding]] = {}

    def as_json(self) -> dict:
        """Deterministic lock-order graph for ``--graph`` output and the
        root-coverage gate."""
        nodes = sorted(
            {e.frm for e in self.edges}
            | {e.to for e in self.edges}
            | {l for s in self.acquires.values() for l in s}
        )
        return {
            "locks": nodes,
            "edges": [
                {
                    "from": e.frm,
                    "to": e.to,
                    "path": e.path,
                    "line": e.line,
                    "note": e.note,
                }
                for e in sorted(
                    self.edges,
                    key=lambda e: (e.frm, e.to, e.path, e.line, e.col),
                )
            ],
            "cycles": self.cycles,
        }


def _lock_id(graph: ProjectGraph, fi: FunctionInfo,
             expr: ast.AST) -> Optional[str]:
    """Canonical lock identity of a with-item expression, or None when
    it is not a known lock (or a parameter lock of unknowable identity)."""
    name = dotted(expr)
    if name is None:
        return None
    if isinstance(expr, ast.Attribute):
        if expr.attr in graph.lock_attrs:
            if (
                isinstance(expr.value, ast.Name)
                and expr.value.id == "self"
                and fi.cls is not None
            ):
                return f"{fi.module}:{fi.cls}.{expr.attr}"
            return f"*.{expr.attr}"
    if "." not in name and name in graph.lock_params.get(fi.key, ()):
        return None  # parameter lock: identity unknown at this site
    got = graph.resolve(fi.module, name)
    if got is not None:
        mod, sym = got
        mi = graph.modules.get(mod)
        if mi is not None and mi.assigns.get(sym) == "lock":
            return f"{mod}.{sym}"
    return None


class _LockWalk:
    """One function's body walk: direct acquisitions, nested-with order
    edges, and direct blocking calls under a held lock."""

    def __init__(self, graph: ProjectGraph, fi: FunctionInfo,
                 blocking: Set[str], result: LockOrderResult) -> None:
        self.g = graph
        self.fi = fi
        self.blocking = blocking
        self.res = result
        self.held: List[str] = []
        self.direct_blocks: List[Tuple[str, int, int, str]] = []
        #: the body names a blocking call at all (held or not) — seeds
        #: the transitive blocking_funcs fixpoint, so a lock-free
        #: wrapper around guarded_dispatch still taints its callers
        self.names_blocking = False

    def run(self) -> None:
        acq: Set[str] = set()
        self.res.acquires[self.fi.key] = acq
        self._walk_body(self.fi.node, acq)

    def _walk_body(self, node: ast.AST, acq: Set[str]) -> None:
        for child in ast.iter_child_nodes(node):
            self._walk(child, acq)

    def _walk(self, node: ast.AST, acq: Set[str]) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            return  # nested defs are their own graph nodes
        if isinstance(node, (ast.With, ast.AsyncWith)):
            pushed = 0
            for item in node.items:
                lid = _lock_id(self.g, self.fi, item.context_expr)
                if lid is None:
                    continue
                acq.add(lid)
                for h in self.held:
                    if h != lid:
                        self.res.edges.append(
                            OrderEdge(
                                frm=h,
                                to=lid,
                                path=self.fi.path,
                                line=item.context_expr.lineno,
                                col=item.context_expr.col_offset,
                                note="with",
                            )
                        )
                self.held.append(lid)
                pushed += 1
            for child in node.body:
                self._walk(child, acq)
            del self.held[len(self.held) - pushed:]
            for item in node.items:
                self._walk(item.context_expr, acq)
            return
        if isinstance(node, ast.Call):
            tail = (dotted(node.func) or "").rsplit(".", 1)[-1]
            if tail in self.blocking:
                self.names_blocking = True
                if self.held:
                    self.direct_blocks.append(
                        (self.held[-1], node.lineno, node.col_offset, tail)
                    )
        self._walk_body(node, acq)


def _find_cycles(edges: List[OrderEdge]) -> List[List[str]]:
    """Deterministic minimal cycles in the order graph: for each node in
    sorted order, the BFS-shortest path back to itself; canonicalized
    (rotated to the smallest member) and deduplicated."""
    adj: Dict[str, Set[str]] = {}
    for e in edges:
        adj.setdefault(e.frm, set()).add(e.to)
    cycles: List[List[str]] = []
    seen: Set[Tuple[str, ...]] = set()
    for start in sorted(adj):
        # BFS from start's successors back to start.
        prev: Dict[str, Optional[str]] = {}
        frontier = sorted(adj.get(start, ()))
        for n in frontier:
            prev.setdefault(n, None)
        found = None
        while frontier and found is None:
            nxt: List[str] = []
            for n in frontier:
                if n == start:
                    found = n
                    break
                for m in sorted(adj.get(n, ())):
                    if m not in prev:
                        prev[m] = n
                        nxt.append(m)
            frontier = nxt
        if found is None:
            continue
        # Reconstruct start -> ... -> start.
        path = [start]
        n: Optional[str] = prev.get(start)
        while n is not None:
            path.append(n)
            n = prev.get(n)
        path.reverse()  # [first successor, ..., start] -> chronological
        cycle = [start] + path[:-1] if len(path) > 1 else [start]
        lo = min(range(len(cycle)), key=lambda i: cycle[i])
        canon = tuple(cycle[lo:] + cycle[:lo])
        if canon in seen:
            continue
        seen.add(canon)
        cycles.append(list(canon))
    return cycles


def run_r9(
    graph: ProjectGraph,
    config: TorchlintConfig,
) -> Tuple[Dict[str, List[RawFinding]], LockOrderResult]:
    res = LockOrderResult()
    blocking_names = set(config.blocking_calls)
    walks: Dict[str, _LockWalk] = {}
    for fkey in sorted(graph.functions):
        w = _LockWalk(graph, graph.functions[fkey], blocking_names, res)
        w.run()
        walks[fkey] = w

    # Transitive acquisitions (call-graph fixpoint).
    res.trans_acquires = {
        k: set(v) for k, v in res.acquires.items()
    }
    changed = True
    while changed:
        changed = False
        for fkey in sorted(graph.functions):
            mine = res.trans_acquires[fkey]
            before = len(mine)
            for e in graph.out_edges.get(fkey, ()):
                mine |= res.trans_acquires.get(e.callee, set())
            if len(mine) != before:
                changed = True

    # Transitively-blocking functions: the function's own name matches,
    # or its body names a blocking call, or it calls a blocking function.
    for fkey in graph.functions:
        qual_tail = fkey.rsplit(".", 1)[-1].split(":")[-1]
        if qual_tail in blocking_names or walks[fkey].names_blocking:
            res.blocking_funcs.add(fkey)
    changed = True
    while changed:
        changed = False
        for fkey in sorted(graph.functions):
            if fkey in res.blocking_funcs:
                continue
            for e in graph.out_edges.get(fkey, ()):
                if e.callee in res.blocking_funcs:
                    res.blocking_funcs.add(fkey)
                    changed = True
                    break

    # Interprocedural order edges + held-across-dispatch findings.
    held_seen: Set[Tuple[str, int, str]] = set()
    for e in sorted(
        graph.edges, key=lambda e: (e.path, e.line, e.col, e.callee)
    ):
        caller = graph.functions.get(e.caller)
        if caller is None or e.callee not in graph.functions:
            continue
        held = [
            lid
            for lid in (
                _lock_id(graph, caller, x) for x in e.with_stack
            )
            if lid is not None
        ]
        if not held:
            continue
        callee = graph.functions[e.callee]
        for t in sorted(res.trans_acquires.get(e.callee, ())):
            for h in held:
                if h != t:
                    res.edges.append(
                        OrderEdge(
                            frm=h,
                            to=t,
                            path=e.path,
                            line=e.line,
                            col=e.col,
                            note=f"call {callee.qualname}",
                        )
                    )
        if e.callee in res.blocking_funcs:
            key = (e.path, e.line, held[-1])
            if key not in held_seen:
                held_seen.add(key)
                res.findings.setdefault(e.path, []).append(
                    (
                        "R9",
                        e.line,
                        e.col,
                        f"lock '{held[-1]}' is held across a blocking "
                        f"dispatch/resolve (via '{callee.qualname}') — "
                        "the deadline window blocks the lock, and the "
                        "abandonment/degradation path deadlocks if it "
                        "needs it; release before dispatching or "
                        "acknowledge with ignore[R9] and a reason",
                    )
                )
    # Direct blocking-call sites (the callee may be unresolvable —
    # e.g. ctx.guarded_dispatch on an opaque context object).
    for fkey in sorted(walks):
        w = walks[fkey]
        for lock, line, col, tail in w.direct_blocks:
            key = (w.fi.path, line, lock)
            if key in held_seen:
                continue
            held_seen.add(key)
            res.findings.setdefault(w.fi.path, []).append(
                (
                    "R9",
                    line,
                    col,
                    f"lock '{lock}' is held across the blocking call "
                    f"'{tail}' — the deadline window blocks the lock, "
                    "and the abandonment/degradation path deadlocks if "
                    "it needs it; release before dispatching or "
                    "acknowledge with ignore[R9] and a reason",
                )
            )

    # Cycles, each reported once at its first witness edge.
    res.cycles = _find_cycles(res.edges)
    by_pair: Dict[Tuple[str, str], OrderEdge] = {}
    for e in sorted(
        res.edges, key=lambda e: (e.path, e.line, e.col, e.frm, e.to)
    ):
        by_pair.setdefault((e.frm, e.to), e)
    for cycle in res.cycles:
        hops = list(zip(cycle, cycle[1:] + cycle[:1]))
        witnesses = [by_pair[h] for h in hops if h in by_pair]
        if not witnesses:
            continue
        site = min(witnesses, key=lambda e: (e.path, e.line, e.col))
        arrows = " -> ".join(cycle + [cycle[0]])
        detail = "; ".join(
            f"{b} acquired at {by_pair[(a, b)].path}:"
            f"{by_pair[(a, b)].line} while holding {a}"
            for a, b in hops
            if (a, b) in by_pair
        )
        res.findings.setdefault(site.path, []).append(
            (
                "R9",
                site.line,
                site.col,
                f"lock acquisition-order cycle: {arrows} ({detail}) — "
                "two threads interleaving these paths deadlock; impose "
                "one global acquisition order",
            )
        )
    return res.findings, res
