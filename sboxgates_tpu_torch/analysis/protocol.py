"""R10: replicated-protocol divergence (whole-program pass).

The replicated degradation protocol only works if every process
makes the same sequence of agreement calls: ``breach_verdict``,
``journal_seq_check``, ``run_config_check``, the ``_kv_exchange``
primitive, device collectives, and the replicated dispatch/retry
entries.  A call path that reaches one of those sites from only ONE
side of a rank-gated branch (``rank()``, ``is_primary()``,
or a local derived from them) means the primary blocks on an agreement
the secondaries never join — the group hangs at the next barrier, or the
launch counts diverge and the runtime deadlocks inside a collective.

Three checks:

* **one-sided agreement** — an ``ast.If`` whose test derives from a
  rank source where exactly one side (lexically, or transitively
  through the call graph) reaches an agreement site.  Guard style
  (``if rank != 0: return`` followed by agreement code) is handled by
  treating the statements after a terminating body as the else side.
* **collective in a host-agreement window** — a device collective
  (``torch.distributed`` ``all_reduce`` / ``all_gather`` / ``broadcast``
  / ``barrier``, or the JAX names the reference uses) issued in a
  function that also speaks the control store's protocol directly
  (``store.wait`` / ``store.get`` / ``store.set``).  The breach path
  exists precisely because a wedged device collective must be escaped
  via the *host* store; nesting one inside the host window
  re-introduces the deadlock the escape hatch is for.
* **rank-gated re-dispatch** — covered by the first check because the
  replicated dispatch/retry entries are agreement sites: re-issuing a
  sharded sweep from one rank only breaks launch-count lockstep.

Branches on replicated predicates (``world_size() <= 1`` and
friends) are NOT rank tests: every process takes the same side, so
there is nothing to diverge.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from .callgraph import ProjectGraph, iter_body_nodes
from .config import TorchlintConfig
from .rules import dotted

RawFinding = Tuple[str, int, int, str]

#: Device collectives: these resolve on the accelerator network, not the
#: host network, so they deadlock differently (and harder).  The
#: ``torch.distributed`` names, and the JAX names of the reference.
_DEVICE_COLLECTIVES = frozenset(
    {
        "all_gather",
        "all_reduce",
        "broadcast",
        "barrier",
        "reduce_scatter",
        "all_to_all",
        "process_allgather",
        "broadcast_one_to_all",
        "psum",
        "pmean",
        "pmax",
        "pmin",
    }
)

#: Direct coordination-protocol calls: a function issuing these is
#: inside a host-agreement window.  Bare tails, and the control store's
#: operations (the tail with ``store`` in the receiver chain).
_HOST_WINDOW_TAILS = frozenset(
    {"wait_at_barrier", "blocking_key_value_get", "key_value_set"}
)
_HOST_STORE_OPS = frozenset({"wait", "get", "set", "add", "compare_set"})


def _tail(name: Optional[str]) -> Optional[str]:
    return name.rsplit(".", 1)[-1] if name else None


def site_name(call: ast.Call, sites: Set[str]) -> Optional[str]:
    """The matching ``agreement_sites`` entry, if this call is one.  A
    dotted entry ("store.wait") requires the call tail to match its last
    component and the preceding component to appear in the receiver
    chain; a bare entry matches the call-name tail."""
    name = dotted(call.func)
    if name is None:
        return None
    parts = name.split(".")
    if parts[-1] in sites:
        return parts[-1]
    for entry in sorted(sites):
        if "." in entry:
            ehead, _, etail = entry.rpartition(".")
            if parts[-1] == etail and ehead in parts[:-1]:
                return entry
    return None


def _is_host_window_call(call: ast.Call) -> bool:
    name = dotted(call.func)
    if name is None:
        return False
    parts = name.split(".")
    if parts[-1] in _HOST_WINDOW_TAILS:
        return True
    return parts[-1] in _HOST_STORE_OPS and any(
        "store" in p.lower() for p in parts[:-1]
    )


def _rank_locals(fn_node: ast.AST, rank_sources: Set[str]) -> Set[str]:
    """Local names derived (transitively, via assignments in this
    function's own body) from a rank-source call — ``rank =
    is_primary()`` makes ``rank`` a rank-shaped value."""
    assigns: List[Tuple[Set[str], ast.AST]] = []
    for node in iter_body_nodes(fn_node):
        if isinstance(node, ast.Assign):
            names = {
                t.id for t in node.targets if isinstance(t, ast.Name)
            }
            if names:
                assigns.append((names, node.value))
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            if isinstance(node.target, ast.Name):
                assigns.append(({node.target.id}, node.value))
        elif isinstance(node, ast.NamedExpr):
            if isinstance(node.target, ast.Name):
                assigns.append(({node.target.id}, node.value))
    derived: Set[str] = set()
    changed = True
    while changed:
        changed = False
        for names, value in assigns:
            if names <= derived:
                continue
            if _mentions_rank(value, rank_sources, derived):
                derived |= names
                changed = True
    return derived


def _mentions_rank(expr: ast.AST, rank_sources: Set[str],
                   rank_locals: Set[str]) -> bool:
    for node in ast.walk(expr):
        if isinstance(node, ast.Call):
            if _tail(dotted(node.func)) in rank_sources:
                return True
        elif isinstance(node, ast.Attribute):
            if node.attr in rank_sources:
                return True
        elif isinstance(node, ast.Name):
            if node.id in rank_sources or node.id in rank_locals:
                return True
    return False


def _terminates(stmts: List[ast.stmt]) -> bool:
    """Does this block unconditionally leave the enclosing block?"""
    if not stmts:
        return False
    return isinstance(
        stmts[-1], (ast.Return, ast.Raise, ast.Continue, ast.Break)
    )


def _child_blocks(st: ast.stmt) -> List[List[ast.stmt]]:
    blocks: List[List[ast.stmt]] = []
    for attr in ("body", "orelse", "finalbody"):
        blk = getattr(st, attr, None)
        if blk and not isinstance(
            st, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)
        ):
            blocks.append(blk)
    for h in getattr(st, "handlers", ()) or ():
        blocks.append(h.body)
    return blocks


class _FuncProtocol:
    """Per-function R10 state: rank-derived locals plus the (line, col)
    -> callee index used to resolve transitive agreement reach."""

    def __init__(self, graph: ProjectGraph, fkey: str,
                 config: TorchlintConfig,
                 reach: Dict[str, str]) -> None:
        self.fi = graph.functions[fkey]
        self.agreement = set(config.agreement_sites)
        self.rank_sources = set(config.rank_sources)
        self.reach = reach
        self.calls = graph.call_index(fkey)
        self.locals = _rank_locals(self.fi.node, self.rank_sources)

    def is_rank_test(self, test: ast.AST) -> bool:
        return _mentions_rank(test, self.rank_sources, self.locals)

    def side_events(self, stmts: List[ast.stmt]) -> Set[str]:
        """Agreement sites reached from this branch side: direct calls
        whose name tail is an agreement site, plus calls into functions
        the reach fixpoint marked as transitively reaching one."""
        events: Set[str] = set()
        stack: List[ast.AST] = list(stmts)
        while stack:
            node = stack.pop()
            if isinstance(
                node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)
            ):
                continue
            if isinstance(node, ast.Call):
                t = site_name(node, self.agreement)
                if t is not None:
                    events.add(t)
                else:
                    for callee in self.calls.get(
                        (node.lineno, node.col_offset), ()
                    ):
                        w = self.reach.get(callee)
                        if w is not None:
                            events.add(w)
            stack.extend(ast.iter_child_nodes(node))
        return events


def _walk_blocks(scan: _FuncProtocol, stmts: List[ast.stmt],
                 out: List[RawFinding]) -> None:
    for i, st in enumerate(stmts):
        if isinstance(st, ast.If) and scan.is_rank_test(st.test):
            body_events = scan.side_events(st.body)
            if st.orelse:
                else_events = scan.side_events(st.orelse)
                shape = "the other side"
            elif _terminates(st.body):
                # guard style: `if rank != 0: return` — the code after
                # the guard is what the surviving side runs.
                else_events = scan.side_events(stmts[i + 1:])
                shape = "the path past the guard"
            else:
                else_events = set()
                shape = "the fall-through side"
            one_sided: Set[str] = set()
            if body_events and not else_events:
                one_sided, side = body_events, "one side"
            elif else_events and not body_events:
                one_sided, side = else_events, shape
            if one_sided:
                names = ", ".join(sorted(one_sided))
                out.append(
                    (
                        "R10",
                        st.lineno,
                        st.col_offset,
                        f"rank-gated branch reaches agreement site(s) "
                        f"{names} from {side} only — every process must "
                        "issue the same agreement/collective sequence "
                        "(launch-count lockstep), or acknowledge with "
                        "ignore[R10] and a reason",
                    )
                )
        for blk in _child_blocks(st):
            _walk_blocks(scan, blk, out)


def _host_window_findings(fi, out: List[RawFinding]) -> None:
    has_window = any(
        isinstance(n, ast.Call) and _is_host_window_call(n)
        for n in iter_body_nodes(fi.node)
    )
    if not has_window:
        return
    for node in iter_body_nodes(fi.node):
        if not isinstance(node, ast.Call):
            continue
        t = _tail(dotted(node.func))
        if t in _DEVICE_COLLECTIVES:
            out.append(
                (
                    "R10",
                    node.lineno,
                    node.col_offset,
                    f"device collective {t} issued inside a "
                    "host-agreement window (this function speaks the "
                    "coordination-service protocol directly) — a wedged "
                    "collective can no longer be escaped via the host "
                    "network, or acknowledge with ignore[R10] and a "
                    "reason",
                )
            )


def run_r10(graph: ProjectGraph,
            config: TorchlintConfig) -> Dict[str, List[RawFinding]]:
    """R10 findings per project-relative path."""
    agreement = set(config.agreement_sites)
    seeds: Dict[str, str] = {}
    for fkey in sorted(graph.functions):
        fi = graph.functions[fkey]
        for node in iter_body_nodes(fi.node):
            if not isinstance(node, ast.Call):
                continue
            t = site_name(node, agreement)
            if t is not None:
                w = f"{t} (via {fi.path}:{node.lineno})"
                if fkey not in seeds or w < seeds[fkey]:
                    seeds[fkey] = w
    reach = graph.reach_witness(seeds)

    out: Dict[str, List[RawFinding]] = {}
    for fkey in sorted(graph.functions):
        fi = graph.functions[fkey]
        found: List[RawFinding] = []
        scan = _FuncProtocol(graph, fkey, config, reach)
        body = list(getattr(fi.node, "body", ()))
        _walk_blocks(scan, body, found)
        _host_window_findings(fi, found)
        if found:
            out.setdefault(fi.path, []).extend(found)
    return out
